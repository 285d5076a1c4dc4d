# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's meshes, the counterpart of ``repro/launch/mesh.py``.

A mesh has a ``data`` axis (example shards) and a ``model`` axis whose
extent M is the number of feature blocks, the paper's M machines; a
process mesh may also have a ``pod`` axis before them, and then
``("pod", "data")`` together are the example axes (:attr:`ProcMesh.
example_axes`, as the reference's ``_data_axes``). Two kinds, with one
interface (``shape``, ``axis_names``, ``device``, the rank's coordinates,
``examples`` / ``example_rank`` / ``example_axes`` and ``all_reduce``):

* :class:`DevMesh` (:func:`make_dev_mesh`) -- one device, data extent
  1: the M blocks run as the leading batch axis of every tensor
  (``core.subproblem.layout_blocks``), and every collective is a no-op;
* :class:`ProcMesh` (:func:`make_process_mesh`) -- the ranks of an
  initialised ``torch.distributed`` world laid out as a (data, R) grid,
  rank = d * R + r, or as a (pod, data, R) grid, rank = (q * D + d) * R
  + r. Rank (d, r) holds example shard d (q * D + d on a pod mesh) and
  runs the blocks ``[r * M / R, (r + 1) * M / R)`` as one batch, as a
  :class:`DevMesh` runs all M. Each axis, the example axes together and
  the whole world have a process group each, so a reduction over the
  example axes of a (P, D, M) mesh is one ``all_reduce`` over the same
  ranks, in the same order, as the data axis of a (P * D, M) mesh.

The mesh's one collective is ``all_reduce(SUM)``, which NCCL and gloo
both run on CUDA tensors. An axis of one rank skips its
collective, so a one-rank :class:`ProcMesh` computes bit for bit what a
:class:`DevMesh` computes. Each reduction hands every rank the same bits,
so every rank takes the same branch on a reduced value. A
:class:`ProcMesh` counts its collectives and their bytes per axis
(:meth:`ProcMesh.stats`).

The backend is the caller's choice, made once in ``init_process_group``
and named again to :func:`make_process_mesh`: ``"nccl"`` wants one card
per rank and raises if two ranks share one; ``"gloo"`` serves ranks on
the CPU and ranks that share one card. Nothing switches backends, and
nothing moves to the CPU when a card is missing.

A world that :func:`init_process_mesh` or :func:`make_production_mesh`
starts is the caller's to end: :func:`world_scope` around a rank's work
tears the process group down, so that no rank exits with a live gloo or
NCCL group (whose threads abort the process at exit).

The reference's TPU roofline constants have no counterpart here: the
card's rates live with the measurements (``chip_smoke.py``).
"""
from __future__ import annotations

import os
import socket
import zlib
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

AXIS_NAMES: Tuple[str, str] = ("data", "model")
#: the axes of a mesh with a pod axis; ``("pod", "data")`` are its example axes
POD_AXIS_NAMES: Tuple[str, str, str] = ("pod", "data", "model")
#: the process groups' default deadline: a collective that hangs fails
DEFAULT_TIMEOUT = timedelta(seconds=300)


@dataclass(frozen=True)
class DevMesh:
    """A (data, model) mesh on one device; ``data`` is 1."""

    data: int
    model: int
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, str]:
        return AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    # the one-rank case of ProcMesh's interface
    data_rank = 0
    model_rank = 0
    model_ranks = 1
    ranks = 1
    examples = 1
    example_rank = 0
    example_axes = ("data",)

    @property
    def local_blocks(self) -> int:
        return self.model

    def axis_ranks(self, axis) -> int:
        return 1

    def axis_index(self, axis) -> int:
        return 0

    def all_reduce(self, t: torch.Tensor, axis) -> torch.Tensor:
        return t


def make_dev_mesh(data: int = 1, model: int = 4, *,
                  device=DEFAULT_DEVICE) -> DevMesh:
    """A (data, model) mesh on ``device`` (raises for ``"cuda"`` without a
    card). ``model`` feature blocks run as one batch on the device."""
    if model < 1:
        raise ValueError(f"model extent must be >= 1, got {model}")
    if data != 1:
        raise ValueError(
            f"data extent {data} needs example shards on several ranks: build a "
            f"process mesh over a torch.distributed world "
            f"(make_process_mesh({data}, {model}, backend=...)); make_dev_mesh "
            f"takes data extent 1")
    return DevMesh(data=1, model=int(model), device=resolve_device(device))


def _axes(axis, names: Tuple[str, ...] = AXIS_NAMES) -> Tuple[str, ...]:
    """``axis`` (a name or names) as a tuple in the mesh's axis order."""
    asked = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in asked:
        if a not in names:
            raise ValueError(f"unknown mesh axis {a!r}: expected one of {names}")
    return tuple(a for a in names if a in asked)


@dataclass(eq=False)
class ProcMesh:
    """A (data, model) or (pod, data, model) mesh over the ranks of a
    ``torch.distributed`` world (see the module docstring); built by
    :func:`make_process_mesh`.

    ``model`` is M, the feature blocks; ``model_ranks`` (R) ranks share
    them, ``local_blocks`` = M / R each; ``pods`` (P, 1 for a mesh
    without a pod axis) times ``data`` (D) example shards. ``groups``
    maps an axis tuple (``("data",)``, ``("model",)``, ``("pod",
    "data")``, every axis, ...) to this rank's process group on it; an
    axis of one rank has none (its collectives are skipped)."""

    data: int
    model: int
    model_ranks: int
    backend: str
    device: torch.device
    rank: int
    groups: Dict[Tuple[str, ...], object] = field(repr=False)
    calls: Counter = field(default_factory=Counter, repr=False)
    nbytes: Counter = field(default_factory=Counter, repr=False)
    pods: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return POD_AXIS_NAMES if self.pods > 1 else AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        shape = {"data": self.data, "model": self.model}
        return {"pod": self.pods, **shape} if self.pods > 1 else shape

    @property
    def ranks(self) -> int:
        return self.pods * self.data * self.model_ranks

    @property
    def examples(self) -> int:
        """The example shards: the extent of the example axes, P * D."""
        return self.pods * self.data

    @property
    def example_axes(self) -> Tuple[str, ...]:
        """The axes the examples are sharded over: ``("pod", "data")`` on a
        pod mesh, else ``("data",)``."""
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def example_rank(self) -> int:
        """This rank's example shard, q * D + d."""
        return self.rank // self.model_ranks

    @property
    def pod_rank(self) -> int:
        return self.example_rank // self.data

    @property
    def data_rank(self) -> int:
        return self.example_rank % self.data

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_ranks

    @property
    def local_blocks(self) -> int:
        return self.model // self.model_ranks

    def _extent(self, axis: str) -> int:
        return {"pod": self.pods, "data": self.data, "model": self.model_ranks}[axis]

    def axis_ranks(self, axis) -> int:
        """The ranks along ``axis`` (a name or a tuple of names)."""
        n = 1
        for a in _axes(axis, self.axis_names):
            n *= self._extent(a)
        return n

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis`` (several axes: row-major in the
        mesh's axis order)."""
        coord = {"pod": self.pod_rank, "data": self.data_rank, "model": self.model_rank}
        idx = 0
        for a in _axes(axis, self.axis_names):
            idx = idx * self._extent(a) + coord[a]
        return idx

    def all_reduce(self, t: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` (a name, or a tuple
        of names reduced together in one collective), as a new tensor;
        ``t`` itself is returned when the axis has one rank."""
        import torch.distributed as dist

        axes = _axes(axis, self.axis_names)
        if self.axis_ranks(axes) == 1:
            return t
        group = self.groups.get(axes)
        if group is None:
            raise ValueError(f"this mesh builds no process group over {axes}")
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        key = "+".join(axes)
        self.calls[key] += 1
        self.nbytes[key] += out.numel() * out.element_size()
        return out

    def stats(self) -> Dict[str, Tuple[int, int]]:
        """Collectives made since the last :meth:`reset_stats`, per axis:
        ``{axis: (calls, bytes)}``."""
        return {k: (self.calls[k], self.nbytes[k]) for k in sorted(self.calls)}

    def reset_stats(self) -> None:
        self.calls.clear()
        self.nbytes.clear()


def check_devices(backend: str, entries: Sequence[Tuple[int, str]]) -> None:
    """Raise if the backend cannot serve the ranks' devices: ``entries``
    holds each rank's (host id, device) in rank order. NCCL wants one
    card per rank."""
    if backend != "nccl":
        return
    seen: Dict[Tuple[int, str], int] = {}
    for rank, (host, dev) in enumerate(entries):
        if not str(dev).startswith("cuda"):
            raise ValueError(f"backend 'nccl' needs a card per rank; rank {rank} is on {dev}")
        if (host, dev) in seen:
            raise ValueError(
                f"backend 'nccl' wants one card per rank, but ranks {seen[(host, dev)]} "
                f"and {rank} share {dev} on one host: give each rank its own card "
                f"(torch.cuda.set_device(LOCAL_RANK)), or choose backend 'gloo' for "
                f"ranks that share a card")
        seen[(host, dev)] = rank


def _mesh_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _lines(axes: Tuple[str, ...], names: Tuple[str, ...], extents: Dict[str, int]):
    """The rank lists of every line of ``axes`` (the ranks that differ only
    in those coordinates), each in rank order, the lines in a fixed order."""
    lines: Dict[Tuple[int, ...], list] = {}
    world = 1
    for a in names:
        world *= extents[a]
    for rank in range(world):
        coord, rest = {}, rank
        for a in reversed(names):
            coord[a] = rest % extents[a]
            rest //= extents[a]
        lines.setdefault(tuple(coord[a] for a in names if a not in axes), []).append(rank)
    return [lines[k] for k in sorted(lines)]


def make_process_mesh(data: int, model: int, *, backend: str, device=DEFAULT_DEVICE,
                      timeout: timedelta = DEFAULT_TIMEOUT, pod: int = 1) -> ProcMesh:
    """A (data, model) :class:`ProcMesh` over the initialised world, or,
    with ``pod`` > 1, a (pod, data, model) one: every rank calls it with
    the same arguments. ``pod * data`` must divide the world size W, and
    R = W / (pod * data) must divide ``model`` (M blocks); a ``pod`` of 1
    is the (data, model) mesh. ``backend`` must be the world's own
    (``init_process_group``'s choice). Builds one process group per line
    of each axis, of the example axes together and of the world (every
    rank builds every group, in one order) and checks, with one
    all_reduce, that every rank asked for the same mesh and, under NCCL,
    that no two ranks share a card."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_process_mesh needs an initialised torch.distributed world "
            "(init_process_group(backend, init_method=..., world_size=..., rank=...) "
            "or torchrun); make_dev_mesh(1, M) runs one device")
    world_backend = str(dist.get_backend())
    if world_backend != backend:
        raise ValueError(f"the world was initialised with backend {world_backend!r}, the "
                         f"mesh asks for {backend!r}: a mesh never switches backends")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"backend 'nccl' needs a card per rank, got device={device!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    examples = pod * data
    if pod < 1 or data < 1 or model < 1 or world % examples:
        raise ValueError(f"{'pod x ' if pod > 1 else ''}data extent {examples} must divide "
                         f"the world size {world}")
    r_model = world // examples
    if model % r_model:
        raise ValueError(f"{r_model} ranks on the model axis must divide the model "
                         f"extent {model} (the feature blocks)")
    dev = _mesh_device(device)
    names = POD_AXIS_NAMES if pod > 1 else AXIS_NAMES
    extents = {"pod": pod, "data": data, "model": r_model}
    groups: Dict[Tuple[str, ...], object] = {}
    wanted = [(a,) for a in names]
    if pod > 1:
        wanted.append(("pod", "data"))
    for axes in wanted:
        for members in _lines(axes, names, extents):
            if len(members) < 2:
                continue
            g = dist.new_group(members, timeout=timeout, backend=backend)
            if rank in members:
                groups[axes] = g
    if world > 1:
        groups[names] = dist.group.WORLD
    mesh = ProcMesh(data=data, model=model, model_ranks=r_model, backend=backend,
                    device=dev, rank=rank, groups=groups, pods=pod)
    # every rank's (pod, data, model) and (host, device), in one reduction
    host = zlib.crc32(socket.gethostname().encode())
    # NCCL reduces only on the card; gloo takes the host copy
    slot = torch.zeros(world, 5, dtype=torch.int64,
                       device=dev if backend == "nccl" else "cpu")
    slot[rank] = torch.tensor([pod, data, model, host, -1 if dev.index is None else dev.index])
    # allow[torch-host-sync]: one read when the mesh is built, before any solve
    table = mesh.all_reduce(slot, names).tolist()
    mesh.reset_stats()
    if any(tuple(row[:3]) != (pod, data, model) for row in table):
        raise ValueError(f"the ranks asked for different meshes: "
                         f"{[tuple(r[:3]) for r in table]}")
    check_devices(backend, [(row[3], f"cuda:{row[4]}" if row[4] >= 0 else "cpu")
                            for row in table])
    return mesh


def _close_world(*, barrier: bool) -> None:
    """End this process's ``torch.distributed`` world, if it has one:
    the barrier if asked, then ``destroy_process_group``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        if barrier:
            dist.barrier()
    finally:
        dist.destroy_process_group()


@contextmanager
def world_scope():
    """Run the block, then end the world it started (a world initialised
    before the block is its owner's to end): a barrier, so that no rank
    leaves while another still talks to it, and ``destroy_process_group``
    when the block returns; ``destroy_process_group`` alone when it raises
    (its peers may never reach a barrier), and the error goes on."""
    import torch.distributed as dist

    owned = not (dist.is_available() and dist.is_initialized())
    try:
        yield
    except BaseException:
        if owned:
            _close_world(barrier=False)
        raise
    if owned:
        _close_world(barrier=True)


def init_process_mesh(data: int, model: int, *, backend: str, init_method: str,
                      world_size: int, rank: int, device=DEFAULT_DEVICE,
                      timeout: timedelta = DEFAULT_TIMEOUT, pod: int = 1) -> ProcMesh:
    """``init_process_group`` with the caller's backend, address, world
    size and rank, then :func:`make_process_mesh`. Under NCCL the caller
    sets each rank's card first (``torch.cuda.set_device``). The caller
    ends the world (:func:`world_scope`)."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)
    return make_process_mesh(data, model, backend=backend, device=device, timeout=timeout,
                             pod=pod)


def make_production_mesh(*, data: Optional[int] = None, model: int = 16,
                         multi_pod: bool = False, backend: str = "nccl",
                         timeout: timedelta = DEFAULT_TIMEOUT) -> ProcMesh:
    """The ``torchrun`` world as a (data, model) mesh, one card per
    ``LOCAL_RANK``: reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` (torchrun sets them), sets the
    rank's card and initialises the world (unless it is initialised
    already). ``model`` is the number of feature blocks (16, as the
    paper's timing runs); ``data`` defaults to 1.

    ``multi_pod=True`` gives the reference's multi-pod mesh, (2, ``data``,
    ``model``) = (2, 16, 16) by default, one rank per feature block of each
    pod's example row: the world must hold exactly 2 * ``data`` *
    ``model`` ranks, else ValueError."""
    import torch.distributed as dist

    if not dist.is_initialized():
        try:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            local = int(os.environ["LOCAL_RANK"])
            addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        except KeyError as e:
            raise RuntimeError(f"make_production_mesh runs under torchrun: {e} is not set "
                               f"(torchrun --nproc-per-node N ...)") from None
        resolve_device("cuda")
        torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank,
                                timeout=timeout)
    if not multi_pod:
        return make_process_mesh(1 if data is None else data, model, backend=backend,
                                 device="cuda", timeout=timeout)
    data = 16 if data is None else data
    need, world = 2 * data * model, dist.get_world_size()
    if world != need:
        raise ValueError(f"the multi-pod production mesh (2, {data}, {model}) runs one rank "
                         f"per feature block: it needs 2 x {data} x {model} = {need} ranks, "
                         f"the world has {world}")
    return make_process_mesh(data, model, backend=backend, device="cuda", timeout=timeout,
                             pod=2)


def parse_mesh(spec: str, *, backend: Optional[str] = None, device=DEFAULT_DEVICE):
    """CLI mesh spec: ``prod`` / ``prod-multipod``
    (:func:`make_production_mesh`), ``DxM`` or ``PxDxM``: over an
    initialised world a :class:`ProcMesh` with the world's ``backend``
    (named by the caller), else a (1, M) :class:`DevMesh`. A ``1xDxM``
    spec is the ``DxM`` mesh."""
    import torch.distributed as dist

    if spec in ("prod", "prod-multipod"):
        return make_production_mesh(multi_pod=spec == "prod-multipod",
                                    backend=backend or "nccl")
    try:
        dims = tuple(int(x) for x in spec.split("x"))
        if len(dims) not in (2, 3):
            raise ValueError(spec)
    except ValueError:
        raise ValueError(f"mesh spec {spec!r}: expected 'prod' or 'DxM' (or 'prod-multipod' "
                         f"or 'PxDxM')") from None
    pod, data, model = dims if len(dims) == 3 else (1, *dims)
    if dist.is_available() and dist.is_initialized():
        if backend is None:
            raise ValueError("a mesh over a torch.distributed world needs backend= "
                             "('nccl' or 'gloo')")
        return make_process_mesh(data, model, backend=backend, device=device, pod=pod)
    if pod != 1:
        raise ValueError(f"mesh spec {spec!r}: a pod axis spans ranks of a torch.distributed "
                         f"world (initialise one first); make_dev_mesh runs one device")
    return make_dev_mesh(data, model, device=device)


def num_chips(mesh) -> int:
    """The devices a mesh runs on: its ranks (one for a :class:`DevMesh`)."""
    return int(getattr(mesh, "ranks", 1))


def is_process_mesh(mesh) -> bool:
    """Whether ``mesh`` spans ranks of a torch.distributed world."""
    return isinstance(mesh, ProcMesh)
