# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Per-lambda progress store behind ``LogisticL1.path(checkpoint_every=)``,
the port's copy of ``repro/resilience/progress.py`` (the same files: a
slot written by either package loads in the other).

Layout under one progress directory::

    <dir>/point-00004/   checkpoint dir (manifest + CRC'd payload)
    <dir>/point-00009/   ... rotated, newest ``keep`` slots retained ...
    <dir>/LATEST         atomic pointer file: index of the newest slot

Each slot is a full :func:`repro_torch.checkpoint.save_pytree` checkpoint
(atomic publish + CRC-32 payload integrity), written *after* the path
point it names was emitted; the ``LATEST`` pointer is replaced atomically
after the slot lands, so a crash at any instant leaves either the old or
the new pointer -- never a pointer to a half-written slot. On load, a
slot that fails its integrity check
(:class:`repro_torch.checkpoint.CheckpointCorruption`) or lacks its
``meta`` is skipped and the next-older retained slot is used --
corruption costs re-solving a few lambdas, not the whole path.

On a process mesh of several ranks (``LogisticL1.path`` over a design
split between ranks) each rank's margins ``m`` are its own example
shard, so each rank keeps its own rotated slots, in a directory of its
own under the shared one (:func:`rank_directory`)::

    <dir>/rank-00000/point-00004/   rank 0's slots and its LATEST pointer
    <dir>/rank-00000/LATEST
    <dir>/rank-00001/point-00004/   ... one directory per rank ...

and each slot's meta also names the mesh (``"mesh"``: pods, data, model,
ranks). Ranks can die between their own saves, so a resume does not
trust any one rank's pointer: every rank lists the slots it can load
(:meth:`PathProgress.load_all`), and one reduction over the mesh picks
the newest index that every rank holds (``keep=2`` keeps the slot before
the newest for exactly this); a slot written for another grid, ``p`` or
mesh, or a directory laid out for another world (:func:`foreign_layout`),
raises on every rank.

Arrays go in and come out as numpy arrays (a tensor leaf is copied to
the host by the checkpointer); the caller decides how they reach the
device.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import CheckpointCorruption, save_pytree
from repro_torch.checkpoint.checkpointer import _read_manifest, verify_payload

_SLOT_RE = re.compile(r"^point-(\d{5})$")
_RANK_RE = re.compile(r"^rank-(\d{5})$")
_POINTER = "LATEST"


def rank_directory(directory: str, rank: int) -> str:
    """Rank ``rank``'s own progress directory under a shared one."""
    return os.path.join(directory, f"rank-{rank:05d}")


def foreign_layout(directory: str, ranks: int) -> bool:
    """Whether ``directory`` holds progress laid out for another world
    than one of ``ranks`` ranks: one device's slots (``point-*``,
    ``LATEST``) beside per-rank ones, or a rank directory past the
    world (``ranks`` of 1: any rank directory)."""
    if not os.path.isdir(directory):
        return False
    for name in os.listdir(directory):
        match = _RANK_RE.match(name)
        if match:
            if ranks == 1 or int(match.group(1)) >= ranks:
                return True
        elif ranks > 1 and (_SLOT_RE.match(name) or name == _POINTER):
            return True
    return False


def _leaf_name(path_str: str) -> str:
    """``jax.tree_util.keystr`` of a flat-dict key, back to the key."""
    if path_str.startswith("['") and path_str.endswith("']"):
        return path_str[2:-2]
    return path_str


class PathProgress:
    """Rotated, integrity-checked per-point checkpoints of a path solve.

    ``keep`` >= 2 so the newest slot can be corrupted (torn write, disk
    fault) and resume still has a certified fallback.
    """

    def __init__(self, directory: str, *, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def slot(self, idx: int) -> str:
        return os.path.join(self.directory, f"point-{idx:05d}")

    def slots(self):
        """Indices of the retained slots, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            match = _SLOT_RE.match(name)
            if match:
                out.append(int(match.group(1)))
        return sorted(out)

    # -- write -------------------------------------------------------------

    def save(self, idx: int, tree: Dict[str, Any], meta: dict) -> str:
        """Checkpoint ``tree`` (a flat dict of arrays) + ``meta`` as slot
        ``idx``, publish the pointer, prune old slots. Returns the slot
        directory."""
        directory = save_pytree(tree, self.slot(idx), step=idx, meta=meta)
        self._publish(idx)
        self._prune(idx)
        return directory

    def _publish(self, idx: int) -> None:
        pointer = os.path.join(self.directory, _POINTER)
        tmp = f"{pointer}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                f.write(f"{idx}\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, pointer)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def _prune(self, newest: int) -> None:
        for idx in self.slots():
            if idx <= newest - self.keep:
                shutil.rmtree(self.slot(idx), ignore_errors=True)

    # -- read --------------------------------------------------------------

    def pointer(self) -> Optional[int]:
        """The raw LATEST pointer value, or None when never published."""
        try:
            with open(os.path.join(self.directory, _POINTER)) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            return None

    def load(self, idx: int) -> Tuple[Dict[str, np.ndarray], dict]:
        """Arrays + meta of slot ``idx``; raises ``CheckpointCorruption``
        when the slot fails its integrity contract."""
        directory = self.slot(idx)
        manifest = _read_manifest(directory)
        verify_payload(directory)
        try:
            data = np.load(os.path.join(directory, "arrays.npz"))
        except (OSError, ValueError) as err:
            raise CheckpointCorruption(
                f"unreadable payload in {directory}: {err}")
        arrays = {_leaf_name(e["path"]): np.asarray(data[e["key"]])
                  for e in manifest["leaves"]}
        meta = manifest.get("meta")
        if meta is None:
            raise CheckpointCorruption(
                f"slot {directory} has no meta side channel — cannot "
                f"rebuild path state from arrays alone")
        return arrays, meta

    def load_all(self) -> Dict[int, Tuple[Dict[str, np.ndarray], dict]]:
        """Every retained slot that passes its integrity check, as
        ``{idx: (arrays, meta)}`` (a process mesh's resume picks among
        them by one reduction)."""
        out = {}
        for idx in self.slots():
            try:
                out[idx] = self.load(idx)
            except CheckpointCorruption:
                continue
        return out

    def load_latest(self) -> Optional[Tuple[int, Dict[str, np.ndarray], dict]]:
        """Newest loadable state: ``(idx, arrays, meta)``, walking back
        over corrupted slots; None when nothing usable remains."""
        ptr = self.pointer()
        candidates = self.slots()
        # pointer first (it is the committed one), then newest-to-oldest
        order = ([ptr] if ptr in candidates else []) + \
            [i for i in sorted(candidates, reverse=True) if i != ptr]
        for idx in order:
            try:
                arrays, meta = self.load(idx)
                return idx, arrays, meta
            except CheckpointCorruption:
                continue
        return None

    def describe(self) -> str:
        ptr = self.pointer()
        return (f"PathProgress({self.directory!r}: pointer={ptr}, "
                f"slots={self.slots()}, keep={self.keep})")
