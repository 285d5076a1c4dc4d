# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Run-time sanitizers for the host-read contract, the counterpart of
``repro/analysis/sanitize.py`` (same names, the port's own mechanisms).

``transfer_sanitizer(max_fetches)``
    The engine's contract is k + 1 host reads for a fit of k outer
    iterations (k + 2 for a slab fit) and, for a path, the driver's reads
    on top (``core/engine.py``). Every one of them goes through the
    engine's two counted doors, :func:`~repro_torch.core.engine.host_read`
    and :func:`~repro_torch.core.engine.host_array`. Inside the context
    those doors are wrapped: each call is counted against
    ``max_fetches`` (one more raises :class:`FetchBudgetExceeded`), and
    every other way a guarded tensor reaches the host raises
    :class:`HostTransferError` at the offending line: ``Tensor.item``,
    ``tolist``, ``numpy``, ``cpu``, ``float()``, ``int()``, ``bool()``,
    ``operator.index`` and ``np.asarray`` (``__array__``; unlike the
    reference's JAX arrays, a tensor's ``__array__`` is a Python method,
    so this spelling is caught too).

    Which tensors are guarded: on a machine with a card, the CUDA tensors,
    and torch's sync debug mode is set to ``"error"`` as well, dropped to
    ``"default"`` only while a door reads -- so a synchronising call the
    patches cannot see (a blocking copy, ``nonzero``) fails too. Without a
    card every tensor is guarded: the CPU stands in for the card, as the
    reference's CPU runs treat every array as a device array. Everything patched is restored on exit, also when
    the body raises.

``compile_sanitizer(max_compiles)``
    The port compiles nothing per call: its counterpart of an XLA compile
    is a kernel build (``kernels/build.py`` :func:`build_all` running
    ``nvcc`` for a library not built yet) or a first load of a kernel
    library (:func:`~repro_torch.kernels.build.load`). Inside the context
    both are counted, and on exit more than ``max_compiles`` of them
    raise :class:`CompileBudgetExceeded` naming each. ``compile_sanitizer
    (0)`` around the warm leg of a path is the port's zero-rebuild
    certificate.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List

import torch

#: the ways a tensor reaches the host that the transfer sanitizer patches
GUARDED_METHODS = ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__",
                   "__index__", "__array__")


class HostTransferError(RuntimeError):
    """A guarded tensor reached the host outside the engine's counted doors
    (``core.engine.host_read`` / ``host_array``)."""


class FetchBudgetExceeded(HostTransferError):
    """More reads through the counted doors than the budget allows."""


class CompileBudgetExceeded(RuntimeError):
    """More kernel builds or first library loads than the budget allows."""


@dataclass
class TransferStats:
    """What the transfer sanitizer saw: the sanctioned reads (anything
    unsanctioned raised instead of being recorded)."""

    max_fetches: int
    fetches: int = 0


@dataclass
class CompileStats:
    """The kernel builds (``build:<name>``) and first library loads
    (``load:<name>``) seen inside :func:`compile_sanitizer`."""

    max_compiles: int
    compiles: List[str] = field(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.compiles)


@contextmanager
def transfer_sanitizer(max_fetches: int = 1):
    """Allow device -> host reads only through ``engine.host_read`` /
    ``engine.host_array``, at most ``max_fetches`` of them; yields a
    :class:`TransferStats`. The guarded tensors are the CUDA ones on a
    machine with a card, every tensor without one (module docstring)."""
    from repro_torch.core import engine

    card = torch.cuda.is_available()
    stats = TransferStats(max_fetches=max_fetches)
    state = {"sanctioned": 0}

    def guarded(t) -> bool:
        return not state["sanctioned"] and (t.is_cuda if card else True)

    def guard(name, orig):
        def method(self, *args, **kwargs):
            if guarded(self):
                raise HostTransferError(
                    f"Tensor.{name} on a {self.device.type} tensor outside the engine's "
                    f"counted doors (core.engine.host_read / host_array): read it through "
                    f"a door, or keep it on the device")
            return orig(self, *args, **kwargs)
        method.__name__ = name
        return method

    def door(orig):
        def sanctioned(t):
            stats.fetches += 1  # allow[torch-metric-discipline]: the sanitizer is the contract's meter and must count with no registry active
            if stats.fetches > stats.max_fetches:
                raise FetchBudgetExceeded(
                    f"counted host read #{stats.fetches} exceeds the budget of "
                    f"{stats.max_fetches} in this scope")
            state["sanctioned"] += 1
            if card:
                torch.cuda.set_sync_debug_mode("default")
            try:
                return orig(t)
            finally:
                state["sanctioned"] -= 1
                if card and not state["sanctioned"]:
                    torch.cuda.set_sync_debug_mode("error")
        return sanctioned

    saved = {name: torch.Tensor.__dict__.get(name) for name in GUARDED_METHODS}
    doors = (engine.host_read, engine.host_array)
    prev_mode = torch.cuda.get_sync_debug_mode() if card else None
    for name in GUARDED_METHODS:
        setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    engine.host_read, engine.host_array = (door(d) for d in doors)
    try:
        if card:
            torch.cuda.set_sync_debug_mode("error")
        yield stats
    finally:
        if card:
            torch.cuda.set_sync_debug_mode(prev_mode)
        engine.host_read, engine.host_array = doors
        for name, orig in saved.items():
            if orig is None:
                delattr(torch.Tensor, name)     # it was inherited: unshadow it
            else:
                setattr(torch.Tensor, name, orig)


@contextmanager
def compile_sanitizer(max_compiles: int = 0):
    """Count the kernel builds and first library loads inside the
    context; on exit, more than ``max_compiles`` raise
    :class:`CompileBudgetExceeded`. Yields a :class:`CompileStats`."""
    from repro_torch.kernels import build

    stats = CompileStats(max_compiles=max_compiles)
    orig_build_all, orig_load = build.build_all, build.load

    def build_all(names=build.SOURCES):
        names = list(names)
        stats.compiles.extend(f"build:{n}" for n in names if not build.lib_path(n).exists())
        return orig_build_all(names)

    def load(name):
        if name not in build._loaded:
            stats.compiles.append(f"load:{name}")
        return orig_load(name)

    build.build_all, build.load = build_all, load
    try:
        yield stats
    finally:
        build.build_all, build.load = orig_build_all, orig_load
    if stats.count > max_compiles:
        raise CompileBudgetExceeded(
            f"{stats.count} kernel build(s) or first load(s) inside a budget of "
            f"{max_compiles}: {', '.join(stats.compiles)}")
