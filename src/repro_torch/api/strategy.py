# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Strategy resolution, the counterpart of ``repro/api/strategy.py``:
the one place (design layout, options) maps to an execution plan. Only
the local dense cell is ported."""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core.dglmnet import DGLMNETOptions


@dataclass(frozen=True)
class Strategy:
    """Resolved execution plan for one solve."""

    execution: str                  # "local" (the mesh is not ported yet)
    solver: str                     # "dense" (slab solvers are not ported yet)
    opts: DGLMNETOptions            # cycle_mode resolved to a concrete mode


def _resolve_cycle(opts: DGLMNETOptions) -> DGLMNETOptions:
    """``cycle_mode="auto"`` -> concrete mode (the ``prefer_blocked_cd``
    tile-size heuristic) + eager blocked-cycle shape validation."""
    cycle_mode = opts.cycle_mode
    if cycle_mode == "auto":
        from repro_torch.kernels.ops import prefer_blocked_cd

        cycle_mode = ("blocked" if prefer_blocked_cd(opts.tile, opts.block)
                      else "sequential")
    if cycle_mode == "blocked" and opts.tile % opts.block:
        raise ValueError(
            f"blocked cycle needs block ({opts.block}) to divide tile "
            f"({opts.tile}) — pick block in {{1, 2, 4, ...}} <= tile"
        )
    if cycle_mode != opts.cycle_mode:
        opts = replace(opts, cycle_mode=cycle_mode)
    return opts


def resolve(design, opts: DGLMNETOptions) -> Strategy:
    """Pick the execution plan for ``design`` under ``opts``: the local
    dense solver, with ``cycle_mode="auto"`` resolved here so everything
    downstream sees only "sequential" or "blocked"."""
    if design.layout != "dense":
        raise ValueError(f"layout {design.layout!r} is not ported yet")
    opts = _resolve_cycle(opts)
    return Strategy(execution="local", solver="dense", opts=opts)
