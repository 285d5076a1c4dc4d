# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Strategy resolution, the counterpart of ``repro/api/strategy.py``:
the one place (design layout, mesh, options) maps to an execution plan.

* local vs mesh comes from the design (:class:`ShardedDesign` or not);
* dense vs slab subproblems from the layout: a local slab design
  densifies once and rides the dense solver, a slab design on a mesh
  gets the by-feature slab solver, whose per-solve densify decision is
  :meth:`Strategy.use_densify`;
* ``cycle_mode="auto"`` resolves to a concrete mode here;
* ``cap_tile`` is the feature-capacity quantum of the screened path's
  restricted solves: ``tile`` locally, ``M * tile`` on a mesh of M
  feature blocks;
* ``residency`` is "streamed" when a mesh slab design's device budget is
  below its padded slab bytes (``data.residency`` then double-buffers
  the buckets from the host through every pass), else "resident". A
  budget on a sharded dense layout is rejected: the dense mesh solve
  keeps X resident, so the budget would bound nothing.

:func:`mesh_programs` hands out a mesh's outer step and sparse screen,
resolved the same way.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.api.design import ShardedDesign
from repro_torch.core.dglmnet import DGLMNETOptions


@dataclass(frozen=True)
class Strategy:
    """Resolved execution plan for one solve."""

    execution: str                  # "local" | "mesh"
    solver: str                     # "dense" | "slab"
    opts: DGLMNETOptions            # cycle_mode resolved to a concrete mode
    cap_tile: int                   # feature-capacity quantum (screened path)
    densify: Optional[bool] = None  # slab solver: force/forbid densify-once
    residency: str = "resident"     # "resident" | "streamed" (mesh slabs)

    def use_densify(self, n_loc: int, k: int) -> bool:
        """Per-solve densify decision for the slab solver: the explicit
        override wins, else the nnz-density heuristic
        (``kernels.ops.prefer_slab_gram``) at the solve's (n_loc, K)."""
        if self.densify is not None:
            return self.densify
        from repro_torch.kernels.ops import prefer_slab_gram

        return not prefer_slab_gram(n_loc, k)


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


def resolve(design, opts: DGLMNETOptions, *,
            densify: Optional[bool] = None) -> Strategy:
    """Pick the execution plan for ``design`` under ``opts`` (see the
    module docstring)."""
    sharded = isinstance(design, ShardedDesign)
    if design.layout not in ("dense", "slab", "bucketed"):
        raise ValueError(f"unknown layout {design.layout!r}")
    execution = "mesh" if sharded else "local"
    solver = "slab" if (sharded and design.layout in ("slab", "bucketed")) else "dense"
    opts = _resolve_cycle(opts)
    cap_tile = (design.mdim if sharded else 1) * opts.tile
    residency = "resident"
    if sharded and design.device_budget_bytes is not None:
        if solver != "slab":
            raise ValueError(
                "device_budget_bytes streams slab layouts only; a sharded dense "
                "design keeps X resident -- build the design from slabs "
                "(to_by_feature / to_slab_buckets) to stream")
        if design.device_budget_bytes < design.slab_nbytes(opts.tile):
            residency = "streamed"
    return Strategy(execution=execution, solver=solver, opts=opts,
                    cap_tile=cap_tile, densify=densify, residency=residency)


def mesh_programs(mesh, opts: DGLMNETOptions, *, layout: str = "dense",
                  n_loc: Optional[int] = None):
    """The mesh programs for a layout and option bundle, resolved as live
    solves resolve them (the reference's dry-run front door).

    Returns ``(step, screen)``: ``step`` is the outer iteration for the
    layout (``core.distributed.make_dglmnet_step`` for ``"dense"``,
    ``make_dglmnet_step_sparse`` for slab layouts: ``step(X | row_idx,
    values, y, beta, m, lam)``); ``screen`` is the sparse strong-rule pass
    ``core.screening.make_sparse_screen`` (slab layouts with ``n_loc``
    given, else None)."""
    from repro_torch.core.distributed import make_dglmnet_step, make_dglmnet_step_sparse

    if layout not in ("dense", "slab", "bucketed"):
        raise ValueError(f"unknown layout {layout!r}")
    opts = _resolve_cycle(opts)
    if layout == "dense":
        step = make_dglmnet_step(mesh, opts)
    else:
        step = make_dglmnet_step_sparse(mesh, opts)
    screen = None
    if layout != "dense" and n_loc is not None:
        from repro_torch.core.screening import make_sparse_screen

        screen = make_sparse_screen(mesh, n_loc, opts.tile)
    return step, screen
