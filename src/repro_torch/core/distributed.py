# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The by-feature slab solve (paper Algorithm 4) on one device, the
counterpart of ``repro/core/distributed.py`` at data extent 1.

The reference runs the mesh's ``model`` axis (the M feature blocks) under
``shard_map``; here it is the leading batch axis of every tensor, so the
M blocks advance together, one kernel launch for all of them:

* :func:`layout_slabs` -- (p_pad, K) slabs -> (M, nt, T, K) tiles, each
  feature's slots sorted by row, plus each tile's row-sorted slot order
  and its values in that order (``slab_gram`` needs the sorted slots and
  the order, ``slab_spmv``'s segmented sum the order and its values).
  Built once per fit, as ``layout_blocks`` lays out dense tiles;
* :func:`local_subproblem_sparse` -- one CD cycle over the tiles: per
  tile step one ``slab_gram``, one tile-cycle kernel and one
  ``slab_spmv`` residual update for all M blocks, which also advances
  the tile's dbeta;
* :func:`make_distributed_iteration_sparse` -- the engine's iteration,
  with ``dm = sum_m (z - r_m)`` (a reduction over the batch axis, in a
  fixed order) in place of the reference's ``psum`` over ``model``;
* :func:`make_slab_margins` / :func:`make_slab_densifier` -- X @ beta
  and the densify-once fallback, from the slabs.

Host reads: the engine's (one per outer iteration plus one fetch) and
one entry read in :func:`check_slab_shapes` (the slab's largest row),
both through ``engine.host_read``. Nothing per tile reads the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.subproblem import layout_coefs, make_tile_solver, unlayout_coefs
from repro_torch.kernels.slab_spmv import SlabOrder, slab_order


def slab_dims(row_idx, values, mesh, n: int) -> int:
    """The shape half of :func:`check_slab_shapes`, with no host read:
    (p, DP, K) slabs against the mesh and the example count. Returns
    n_loc."""
    if row_idx.shape != values.shape or row_idx.dim() != 3:
        raise ValueError(
            f"slab shapes must match and be (p, DP, K); got row_idx "
            f"{tuple(row_idx.shape)} vs values {tuple(values.shape)}")
    ddim = mesh.shape["data"]
    if row_idx.shape[1] != ddim:
        raise ValueError(
            f"slab data dimension {row_idx.shape[1]} must equal the mesh "
            f"data extent {ddim}")
    if n % ddim:
        raise ValueError(f"data extent {ddim} must divide n={n} (trim or pad upstream)")
    return n // ddim


def check_rows(max_row: int, n_loc: int, n: int, ddim: int) -> None:
    """Raise if a slab's largest local row index passes the sentinel."""
    if max_row > n_loc:
        raise ValueError(
            f"slab row index {max_row} exceeds the local example count "
            f"{n_loc} implied by n={n} on data extent {ddim} -- were the "
            f"slabs built for a different n?")


def check_slab_shapes(row_idx, values, mesh, n: int) -> int:
    """Validate (p, DP, K) by-feature slabs against the mesh and example
    count. Returns n_loc (local examples per data shard). Reads the
    slab's largest row index once (counted by ``engine.host_read``)."""
    n_loc = slab_dims(row_idx, values, mesh, n)
    # local row indices beyond the sentinel would be silently dropped by
    # the products downstream -- catch a slab/y example-count mismatch
    # here instead of converging to a wrong solution
    max_row = int(engine.host_read(row_idx.max())) if row_idx.numel() else 0
    check_rows(max_row, n_loc, n, mesh.shape["data"])
    return n_loc


def pad_features(row_idx, values, beta, n_loc: int, quantum: int):
    """Pad the feature axis of (p, DP, K) slabs (sentinel rows, zero
    values) and of ``beta`` (zeros, if given) to a multiple of
    ``quantum``. All-sentinel features add nothing to any Gram tile or
    product, so their coefficients stay 0. Returns (row_idx, values,
    beta, pad)."""
    pad = (-row_idx.shape[0]) % quantum
    if pad:
        row_idx = torch.cat([row_idx, row_idx.new_full((pad, *row_idx.shape[1:]), n_loc)])
        values = torch.cat([values, values.new_zeros((pad, *values.shape[1:]))])
        if beta is not None:
            beta = torch.cat([beta, beta.new_zeros(pad)])
    return row_idx, values, beta, pad


class SlabLayout(NamedTuple):
    """Slabs laid out for the by-feature solve: ``rows``/``vals`` (M, nt,
    T, K) with each feature's slots sorted by row, and ``order``, each
    tile's slots sorted by row with their values ((M, nt, T * K) each)."""

    rows: torch.Tensor
    vals: torch.Tensor
    order: SlabOrder


def layout_slabs(row_idx, values, num_blocks: int, tile: int) -> SlabLayout:
    """(p_pad, K) slabs (p_pad a multiple of num_blocks * tile) -> the
    per-fit :class:`SlabLayout`: two stable sorts and two gathers of the
    values, no host read."""
    p, k = row_idx.shape
    if p % (num_blocks * tile):
        raise ValueError(f"p={p} must be a multiple of M * tile = {num_blocks * tile}")
    nt = p // (num_blocks * tile)
    rows = row_idx.reshape(num_blocks, nt, tile, k)
    rows_s, idx = torch.sort(rows, dim=-1, stable=True)
    vals = values.reshape(num_blocks, nt, tile, k).gather(-1, idx)
    return SlabLayout(rows_s.contiguous(), vals.contiguous(), slab_order(rows_s, vals))


def local_subproblem_sparse(lay: SlabLayout, w, r, beta, lam, *, tile: int,
                            nu: float, cycle_mode: str = "sequential",
                            block: int = 16):
    """One CD cycle of every feature block over its slab tiles.

    ``lay`` from :func:`layout_slabs`; w (n_loc,); r (M, n_loc), advanced
    in place; beta (M, nt * tile). Each tile's Gram block and correlation
    come straight from the slabs (``kernels.slab_gram``), and the
    residuals and dbeta advance with the slab product
    (``kernels.slab_spmv``, one launch for both), with no (n_loc, tile)
    densify. Returns (dbeta (M, nt * tile), r).
    """
    from repro_torch.kernels import ops as kops

    nt = lay.rows.shape[1]
    tile_solver = make_tile_solver(cycle_mode=cycle_mode, tile=tile, block=block)
    dbeta = torch.zeros_like(beta)
    for t in range(nt):
        rows, vals = lay.rows[:, t], lay.vals[:, t]
        order = SlabOrder(*(f[:, t] for f in lay.order))
        G, c = kops.slab_gram(rows, vals, w, r, rows_sorted=True, order=order)
        sl = slice(t * tile, (t + 1) * tile)
        d = tile_solver(G, c, beta[:, sl], dbeta[:, sl], lam, nu)
        kops.slab_residual_update(r, rows, vals, d, order=order, dbeta=dbeta[:, sl])
    return dbeta, r


def make_distributed_iteration_sparse(mesh, opts: DGLMNETOptions):
    """The by-feature subproblem in the engine's ``iteration_fn``
    signature, with ``data`` a :class:`SlabLayout` of the mesh's M
    feature blocks."""
    num_blocks = mesh.shape["model"]

    def iteration(data, y, beta, m, lam, w, z):
        bt = layout_coefs(beta, num_blocks, opts.tile)
        r = z.expand(num_blocks, -1).clone()
        dbeta, r = local_subproblem_sparse(
            data, w, r, bt, lam, tile=opts.tile, nu=opts.nu,
            cycle_mode=opts.cycle_mode, block=opts.block)
        # paper Alg. 4 step 3: the blocks' margin deltas summed over the
        # model axis (a fixed-order reduction over the batch axis)
        dm = (z - r).sum(0)
        grad_dot = torch.dot(torch.sigmoid(m) - (y + 1.0) * 0.5, dm)
        return unlayout_coefs(dbeta, beta.shape[0]), dm, grad_dot

    return iteration


def make_slab_margins(mesh, n_loc: int):
    """``margins(row_idx, values, beta) -> X @ beta`` over (p, 1, K) slabs
    (p a multiple of M): the slab product of each feature block's p/M
    features in one launch, summed over the M blocks in a fixed order."""
    from repro_torch.kernels import ops as kops

    num_blocks = mesh.shape["model"]

    def slab_margins(row_idx, values, beta):
        p, _, k = row_idx.shape
        if p % num_blocks:
            raise ValueError(f"p={p} must be a multiple of M={num_blocks}")
        rows = row_idx[:, 0].reshape(num_blocks, p // num_blocks, k)
        vals = values[:, 0].reshape(num_blocks, p // num_blocks, k)
        m_blocks = kops.slab_spmv(rows, vals, beta.reshape(num_blocks, -1), n_loc=n_loc)
        return m_blocks.sum(0)

    return slab_margins


def make_slab_densifier(mesh, n_loc: int):
    """One-shot densify ``(row_idx, values) -> X`` (n_loc, p) of (p, 1, K)
    slabs: the dense fallback's setup for slabs above the sparse-win
    density (``kernels.prefer_slab_gram``). The scatter runs once per
    solve; the solve then rides the dense subproblem."""
    from repro_torch.kernels.ref import _densify_slab

    def densify(row_idx, values):
        return _densify_slab(row_idx[:, 0], values[:, 0], n_loc)

    return densify


@dataclass
class DistributedFitResult:
    """Mirror of ``FitResult`` for mesh solves, plus the final margin
    cache ``m``."""

    beta: torch.Tensor
    f: float
    n_iters: int
    objective_history: List[float]
    alpha_history: List[float] = field(default_factory=list)
    unit_step_frac: float = 0.0
    converged: bool = False
    m: Optional[torch.Tensor] = None
    # engine.STATUS_* code; non-OK means the solve tripped a guardrail and
    # beta/f are the last certified iterate, not the final proposed step
    status: int = 0

    @property
    def nnz(self) -> int:
        return int((self.beta.abs() > 0).sum())

    @property
    def status_name(self) -> str:
        return engine.status_name(self.status)

    @property
    def ok(self) -> bool:
        return self.status == engine.STATUS_OK


def _finish(state, p: int, pad: int, verbose: bool, tag: str) -> DistributedFitResult:
    """Shared solve epilogue: the one closing host read + result."""
    host, hist, alphas = engine.fetch(state)
    it = host.it
    if verbose:
        for k in range(1, it + 1):
            print(f"  [{tag}] iter {k} f={hist[k]:.6f}")
    return DistributedFitResult(
        beta=state.beta[:p] if pad else state.beta,
        f=hist[-1], n_iters=it, objective_history=hist, alpha_history=alphas,
        unit_step_frac=host.unit_steps / max(it, 1), converged=host.converged,
        m=state.m, status=host.status)


def fit_distributed_sparse(row_idx, values, y, lam: float, mesh, *,
                           beta0: Optional[torch.Tensor] = None,
                           opts: DGLMNETOptions = DGLMNETOptions(),
                           verbose: bool = False,
                           densify: Optional[bool] = None) -> DistributedFitResult:
    """The by-feature solve over (p, 1, K) slabs on ``mesh``'s device.
    Delegates to the front door ``LogisticL1(opts, mesh=mesh)`` over
    ``ShardedDesign(SlabDesign(...), mesh)``; ``densify`` overrides the
    ``prefer_slab_gram`` heuristic."""
    from repro_torch.api import LogisticL1, ShardedDesign, SlabDesign

    design = ShardedDesign(SlabDesign(row_idx, values, int(y.shape[0])), mesh,
                           tile=opts.tile)
    return LogisticL1(opts=opts, mesh=mesh, device=mesh.device).fit(
        design, y, lam, beta0=beta0, verbose=verbose, densify=densify)
