# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""d-GLMNET on a mesh (paper Algorithm 4), the counterpart of
``repro/core/distributed.py``.

The mesh (``launch.mesh``) has a ``model`` axis of M feature blocks and
a ``data`` axis of example shards. On a ``DevMesh`` (one device) the M
blocks are the leading batch axis of every tensor, one kernel launch for
all of them; on a ``ProcMesh`` rank (d, r) of a ``torch.distributed``
world holds example shard d and runs its M / R blocks as one batch. What
each rank holds in a solve:

* ``beta`` (p,): whole, on every rank (the same bits everywhere);
* ``m``, ``y``, ``w``, ``z`` (n_loc,): the rank's own example shard;
* the design: its shard's rows of its blocks' features, laid out once
  per fit (:func:`layout_slabs`; ``api.design.shard_examples`` keeps only
  that piece of a global design, so the solve cuts nothing; the
  per-call steps below cut it from the global arrays).

Entry points take the global arrays on every rank and keep the rank's
shard, as the reference's ``device_put`` does. The reductions
(``mesh.all_reduce``, skipped on an axis of one rank, so a one-rank
``ProcMesh`` computes bit for bit what a ``DevMesh`` computes):

* over ``data`` (the example axes, ``("pod", "data")`` on a pod mesh,
  in one collective): each tile step's Gram block and correlation, packed in
  one reduction (exact row-global statistics, as the reference's
  ``psum``), ``grad_dot``, and the engine's NLL partials (f(beta0), the
  fused NLL, each batch of line-search trials, the snap-back);
* over ``model``: ``dm`` (paper Alg. 4 step 3, the AllReduce of the
  blocks' margin deltas) and the blocks' dbeta pieces, collected by
  ``sharding.collect`` into the whole dbeta. With beta whole on every
  rank the L1 norm of every trial point is local: one collection of
  dbeta per iteration stands for a model-axis reduction of the L1 norm
  in every line-search trial.

Modules:

* :func:`local_subproblem` / :func:`local_subproblem_sparse` -- one CD
  cycle of the rank's blocks over dense tiles / slab tiles (per slab
  tile step one ``slab_gram``, one tile-cycle kernel and one
  ``slab_spmv`` residual update for the rank's blocks);
* :func:`make_distributed_iteration` / ``_sparse`` -- the engine's
  iteration; :func:`make_dglmnet_step` / ``_sparse`` -- one outer step;
* :func:`make_slab_margins` / :func:`make_slab_densifier` -- the rank's
  part of X @ beta and the densify-once fallback, per example shard;
* :func:`fit_distributed` / :func:`fit_distributed_sparse` -- the front
  door ``LogisticL1(opts, mesh=mesh)`` over a ``ShardedDesign``.

Host reads: the engine's (one per outer iteration plus one fetch, on
every rank) and one entry read in a slab solve (the slabs' largest row),
both through ``engine.host_read``. Nothing per tile reads the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.subproblem import (layout_blocks, layout_coefs, make_tile_solver,
                                         solve_subproblem, unlayout_coefs)
from repro_torch.kernels.slab_spmv import SlabOrder, slab_order
from repro_torch.sharding.collect import concat_replicated


def data_reducer(mesh):
    """The sum of NLL partials over the mesh's example shards (None when
    its example axes hold one rank): the engine's ``reduce``. On a pod
    mesh the example axes are ``("pod", "data")``, reduced together in
    one collective."""
    axes = mesh.example_axes
    if mesh.axis_ranks(axes) == 1:
        return None
    return lambda t: mesh.all_reduce(t, axes)


def _gc_reducer(mesh):
    """A tile's (G, c) summed over the example shards in one reduction."""
    axes = mesh.example_axes
    if mesh.axis_ranks(axes) == 1:
        return None

    def reduce(G, c):
        buf = mesh.all_reduce(torch.cat([G.reshape(-1), c.reshape(-1)]), axes)
        return buf[:G.numel()].view(G.shape), buf[G.numel():].view(c.shape)

    return reduce


def example_rows(n: int, mesh) -> slice:
    """This rank's rows of an n-example axis (all of them when the example
    axes hold one rank): shard ``mesh.example_rank`` of ``mesh.examples``
    (the pod and data extents together)."""
    ddim = mesh.examples
    if n % ddim:
        raise ValueError(f"data extent {ddim} must divide n={n} (trim or pad upstream)")
    n_loc = n // ddim
    return slice(mesh.example_rank * n_loc, (mesh.example_rank + 1) * n_loc)


def rank_features(p: int, mesh) -> slice:
    """This rank's features of a p-wide axis split into M blocks (p a
    multiple of M): the contiguous run of its M / R blocks."""
    width = p // mesh.model_ranks
    return slice(mesh.model_rank * width, (mesh.model_rank + 1) * width)


def _rank_blocks(mesh) -> slice:
    return slice(mesh.model_rank * mesh.local_blocks, (mesh.model_rank + 1) * mesh.local_blocks)


def _collect(dbeta_t, mesh, p: int):
    """The rank's blocks' (M / R, L) dbeta -> the whole (p,) on every rank."""
    return unlayout_coefs(concat_replicated(dbeta_t, mesh), p)


def slab_dims(row_idx, values, ddim: int, n: int) -> int:
    """The shape half of :func:`check_slab_shapes`, with no host read:
    (p, DP, K) slabs against the data extent ``ddim`` and the example
    count. Returns n_loc."""
    if row_idx.shape != values.shape or row_idx.dim() != 3:
        raise ValueError(
            f"slab shapes must match and be (p, DP, K); got row_idx "
            f"{tuple(row_idx.shape)} vs values {tuple(values.shape)}")
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
    """Validate global (p, DP, K) by-feature slabs against the mesh and
    example count. Returns n_loc (local examples per data shard). Reads
    the slabs' largest row index once (counted by ``engine.host_read``);
    on a process mesh every rank reads the same global slabs."""
    ddim = mesh.examples
    n_loc = slab_dims(row_idx, values, ddim, n)
    # local row indices beyond the sentinel would be silently dropped by
    # the products downstream -- catch a slab/y example-count mismatch
    # here instead of converging to a wrong solution
    max_row = int(engine.host_read(row_idx.max())) if row_idx.numel() else 0
    check_rows(max_row, n_loc, n, ddim)
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


def dense_blocks(X, mesh, tile: int) -> torch.Tensor:
    """The rank's shard of a dense X (n_loc, p), p a multiple of M * tile,
    laid out as its M / R blocks' tiles (M / R, nt, n_loc, tile): one
    copy per fit (``layout_blocks`` of the rank's features)."""
    return layout_blocks(X[:, rank_features(X.shape[1], mesh)], mesh.local_blocks, tile)


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


def local_subproblem(Xt, w, z, beta, lam, *, mesh, opts: DGLMNETOptions):
    """One CD cycle of the rank's blocks over their dense tiles (the
    reference's per-(data, model)-shard body).

    Xt (M / R, nt, n_loc, tile) from :func:`dense_blocks`; w, z (n_loc,);
    beta (M / R, nt * tile). Each tile's Gram block and correlation are
    summed over the example shards before its cycle, so every data rank
    runs the same cycle. Returns (dbeta (M / R, nt * tile), dm (M / R,
    n_loc)), dm the blocks' margin deltas on the rank's rows."""
    return solve_subproblem(Xt, w, z, beta, lam, method=opts.method, n_cycles=opts.n_cycles,
                            nu=opts.nu, cycle_mode=opts.cycle_mode, block=opts.block,
                            reduce=_gc_reducer(mesh))


def make_distributed_iteration(mesh, opts: DGLMNETOptions):
    """The dense mesh subproblem in the engine's ``iteration_fn``
    signature: ``iteration(Xt, y, beta, m, lam, w, z) -> (dbeta, dm,
    grad_dot)``, ``Xt`` from :func:`dense_blocks`; dbeta whole, dm on
    the rank's rows, grad_dot summed over the shards."""
    num_blocks = mesh.shape["model"]
    blocks = _rank_blocks(mesh)
    nll_sum = data_reducer(mesh)

    def iteration(Xt, y, beta, m, lam, w, z):
        bt = layout_coefs(beta, num_blocks, opts.tile)[blocks]
        dbeta_t, dm_b = local_subproblem(Xt, w, z, bt, lam, mesh=mesh, opts=opts)
        # paper Alg. 4 step 3: the blocks' margin deltas summed over the
        # model axis (the rank's blocks in a fixed order, then the ranks)
        dm = mesh.all_reduce(dm_b.sum(0), "model")
        grad_dot = torch.dot(torch.sigmoid(m) - (y + 1.0) * 0.5, dm)
        if nll_sum is not None:
            grad_dot = nll_sum(grad_dot)
        return _collect(dbeta_t, mesh, beta.shape[0]), dm, grad_dot

    return iteration


def local_subproblem_sparse(lay: SlabLayout, w, r, beta, lam, *, tile: int,
                            nu: float, cycle_mode: str = "sequential",
                            block: int = 16, mesh=None):
    """One CD cycle of every feature block of ``lay`` over its slab tiles.

    ``lay`` from :func:`layout_slabs` (the rank's blocks); w (n_loc,); r
    (B, n_loc), advanced in place; beta (B, nt * tile). Each tile's Gram
    block and correlation come straight from the slabs
    (``kernels.slab_gram``), summed over ``mesh``'s example shards when
    it has several; the residuals and dbeta advance with the slab
    product (``kernels.slab_spmv``, one launch for both), with no
    (n_loc, tile) densify. Returns (dbeta (B, nt * tile), r).
    """
    from repro_torch.kernels import ops as kops

    nt = lay.rows.shape[1]
    tile_solver = make_tile_solver(cycle_mode=cycle_mode, tile=tile, block=block)
    reduce = None if mesh is None else _gc_reducer(mesh)
    dbeta = torch.zeros_like(beta)
    for t in range(nt):
        rows, vals = lay.rows[:, t], lay.vals[:, t]
        order = SlabOrder(*(f[:, t] for f in lay.order))
        G, c = kops.slab_gram(rows, vals, w, r, rows_sorted=True, order=order)
        if reduce is not None:
            G, c = reduce(G, c)
        sl = slice(t * tile, (t + 1) * tile)
        d = tile_solver(G, c, beta[:, sl], dbeta[:, sl], lam, nu)
        kops.slab_residual_update(r, rows, vals, d, order=order, dbeta=dbeta[:, sl])
    return dbeta, r


def make_distributed_iteration_sparse(mesh, opts: DGLMNETOptions):
    """The by-feature subproblem in the engine's ``iteration_fn``
    signature, with ``data`` a :class:`SlabLayout` of the rank's M / R
    feature blocks (all M on a ``DevMesh``) on its example shard."""
    num_blocks = mesh.shape["model"]
    blocks = _rank_blocks(mesh)
    nll_sum = data_reducer(mesh)

    def iteration(data, y, beta, m, lam, w, z):
        bt = layout_coefs(beta, num_blocks, opts.tile)[blocks]
        r = z.expand(bt.shape[0], -1).clone()
        dbeta, r = local_subproblem_sparse(
            data, w, r, bt, lam, tile=opts.tile, nu=opts.nu,
            cycle_mode=opts.cycle_mode, block=opts.block, mesh=mesh)
        # paper Alg. 4 step 3: the blocks' margin deltas summed over the
        # model axis (a fixed-order reduction over the batch axis, then
        # over the ranks)
        dm = mesh.all_reduce((z - r).sum(0), "model")
        grad_dot = torch.dot(torch.sigmoid(m) - (y + 1.0) * 0.5, dm)
        if nll_sum is not None:
            grad_dot = nll_sum(grad_dot)
        return _collect(dbeta, mesh, beta.shape[0]), dm, grad_dot

    return iteration


def make_dglmnet_step(mesh, opts: DGLMNETOptions):
    """One dense outer iteration on ``mesh``, for callers that run the
    loop themselves: ``step(X, y, beta, m, lam) -> (beta', m', f',
    alpha)``. X (n, p) and y (n,) are the global arrays on every rank
    (each keeps its shard; X laid out anew per call), beta (p,) whole,
    m the rank's rows of X @ beta."""
    step_core = engine.make_step(make_distributed_iteration(mesh, opts),
                                 reduce=data_reducer(mesh))
    quantum = mesh.shape["model"] * opts.tile

    def step(X, y, beta, m, lam):
        rows = example_rows(X.shape[0], mesh)
        p = X.shape[1]
        pad = (-p) % quantum
        Xt = dense_blocks(torch.nn.functional.pad(X[rows], (0, pad)), mesh, opts.tile)
        beta_p = torch.nn.functional.pad(beta, (0, pad))
        b, m_new, f, alpha = step_core(Xt, y[rows], beta_p, m, lam)
        return b[:p], m_new, f, alpha

    return step


def make_dglmnet_step_sparse(mesh, opts: DGLMNETOptions):
    """One outer iteration over global by-feature slabs (p, DP, K) on
    ``mesh``: ``step(row_idx, values, y, beta, m, lam) -> (beta', m', f',
    alpha)``, as :func:`make_dglmnet_step` (the rank's shard laid out
    anew per call; no host read)."""
    step_core = engine.make_step(make_distributed_iteration_sparse(mesh, opts),
                                 reduce=data_reducer(mesh))
    quantum = mesh.shape["model"] * opts.tile

    def step(row_idx, values, y, beta, m, lam):
        n_loc = slab_dims(row_idx, values, mesh.examples, y.shape[0])
        d = mesh.example_rank
        rows, vals, beta_p, pad = pad_features(row_idx[:, d], values[:, d], beta, n_loc,
                                               quantum)
        feats = rank_features(rows.shape[0], mesh)
        lay = layout_slabs(rows[feats], vals[feats], mesh.local_blocks, opts.tile)
        b, m_new, f, alpha = step_core(lay, y[example_rows(y.shape[0], mesh)], beta_p, m, lam)
        return b[:b.shape[0] - pad], m_new, f, alpha

    return step


def make_slab_margins(mesh, n_loc: int):
    """``margins(row_idx, values, beta) -> X @ beta`` over this rank's
    features on one example shard: (w, 1, K) slabs of the shard's rows (w
    a multiple of the rank's M / R blocks; all M on one rank) and their
    coefficients, the slab product of each block's features in one
    launch, summed over the rank's blocks in a fixed order. This is the
    rank's partial: the caller sums it over ``model`` (the reference's
    ``psum``), once over all of its pieces."""
    from repro_torch.kernels import ops as kops

    num_blocks = mesh.local_blocks

    def slab_margins(row_idx, values, beta):
        p, _, k = row_idx.shape
        if p % num_blocks:
            raise ValueError(f"p={p} must be a multiple of the rank's {num_blocks} blocks")
        rows = row_idx[:, 0].reshape(num_blocks, p // num_blocks, k)
        vals = values[:, 0].reshape(num_blocks, p // num_blocks, k)
        m_blocks = kops.slab_spmv(rows, vals, beta.reshape(num_blocks, -1), n_loc=n_loc)
        return m_blocks.sum(0)

    return slab_margins


def make_slab_densifier(mesh, n_loc: int):
    """One-shot densify ``(row_idx, values) -> X`` (n_loc, p) of one
    example shard's (p, 1, K) slabs: the dense fallback's setup for slabs
    above the sparse-win density (``kernels.prefer_slab_gram``). The
    scatter runs once per solve; the solve then rides the dense
    subproblem."""
    from repro_torch.kernels.ref import _densify_slab

    def densify(row_idx, values):
        return _densify_slab(row_idx[:, 0], values[:, 0], n_loc)

    return densify


@dataclass
class DistributedFitResult:
    """Mirror of ``FitResult`` for mesh solves, plus the final margin
    cache ``m`` (the rank's example shard; ``beta`` is whole)."""

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


def fit_distributed(X, y, lam: float, mesh, *, beta0: Optional[torch.Tensor] = None,
                    opts: DGLMNETOptions = DGLMNETOptions(),
                    verbose: bool = False) -> DistributedFitResult:
    """The dense solve on ``mesh`` (X (n, p), y (n,) global on every
    rank; each keeps its shard). Delegates to the front door
    ``LogisticL1(opts, mesh=mesh)`` over ``ShardedDesign(DenseDesign(X),
    mesh)``."""
    from repro_torch.api import DenseDesign, LogisticL1, ShardedDesign

    design = ShardedDesign(DenseDesign(X), mesh, tile=opts.tile)
    return LogisticL1(opts=opts, mesh=mesh, device=mesh.device).fit(
        design, y, lam, beta0=beta0, verbose=verbose)


def fit_distributed_sparse(row_idx, values, y, lam: float, mesh, *,
                           beta0: Optional[torch.Tensor] = None,
                           opts: DGLMNETOptions = DGLMNETOptions(),
                           verbose: bool = False,
                           densify: Optional[bool] = None) -> DistributedFitResult:
    """The by-feature solve over global (p, DP, K) slabs on ``mesh``
    (DP its data extent; each rank keeps its shard). Delegates to the front door ``LogisticL1(opts, mesh=mesh)`` over
    ``ShardedDesign(SlabDesign(...), mesh)``; ``densify`` overrides the
    ``prefer_slab_gram`` heuristic."""
    from repro_torch.api import LogisticL1, ShardedDesign, SlabDesign

    design = ShardedDesign(SlabDesign(row_idx, values, int(y.shape[0])), mesh,
                           tile=opts.tile)
    return LogisticL1(opts=opts, mesh=mesh, device=mesh.device).fit(
        design, y, lam, beta0=beta0, verbose=verbose, densify=densify)
