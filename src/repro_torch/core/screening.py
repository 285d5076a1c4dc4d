# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Feature screening for the regularization path, the counterpart of
``repro/core/screening.py``.

Sequential strong rule (Tibshirani et al., JRSS-B 2012, section 5) in the
paper's conventions (y in {-1, +1}, margins-cached gradient):

    keep j  iff  |g_j(beta_hat(lam_prev))| >= 2*lam - lam_prev

with g = X^T (sigmoid(m) - (y+1)/2) the NLL gradient at the warm start.
The rule is a heuristic, so every screened solve is followed by a KKT
check over the discarded set; violators re-enter and the solve repeats.

Every predicate runs on the tensors' device and reads nothing back: the
path driver (``api.estimator``) reads the counts it needs through
``engine.host_read``, and :func:`budgeted_admission` makes its one read
there too. In particular :func:`pack_indices` is a stable argsort, not
``torch.nonzero`` (which synchronises). The thresholds are computed in
float32 on the host, as the reference's jitted functions compute them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.objective import grad_nll_from_margins

#: features per slab-correlation chunk: bounds the pass's temporaries
#: (about 20 bytes per slot) independently of p
CORR_CHUNK = 1 << 16


def _nll_residual(m, y):
    """v = sigmoid(m) - (y+1)/2, the per-example NLL gradient factor."""
    return torch.sigmoid(m) - (y + 1.0) * 0.5


def nll_grad_abs(X, y, m) -> torch.Tensor:
    """|g_j| = |x_j^T (sigmoid(m) - (y+1)/2)| for all p features."""
    return grad_nll_from_margins(m, y, X).abs()


def nll_grad_abs_sparse(row_idx, values, y, m) -> torch.Tensor:
    """|g_j| over a by-feature layout (p, K), sentinel row n: the slab
    correlation ``X^T v`` (``kernels.ops.slab_corr``) at the NLL
    residual, with no dense X."""
    from repro_torch.kernels.ops import slab_corr

    return slab_corr(row_idx, values, _nll_residual(m, y)).abs()


def strong_rule_mask(g_abs, lam, lam_prev, beta) -> torch.Tensor:
    """Sequential-strong-rule working set at ``lam`` from the gradient
    magnitudes ``g_abs`` and coefficients ``beta`` at ``lam_prev``.
    Ever-active features are always kept. The admission threshold is
    ``max(2*lam - lam_prev, lam)`` (on the halving grid the strong rule
    alone admits everything); the KKT check makes either half safe."""
    lam32 = np.float32(lam)
    lam_prev32 = max(np.float32(lam_prev), lam32)
    thresh = max(np.float32(2.0) * lam32 - lam_prev32, lam32)
    return torch.logical_or(g_abs >= float(thresh), beta != 0.0)


def kkt_violations(g_abs, lam, mask, *, tol: float = 1e-3) -> torch.Tensor:
    """KKT check on the discarded set: features outside ``mask`` with
    |g_j| > lam (1 + tol) were wrongly screened out. Returns the boolean
    violation mask (all False: the screen is certified)."""
    # the reference's jitted form contracts lam * (1 + tol) + 1e-7 into one
    # fused multiply-add (one rounding); the product of two float32 values
    # and the float32 addend sum exactly in float64, so one cast rounds once
    slack = np.float32(np.float64(np.float32(lam)) * np.float64(np.float32(1.0) + np.float32(tol))
                       + np.float64(np.float32(1e-7)))
    return torch.logical_and(torch.logical_not(mask), g_abs > float(slack))


def budgeted_admission(viol, g_abs, budget: int):
    """Keep only the ``budget`` most violating features (largest
    ``g_abs``) of ``viol``; the rest wait for a later round. Ties at the
    cutoff are all admitted. Reads the violation count once (through
    ``engine.host_read``). Returns the admitted mask."""
    n_viol = int(engine.host_read(viol.sum()))
    if n_viol <= budget:
        return viol
    scores = torch.where(viol, g_abs, -torch.inf)
    cutoff = torch.topk(scores, budget).values[-1]
    return torch.logical_and(viol, scores >= cutoff)


def capacity_bucket(count: int, p: int, *, tile: int) -> int:
    """Round an active-set size up to a power-of-two multiple of ``tile``
    (min ``tile``, max ``p``): O(log(p / tile)) restricted shapes per
    path."""
    cap = max(tile, 1)
    while cap < count:
        cap *= 2
    return min(cap, p)


def pack_indices(mask, cap: int) -> torch.Tensor:
    """Stable front-pack of the selected indices into shape ``(cap,)``,
    sentinel ``p`` (the mask's size) marking padding: a stable argsort of
    ``where(mask, arange(p), p)``, with no host read."""
    p = mask.shape[0]
    ar = torch.arange(p, device=mask.device)
    order = torch.argsort(torch.where(mask, ar, p), stable=True)
    return torch.where(ar < mask.sum(), order, p)[:cap]


def take_fill(x, idx, fill, dim: int = 0):
    """``x`` indexed by ``idx`` along ``dim``, indices at or past the end
    reading ``fill`` (the reference's ``jnp.take(..., mode="fill")``)."""
    size = x.shape[dim]
    got = x.index_select(dim, idx.clamp_max(max(size - 1, 0)))
    shape = [1] * x.dim()
    shape[dim] = idx.shape[0]
    return torch.where((idx < size).view(shape), got, fill)


def scatter_set(values, idx, size: int):
    """A (size,) tensor of zeros with ``values`` set at ``idx``, entries at
    indices at or past ``size`` dropped (the reference's
    ``.at[idx].set(..., mode="drop")``): a set into one spare slot, never
    an add."""
    out = values.new_zeros(size + 1)
    out.index_copy_(0, idx.clamp_max(size), values)
    return out[:size]


def gather_columns(X, beta, mask, cap: int):
    """The working set as a (n, cap) problem: (X_sub, beta_sub, idx),
    ``idx`` (cap,) with sentinel p at the padding, whose columns are zero
    (their coordinates stay at zero: the restricted solve is the masked
    full solve)."""
    idx = pack_indices(mask, cap)
    return take_fill(X, idx, 0.0, dim=1), take_fill(beta, idx, 0.0), idx


def scatter_columns(beta_sub, idx, p: int):
    """Inverse of :func:`gather_columns`: restricted solution -> (p,)."""
    return scatter_set(beta_sub, idx, p)


def make_sparse_corr(mesh, n_loc: int, tile: int) -> Callable:
    """``corr(row_idx, values, v) -> X^T v`` (signed) over one example
    shard's (p, 1, K) slabs (local rows, sentinel ``n_loc``; ``v`` the
    shard's (n_loc,)), summed over the mesh's example shards (one
    all_reduce over ``data``, as the reference's ``psum``), so the (p,)
    result is whole on every rank of the model rank's ``data`` line. On a
    design split over ``model`` the slabs are the rank's piece, and the
    design collects the pieces' entries over ``model``
    (``api.design.ShardedDesign.correlation``, ``sharding.collect``); the
    screen and the KKT pass do the same. The reference runs it per tile under
    ``shard_map`` to bound memory; here the feature axis goes in chunks of
    :data:`CORR_CHUNK` (each feature's sum over K does not depend on the
    chunking). ``tile`` is checked as the reference checks it: the padded
    feature count must be a multiple of it."""

    def corr(row_idx, values, v):
        from repro_torch.kernels.ops import slab_corr

        p = row_idx.shape[0]
        if p % tile:
            raise ValueError(f"feature count {p} must be a multiple of tile={tile} "
                             f"(pad the slabs upstream)")
        rows, vals = row_idx[:, 0], values[:, 0]
        g = torch.cat([slab_corr(rows[s:s + CORR_CHUNK], vals[s:s + CORR_CHUNK], v)
                       for s in range(0, p, CORR_CHUNK)])
        return mesh.all_reduce(g, mesh.example_axes)

    return corr


def make_sparse_screen(mesh, n_loc: int, tile: int) -> Callable:
    """``screen(row_idx, values, y, m) -> |X^T v(m, y)|``: the
    :func:`make_sparse_corr` pass at the NLL residual, the strong rule's
    and the KKT check's gradient."""
    corr = make_sparse_corr(mesh, n_loc, tile)

    def screen(row_idx, values, y, m):
        return corr(row_idx, values, _nll_residual(m, y)).abs()

    return screen
