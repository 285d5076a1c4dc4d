# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Kernel dispatch, the counterpart of ``repro/kernels/ops.py``.

Every solver-facing kernel call goes through here, and the tensor's
device picks the implementation:

* a CUDA tensor launches the hand-written kernel (and raises if the
  kernel cannot build or launch -- there is no fallback);
* a CPU tensor runs the plain PyTorch version in ``kernels.ref``;
* any other device raises.

Each kernel module counts its own launches (``<module>.launches``);
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes
them.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.subproblem import DOM_TOL, NU
from repro_torch.kernels import blocked_cd as _blocked_cd
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import gram_cd as _gram_cd
from repro_torch.kernels import logistic_stats as _logistic_stats
from repro_torch.kernels import ref
from repro_torch.kernels import slab_gram as _slab_gram
from repro_torch.kernels import slab_spmv as _slab_spmv
from repro_torch.kernels import tg_pass as _tg_pass
from repro_torch.kernels.slab_spmv import SlabOrder, slab_order

_KERNELS = {
    "logistic_stats": _logistic_stats,
    "gram_cd": _gram_cd,
    "blocked_cd": _blocked_cd,
    "slab_gram": _slab_gram,
    "slab_spmv": _slab_spmv,
    "flash_attention": _flash_attention,
    "tg_pass": _tg_pass,
}


def launch_counts() -> Dict[str, int]:
    """Launches per kernel of the solver, baseline and LM paths since the
    last reset; ``slab_path_spmv`` is ``slab_spmv``'s serving mode, counted
    apart."""
    counts = {name: mod.launches for name, mod in _KERNELS.items()}
    counts["slab_path_spmv"] = _slab_spmv.path_launches
    return counts


def reset_launch_counts() -> None:
    """Zero every kernel's count."""
    for mod in _KERNELS.values():
        mod.launches = 0
    _slab_spmv.path_launches = 0


def _on_cuda(*tensors) -> bool:
    """True for CUDA operands, False for CPU ones; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on mixed devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type == "cuda"


def _check_block(name: str, value) -> None:
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(f"{name} must be a positive int, got {value!r}")


def logistic_stats(m, y, *, block: int = 4096):
    """Fused (w, z, nll) from margins -- one pass over the examples axis;
    the dispatch point the outer iteration uses (core/engine.py).

    ``block`` is the reference's TPU block over the examples axis: it is
    accepted and checked (a positive int) so that a call written for the
    reference runs here, but it does not steer the CUDA kernel, which
    picks its own grid; the result is the same for every ``block``."""
    _check_block("block", block)
    if _on_cuda(m, y):
        return _logistic_stats.logistic_stats_kernel(m, y)
    return ref.logistic_stats_ref(m, y)


def gram_cd(G, c, beta, dbeta0, lam, nu=NU):
    """One sequential CD cycle on Gram tiles (M, F, F); returns d (M, F).
    The (M, F) operands may be row-strided views (the solve's
    ``beta[:, sl]`` slices): the kernel reads them in place."""
    if _on_cuda(G, c, beta, dbeta0):
        return _gram_cd.gram_cd_kernel(G, c, beta, dbeta0, lam, nu)
    return ref.gram_cd_ref(G, c, beta, dbeta0, lam, nu)


def prefer_blocked_cd(f: int, block: int) -> bool:
    """Tile-size heuristic for `cycle_mode="auto"`: the blocked cycle wins
    when it meaningfully shortens the dependent-step chain — at least two
    blocks per tile and a tile wide enough (F >= 32) that the F-step
    scalar chain, not the Gram matmul, dominates the tile (CPU-measured;
    the `--cycle` bench section tracks the crossover). Below that, or at
    block=1 (== the sequential chain), dispatch stays on ``gram_cd``."""
    return block > 1 and f >= 2 * block and f >= 32


def blocked_cd(G, c, beta, dbeta0, lam, nu=NU, *, block: int = 16, dom_tol=None):
    """Blocked semi-parallel CD cycle on Gram tiles (F/B dependent steps
    instead of F); same contract as :func:`gram_cd`. ``dom_tol`` is the
    safeguard's Gershgorin threshold (None: ``DOM_TOL``). On the card one
    launch computes the per-block modes and the cycle."""
    tol = DOM_TOL if dom_tol is None else dom_tol
    if _on_cuda(G, c, beta, dbeta0):
        return _blocked_cd.blocked_cd_kernel(G, c, beta, dbeta0, lam, nu, block=block,
                                             dom_tol=tol)
    return ref.blocked_cd_ref(G, c, beta, dbeta0, lam, nu, block=block, dom_tol=tol)


# ---------------------------------------------------------------------------
# sparse slab suite (slabs (..., T, K): local example rows, sentinel n_loc)
# ---------------------------------------------------------------------------

def prefer_slab_gram(n_loc: int, k: int) -> bool:
    """nnz-density heuristic: sparse-native Gram when the match join
    (O(T^2 K^2) VPU ops) beats the dense path (O(nnz) scatter +
    O(n_loc T^2) MXU FLOPs). The measured crossover sits near
    K ~ sqrt(n_loc/8) with margin to spare — the paper's truly sparse
    regime (webspam K is single digits) clears it at any realistic
    n_loc, while moderate-density slabs fall back to densify-once."""
    return 8 * k * k <= n_loc


def _sentinel_zeroed(rows, vals, w, r, n_loc: int):
    """Gathered operands with sentinel slots contributing exactly zero.

    Gathers clamp the slab's row indices into range and then mask the
    result on the original validity predicate, so padding slots (and any
    values parked on them) never pick up a real example's weight -- in
    particular not the last row's, which a plain clamped gather would.
    ``rows``/``vals`` (..., T, K), ``w`` (n_loc,), ``r`` (..., n_loc).
    Returns (rows clamped to n_loc, va, wv, cva)."""
    valid = rows < n_loc
    idx = torch.where(valid, rows, 0).long()
    va = torch.where(valid, vals, 0.0).to(torch.float32)
    wv = torch.where(valid, w.to(torch.float32)[idx], 0.0) * va
    wr = (w * r).to(torch.float32)
    wr_g = torch.gather(wr, -1, idx.flatten(-2)).view_as(idx)
    cva = va * torch.where(valid, wr_g, 0.0)
    return rows.clamp_max(n_loc), va, wv, cva


def slab_gram(rows, vals, w, r, *, rows_sorted: bool = False, order: SlabOrder = None):
    """Weighted Gram tile and correlation straight from a feature slab.

    rows/vals (..., T, K), local example rows with sentinel n_loc
    (= ``w.shape[0]``); r (..., n_loc). Returns ``(G (..., T, T),
    c (..., T))`` with G = X_F^T diag(w) X_F and c = X_F^T (w r), with no
    (n_loc, T) densify. On the card one launch gathers and joins;
    ``rows_sorted`` promises each feature's slots in row order and
    ``order`` is the tile's :func:`slab_order` (the kernel needs both and
    otherwise builds them). Off the card the gathers feed the match join."""
    n_loc = w.shape[0]
    if _on_cuda(rows, vals, w, r):
        return _slab_gram.slab_gram_kernel(rows, vals, w, r, rows_sorted=rows_sorted,
                                           order=order)
    safe, va, wv, cva = _sentinel_zeroed(rows, vals, w, r, n_loc)
    return ref.slab_gram_join(safe, wv, va, cva)


def _spmv_cpu(rows, vals, d, n_loc: int):
    dv = torch.where(rows < n_loc, vals, 0.0).to(torch.float32) * d[..., None]
    return ref.slab_spmv_scatter(rows.clamp_max(n_loc), dv, n_loc)


def slab_spmv(rows, vals, d, *, n_loc: int, order: SlabOrder = None):
    """``X_F @ d`` from a feature slab (..., T, K) and d (..., T): the
    (..., n_loc) per-example product, O(nnz). ``order`` is the slab's
    row-sorted order with its values (:func:`slab_order`), which the
    card's kernel needs and otherwise builds here, once per call."""
    if _on_cuda(rows, vals, d):
        out = torch.zeros(*rows.shape[:-2], n_loc, dtype=torch.float32,
                          device=rows.device)
        return _slab_spmv.slab_spmv_kernel(
            slab_order(rows, vals) if order is None else order, vals, d, out,
            n_loc=n_loc, sign=1.0)
    return _spmv_cpu(rows, vals, d, n_loc)


def slab_residual_update(r, rows, vals, d, *, order: SlabOrder = None, dbeta=None):
    """``r -= X_F @ d`` in place for the residuals r (..., n_loc) of every
    feature block at once; given ``dbeta`` (..., T), also ``dbeta += d``
    in place (the solve's per-tile coefficient update). On the card both
    are one launch; returns r."""
    n_loc = r.shape[-1]
    if _on_cuda(r, rows, vals, d):
        return _slab_spmv.slab_spmv_kernel(
            slab_order(rows, vals) if order is None else order, vals, d, r,
            n_loc=n_loc, sign=-1.0, dbeta=dbeta)
    r.sub_(_spmv_cpu(rows, vals, d, n_loc))
    if dbeta is not None:
        dbeta += d
    return r


def slab_path_spmv(rows, vals, lam_idx, betas, *, n_loc: int, order: SlabOrder = None):
    """Per-example-lambda slab product, the serving layer's scoring
    primitive: rows/vals (..., T, K) with local example (request) rows,
    sentinel ``n_loc``; ``lam_idx`` (n_loc,) int32 picks each row's point
    of the stacked path ``betas`` (L, ..., T). Returns (..., n_loc) with
    ``out[..., i] = sum_jk vals[..., j, k] betas[lam_idx[i], ..., j]
    [rows[..., j, k] == i]``. At a uniform ``lam_idx == l`` it is
    bit-equal to ``slab_spmv(rows, vals, betas[l])``, on the card and off
    it. On the card one launch of ``slab_spmv``'s path mode; ``order`` as
    for :func:`slab_spmv`."""
    if _on_cuda(rows, vals, lam_idx, betas):
        out = torch.zeros(*rows.shape[:-2], n_loc, dtype=torch.float32,
                          device=rows.device)
        return _slab_spmv.slab_path_spmv_kernel(
            slab_order(rows, vals) if order is None else order, vals, lam_idx, betas, out,
            n_loc=n_loc)
    return ref.slab_path_spmv_scatter(rows, vals, lam_idx, betas, n_loc)


def slab_corr(rows, vals, v):
    """Per-feature correlation ``X_F^T v`` from a slab (..., K) -> (...,):
    the gather-reduce behind lambda_max and the screen (sentinel slots
    masked to exact zero). A torch op: the reference leaves it to XLA."""
    n = v.shape[0]
    valid = rows < n
    va = torch.where(valid, vals, 0.0).to(torch.float32)
    vg = torch.where(valid, v.to(torch.float32)[torch.where(valid, rows, 0).long()], 0.0)
    return (va * vg).sum(-1)


# ---------------------------------------------------------------------------
# attention (the LM zoo)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Blocked online-softmax attention (forward): q (B, S, H, D), k/v
    (B, S, Hk, D) with H a multiple of Hk -> (B, S, H, D) in q's type.

    ``block_q`` / ``block_k`` are the reference's TPU tile sizes: accepted
    and checked (positive ints), but the Hopper kernel picks its own tiles
    (``csrc/flash_attention.cu``), so they do not change the result."""
    _check_block("block_q", block_q)
    _check_block("block_k", block_k)
    if _on_cuda(q, k, v):
        return _flash_attention.flash_attention_kernel(q, k, v, causal=causal)
    return ref.flash_attention_ref(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# the truncated-gradient baseline (paper section 4.3)
# ---------------------------------------------------------------------------

def tg_pass(Xs, ys, beta, eta: float, shrink: float, theta: float):
    """One truncated-gradient pass per machine: Xs (M, steps, p), ys (M,
    steps), the shared warm start beta (p,) -> each machine's beta (M, p).
    ``shrink`` is eta * gravity rounded to float32. On the card one launch
    for all M machines (p up to ``tg_pass.MAX_P``, else a
    ``TGWidthError``)."""
    if _on_cuda(Xs, ys, beta):
        return _tg_pass.tg_pass_kernel(Xs, ys, beta, eta, shrink, theta)
    return ref.tg_pass_ref(Xs, ys, beta, eta, shrink, theta)
