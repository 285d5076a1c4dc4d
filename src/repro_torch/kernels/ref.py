# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Plain PyTorch versions of every kernel of the port, the counterpart of
``repro/kernels/ref.py``. The CPU path runs them, and the card's kernels
are held against them.

The slab functions take leading batch axes (the M feature blocks):

* :func:`_densify_slab`, :func:`slab_gram_ref`, :func:`slab_spmv_ref` --
  the densify-based oracles; they define the semantics the sparse
  kernels must match: duplicate rows within a feature sum, and sentinel
  slots (row >= n_loc) contribute exactly 0;
* :func:`slab_gram_join`, :func:`slab_spmv_scatter` -- the match-join
  and scatter forms of ``repro/kernels/ops.py`` ``slab_gram`` /
  ``slab_spmv`` off the TPU: what a CPU tensor runs.

:func:`flash_attention_ref` is plain softmax attention, the oracle of the
attention kernel and what a CPU tensor runs.
"""
from __future__ import annotations

import torch

from repro_torch.core.objective import P_EPS, W_MIN, softplus
from repro_torch.core.subproblem import (DOM_TOL, NU, cd_cycle_blocked_tile,
                                         cd_cycle_gram_tile)


def logistic_stats_ref(m, y):
    """(w, z, nll) from margins: the fused working-statistics pass."""
    m = m.to(torch.float32)
    y = y.to(torch.float32)
    p = torch.sigmoid(m).clamp(P_EPS, 1.0 - P_EPS)
    w = torch.clamp_min(p * (1.0 - p), W_MIN)
    z = ((y + 1.0) * 0.5 - p) / w
    nll = softplus(-y * m).sum()
    return w, z, nll


def gram_cd_ref(G, c, beta, dbeta0, lam, nu=NU):
    """Plain version of kernels.gram_cd: the sequential chain, reading
    row j of G (batched over leading axes)."""
    f32 = torch.float32
    return cd_cycle_gram_tile(G.to(f32), c.to(f32), beta.to(f32),
                              dbeta0.to(f32), lam, nu)


def blocked_cd_ref(G, c, beta, dbeta0, lam, nu=NU, *, block=16, dom_tol=DOM_TOL):
    """Plain version of kernels.blocked_cd: the blocked cycle (bit-identical
    to the sequential chain at block=1), its safeguard at ``dom_tol``."""
    f32 = torch.float32
    return cd_cycle_blocked_tile(G.to(f32), c.to(f32), beta.to(f32),
                                 dbeta0.to(f32), lam, nu, block=block, dom_tol=dom_tol)


def _densify_slab(rows, vals, n_loc: int):
    """Slab (..., T, K) -> dense (..., n_loc, T) via scatter. Sentinel
    slots (row >= n_loc) land in a swallow row that is dropped; duplicate
    rows within a feature sum."""
    *lead, t, k = rows.shape
    b = 1
    for s in lead:
        b *= s
    safe = rows.reshape(b, t, k).clamp_max(n_loc).long()
    va = torch.where(rows < n_loc, vals, 0.0).to(torch.float32).reshape(b, t, k)
    out = torch.zeros(b, n_loc + 1, t, dtype=torch.float32, device=rows.device)
    bi = torch.arange(b, device=rows.device)[:, None, None].expand(b, t, k)
    ci = torch.arange(t, device=rows.device)[None, :, None].expand(b, t, k)
    out.index_put_((bi.reshape(-1), safe.reshape(-1), ci.reshape(-1)),
                   va.reshape(-1), accumulate=True)
    return out[:, :n_loc].reshape(*lead, n_loc, t)


def slab_gram_ref(rows, vals, w, r):
    """Oracle for kernels.slab_gram: densify, then the dense weighted Gram
    G = X_F^T diag(w) X_F and correlation c = X_F^T (w r)."""
    xf = _densify_slab(rows, vals, w.shape[0])
    wxf = w.to(torch.float32)[:, None] * xf
    G = xf.transpose(-1, -2) @ wxf
    c = (wxf.transpose(-1, -2) @ r.to(torch.float32)[..., None])[..., 0]
    return G, c


def slab_spmv_ref(rows, vals, d, n_loc: int):
    """Oracle for kernels.slab_spmv: densify, then X_F @ d."""
    xf = _densify_slab(rows, vals, n_loc)
    return (xf @ d.to(torch.float32)[..., None])[..., 0]


def slab_gram_join(safe, wv, va, cva):
    """The match join that computes (G, c) off the card, from operands
    gathered and sentinel-zeroed by ``ops._sentinel_zeroed``:
    G[a, b] = sum over slot pairs (ka, kb) with equal rows of
    wv[a, ka] * va[b, kb], and c = sum_k cva. One (TK, TK) match when
    T*K <= 2048, else one (TK, T) match per right-hand slot column."""
    *lead, t, k = safe.shape
    rf = safe.reshape(*lead, t * k)
    wvf = wv.reshape(*lead, t * k)
    if t * k <= 2048:
        match = (rf[..., :, None] == rf[..., None, :]).to(torch.float32)
        G = (wvf[..., :, None] * match * va.reshape(*lead, 1, t * k)
             ).reshape(*lead, t, k, t, k).sum(dim=(-3, -1))
    else:
        G = wv.new_zeros(*lead, t, t)
        for kp in range(k):
            mk = (rf[..., :, None] == safe[..., None, :, kp]).to(torch.float32)
            contrib = (wvf[..., :, None] * mk).reshape(*lead, t, k, t).sum(-2)
            G = G + contrib * va[..., None, :, kp]
    return G, cva.sum(-1)


def slab_spmv_scatter(safe, dv, n_loc: int):
    """X_F @ d off the card: a scatter-add of dv = values * d[feature]
    (sentinel-zeroed) over the slot rows ``safe`` (clamped to n_loc, the
    dropped swallow row). Batched over leading axes -> (..., n_loc)."""
    *lead, t, k = safe.shape
    b = 1
    for s in lead:
        b *= s
    out = torch.zeros(b, n_loc + 1, dtype=torch.float32, device=safe.device)
    out.scatter_add_(1, safe.reshape(b, t * k).long(),
                     dv.reshape(b, t * k).to(torch.float32))
    return out[:, :n_loc].reshape(*lead, n_loc)


def slab_path_spmv_scatter(rows, vals, lam_idx, betas, n_loc: int):
    """Plain version of ``ops.slab_path_spmv``: gather each live slot's
    coefficient ``betas[lam_idx[row], ..., feature]`` (rows clamped, so a
    sentinel reads row 0's index and is then masked), zero the sentinels,
    and scatter as :func:`slab_spmv_scatter` does. At a uniform lam_idx
    the products and the scatter order are those of the plain
    ``slab_spmv``, so the two agree bit for bit."""
    valid = rows < n_loc
    li = lam_idx.long()[torch.where(valid, rows, 0).long()]            # (..., T, K)
    *lead, t, k = rows.shape
    coef = betas.to(torch.float32).reshape(betas.shape[0], -1, t)      # (L, B, T)
    b = torch.arange(coef.shape[1], device=rows.device).reshape(*lead, 1, 1) if lead \
        else torch.zeros((), dtype=torch.long, device=rows.device)
    feat = torch.arange(t, device=rows.device)[:, None]
    bsel = coef[li, b, feat]
    dv = torch.where(valid, vals, 0.0).to(torch.float32) * bsel
    return slab_spmv_scatter(rows.clamp_max(n_loc), dv, n_loc)


def flash_attention_ref(q, k, v, *, causal=True):
    """Plain softmax attention, the plain version of kernels.flash_attention:
    q (B, S, H, D), k/v (B, S, Hk, D) with H a multiple of Hk (query head
    h reads KV head h // (H / Hk)); float32 scores, -1e30 causal mask,
    output in q's type."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if g != 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.to(torch.float32)).to(q.dtype)
