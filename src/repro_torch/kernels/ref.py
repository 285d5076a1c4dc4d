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


def _tree_fold(v):
    """Sum the last axis (a power of two) as the kernels' shuffle tree
    does: lane l adds lane l + off for off = width/2 ... 1."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def tg_margin(x, b):
    """Plain version of ``csrc/tg_pass.cu``'s margin, in its sum order:
    coordinate j = k * THREADS + t is thread t's k-th product; each thread
    sums its products in k order, each warp of 32 threads by the shuffle
    tree, and the warps' sums by the same tree padded to 32 lanes (exact
    zeros). ``x``, ``b`` (M, p) float32 -> (M,)."""
    from repro_torch.kernels.tg_pass import THREADS

    M, p = x.shape
    per = max(1, -(-p // THREADS))
    prod = torch.nn.functional.pad(x * b, (0, per * THREADS - p)).view(M, per, THREADS)
    v = prod[:, 0]
    for k in range(1, per):
        v = v + prod[:, k]
    warps = _tree_fold(v.view(M, THREADS // 32, 32))
    return _tree_fold(torch.nn.functional.pad(warps, (0, 32 - warps.shape[-1])))


def tg_pass_ref(Xs, ys, beta, eta: float, shrink: float, theta: float):
    """Plain version of kernels.tg_pass: one truncated-gradient pass per
    machine from the shared warm start ``beta`` (p,) over Xs (M, steps, p)
    and ys (M, steps); returns (M, p). Per example, as the reference's
    ``_tg_pass`` writes it: g = sigmoid(x.beta) - (y+1)/2, beta -= eta (g
    x), then where(|beta| <= theta, sign(beta) max(|beta| - shrink, 0),
    beta) with shrink = eta * gravity. The margin is :func:`tg_margin`'s
    fixed order and the sigmoid's exp is taken in double, as the kernel
    takes them, so the two agree though the pass is chaotic."""
    Xs = Xs.to(torch.float32)
    ys = ys.to(torch.float32)
    M, steps, p = Xs.shape
    b = beta.to(torch.float32).expand(M, p).clone()
    one = torch.ones((), dtype=torch.float32, device=Xs.device)
    for i in range(steps):
        x = Xs[:, i]
        e = torch.exp(-tg_margin(x, b).double()).to(torch.float32)
        g = one / (one + e) - (ys[:, i] + 1.0) * 0.5
        b = b - eta * (g[:, None] * x)
        a = b.abs()
        b = torch.where(a <= theta, torch.sign(b) * torch.clamp_min(a - shrink, 0.0), b)
    return b
