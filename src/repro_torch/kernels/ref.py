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


def _pair_fold(v):
    """Sum the last axis (a power of two) as a balanced tree of adjacent
    pairs: ((v0 + v1) + (v2 + v3)) + ..."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v[..., 0]


def _tg_order(a, threads: int, per: int):
    """The last axis (p) of ``a`` padded with zeros to threads * per and put
    in ``csrc/tg_pass.cu``'s sum order: position t * per + 4 g + c holds
    coordinate j = 4 (g threads + t) + c."""
    p = a.shape[-1]
    a = torch.nn.functional.pad(a, (0, threads * per - p))
    lead = a.shape[:-1]
    return a.view(*lead, per // 4, threads, 4).transpose(-3, -2).reshape(*lead, threads * per)


def tg_margin(x, b):
    """Plain version of ``csrc/tg_pass.cu``'s margin, in its sum order:
    with (threads, per) = ``tg_pass.launch_shape(p)``, thread t owns the
    coordinates j = 4 (g threads + t) + c (g < per / 4, c < 4); the margin
    is one balanced tree of adjacent pairs over the threads * per products
    (zeros past p) in the order t * per + 4 g + c. ``x``, ``b`` (M, p)
    float32 -> (M,)."""
    from repro_torch.kernels.tg_pass import launch_shape

    shape = launch_shape(max(x.shape[-1], 1))
    return _pair_fold(_tg_order(x * b, *shape))


#: ``csrc/tg_pass.cu``'s sigmoid constants, exact float32 values: log2(e),
#: ln 2 in two parts, the clamp of -|m|, the least |m| whose exp(-|m|)
#: rounds to 0, and the degree-6 polynomial for exp on [-ln2/2, ln2/2]
TG_L2E, TG_LN2_HI, TG_LN2_LO = 1.4426950216293335, 0.693145751953125, 1.428606765330187e-06
TG_X_CLAMP, TG_M_ZERO = -103.5, 103.97208404541016
TG_POLY = (1.0, 1.0, 0.49999991059303284, 0.16666419804096222, 0.04166822507977486,
           0.008374832570552826, 0.001383682363666594)


def tg_sigmoid(m):
    """Plain version of ``csrc/tg_pass.cu``'s sigmoid, op for op in float32:
    e = exp(-|m|) by k = rint(x log2 e) (x = max(-|m|, -103.5)), r = (x - k
    ln2_hi) - k ln2_lo, a degree-6 polynomial in Estrin's order and one
    rounding of the product with 2^k (subnormals included); then 1 / (1 +
    e) for m >= 0 and e / (1 + e) below (0 past 150 ln 2). Every step is a
    correctly rounded IEEE operation, so the card and the host give the
    same bits; within 3 ulps of float64."""
    c0, c1, c2, c3, c4, c5, c6 = TG_POLY
    x = torch.clamp(-m.abs(), min=TG_X_CLAMP)
    k = torch.round(x * TG_L2E)
    r = (x - k * TG_LN2_HI) - k * TG_LN2_LO
    r2 = r * r
    r4 = r2 * r2
    q = ((c0 + c1 * r) + (c2 + c3 * r) * r2) + ((c4 + c5 * r) + c6 * r2) * r4
    ki = k.to(torch.int32)
    # the branch where() drops may shift out of range; its bits are unused
    s = torch.where(ki >= -126, (ki + 127) << 23, torch.ones_like(ki) << (ki + 149))
    e = q * s.view(torch.float32)
    num = torch.where(m >= 0, 1.0, torch.where(m <= -TG_M_ZERO, 0.0, e))
    return num / (1.0 + e)


def tg_pass_ref(Xs, ys, beta, eta: float, shrink: float, theta: float):
    """Plain version of kernels.tg_pass: one truncated-gradient pass per
    machine from the shared warm start ``beta`` (p,) over Xs (M, steps, p)
    and ys (M, steps); returns (M, p). Per example, as the reference's
    ``_tg_pass`` writes it: g = sigmoid(x.beta) - (y+1)/2, beta -= (eta g)
    x, then where(|beta| <= theta, copysign(max(|beta| - shrink, 0),
    beta), beta) with shrink = eta * gravity. The margin is
    :func:`tg_margin`'s fixed order (X and beta are kept in that order for
    the whole pass) and the sigmoid :func:`tg_sigmoid`'s float32 sequence,
    as the kernel takes them, so the two agree though the pass is chaotic."""
    from repro_torch.kernels.tg_pass import launch_shape

    M, steps, p = Xs.shape
    threads, per = launch_shape(max(p, 1))
    Xo = _tg_order(Xs.to(torch.float32), threads, per)
    b = _tg_order(beta.to(torch.float32).expand(M, p), threads, per)
    yh = (ys.to(torch.float32) + 1.0) * 0.5
    for i in range(steps):
        x = Xo[:, i]
        c = eta * (tg_sigmoid(_pair_fold(x * b)) - yh[:, i])
        bb = b - c[:, None] * x
        trunc = torch.copysign((bb.abs() - shrink).clamp_min(0.0), bb)
        # with theta = +inf the where keeps trunc everywhere (NaN included)
        b = trunc if theta == float("inf") else torch.where(bb.abs() <= theta, trunc, bb)
    b = b.view(M, threads, per // 4, 4).transpose(1, 2).reshape(M, threads * per)
    return b[:, :p].contiguous()
