# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Quadratic subproblem solver (paper Algorithm 2), the counterpart of
``repro/core/subproblem.py``.

Minimize, over each machine's feature block S_m,

    1/2 sum_i w_i (z_i - dbeta^T x_i)^2 + lam * ||beta + dbeta||_1

with one cycle of cyclic coordinate descent; h_j += nu damps the
curvature (paper nu = 1e-6).

Where the reference ``vmap``s over the M feature blocks, every function
here takes an explicit leading batch axis (M, ...), and the reference's
``scan`` over tiles is a Python loop with one batched tile-solver call
per tile. X is laid out once per fit as a contiguous (M, nt, n, F) tensor
(:func:`layout_blocks`), so no iteration pads or copies it.

Tile cycles (oracles for the kernels in ``repro_torch.kernels``):

* :func:`cd_cycle_gram_tile` -- the sequential chain on an F x F Gram
  tile, keeping s = G^T d. It reads row j of G, as the kernels do (the
  reference's jnp oracle reads column j; G = Xf^T (w Xf) is symmetric up
  to rounding only).
* :func:`cd_cycle_blocked_tile` -- the blocked semi-parallel cycle with
  the per-block Gershgorin safeguard (:func:`blocked_cycle_modes`); with
  B=1 it is the sequential chain, bit for bit.

``cd_cycle_residual`` is the paper-literal residual form, kept as an
oracle (one block, unbatched).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import torch

from repro_torch.core.objective import soft_threshold

NU = 1e-6
# Within-block Gershgorin ratio limit for the full-B Jacobi step (see the
# reference): above it halve B, above it at B/2 go sequential.
DOM_TOL = 0.9


# ---------------------------------------------------------------------------
# paper-literal residual-update CD (one block)
# ---------------------------------------------------------------------------

def cd_cycle_residual(X, w, r, beta, dbeta, lam, nu: float = NU):
    """One cycle over all features of the block X (n, p_b).
    Returns (dbeta, r)."""
    h_all = (w[:, None] * X * X).sum(0) + nu
    dbeta = dbeta.clone()
    for j in range(X.shape[1]):
        xj = X[:, j]
        g = torch.dot(w * xj, r)
        h = h_all[j]
        b_old = beta[j] + dbeta[j]
        b_new = soft_threshold(g + b_old * h, lam) / h
        delta = b_new - b_old
        r = r - delta * xj
        dbeta[j] = dbeta[j] + delta
    return dbeta, r


# ---------------------------------------------------------------------------
# Gram-tile cycles, batched over leading axes
# ---------------------------------------------------------------------------

def cd_cycle_jacobi_tile(G, c, beta, dbeta0, lam, nu: float = NU):
    """Shotgun-style ablation: all coordinates updated in parallel from the
    same residual (Jacobi)."""
    diag = G.diagonal(dim1=-2, dim2=-1) + nu
    b_old = beta + dbeta0
    b_new = soft_threshold(c + b_old * diag, lam) / diag
    return b_new - b_old


def _seq_step(G, c, diag, base, d, s, j: int, lam):
    """One step of the sequential chain at coordinate j (all batch rows)."""
    g = c[..., j] - s[..., j]
    h = diag[..., j]
    b_old = base[..., j] + d[..., j]
    b_new = soft_threshold(g + b_old * h, lam) / h
    delta = b_new - b_old
    s = s + delta[..., None] * G[..., j, :]
    d = d.clone()
    d[..., j] = d[..., j] + delta
    return d, s


def cd_cycle_gram_tile(G, c, beta, dbeta0, lam, nu: float = NU):
    """Sequential CD cycle on Gram tiles G (..., F, F); c, beta, dbeta0
    (..., F). Returns the delta within this cycle d (dbeta becomes
    dbeta0 + d). Keeps s = G^T d so that g_j = c_j - s_j is the live
    gradient."""
    diag = G.diagonal(dim1=-2, dim2=-1) + nu
    base = beta + dbeta0
    d = torch.zeros_like(c)
    s = torch.zeros_like(c)
    for j in range(G.shape[-1]):
        d, s = _seq_step(G, c, diag, base, d, s, j, lam)
    return d


def _block_dominance(G, width: int, nu: float):
    """Per-block Gershgorin row ratio max_j sum_{k != j, same block}
    |G_jk| / (G_jj + nu), for each ``width``-wide diagonal block."""
    f = G.shape[-1]
    blk = torch.arange(f, device=G.device) // width
    same = (blk[:, None] == blk[None, :]).to(G.dtype)
    diag = G.diagonal(dim1=-2, dim2=-1)
    offsum = (G.abs() * same).sum(-1) - diag.abs()
    rho = offsum / (diag + nu)
    return rho.reshape(*G.shape[:-2], f // width, width).amax(-1)


def blocked_cycle_modes(G, block: int, nu: float = NU,
                        dom_tol: float = DOM_TOL) -> torch.Tensor:
    """Per-block safeguard decision (int32, (..., F/B)) from G alone:
    0 full-B Jacobi step, 1 two B/2 Jacobi steps, 2 the sequential chain."""
    f = G.shape[-1]
    nb = f // block
    lead = G.shape[:-2]
    if block <= 1:
        return torch.zeros(*lead, nb, dtype=torch.int32, device=G.device)
    rho_full = _block_dominance(G, block, nu)
    if block % 2:
        return torch.where(rho_full <= dom_tol, 0, 2).to(torch.int32)
    rho_half = _block_dominance(G, block // 2, nu).reshape(*lead, nb, 2).amax(-1)
    return torch.where(rho_full <= dom_tol, 0,
                       torch.where(rho_half <= dom_tol, 1, 2)).to(torch.int32)


def _jacobi_step(G, c, diag, base, d, s, start: int, width: int, lam):
    """One proximal-Jacobi step on coords [start, start + width)."""
    sl = slice(start, start + width)
    g = c[..., sl] - s[..., sl]
    h = diag[..., sl]
    d_blk = d[..., sl]
    b_old = base[..., sl] + d_blk
    b_new = soft_threshold(g + b_old * h, lam) / h
    delta = b_new - b_old
    s = s + (G[..., sl, :] * delta[..., :, None]).sum(-2)   # s += G[blk]^T delta
    d = d.clone()
    d[..., sl] = d_blk + delta
    return d, s


def cd_cycle_blocked_tile(G, c, beta, dbeta0, lam, nu: float = NU, *,
                          block: int = 16, dom_tol: float = DOM_TOL):
    """Blocked semi-parallel CD cycle on Gram tiles (..., F, F): B
    coordinates at a time update Jacobi-style from the shared snapshot
    g = c - s, then s += G[blk]^T d_blk before the next block -- F/B
    dependent steps instead of F. Modes come from
    :func:`blocked_cycle_modes`; each batch row takes its own mode per
    block (all three outcomes are formed and one is selected, so the
    result does not depend on the batch)."""
    f = G.shape[-1]
    if f % block:
        raise ValueError(f"block={block} must divide the tile width F={f}")
    diag = G.diagonal(dim1=-2, dim2=-1) + nu
    base = beta + dbeta0
    modes = blocked_cycle_modes(G, block, nu=nu, dom_tol=dom_tol)
    step = partial(_jacobi_step, G, c, diag, base, lam=lam)
    d = torch.zeros_like(c)
    s = torch.zeros_like(c)
    for b in range(f // block):
        start = b * block
        if block == 1:
            d, s = step(d, s, start, 1)
            continue
        half = block // 2
        d0, s0 = step(d, s, start, block)
        d1, s1 = step(*step(d, s, start, half), start + half, half)
        d2, s2 = d, s
        for j in range(start, start + block):
            d2, s2 = _seq_step(G, c, diag, base, d2, s2, j, lam)
        mode = modes[..., b, None]
        d = torch.where(mode == 0, d0, torch.where(mode == 1, d1, d2))
        s = torch.where(mode == 0, s0, torch.where(mode == 1, s1, s2))
    return d


def make_tile_solver(*, cycle_mode: str = "sequential", tile: int,
                     block: int = 16, dom_tol: float = DOM_TOL):
    """The per-tile cycle every solve shares: ``(G, c, beta, dbeta0, lam,
    nu) -> d``, batched. It goes through the kernel dispatch
    (``repro_torch.kernels.ops``), which launches the kernel for CUDA
    tensors and runs the plain version for CPU tensors. ``dom_tol`` is the
    blocked cycle's safeguard threshold."""
    from repro_torch.kernels import ops

    if cycle_mode == "auto":
        cycle_mode = ("blocked" if ops.prefer_blocked_cd(tile, block)
                      else "sequential")
    if cycle_mode == "blocked":
        return partial(ops.blocked_cd, block=block, dom_tol=dom_tol)
    if cycle_mode != "sequential":
        raise ValueError(f"unknown cycle_mode {cycle_mode!r}")
    return ops.gram_cd


def layout_blocks(X: torch.Tensor, num_blocks: int, tile: int) -> torch.Tensor:
    """X (n, p) -> contiguous (M, nt, n, tile) tiles, zero-padded: p to a
    multiple of M (M blocks of p_b features, the reference's
    ``_pad_features``), then each block to nt * tile features (the
    reference's per-call pad in ``cd_cycle_gram``). One copy per fit."""
    n, p = X.shape
    pb = -(-p // num_blocks)
    nt = -(-pb // tile)
    out = X.new_zeros(num_blocks, nt, n, tile)
    for m in range(num_blocks):
        for t in range(nt):
            lo = m * pb + t * tile
            hi = min(m * pb + min((t + 1) * tile, pb), p)
            if hi > lo:
                out[m, t, :, : hi - lo] = X[:, lo:hi]
    return out


def layout_coefs(beta: torch.Tensor, num_blocks: int, tile: int) -> torch.Tensor:
    """beta (p,) -> (M, nt * tile), zero-padded like :func:`layout_blocks`."""
    p = beta.shape[0]
    pb = -(-p // num_blocks)
    nt = -(-pb // tile)
    out = beta.new_zeros(num_blocks, pb)
    out.view(-1)[:p] = beta
    return torch.nn.functional.pad(out, (0, nt * tile - pb))


def unlayout_coefs(bt: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`layout_coefs`: (M, nt * tile) -> (p,)."""
    pb = -(-p // bt.shape[0])
    return bt[:, :pb].reshape(-1)[:p]


def cd_cycle_gram(Xt, w, r, beta, dbeta, lam, *, nu: float = NU,
                  cycle_mode: str = "sequential", block: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full CD cycle over every block via Gram tiles.

    Xt (M, nt, n, F) from :func:`layout_blocks`; r (M, n); beta, dbeta
    (M, nt * F). The residual advances between tiles with one batched
    matmul, so with the sequential cycle the iterates are those of
    ``cd_cycle_residual``. Returns (dbeta, r).
    """
    nt, tile = Xt.shape[1], Xt.shape[3]
    tile_solver = make_tile_solver(cycle_mode=cycle_mode, tile=tile, block=block)
    dbeta = dbeta.clone()
    for t in range(nt):
        Xf = Xt[:, t]                                       # (M, n, F)
        wX = w[None, :, None] * Xf
        G = Xf.transpose(1, 2) @ wX                         # (M, F, F)
        c = (wX.transpose(1, 2) @ r[..., None])[..., 0]     # (M, F)
        sl = slice(t * tile, (t + 1) * tile)
        d = tile_solver(G, c, beta[:, sl], dbeta[:, sl], lam, nu)
        r = r - (Xf @ d[..., None])[..., 0]
        dbeta[:, sl] = dbeta[:, sl] + d
    return dbeta, r


def solve_subproblem(Xt, w, z, beta, lam, *, method: str = "gram",
                     n_cycles: int = 1, nu: float = NU,
                     cycle_mode: str = "sequential", block: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Algorithm 2 on every block at once.

    Xt (M, nt, n, F), beta (M, nt * F). Returns (dbeta, dmargin) with
    dmargin (M, n) = X_m @ dbeta_m per block. ``method="blocked"`` is
    the Gram path with ``cycle_mode="blocked"``; ``method="jacobi"`` the
    reference's Shotgun-style ablation, every coordinate of a block at
    once from one residual (the ablation driver's baseline). The residual
    method of the reference is not ported to the batched path.
    """
    if method == "blocked":
        method, cycle_mode = "gram", "blocked"
    if method == "jacobi":
        return _solve_jacobi(Xt, w, z, beta, lam, n_cycles=n_cycles, nu=nu)
    if method != "gram":
        raise ValueError(
            f"method {method!r} is not ported to the batched solve; use "
            f"'gram', 'blocked' or 'jacobi'")
    dbeta = torch.zeros_like(beta)
    r = z.expand(Xt.shape[0], -1)                   # dbeta = 0 initially
    for _ in range(n_cycles):
        dbeta, r = cd_cycle_gram(Xt, w, r, beta, dbeta, lam, nu=nu,
                                 cycle_mode=cycle_mode, block=block)
    tile = Xt.shape[3]
    dm = sum((Xt[:, t] @ dbeta[:, t * tile:(t + 1) * tile, None])[..., 0]
             for t in range(Xt.shape[1]))
    return dbeta, dm


def _solve_jacobi(Xt, w, z, beta, lam, *, n_cycles: int, nu: float):
    """The reference's ``method="jacobi"``: per block, G and c over all of
    its features (the tiles side by side; padded features have G = 0 and
    stay 0) and one Jacobi step of every coordinate per cycle."""
    M, nt, n, F = Xt.shape
    Xb = Xt.permute(0, 2, 1, 3).reshape(M, n, nt * F)
    dbeta = torch.zeros_like(beta)
    r = z.expand(M, -1)
    for _ in range(n_cycles):
        wX = w[None, :, None] * Xb
        G = Xb.transpose(1, 2) @ wX
        c = (wX.transpose(1, 2) @ r[..., None])[..., 0]
        d = cd_cycle_jacobi_tile(G, c, beta, dbeta, lam, nu)
        dbeta = dbeta + d
        r = r - (Xb @ d[..., None])[..., 0]
    return dbeta, (Xb @ dbeta[..., None])[..., 0]
