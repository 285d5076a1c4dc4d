"""The port's kernel layer on the CPU: each kernel's plain PyTorch version
(what a CPU tensor runs, and what the card's kernel is held against)
against the JAX reference on the same numpy inputs.

* logistic_stats: vs ``logistic_stats_pallas(interpret=True)`` and
  ``logistic_stats_ref``; w at 1e-5, z with the conditioning of
  1/(1 - p) (one ulp of p moves z by 6e-8/(1-p) relative), the NLL to
  1e-5 relative (summation order).
* gram_cd / blocked_cd: vs ``cd_cycle_gram_tile`` / ``cd_cycle_blocked_tile``
  (the JAX Pallas tile kernels no longer run under this JAX), atol = rtol
  = 1e-5 (``tests/test_blocked_cd.py``'s tolerance). The port reads row j
  of G, the jnp oracle column j; G is symmetric up to rounding.
* blocked B=1 is bit-equal to the sequential chain; the safeguard modes
  equal the reference's exactly.

The kernels themselves run only on the card (``chip_smoke.py``); here the
wrappers must refuse CPU tensors and the dispatch must route CPU tensors
to the plain versions.
"""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import subproblem as jsub
from repro.kernels.logistic_stats import logistic_stats_pallas
from repro.kernels.ref import logistic_stats_ref as j_logistic_stats_ref
from repro_torch.core import subproblem as tsub
from repro_torch.kernels import blocked_cd, ops, ref
gram_cd = import_module("repro_torch.kernels.gram_cd")
logistic_stats = import_module("repro_torch.kernels.logistic_stats")

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def gram_tile(f, seed, *, n=256, kind="random"):
    """Numpy Gram tile G = Xf^T diag(w) Xf, c = (w Xf)^T r as the solver
    builds it; ``kind="modes"`` correlates or duplicates features so the
    blocked safeguard's modes 0, 1 and 2 all occur (B = 8)."""
    rng = np.random.default_rng(seed)
    Xf = rng.standard_normal((n, f), dtype=np.float32)
    if kind == "modes":
        for lo in range(0, f, 8):
            g = (lo // 8) % 3
            if g == 1:
                Xf[:, lo + 4:lo + 8] = Xf[:, lo:lo + 4] + 0.05 * Xf[:, lo + 4:lo + 8]
            elif g == 2:
                Xf[:, lo:lo + 8] = Xf[:, lo:lo + 1]
    w = (0.05 + 0.2 * rng.random(n)).astype(np.float32)
    r = rng.standard_normal(n, dtype=np.float32)
    wX = w[:, None] * Xf
    G = Xf.T @ wX
    c = wX.T @ r
    beta = (0.1 * rng.standard_normal(f)).astype(np.float32)
    db0 = (0.01 * rng.standard_normal(f)).astype(np.float32)
    lam = float(np.abs(c).mean())
    return G, c, beta, db0, lam


# ---------------------------------------------------------------------------
# logistic_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,scale", [(4096, 4.0), (5000, 4.0), (777, 30.0), (64, 100.0)])
def test_logistic_stats_plain_matches_pallas_and_ref(n, scale):
    rng = np.random.default_rng(n)
    m = (scale * rng.standard_normal(n)).astype(np.float32)
    m[:4] = [40.0, -40.0, 100.0, -100.0]
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    w, z, nll = ops.logistic_stats(_t(m), _t(y))
    p = 1.0 / (1.0 + np.exp(-m.astype(np.float64)))
    z_rtol = np.maximum(TOL, 4 * 6e-8 / np.clip(1.0 - p, 1e-5, 1.0))
    for oracle in (logistic_stats_pallas(jnp.asarray(m), jnp.asarray(y), interpret=True),
                   j_logistic_stats_ref(jnp.asarray(m), jnp.asarray(y))):
        w0, z0, nll0 = (np.asarray(v, np.float64) for v in oracle)
        _close(w, w0)
        assert np.all(np.abs(z.numpy() - z0) <= TOL + z_rtol * np.abs(z0))
        assert abs(float(nll) - float(nll0)) <= TOL * abs(float(nll0))
        assert np.isfinite(float(nll))


# ---------------------------------------------------------------------------
# tile cycles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,seed", [(32, 0), (64, 1), (128, 2), (256, 3)])
def test_gram_cd_plain_matches_reference(f, seed):
    G, c, beta, db0, lam = gram_tile(f, seed)
    d = ops.gram_cd(_t(G), _t(c), _t(beta), _t(db0), lam, 1e-6)
    d0 = jsub.cd_cycle_gram_tile(jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta),
                                 jnp.asarray(db0), lam, 1e-6)
    _close(d, d0)


@pytest.mark.parametrize("f,block,kind", [(32, 8, "random"), (64, 16, "random"),
                                          (128, 16, "random"), (64, 8, "modes"),
                                          (32, 4, "modes")])
def test_blocked_cd_plain_matches_reference(f, block, kind):
    G, c, beta, db0, lam = gram_tile(f, f + block, kind=kind)
    modes = tsub.blocked_cycle_modes(_t(G), block)
    modes0 = jsub.blocked_cycle_modes(jnp.asarray(G), block)
    np.testing.assert_array_equal(modes.numpy(), np.asarray(modes0))
    if kind == "modes" and block == 8:
        assert set(modes.tolist()) == {0, 1, 2}
    d = ops.blocked_cd(_t(G), _t(c), _t(beta), _t(db0), lam, 1e-6, block=block)
    d0 = jsub.cd_cycle_blocked_tile(jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta),
                                    jnp.asarray(db0), lam, 1e-6, block=block)
    _close(d, d0)


def test_jacobi_tile_matches_reference():
    G, c, beta, db0, lam = gram_tile(64, 9)
    d = tsub.cd_cycle_jacobi_tile(_t(G), _t(c), _t(beta), _t(db0), lam)
    d0 = jsub.cd_cycle_jacobi_tile(jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta),
                                   jnp.asarray(db0), lam)
    _close(d, d0)


@pytest.mark.parametrize("f", [32, 128])
def test_blocked_b1_is_the_sequential_chain_bit_for_bit(f):
    G, c, beta, db0, lam = gram_tile(f, 5)
    args = (_t(G), _t(c), _t(beta), _t(db0), lam, 1e-6)
    assert torch.equal(ref.blocked_cd_ref(*args, block=1), ref.gram_cd_ref(*args))


@pytest.mark.parametrize("fn", ["gram", "blocked"])
def test_batched_tile_cycle_equals_each_block_alone(fn):
    """The leading batch axis (the M feature blocks) changes nothing: each
    row of a batched call equals the unbatched call on that block."""
    tiles = [gram_tile(32, s, kind="modes" if s % 2 else "random") for s in range(4)]
    G, c, beta, db0 = (torch.stack([_t(t[k]) for t in tiles]) for k in range(4))
    lam = 0.5
    cycle = (ref.gram_cd_ref if fn == "gram"
             else lambda *a: ref.blocked_cd_ref(*a, block=8))
    d = cycle(G, c, beta, db0, lam, 1e-6)
    for i in range(4):
        assert torch.equal(d[i], cycle(G[i], c[i], beta[i], db0[i], lam, 1e-6))


def test_residual_cycle_matches_reference_and_gram_path():
    rng = np.random.default_rng(3)
    n, p = 300, 20
    X = rng.standard_normal((n, p), dtype=np.float32)
    w = (0.05 + 0.2 * rng.random(n)).astype(np.float32)
    r = rng.standard_normal(n, dtype=np.float32)
    beta = (0.1 * rng.standard_normal(p)).astype(np.float32)
    lam = 2.0
    db, rr = tsub.cd_cycle_residual(_t(X), _t(w), _t(r), _t(beta), torch.zeros(p), lam)
    db0, rr0 = jsub.cd_cycle_residual(jnp.asarray(X), jnp.asarray(w), jnp.asarray(r),
                                      jnp.asarray(beta), jnp.zeros(p), lam)
    _close(db, db0, 1e-4)
    _close(rr, rr0, 1e-4)
    # the Gram-tile path gives the same iterates (one block, one tile)
    Xt = tsub.layout_blocks(_t(X), 1, p)
    db_g, _ = tsub.cd_cycle_gram(Xt, _t(w), _t(r)[None], _t(beta)[None],
                                 torch.zeros(1, p), lam)
    _close(db_g[0], db, 1e-4)


@pytest.mark.parametrize("p,num_blocks,tile", [(128, 4, 32), (100, 3, 16), (50, 1, 64)])
def test_layout_round_trips(p, num_blocks, tile):
    X = torch.arange(6 * p, dtype=torch.float32).reshape(6, p)
    beta = torch.arange(p, dtype=torch.float32) + 1
    Xt = tsub.layout_blocks(X, num_blocks, tile)
    bt = tsub.layout_coefs(beta, num_blocks, tile)
    assert Xt.is_contiguous() and Xt.shape[:3] == (num_blocks, Xt.shape[1], 6)
    assert torch.equal(tsub.unlayout_coefs(bt, p), beta)
    # X @ beta equals the sum over blocks and tiles of the laid-out products
    got = sum((Xt[:, t] @ bt[:, t * tile:(t + 1) * tile, None])[..., 0]
              for t in range(Xt.shape[1])).sum(0)
    _close(got, X @ beta)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_dispatch_routes_cpu_tensors_to_plain_versions():
    ops.reset_launch_counts()
    G, c, beta, db0, lam = gram_tile(32, 7)
    args = (_t(G)[None], _t(c)[None], _t(beta)[None], _t(db0)[None], lam)
    ops.gram_cd(*args)
    ops.blocked_cd(*args, block=8)
    ops.logistic_stats(torch.zeros(10), torch.ones(10))
    rows = torch.tensor([[0, 2], [1, 5]], dtype=torch.int32)
    vals = torch.ones(2, 2)
    ops.slab_gram(rows, vals, torch.ones(5), torch.ones(5))
    ops.slab_spmv(rows, vals, torch.ones(2), n_loc=5)
    ops.slab_residual_update(torch.ones(5), rows, vals, torch.ones(2))
    ops.slab_path_spmv(rows, vals, torch.zeros(5, dtype=torch.int32), torch.ones(1, 2), n_loc=5)
    ops.flash_attention(torch.zeros(1, 64, 2, 32), torch.zeros(1, 64, 1, 32),
                        torch.zeros(1, 64, 1, 32))
    assert ops.launch_counts() == {"logistic_stats": 0, "gram_cd": 0, "blocked_cd": 0,
                                   "slab_gram": 0, "slab_spmv": 0, "flash_attention": 0,
                                   "tg_pass": 0, "slab_path_spmv": 0}
    with pytest.raises(ValueError, match="mixed devices"):
        ops.logistic_stats(torch.zeros(4), torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.logistic_stats(torch.zeros(4, device="meta"), torch.ones(4, device="meta"))


@pytest.mark.parametrize("call", ["logistic_stats", "gram_cd", "blocked_cd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes on the
    host by itself."""
    G, c, beta, db0, lam = gram_tile(32, 8)
    tile_args = (_t(G)[None], _t(c)[None], _t(beta)[None], _t(db0)[None], lam, 1e-6)
    with pytest.raises(ValueError):
        if call == "logistic_stats":
            logistic_stats.logistic_stats_kernel(torch.zeros(8), torch.ones(8))
        elif call == "gram_cd":
            gram_cd.gram_cd_kernel(*tile_args)
        else:
            blocked_cd.blocked_cd_kernel(*tile_args, block=8)
