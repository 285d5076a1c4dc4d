"""The Gram-tile CD kernels' host-side rules and in-kernel safeguard, on
the CPU.

The kernels (``src/repro_torch/kernels/csrc/gram_cd.cu``, ``blocked_cd.cu``)
run only on the card (``chip_smoke.py`` holds them against their plain
versions there). What the CPU can check:

* ``blocked_cd`` computes its per-block modes in the kernel, summing
  |G_jk| over each row's block in ascending column order. ``kernel_modes``
  below does the same arithmetic in numpy float32; it must equal the
  port's ``blocked_cycle_modes`` and the JAX reference's wherever the
  Gershgorin ratios are more than 4 ulp from ``DOM_TOL`` (the plain
  versions sum in another order), on the three kinds of tile the card
  check uses; a tile built exactly at the threshold shows the decision
  (ratio == 0.9: the full-width Jacobi step, as ``<=`` says).
* the chunk plan that sizes the kernels' shared memory;
* the stride rule that lets the solve pass ``beta[:, sl]`` slices without
  copies, and the dispatch's CPU branch on such views.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import subproblem as jsub
from repro_torch.core import subproblem as tsub
from repro_torch.kernels import ops
from repro_torch.kernels.blocked_cd import VECTORS
from repro_torch.kernels.gram_cd import (MAX_F, SMEM_LIMIT, chunk_plan,
                                         check_tile_operands, tile_row_stride)

torch.set_num_threads(2)
NU = np.float32(1e-6)
TOL = np.float32(tsub.DOM_TOL)
ULP = np.spacing(TOL)


def kernel_modes(G, block: int, nu=NU, dom_tol=TOL):
    """The kernel's prologue in numpy float32: per row j, the sums of |G_jk|
    over j's B block and B/2 half in ascending column order, minus |G_jj|,
    over h = G_jj + nu; each block's mode from the rows' maxima (NaN
    propagates) against the threshold ``dom_tol`` (a float32, as the
    kernel takes it). Returns (modes, rho_full, rho_half), the ratios per
    block."""
    G = np.asarray(G, np.float32)
    f = G.shape[-1]
    nb = f // block
    lead = G.shape[:-2]
    if block <= 1:
        z = np.zeros((*lead, nb), np.float32)
        return np.zeros((*lead, nb), np.int32), z, z
    even = block % 2 == 0
    half = max(block // 2, 1)
    A = np.abs(G)
    j = np.arange(f)
    bs, hs = j - j % block, j - j % half
    full = np.zeros((*lead, f), np.float32)
    part = np.zeros((*lead, f), np.float32)
    for k in range(block):
        col = bs + k
        a = A[..., j, col]
        full = (full + a).astype(np.float32)
        inside = even & (col >= hs) & (col < hs + half)
        part = np.where(inside, (part + a).astype(np.float32), part)
    diag = G[..., j, j]
    h = (diag + np.float32(nu)).astype(np.float32)
    ad = np.abs(diag)
    rf = ((full - ad).astype(np.float32) / h).astype(np.float32)
    rh = ((part - ad).astype(np.float32) / h).astype(np.float32)
    rf = rf.reshape(*lead, nb, block).max(-1)
    rh = rh.reshape(*lead, nb, block).max(-1)
    tol = np.float32(dom_tol)
    modes = np.where(rf <= tol, 0, np.where(even & (rh <= tol), 1, 2)).astype(np.int32)
    return modes, rf, rh


def kind_tile(f: int, seed: int, kind: str, n: int = 512, group: int = 16):
    """A Gram tile G = Xf^T diag(w) Xf whose ``group``-wide feature groups
    are independent, correlated across halves, or duplicated, by kind
    ("independent", "halves", "duplicated", or "modes": the three in
    turn, as chip_smoke.py's modes tile)."""
    rng = np.random.default_rng(seed)
    Xf = rng.standard_normal((n, f), dtype=np.float32)
    kinds = ("independent", "halves", "duplicated")
    for lo in range(0, f, group):
        g = kinds[(lo // group) % 3] if kind == "modes" else kind
        hf = group // 2
        if g == "halves":
            Xf[:, lo + hf:lo + group] = Xf[:, lo:lo + hf] + 0.05 * Xf[:, lo + hf:lo + group]
        elif g == "duplicated":
            Xf[:, lo:lo + group] = Xf[:, lo:lo + 1]
    w = (0.05 + 0.2 * rng.random(n)).astype(np.float32)
    return (Xf.T @ (w[:, None] * Xf)).astype(np.float32)


def _far_from_threshold(rf, rh, block):
    near = np.abs(rf - TOL) <= 4 * ULP
    if block % 2 == 0:
        near |= np.abs(rh - TOL) <= 4 * ULP
    return ~near


@pytest.mark.parametrize("kind", ["independent", "halves", "duplicated", "modes"])
@pytest.mark.parametrize("f,block", [(64, 16), (128, 16), (128, 8), (64, 4), (48, 12), (96, 32)])
def test_kernel_modes_match_plain_versions(kind, f, block):
    G = np.stack([kind_tile(f, 100 * f + s, kind) for s in range(3)])
    modes, rf, rh = kernel_modes(G, block)
    port = tsub.blocked_cycle_modes(torch.from_numpy(G), block).numpy()
    ref = np.stack([np.asarray(jsub.blocked_cycle_modes(jnp.asarray(g), block)) for g in G])
    far = _far_from_threshold(rf, rh, block)
    assert far.mean() > 0.9
    np.testing.assert_array_equal(modes[far], port[far])
    np.testing.assert_array_equal(modes[far], ref[far])
    if kind == "modes" and block == 16:
        assert set(modes.flatten().tolist()) == {0, 1, 2}
    if kind == "duplicated":
        assert (modes == 2).all()


@pytest.mark.parametrize("block", [1, 3, 16])
def test_kernel_modes_of_nan_and_identity(block):
    """Identity tiles take the full Jacobi step; a NaN in a block fails its
    dominance test (the plain version's amax propagates it)."""
    f = 48
    G = np.eye(f, dtype=np.float32)
    modes, _, _ = kernel_modes(G, block)
    assert (modes == 0).all()
    G[1, 2] = np.nan
    modes, _, _ = kernel_modes(G, block)
    port = tsub.blocked_cycle_modes(torch.from_numpy(G), block).numpy()
    np.testing.assert_array_equal(modes, port)
    if block > 1:
        assert modes[0] == 2 and (modes[1:] == 0).all()


def test_kernel_modes_at_the_threshold():
    """Off-diagonals of exactly 0.9f on unit diagonals (nu = 0): each row's
    ratio is (1 + 0.9f - 1) / 1 == 0.9f exactly, and ``<=`` takes the
    full-width Jacobi step; one ulp above, the halves (width 1) take over."""
    t = np.float32(0.9)
    G = np.array([[1.0, t], [t, 1.0]], np.float32)
    modes, rf, _ = kernel_modes(G, 2, nu=0.0)
    assert rf[0] == TOL and modes[0] == 0
    assert tsub.blocked_cycle_modes(torch.from_numpy(G), 2, nu=0.0).tolist() == [0]
    up = np.nextafter(t, np.float32(1.0))
    G_up = np.array([[1.0, up], [up, 1.0]], np.float32)
    modes, rf, rh = kernel_modes(G_up, 2, nu=0.0)
    assert rf[0] > TOL and rh[0] == 0.0 and modes[0] == 1
    assert tsub.blocked_cycle_modes(torch.from_numpy(G_up), 2, nu=0.0).tolist() == [1]


@pytest.mark.parametrize("f", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("vectors", [3, VECTORS])
def test_chunk_plan(f, vectors):
    plan = chunk_plan(f, vectors)
    assert plan.smem <= SMEM_LIMIT
    # every row in exactly one chunk
    covered = np.zeros(f, int)
    for q in range(plan.chunks):
        covered[q * plan.rows:min((q + 1) * plan.rows, f)] += 1
    assert (covered == 1).all()
    # chunks never straddle a 32-row slab, and TMA copies whole 16-byte units
    assert 32 % plan.rows == 0 or plan.rows == f
    assert plan.rows * f * 4 % 16 == 0
    assert 2 <= plan.stages <= plan.chunks or plan.chunks == 1
    assert plan.resident == (f <= 128)
    if vectors == VECTORS:
        # blocked_cd's fast cycle holds a unit of max(rows, B) rows, B <= 32
        assert plan.rows == f or max(plan.rows, 32) // plan.rows <= plan.stages
    ring = plan.stages * plan.rows * f * 4
    assert plan.smem >= ring + vectors * f * 4 + 8 * plan.stages


def test_chunk_plan_small_and_out_of_range():
    plan = chunk_plan(20, 3)
    assert (plan.rows, plan.stages, plan.chunks) == (20, 1, 1)
    for f in (0, MAX_F + 1):
        with pytest.raises(ValueError, match="outside"):
            chunk_plan(f)


def test_tile_row_stride_rule():
    wide = torch.zeros(4, 3 * 64)
    assert tile_row_stride(wide[:, 64:128]) == 3 * 64
    assert tile_row_stride(torch.zeros(4, 64)) == 64
    with pytest.raises(ValueError, match="unit inner stride"):
        tile_row_stride(torch.zeros(64, 4).t())
    with pytest.raises(ValueError, match="unit inner stride"):
        tile_row_stride(wide[:, ::3])
    with pytest.raises(ValueError, match=r"\(M, F\)"):
        tile_row_stride(torch.zeros(2, 4, 64))


def test_check_tile_operands_refuses_cpu_tensors_and_wide_tiles():
    G = torch.zeros(2, 8, 8)
    v = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        check_tile_operands(G, (v, v, v))
    with pytest.raises(ValueError, match="outside"):
        check_tile_operands(torch.zeros(1, 2048, 2048), (v,))


@pytest.mark.parametrize("fn", ["gram", "blocked"])
def test_strided_views_through_the_dispatch(fn):
    """The solve's ``beta[:, sl]`` / ``dbeta[:, sl]`` slices give the same d
    as contiguous copies (the CPU branch; the card's is in chip_smoke)."""
    rng = np.random.default_rng(11)
    M, F, nt = 3, 32, 4
    G = torch.from_numpy(np.stack([kind_tile(F, 7 + s, "modes", group=8) for s in range(M)]))
    c = torch.from_numpy(rng.standard_normal((M, F), dtype=np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal((M, nt * F), dtype=np.float32))
    dbeta = torch.from_numpy(0.01 * rng.standard_normal((M, nt * F), dtype=np.float32))
    sl = slice(2 * F, 3 * F)
    call = ops.gram_cd if fn == "gram" else (lambda *a: ops.blocked_cd(*a, block=8))
    assert not beta[:, sl].is_contiguous()
    d_view = call(G, c, beta[:, sl], dbeta[:, sl], 0.5, 1e-6)
    d_copy = call(G, c, beta[:, sl].contiguous(), dbeta[:, sl].contiguous(), 0.5, 1e-6)
    assert torch.equal(d_view, d_copy)
