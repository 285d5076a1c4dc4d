"""The safeguard threshold of the blocked cycle, and the host-side logic of
the ``slab_spmv`` and ``logistic_stats`` kernels, on the CPU against the
JAX reference on the same numpy inputs.

* ``dom_tol``: ``ops.blocked_cd``, ``ref.blocked_cd_ref`` and
  ``make_tile_solver(cycle_mode="blocked")`` take the blocked cycle's
  Gershgorin threshold as the reference does, and are held against
  ``cd_cycle_blocked_tile(dom_tol=)`` and the reference's
  ``make_tile_solver`` at atol = rtol = 1e-5; the kernel's numpy
  emulation of its modes (``tests/test_torch_cd_tile.py``) takes the
  threshold too; the default leaves every result as it was.
* ``slab_spmv``: the kernel (``csrc/slab_spmv.cu``) reads the row-sorted
  order's three streams in chunks and sums each run left to right in
  sorted order. ``kernel_spmv`` below does that in numpy float32, chunk by
  chunk; it is bit-equal to the row-order sum of the kernel it replaced
  (``row_order_spmv``), whatever the chunk, and within 1e-5 of the CPU
  path and of ``slab_spmv_pallas`` in interpret mode, on the slab kinds of
  ``tests/test_torch_slab.py`` and on a "hub" row whose run crosses warps
  and chunks. ``slab_order``'s values stream and the fused dbeta update
  of ``slab_residual_update`` are checked on the CPU path.
* ``logistic_stats``: ``kernel_stats`` below is the kernel's grid and its
  two-stage fixed-order NLL sum in numpy float32, held against
  ``logistic_stats_pallas`` (interpret mode) and the reference's
  ``logistic_stats_ref`` at ``tests/test_torch_kernels.py``'s tolerances,
  for n below one block, ragged n and |m| up to 80.

The kernels themselves run only on the card (``chip_smoke.py``).
"""
import ctypes
import inspect
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import subproblem as jsub
from repro.kernels.logistic_stats import logistic_stats_pallas
from repro.kernels.ref import logistic_stats_ref as j_logistic_stats_ref
from repro.kernels.sparse_slab import slab_spmv_pallas
from repro_torch.core import subproblem as tsub
from repro_torch.core.distributed import layout_slabs
from repro_torch.kernels import blocked_cd, ops, ref
logistic_stats = import_module("repro_torch.kernels.logistic_stats")
slab_spmv = import_module("repro_torch.kernels.slab_spmv")
from repro_torch.kernels.slab_spmv import SlabOrder, slab_order
from test_torch_cd_tile import kernel_modes, kind_tile
from test_torch_slab import KINDS, slab_case

torch.set_num_threads(2)
TOL = 1e-5
F32 = np.float32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# dom_tol, the blocked cycle's safeguard threshold
# ---------------------------------------------------------------------------

def modes_tile(f=64, seed=0, n=512):
    """(G, c, beta, dbeta0, lam) with G from ``kind_tile``'s "modes" tile
    (16-wide groups independent, correlated across halves, duplicated)."""
    rng = np.random.default_rng(seed)
    G = kind_tile(f, seed, "modes", n=n)
    c = rng.standard_normal(f).astype(F32) * F32(np.sqrt(np.diag(G)).mean())
    beta = (0.1 * rng.standard_normal(f)).astype(F32)
    db0 = (0.01 * rng.standard_normal(f)).astype(F32)
    return G, c, beta, db0, float(np.abs(c).mean())


@pytest.mark.parametrize("dom_tol", [0.5, 0.99])
@pytest.mark.parametrize("block", [16, 8])
def test_blocked_cd_dom_tol_matches_reference(dom_tol, block):
    G, c, beta, db0, lam = modes_tile(seed=int(dom_tol * 100) + block)
    want = jsub.cd_cycle_blocked_tile(jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta),
                                      jnp.asarray(db0), lam, 1e-6, block=block,
                                      dom_tol=dom_tol)
    args = (_t(G)[None], _t(c)[None], _t(beta)[None], _t(db0)[None], lam, 1e-6)
    d_ops = ops.blocked_cd(*args, block=block, dom_tol=dom_tol)
    d_ref = ref.blocked_cd_ref(*args, block=block, dom_tol=dom_tol)
    _close(d_ops[0], want)
    _close(d_ref[0], want)
    assert torch.equal(d_ops, d_ref)


@pytest.mark.parametrize("dom_tol", [0.5, 0.99])
def test_make_tile_solver_threads_dom_tol(dom_tol):
    G, c, beta, db0, lam = modes_tile(seed=7)
    port = tsub.make_tile_solver(cycle_mode="blocked", tile=64, block=16, dom_tol=dom_tol)
    jref = jsub.make_tile_solver(cycle_mode="blocked", tile=64, block=16, dom_tol=dom_tol)
    d = port(_t(G)[None], _t(c)[None], _t(beta)[None], _t(db0)[None], lam, 1e-6)
    want = jref(jnp.asarray(G), jnp.asarray(c), jnp.asarray(beta), jnp.asarray(db0),
                lam, 1e-6)
    _close(d[0], want)


def test_dom_tol_moves_the_modes_and_the_default_is_unchanged():
    """On the modes tile the modes at 0.5 differ from those at the default
    0.9, and so does the cycle; the default (None, DOM_TOL, or nothing) is
    one result, bit for bit, and 0.9 reaches the kernel as the same float32
    it compared against before."""
    G, c, beta, db0, lam = modes_tile(seed=3)
    Gt = _t(G)[None]
    m5 = tsub.blocked_cycle_modes(Gt, 16, dom_tol=0.5)
    m9 = tsub.blocked_cycle_modes(Gt, 16)
    assert bool((m5 != m9).any())
    args = (Gt, _t(c)[None], _t(beta)[None], _t(db0)[None], lam, 1e-6)
    d5 = ops.blocked_cd(*args, block=16, dom_tol=0.5)
    d_default = ops.blocked_cd(*args, block=16)
    assert not torch.equal(d5, d_default)
    assert torch.equal(d_default, ops.blocked_cd(*args, block=16, dom_tol=None))
    assert torch.equal(d_default, ops.blocked_cd(*args, block=16, dom_tol=tsub.DOM_TOL))
    assert torch.equal(d_default, ref.blocked_cd_ref(*args, block=16))
    sig = inspect.signature(blocked_cd.blocked_cd_kernel)
    assert sig.parameters["dom_tol"].default == tsub.DOM_TOL == jsub.DOM_TOL
    assert ctypes.c_float(tsub.DOM_TOL).value == float(F32(0.9))


@pytest.mark.parametrize("dom_tol", [0.5, 0.99])
@pytest.mark.parametrize("f,block", [(64, 16), (128, 8), (48, 12)])
def test_kernel_modes_take_the_threshold(dom_tol, f, block):
    G = np.stack([kind_tile(f, 10 * f + s, "modes") for s in range(3)])
    modes, rf, rh = kernel_modes(G, block, dom_tol=dom_tol)
    port = tsub.blocked_cycle_modes(torch.from_numpy(G), block, dom_tol=dom_tol).numpy()
    want = np.stack([np.asarray(jsub.blocked_cycle_modes(jnp.asarray(g), block,
                                                          dom_tol=dom_tol)) for g in G])
    tol = F32(dom_tol)
    near = np.abs(rf - tol) <= 4 * np.spacing(tol)
    if block % 2 == 0:
        near |= np.abs(rh - tol) <= 4 * np.spacing(tol)
    far = ~near
    assert far.mean() > 0.9
    np.testing.assert_array_equal(modes[far], port[far])
    np.testing.assert_array_equal(modes[far], want[far])


# ---------------------------------------------------------------------------
# slab_spmv: the kernel's chunks and sum order in numpy
# ---------------------------------------------------------------------------

def kernel_spmv(rows_s, perm, vals_s, d, out, *, n_loc, sign, K, chunk=slab_spmv.CHUNK):
    """``csrc/slab_spmv.cu`` in numpy float32: per batch row, chunks of
    ``chunk`` sorted positions; step 1 loads each position's row, the row
    before it (a different row starts a run, whose owner loads out[row])
    and the row after the chunk; step 2 stages each position's rounded
    product vals_s * d[perm // K]; step 3 has each run's owner sum the
    run's products left to right from 0, from the chunk while it lasts,
    then, if the row after the chunk is the run's, from the streams past
    it, and write out = old + sign * sum once. rows_s/perm/vals_s (B, S),
    d (B, T), out (B, n_out); returns a copy."""
    out = np.array(out, F32, copy=True)
    B, S = rows_s.shape
    for b in range(B):
        rs, pm, vs = rows_s[b], perm[b], vals_s[b]
        for c0 in range(0, S, chunk):
            lim = min(chunk, S - c0)
            seg = slice(c0, c0 + lim)
            row_sh = np.concatenate([rs[seg], [rs[c0 + lim] if c0 + lim < S else -1]])
            prev = np.concatenate([[rs[c0 - 1] if c0 else -1], rs[c0:c0 + lim - 1]])
            live = (rs[seg] >= 0) & (rs[seg] < n_loc)
            start = live & (rs[seg] != prev)
            old = {i: out[b, row_sh[i]] for i in np.flatnonzero(start)}
            prod_sh = np.where(live, vs[seg] * d[b][pm[seg] // K], F32(0)).astype(F32)
            for i in np.flatnonzero(start):
                r = row_sh[i]
                acc, e = F32(0), i
                while e < lim and row_sh[e] == r:
                    acc = F32(acc + prod_sh[e])
                    e += 1
                if e == lim and row_sh[lim] == r:
                    q = c0 + lim
                    while q < S and rs[q] == r:
                        acc = F32(acc + F32(vs[q] * d[b][pm[q] // K]))
                        q += 1
                out[b, r] = F32(old[i] + F32(sign) * acc)
    return out


def row_order_spmv(rows, vals, d, out, *, n_loc, sign):
    """The sum order of the kernel the chunked one replaced: per example
    row, its slots in the stable row-sorted order, products summed left to
    right from 0, then out = out + sign * sum. rows/vals (B, T, K)."""
    out = np.array(out, F32, copy=True)
    B, T, K = rows.shape
    for b in range(B):
        flat_r, flat_v = rows[b].reshape(-1), vals[b].reshape(-1)
        order = np.argsort(flat_r, kind="stable")
        acc, cur = F32(0), None
        for slot in list(order) + [None]:
            r = None if slot is None else flat_r[slot]
            if r != cur:
                if cur is not None and 0 <= cur < n_loc:
                    out[b, cur] = F32(out[b, cur] + F32(sign) * acc)
                acc, cur = F32(0), r
            if slot is not None:
                acc = F32(acc + F32(flat_v[slot] * d[b][slot // K]))
    return out


def hub_case(seed=0, t=32, k=80, n=300, hub=17):
    """A slab with one "hub" example row in the first 40 slots of every
    feature (1,280 slots: a run that crosses warps and 512-position
    chunks), the rest as ``slab_case``'s sentinels kind."""
    rows, vals, w, r, d = slab_case("sentinels", seed=seed, t=t, k=k, n=n)
    rows[:, :40] = hub
    return rows, vals, w, r, d


def spmv_case(kind, seed=0):
    if kind == "hub":
        return hub_case(seed)
    return slab_case(kind, seed=seed)


def _order_np(rows, vals):
    o = slab_order(_t(rows), _t(vals))
    return o.rows_s.numpy(), o.perm.numpy(), o.vals_s.numpy()


@pytest.mark.parametrize("kind", KINDS + ["hub"])
def test_slab_spmv_kernel_emulation(kind):
    rows, vals, _, r, d = spmv_case(kind)
    n, (T, K) = r.shape[0], rows.shape
    B = 3
    rows3 = np.stack([rows] * B)
    vals3 = np.stack([vals * F32(s + 1) for s in range(B)]).astype(F32)
    d3 = np.stack([d * F32(1 - s) for s in range(B)]).astype(F32)
    rs, pm, vs = _order_np(rows3, vals3)
    zero = np.zeros((B, n), F32)
    today = row_order_spmv(rows3, vals3, d3, zero, n_loc=n, sign=1.0)
    for chunk in (slab_spmv.CHUNK, 64, 7):
        got = kernel_spmv(rs, pm, vs, d3, zero, n_loc=n, sign=1.0, K=K, chunk=chunk)
        np.testing.assert_array_equal(got, today)
    plain = ops.slab_spmv(_t(rows3), _t(vals3), _t(d3), n_loc=n)
    _close(got, plain)
    for b in range(B):
        dv = np.where(rows3[b] < n, vals3[b], 0.0).astype(F32) * d3[b][:, None]
        pout = slab_spmv_pallas(jnp.minimum(jnp.asarray(rows3[b]), n), jnp.asarray(dv),
                                n_loc=n, interpret=True)
        _close(got[b], pout)
    # the residual update's sign and in-place add
    r3 = np.stack([r] * B).astype(F32)
    upd = kernel_spmv(rs, pm, vs, d3, r3, n_loc=n, sign=-1.0, K=K)
    np.testing.assert_array_equal(upd, row_order_spmv(rows3, vals3, d3, r3, n_loc=n, sign=-1.0))
    _close(upd, ops.slab_residual_update(_t(r3), _t(rows3), _t(vals3), _t(d3)))
    if kind == "hub":
        live = rs[0] == 17
        assert live.sum() >= 40 * T and np.flatnonzero(live).max() >= 2 * slab_spmv.CHUNK


def test_slab_order_values_stream():
    rows = np.stack([slab_case("adversarial", seed=s)[0] for s in range(2)])
    vals = np.stack([slab_case("adversarial", seed=s)[1] for s in range(2)])
    order = slab_order(_t(rows), _t(vals))
    assert order.vals_s.dtype == torch.float32
    assert torch.equal(order.vals_s, _t(vals).flatten(-2).gather(-1, order.perm.long()))
    bare = slab_order(_t(rows))
    assert bare.vals_s is None
    assert torch.equal(bare.rows_s, order.rows_s) and torch.equal(bare.perm, order.perm)
    two = SlabOrder(order.rows_s, order.perm)
    assert two.vals_s is None and len(two) == 3


def test_layout_slabs_keeps_the_values_stream():
    rng = np.random.default_rng(5)
    p, K, n = 64, 6, 50
    rows = np.sort(rng.integers(0, n + 1, (p, K)), axis=1).astype(np.int32)
    vals = rng.standard_normal((p, K)).astype(F32)
    lay = layout_slabs(_t(rows), _t(vals), 2, 16)
    M, nt = 2, 2
    flat = lay.vals.reshape(M, nt, -1)
    assert lay.order.vals_s.shape == lay.order.rows_s.shape == (M, nt, 16 * K)
    assert torch.equal(lay.order.vals_s, flat.gather(-1, lay.order.perm.long()))
    assert torch.equal(lay.order.rows_s, lay.rows.reshape(M, nt, -1).gather(
        -1, lay.order.perm.long()))


def test_residual_update_fuses_dbeta_on_the_cpu():
    """``slab_residual_update(..., dbeta=)`` on the CPU is the two steps it
    replaces, bit for bit: r -= X_F d, then dbeta[:, sl] += d on a
    row-strided view."""
    cases = [slab_case("adversarial", seed=s) for s in range(3)]
    rows, vals = (_t(np.stack([c[i] for c in cases])) for i in (0, 1))
    n = cases[0][3].shape[0]
    r = _t(np.stack([c[3] for c in cases]))
    d = _t(np.stack([c[4] for c in cases]))
    T = d.shape[1]
    dbeta = torch.randn(3, 3 * T, generator=torch.Generator().manual_seed(0))
    r1, db1 = r.clone(), dbeta.clone()
    out = ops.slab_residual_update(r1, rows, vals, d, order=slab_order(rows, vals),
                                   dbeta=db1[:, T:2 * T])
    assert out is r1
    r2, db2 = r.clone(), dbeta.clone()
    ops.slab_residual_update(r2, rows, vals, d)
    db2[:, T:2 * T] += d
    assert torch.equal(r1, r2) and torch.equal(db1, db2)
    assert n == r.shape[1]


def test_slab_spmv_wrapper_refuses_cpu_dbeta():
    rows, vals, w, _, d = (_t(a) for a in slab_case("plain"))
    with pytest.raises(ValueError, match="CUDA"):
        slab_spmv.slab_spmv_kernel(slab_order(rows, vals), vals, d, torch.zeros(w.shape[0]),
                                   n_loc=w.shape[0], sign=-1.0, dbeta=torch.zeros_like(d))
    assert slab_spmv.launches == 0


# ---------------------------------------------------------------------------
# logistic_stats: the kernel's grid and fixed-order NLL in numpy
# ---------------------------------------------------------------------------

def _tree(v):
    """A warp's shuffle-down tree (offsets 16 .. 1) over the last axis of
    32 lanes, as __shfl_down_sync sums it into lane 0."""
    v = np.array(v, F32, copy=True)
    off = 16
    while off:
        v[..., :off] = (v[..., :off] + v[..., off:2 * off]).astype(F32)
        off //= 2
    return v[..., 0]


def _block_sum(v):
    """``block_sum``: each warp's tree, then the tree over the warps' sums
    padded with zeros to 32 lanes. v (..., THREADS) -> (...)."""
    warps = _tree(v.reshape(*v.shape[:-1], -1, 32))
    pad = np.zeros((*warps.shape[:-1], 32), F32)
    pad[..., :warps.shape[-1]] = warps
    return _tree(pad)


def kernel_stats(m, y, *, vec=True, sms=132):
    """``csrc/logistic_stats.cu`` in numpy float32: w and z elementwise; the
    NLL as each thread's grid-stride sum (a float4's lanes in order, then
    the ragged tail), each block's fixed tree, and the last block's sum of
    the partials in block order (thread i: partials i, i + 256, ...) and
    the same tree."""
    m, y = np.asarray(m, F32), np.asarray(y, F32)
    n = m.shape[0]
    p = (F32(1) / (F32(1) + np.exp(-m))).astype(F32)
    p = np.clip(p, F32(1e-5), F32(1.0 - 1e-5))
    w = np.maximum((p * (F32(1) - p)).astype(F32), F32(1e-6))
    z = (((y + F32(1)) * F32(0.5) - p) / w).astype(F32)
    t = (-y * m).astype(F32)
    sp = (np.maximum(t, F32(0)) + np.log1p(np.exp(-np.abs(t)))).astype(F32)
    threads = logistic_stats.THREADS
    G = logistic_stats.grid(n, vec, sms)
    stride = G * threads
    acc = np.zeros(stride, F32)
    head = 0
    if vec:
        n4 = n // 4
        for i0 in range(0, n4, stride):
            idx = np.arange(i0, min(i0 + stride, n4))
            for lane in range(4):
                acc[:idx.size] = (acc[:idx.size] + sp[4 * idx + lane]).astype(F32)
        head = 4 * n4
    for i0 in range(head, n, stride):
        k = min(stride, n - i0)
        acc[:k] = (acc[:k] + sp[i0:i0 + k]).astype(F32)
    partials = _block_sum(acc.reshape(G, threads))
    last = np.zeros(threads, F32)
    for i0 in range(0, G, threads):
        k = min(threads, G - i0)
        last[:k] = (last[:k] + partials[i0:i0 + k]).astype(F32)
    return w, z, _block_sum(last)


@pytest.mark.parametrize("n", [100, 1000, 5003, 70_001])
@pytest.mark.parametrize("vec", [True, False])
def test_logistic_stats_kernel_emulation(n, vec):
    rng = np.random.default_rng(n + vec)
    m = (8.0 * rng.standard_normal(n)).astype(F32)
    m[:6] = [80.0, -80.0, 40.0, -40.0, 17.5, -0.0]
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(F32)
    w, z, nll = kernel_stats(m, y, vec=vec)
    p = 1.0 / (1.0 + np.exp(-m.astype(np.float64)))
    z_rtol = np.maximum(TOL, 4 * 6e-8 / np.clip(1.0 - p, 1e-5, 1.0))
    for oracle in (logistic_stats_pallas(jnp.asarray(m), jnp.asarray(y), interpret=True),
                   j_logistic_stats_ref(jnp.asarray(m), jnp.asarray(y))):
        w0, z0, nll0 = (np.asarray(v, np.float64) for v in oracle)
        _close(w, w0)
        assert np.all(np.abs(z - z0) <= TOL + z_rtol * np.abs(z0))
        assert abs(float(nll) - float(nll0)) <= TOL * abs(float(nll0))
        assert np.isfinite(float(nll))
    wt, zt, nllt = ref.logistic_stats_ref(_t(m), _t(y))
    assert abs(float(nll) - float(nllt)) <= TOL * abs(float(nllt))


def test_logistic_stats_grid():
    g = logistic_stats.grid
    sms = 132
    cap = logistic_stats.BLOCKS_PER_SM * sms
    assert g(0, True, sms) == g(5, True, sms) == g(1023, True, sms) == 1
    assert g(1024, False, sms) == 4 and g(1025, False, sms) == 5
    assert g(320_000, True, sms) == 313
    assert g(10 ** 8, True, sms) == g(10 ** 8, False, sms) == cap
