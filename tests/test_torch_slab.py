"""The port's by-feature layer on the CPU against the JAX reference, on
the same numpy inputs:

* data: ``to_by_feature``, ``to_slabs`` (dp 1 and 2), ``densify``,
  ``partition_features`` and the Table-1 text round trip give equal
  arrays;
* kernels: the plain versions of ``slab_gram`` / ``slab_spmv`` (what a
  CPU tensor runs) and ``slab_corr`` against ``repro.kernels.ops``, the
  densify oracles of ``repro.kernels.ref`` and, for ``slab_spmv``,
  ``slab_spmv_pallas`` in interpret mode (``slab_gram_pallas`` no longer
  runs under this JAX: ``pl.load`` is gone), atol = rtol = 1e-5
  (``tests/test_blocked_cd.py``'s tolerance), with duplicate rows,
  sentinels anywhere (with values parked on them), empty features and a
  tile past the one-shot match size;
* designs: ``SlabDesign.margins/correlation/gram_tile/densify`` and
  ``as_design``;
* the mesh description.

The CUDA kernels run only on the card (``chip_smoke.py``); here their
wrappers must refuse CPU tensors and wrong types, and ``slab_gram``'s
algorithm is written out in numpy and held against the plain path and
the earlier merge join's sum order.
"""
import io
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SlabDesign as JSlabDesign
from repro.data import byfeature as jbf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sparse_slab import slab_spmv_pallas
from repro_torch.api import SlabDesign, as_design
from repro_torch.data import byfeature as tbf
from repro_torch.kernels import ops, ref
slab_gram = import_module("repro_torch.kernels.slab_gram")
slab_spmv = import_module("repro_torch.kernels.slab_spmv")
from repro_torch.launch.mesh import make_dev_mesh

torch.set_num_threads(2)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def sparse_matrix(n=96, p=40, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p)).astype(np.float32) * (rng.random((n, p)) < density)
    X[:, 3] = 0.0                      # an empty feature
    return X


# ---------------------------------------------------------------------------
# data layer
# ---------------------------------------------------------------------------

def test_to_by_feature_matches_reference():
    X = sparse_matrix()
    bf, jb = tbf.to_by_feature(X), jbf.to_by_feature(X)
    np.testing.assert_array_equal(bf.row_idx.numpy(), np.asarray(jb.row_idx))
    np.testing.assert_array_equal(bf.values.numpy(), np.asarray(jb.values))
    assert (bf.n, bf.p, bf.nnz) == (jb.n, jb.p, jb.nnz)
    np.testing.assert_array_equal(tbf.densify(bf).numpy(), np.asarray(jbf.densify(jb)))
    np.testing.assert_array_equal(tbf.densify(bf).numpy(), X)
    np.testing.assert_array_equal(tbf.densify_tile(bf, 5, 7).numpy(),
                                  np.asarray(jbf.densify_tile(jb, 5, 7)))


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_to_slabs_matches_reference(dp):
    X = sparse_matrix(n=96)
    r, v, n_loc = tbf.to_slabs(tbf.to_by_feature(X), dp)
    jr, jv, jn = jbf.to_slabs(jbf.to_by_feature(X), dp)
    assert n_loc == jn and r.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    live = (r < n_loc).numpy()
    assert (live[..., 1:] <= live[..., :-1]).all(), "slots must be front-packed"


def test_to_slabs_rejects_ragged_shards():
    with pytest.raises(ValueError, match="must divide"):
        tbf.to_slabs(tbf.to_by_feature(sparse_matrix(n=95)), 2)


@pytest.mark.parametrize("p,m", [(10, 3), (64, 4), (5, 8)])
def test_partition_features_matches_reference(p, m):
    for a, b in zip(tbf.partition_features(p, m), jbf.partition_features(p, m), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
def test_table1_round_trip(shuffle):
    """The port writes the reference's Table-1 text and reads it back by
    feature id (lines in any order, gaps become empty features)."""
    X = sparse_matrix(p=12)
    bf, jb = tbf.to_by_feature(X), jbf.to_by_feature(X)
    out, jout = io.StringIO(), io.StringIO()
    tbf.write_table1(bf, out)
    jbf.write_table1(jb, jout)
    assert out.getvalue() == jout.getvalue()
    lines = out.getvalue().splitlines()
    if shuffle:
        lines = [lines[i] for i in np.random.default_rng(1).permutation(len(lines))]
        lines = [ln for ln in lines if not ln.startswith("7 ")]    # a gap
    text = "\n".join(lines) + "\n"
    back, jback = tbf.read_table1(io.StringIO(text), bf.n), jbf.read_table1(io.StringIO(text), jb.n)
    np.testing.assert_array_equal(back.row_idx.numpy(), np.asarray(jback.row_idx))
    np.testing.assert_array_equal(back.values.numpy(), np.asarray(jback.values))
    want = X.copy()
    if shuffle:
        want[:, 7] = 0.0
    np.testing.assert_array_equal(tbf.densify(back).numpy(), want)


# ---------------------------------------------------------------------------
# slab kernels: plain versions
# ---------------------------------------------------------------------------

def slab_case(kind, seed=0, t=16, k=6, n=40):
    """(rows, vals, w, r, d) for one (T, K) slab tile, numpy."""
    rng = np.random.default_rng(seed)
    if kind == "wide":                  # T*K = 2560 > 2048: the chunked match join
        t, k, n = 32, 80, 300
    rows = np.stack([np.sort(rng.choice(n, k, replace=False)) for _ in range(t)]).astype(np.int32)
    vals = rng.standard_normal((t, k)).astype(np.float32)
    if kind in ("sentinels", "adversarial"):
        # sentinel slots anywhere (several values >= n), with values parked on them
        mask = rng.random((t, k)) < 0.3
        rows[mask] = n + rng.integers(0, 3, mask.sum())
    if kind in ("duplicates", "adversarial"):
        rows[:, 1] = rows[:, 0]          # a row twice within a feature: they sum
        rows[2, :] = rows[2, 0]
    if kind in ("empty", "adversarial"):
        rows[4] = n                      # all-sentinel features
        rows[-1] = n + 7
        vals[4] = 5.0
    if kind == "unsorted":
        for j in range(t):
            perm = rng.permutation(k)
            rows[j], vals[j] = rows[j][perm], vals[j][perm]
    w = (0.05 + 0.25 * rng.random(n)).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    d = rng.standard_normal(t).astype(np.float32)
    return rows, vals, w, r, d


KINDS = ["plain", "duplicates", "sentinels", "empty", "unsorted", "adversarial", "wide"]


@pytest.mark.parametrize("kind", KINDS)
def test_slab_gram_plain_matches_reference(kind):
    rows, vals, w, r, _ = slab_case(kind)
    G, c = ops.slab_gram(_t(rows), _t(vals), _t(w), _t(r))
    jG, jc = jops.slab_gram(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(w), jnp.asarray(r))
    oG, oc = jref.slab_gram_ref(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(w), jnp.asarray(r))
    tG, tc = ref.slab_gram_ref(_t(rows), _t(vals), _t(w), _t(r))
    for a, b in ((G, jG), (c, jc), (G, oG), (c, oc), (tG, oG), (tc, oc)):
        _close(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_slab_spmv_plain_matches_reference(kind):
    rows, vals, _, r, d = slab_case(kind)
    n = r.shape[0]
    out = ops.slab_spmv(_t(rows), _t(vals), _t(d), n_loc=n)
    jout = jops.slab_spmv(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(d), n_loc=n)
    oout = jref.slab_spmv_ref(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(d), n)
    dv = np.where(rows < n, vals, 0.0).astype(np.float32) * d[:, None]
    pout = slab_spmv_pallas(jnp.minimum(jnp.asarray(rows), n), jnp.asarray(dv), n_loc=n,
                            interpret=True)
    tout = ref.slab_spmv_ref(_t(rows), _t(vals), _t(d), n)
    for a, b in ((out, jout), (out, oout), (out, pout), (tout, oout)):
        _close(a, b)
    rr = ops.slab_residual_update(_t(r).clone(), _t(rows), _t(vals), _t(d))
    _close(rr, r - np.asarray(jout))


@pytest.mark.parametrize("kind", KINDS)
def test_slab_corr_matches_reference(kind):
    rows, vals, _, r, _ = slab_case(kind)
    _close(ops.slab_corr(_t(rows), _t(vals), _t(r)),
           jops.slab_corr(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(r)))


@pytest.mark.parametrize("kind", ["sentinels", "adversarial"])
def test_sentinel_zeroed_matches_reference(kind):
    rows, vals, w, r, _ = slab_case(kind)
    n = w.shape[0]
    got = ops._sentinel_zeroed(_t(rows), _t(vals), _t(w), _t(r), n)
    want = jops._sentinel_zeroed(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(w),
                                 jnp.asarray(r), n)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got[2][rows >= n].abs().sum()) == 0.0      # no ghost weight


@pytest.mark.parametrize("n_loc,k", [(800, 10), (799, 10), (252_000, 95), (252_000, 178),
                                     (1024, 12), (8192, 32), (8192, 33)])
def test_prefer_slab_gram_is_the_reference_heuristic(n_loc, k):
    assert ops.prefer_slab_gram(n_loc, k) == jops.prefer_slab_gram(n_loc, k)


def test_batched_slab_ops_equal_per_block_calls():
    """The M feature blocks ride a leading batch axis: each block's
    result is the unbatched call's, bit for bit."""
    cases = [slab_case("adversarial", seed=s) for s in range(3)]
    rows, vals = (_t(np.stack([c[i] for c in cases])) for i in (0, 1))
    w = _t(cases[0][2])
    r = _t(np.stack([c[3] for c in cases]))
    d = _t(np.stack([c[4] for c in cases]))
    G, c = ops.slab_gram(rows, vals, w, r)
    out = ops.slab_spmv(rows, vals, d, n_loc=w.shape[0])
    for b in range(3):
        Gb, cb = ops.slab_gram(rows[b], vals[b], w, r[b])
        assert torch.equal(G[b], Gb) and torch.equal(c[b], cb)
        assert torch.equal(out[b], ops.slab_spmv(rows[b], vals[b], d[b], n_loc=w.shape[0]))


def test_slab_order_sorts_each_batch_row():
    rows = _t(np.stack([slab_case("adversarial", seed=s)[0] for s in range(2)]))
    order = slab_spmv.slab_order(rows)
    flat = rows.flatten(-2)
    assert order.rows_s.dtype == torch.int32 and order.perm.dtype == torch.int32
    assert torch.equal(flat.gather(-1, order.perm.long()), order.rows_s)
    assert bool((order.rows_s[:, 1:] >= order.rows_s[:, :-1]).all())


def _kernel_run_walk(rows, vals, w, r):
    """The card kernel's algorithm (``csrc/slab_gram.cu``) in numpy float32:
    each feature's slots sorted by row, the tile's slots in a stable
    row-sorted order, and per feature a its live slots in order, each
    adding w[x] v * v' for every slot (b, kb) of the run of its row x in
    that order (a slot alone in its run: its own product, to G[a, a]),
    a's slots outer and b's inner; c in slot order."""
    t, k = rows.shape
    n = w.shape[0]
    idx = np.argsort(np.minimum(rows, n), axis=-1, kind="stable")
    rows = np.take_along_axis(np.minimum(rows, n), idx, -1)
    vals = np.take_along_axis(vals, idx, -1)
    flat = rows.reshape(-1)
    perm = np.argsort(flat, kind="stable")
    pos = np.empty_like(perm)
    pos[perm] = np.arange(perm.size)
    G = np.zeros((t, t), np.float32)
    c = np.zeros(t, np.float32)
    for a in range(t):
        for ka in range(k):
            x = rows[a, ka]
            if x < n:
                cva = np.float32(vals[a, ka] * np.float32(w[x] * r[x]))
            else:
                cva = np.float32(0.0)
            c[a] = np.float32(c[a] + cva)
        for ka in range(k):
            x = rows[a, ka]
            if x >= n:
                break
            wa = np.float32(w[x] * vals[a, ka])
            j = pos[a * k + ka]
            if ((j == 0 or flat[perm[j - 1]] != x)
                    and (j + 1 == perm.size or flat[perm[j + 1]] != x)):
                G[a, a] = np.float32(G[a, a] + np.float32(wa * vals[a, ka]))
                continue
            while j > 0 and flat[perm[j - 1]] == x:
                j -= 1
            while j < perm.size and flat[perm[j]] == x:
                b, kb = divmod(int(perm[j]), k)
                G[a, b] = np.float32(G[a, b] + np.float32(wa * vals[b, kb]))
                j += 1
    return G, c, rows, vals


def _merge_walk(rows, vals, w):
    """A merge join of each pair of row-sorted slot lists, in numpy float32."""
    t, k = rows.shape
    n = w.shape[0]
    G = np.zeros((t, t), np.float32)
    for a in range(t):
        for b in range(t):
            ia = ib = 0
            while ia < k and ib < k and rows[a, ia] < n and rows[b, ib] < n:
                x, y = rows[a, ia], rows[b, ib]
                if x != y:
                    ia, ib = (ia + 1, ib) if x < y else (ia, ib + 1)
                    continue
                ea, eb = ia, ib
                while ea < k and rows[a, ea] == x:
                    ea += 1
                while eb < k and rows[b, eb] == x:
                    eb += 1
                for sa in range(ia, ea):
                    for ub in range(ib, eb):
                        G[a, b] = np.float32(G[a, b] + np.float32(
                            np.float32(w[x] * vals[a, sa]) * vals[b, ub]))
                ia, ib = ea, eb
    return G


@pytest.mark.parametrize("kind", KINDS)
def test_slab_gram_kernel_algorithm(kind):
    """The card kernel's run walk over the tile's row-sorted order gives
    the plain path's (G, c) and sums in a merge join's order: bit for bit
    the merge join's G, duplicates, sentinels and empty features
    included."""
    rows, vals, w, r, _ = slab_case(kind)
    G, c, rows_s, vals_s = _kernel_run_walk(rows, vals, w, r)
    pG, pc = ops.slab_gram(_t(rows), _t(vals), _t(w), _t(r))
    _close(G, pG)
    _close(c, pc)
    np.testing.assert_array_equal(G, _merge_walk(rows_s, vals_s, w))


@pytest.mark.parametrize("wrapper", ["slab_gram", "slab_spmv", "slab_gram rows int64",
                                     "slab_gram vals float64", "slab_gram w float64"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """No fallback: the kernels' wrappers take CUDA tensors of their types
    or raise."""
    rows, vals, w, r, d = (_t(a) for a in slab_case("plain"))
    if wrapper.startswith("slab_gram "):
        rows = rows.long() if "rows" in wrapper else rows
        vals = vals.double() if "vals" in wrapper else vals
        w = w.double() if " w " in wrapper else w
        with pytest.raises(TypeError):
            slab_gram.slab_gram_kernel(rows, vals, w, r, rows_sorted=True)
        assert slab_gram.launches == 0
        return
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "slab_gram":
            slab_gram.slab_gram_kernel(rows, vals, w, r, rows_sorted=True,
                                       order=slab_spmv.slab_order(rows))
        else:
            slab_spmv.slab_spmv_kernel(slab_spmv.slab_order(rows), vals, d,
                                       torch.zeros(w.shape[0]), n_loc=w.shape[0], sign=1.0)


def test_slab_gram_cpu_branch_ignores_the_order():
    """Off the card the gathers and the match join need no order: passing
    the tile's order changes nothing."""
    rows, vals, w, r, _ = (_t(a) for a in slab_case("adversarial"))
    G, c = ops.slab_gram(rows, vals, w, r)
    Go, co = ops.slab_gram(rows, vals, w, r, order=slab_spmv.slab_order(rows))
    assert torch.equal(G, Go) and torch.equal(c, co)


# ---------------------------------------------------------------------------
# designs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def designs():
    X = sparse_matrix(n=96, p=40, density=0.1, seed=3)
    out = {}
    for dp in (1, 2):
        out[dp] = (SlabDesign.from_dense(X, dp), JSlabDesign.from_dense(X, dp), X)
    return out


@pytest.mark.parametrize("dp", [1, 2])
def test_slab_design_matches_reference(designs, dp):
    td, jd, X = designs[dp]
    n, p = X.shape
    assert td.shape == jd.shape and (td.dp, td.n_loc, td.k) == (jd.dp, jd.n_loc, jd.k)
    rng = np.random.default_rng(dp)
    beta = (rng.standard_normal(p) * (rng.random(p) < 0.5)).astype(np.float32)
    v = rng.standard_normal(n).astype(np.float32)
    w = (0.1 + rng.random(n)).astype(np.float32)
    _close(td.margins(_t(beta)), jd.margins(jnp.asarray(beta)))
    _close(td.margins(_t(beta)), X @ beta)
    _close(td.correlation(_t(v)), jd.correlation(jnp.asarray(v)))
    for start, width in ((0, 16), (16, 16), (32, 8)):
        G, c = td.gram_tile(_t(w), _t(v), start, width)
        jG, jc = jd.gram_tile(jnp.asarray(w), jnp.asarray(v), start, width)
        _close(G, jG)
        _close(c, jc)
    np.testing.assert_array_equal(td.densify().numpy(), np.asarray(jd.densify()))
    assert td.densify() is td.densify()                     # cached
    np.testing.assert_array_equal(td.k_per_feature(), jd.k_per_feature())


def test_as_design_forms():
    X = sparse_matrix(n=64, p=12)
    bf = tbf.to_by_feature(X)
    d = as_design(bf)
    assert d.layout == "slab" and d.shape == (64, 12) and d.front_packed
    # raw slabs with interleaved sentinels: front-packing detected as False
    rows, vals = bf.row_idx.clone(), bf.values.clone()
    live = (rows < 64).sum(1)
    j = int(torch.nonzero((live > 0) & (live < rows.shape[1]))[0, 0])
    rows[j, 0], rows[j, -1] = 64, int(bf.row_idx[j, 0])
    vals[j, -1], vals[j, 0] = vals[j, 0], 0.0
    raw = as_design((rows, vals), n=64)
    assert raw.layout == "slab" and raw.front_packed is False
    np.testing.assert_array_equal(raw.densify().numpy(), X)
    assert as_design(X).layout == "dense"
    mesh = make_dev_mesh(1, 2, device="cpu")
    sharded = as_design(bf, mesh=mesh, tile=4)
    assert sharded.layout == "slab" and sharded.mdim == 2 and sharded.tile == 4
    with pytest.raises(ValueError, match="need n="):
        as_design((rows, vals))
    buckets = as_design(tbf.to_slab_buckets(bf, 1))
    assert buckets.layout == "bucketed" and buckets.shape == (64, 12)
    np.testing.assert_array_equal(buckets.densify().numpy(), X)
    # the reference's own SlabBuckets is not a port type
    with pytest.raises(TypeError, match="cannot build a design"):
        as_design(jbf.to_slab_buckets(jbf.to_by_feature(X), 1))


def test_make_dev_mesh():
    mesh = make_dev_mesh(1, 4, device="cpu")
    assert mesh.shape == {"data": 1, "model": 4}
    assert mesh.axis_names == ("data", "model") and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="process mesh"):
        make_dev_mesh(2, 4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_dev_mesh(1, 4)
