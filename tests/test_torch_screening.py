"""The port's screening primitives and working-set gathers
(``repro_torch.core.screening``, ``repro_torch.data.byfeature``,
``repro_torch.data.residency``) against the reference's
(``repro.core.screening``, ``repro.data.byfeature``) on the same numpy
inputs: masks, indices and slabs exactly, floats at atol = rtol = 1e-5.

* the strong rule and the KKT check, with gradients placed exactly on
  their float32 thresholds;
* the budgeted admission, a tie at the cutoff included, and its one host
  read;
* ``capacity_bucket``, ``k_class``, ``pack_indices``, the column gather
  and scatter;
* ``gather_features`` with and without ``k_cap``, ``to_slab_buckets``,
  ``take_features_buckets`` and ``gather_features_buckets``;
* the slab screen against the dense one, chunked or not, and the mesh
  designs' correlation and working-set gather.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.screening as jscr
import repro.data.byfeature as jbf
from repro.api import ShardedDesign as JShardedDesign
from repro.api import SlabDesign as JSlabDesign
from repro.data.residency import BucketResidencyManager as JBucketResidencyManager
from repro.launch.mesh import make_dev_mesh as j_make_dev_mesh
from repro_torch.api import BucketedSlabDesign, ShardedDesign, SlabDesign
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core import screening as scr
from repro_torch.data import byfeature as tbf
from repro_torch.data.residency import BucketResidencyManager
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.launch.mesh import make_dev_mesh

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def problem():
    ds = make_glm_dataset(GLMConfig(name="screen", num_examples=1280, num_features=150,
                                    density=0.05),
                          np.random.default_rng(11), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    # a few heavy features, so the buckets span several K classes
    rng = np.random.default_rng(5)
    for j in (3, 40, 77):
        X[rng.random(X.shape[0]) < 0.3, j] = rng.standard_normal(1)[0]
    bf = tbf.to_by_feature(X)
    return dict(X=X, y=y, bf=bf, jbf=jbf.to_by_feature(X))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("lam,lam_prev", [(1.0, 2.0), (0.7, 0.9), (0.3, 0.3), (2.0, 1.0)])
def test_strong_rule_and_kkt_match_reference(lam, lam_prev):
    rng = np.random.default_rng(int(lam * 100))
    g = rng.uniform(0, 3, 400).astype(np.float32)
    lam32, prev32 = np.float32(lam), max(np.float32(lam_prev), np.float32(lam))
    thresh = max(np.float32(2.0) * lam32 - prev32, lam32)
    # the reference's jitted slack is one fused multiply-add (one rounding)
    slack = np.float32(np.float64(lam32) * np.float64(np.float32(1.0) + np.float32(1e-3))
                       + np.float64(np.float32(1e-7)))
    g[:3] = thresh                                # exactly at the strong rule's threshold
    g[3:6] = np.nextafter(thresh, np.float32(0))
    g[6:9] = slack                                # exactly at the KKT slack
    g[9:12] = np.nextafter(slack, np.float32(10))
    beta = np.where(rng.random(400) < 0.1, rng.standard_normal(400), 0).astype(np.float32)
    mask = scr.strong_rule_mask(torch.from_numpy(g), lam, lam_prev, torch.from_numpy(beta))
    jmask = jscr.strong_rule_mask(jnp.asarray(g), lam, lam_prev, jnp.asarray(beta))
    _eq(mask, jmask)
    assert bool(mask[:3].all())
    sub = mask.clone()
    sub[::2] = False
    viol = scr.kkt_violations(torch.from_numpy(g), lam, sub, tol=1e-3)
    jviol = jscr.kkt_violations(jnp.asarray(g), lam, jnp.asarray(sub.numpy()), tol=1e-3)
    _eq(viol, jviol)


@pytest.mark.parametrize("budget", [2, 3, 16])
def test_budgeted_admission_matches_reference(budget):
    # 4.0 three times: a budget of 2 cuts inside the tie and admits all three
    g = np.asarray([9.0, 1.0, 5.0, 4.0, 4.0, 8.0, 4.0, 0.5], np.float32)
    viol = np.asarray([True, True, False, True, True, False, True, True])
    before = engine.host_syncs
    got = scr.budgeted_admission(torch.from_numpy(viol), torch.from_numpy(g), budget)
    assert engine.host_syncs == before + 1
    want = jscr.budgeted_admission(jnp.asarray(viol), jnp.asarray(g), budget)
    _eq(got, want)
    if budget == 2:
        _eq(got, [True, False, False, True, True, False, True, False])


def test_capacity_bucket_and_k_class_match_reference():
    for count in (0, 1, 15, 16, 17, 100, 129, 300, 513, 1024, 5000):
        for p in (16, 200, 1024, 4096):
            for tile in (1, 16, 128):
                assert scr.capacity_bucket(count, p, tile=tile) == \
                    jscr.capacity_bucket(count, p, tile=tile)
    for k_need in (0, 1, 7, 8, 9, 33, 64, 65, 94, 200):
        for k_max in (1, 8, 40, 94, 128):
            assert tbf.k_class(k_need, k_max) == jbf.k_class(k_need, k_max)
            assert tbf.k_class(k_need, k_max, k_min=4) == jbf.k_class(k_need, k_max, k_min=4)


@pytest.mark.parametrize("cap", [32, 64, 200])
def test_pack_indices_and_column_gather_match_reference(problem, cap):
    rng = np.random.default_rng(cap)
    X = problem["X"]
    p = X.shape[1]
    mask = rng.random(p) < 0.2
    beta = rng.standard_normal(p).astype(np.float32)
    idx = scr.pack_indices(torch.from_numpy(mask), min(cap, p))
    _eq(idx, jscr.pack_indices(jnp.asarray(mask), min(cap, p)))
    Xs, bs, idx = scr.gather_columns(torch.from_numpy(X), torch.from_numpy(beta),
                                     torch.from_numpy(mask), min(cap, p))
    jXs, jbs, jidx = jscr.gather_columns(jnp.asarray(X), jnp.asarray(beta), jnp.asarray(mask),
                                         min(cap, p))
    _eq(Xs, jXs)
    _eq(bs, jbs)
    _eq(idx, jidx)
    back = scr.scatter_columns(bs, idx, p)
    _eq(back, jscr.scatter_columns(jbs, jidx, p))
    _eq(back, np.where(mask, beta, 0.0))


@pytest.mark.parametrize("k_cap", [None, 8, 16, 128])
@pytest.mark.parametrize("mesh_form", [False, True])
def test_gather_features_matches_reference(problem, k_cap, mesh_form):
    bf, n = problem["bf"], problem["bf"].n
    rows, vals = bf.row_idx.numpy(), bf.values.numpy()
    if mesh_form:
        rows, vals = rows[:, None, :], vals[:, None, :]
    p = rows.shape[0]
    rng = np.random.default_rng(3)
    mask = rng.random(p) < 0.3
    mask[3] = True                      # a heavy feature: k_cap trims it
    beta = rng.standard_normal(p).astype(np.float32)
    got = tbf.gather_features(torch.from_numpy(rows), torch.from_numpy(vals),
                              torch.from_numpy(beta), torch.from_numpy(mask), 64,
                              sentinel=n, k_cap=k_cap)
    want = jbf.gather_features(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(beta),
                               jnp.asarray(mask), 64, sentinel=n, k_cap=k_cap)
    for a, b in zip(got, want):
        _eq(a, b)
    if not mesh_form and k_cap is None:
        sub, bsub, idx = bf.gather(torch.from_numpy(beta), torch.from_numpy(mask), 64)
        jsub, jbsub, jidx = problem["jbf"].gather(jnp.asarray(beta), jnp.asarray(mask), 64)
        _eq(sub.row_idx, jsub.row_idx)
        _eq(sub.values, jsub.values)
        _eq(tbf.scatter_features(bsub, idx, p), jbf.scatter_features(jbsub, jidx, p))


def test_slab_buckets_and_bucket_gathers_match_reference(problem):
    sb = tbf.to_slab_buckets(problem["bf"], 1)
    jsb = jbf.to_slab_buckets(problem["jbf"], 1)
    assert len(sb.buckets) >= 3 and sb.k_classes == jsb.k_classes
    assert (sb.n_loc, sb.p) == (jsb.n_loc, jsb.p) and sb.nbytes == jsb.nbytes
    for (r, v, f), (jr, jv, jf) in zip(sb.buckets, jsb.buckets):
        _eq(r, jr)
        _eq(v, jv)
        _eq(f, jf)
    _eq(sb.feat_order, jsb.feat_order)
    rng = np.random.default_rng(9)
    idx = rng.permutation(sb.p + 20)[:64]           # sentinels past the extent too
    for k_cap in (8, 32, max(sb.k_classes)):
        got = tbf.take_features_buckets(sb, torch.from_numpy(idx), k_cap)
        want = jbf.take_features_buckets(jsb, jnp.asarray(idx), k_cap)
        for a, b in zip(got, want):
            _eq(a, b)
    mask = rng.random(sb.p) < 0.25
    beta = rng.standard_normal(sb.p).astype(np.float32)
    got = tbf.gather_features_buckets(sb, torch.from_numpy(beta), torch.from_numpy(mask), 64, 16)
    want = jbf.gather_features_buckets(jsb, jnp.asarray(beta), jnp.asarray(mask), 64, 16)
    for a, b in zip(got, want):
        _eq(a, b)


@pytest.mark.parametrize("chunk", [scr.CORR_CHUNK, 7])
def test_slab_screen_equals_dense(problem, monkeypatch, chunk):
    """The slab screen equals the dense screen on the densified matrix and
    the reference's slab screen, at zero margins and at a warm start; the
    mesh pass gives the same bits at any chunking of the feature axis."""
    monkeypatch.setattr(scr, "CORR_CHUNK", chunk)
    X, y, bf = problem["X"], problem["y"], problem["bf"]
    rng = np.random.default_rng(4)
    mesh = make_dev_mesh(1, 1, device="cpu")
    for m in (np.zeros(len(y), np.float32),
              (X @ (0.05 * rng.standard_normal(X.shape[1]))).astype(np.float32)):
        tm, ty = torch.from_numpy(m), torch.from_numpy(y)
        g_sparse = scr.nll_grad_abs_sparse(bf.row_idx, bf.values, ty, tm)
        np.testing.assert_allclose(g_sparse, scr.nll_grad_abs(torch.from_numpy(X), ty, tm),
                                   **TOL)
        np.testing.assert_allclose(
            g_sparse, jscr.nll_grad_abs_sparse(problem["jbf"].row_idx, problem["jbf"].values,
                                               jnp.asarray(y), jnp.asarray(m)), **TOL)
        p_pad = -(-bf.p // 16) * 16
        rows = torch.full((p_pad, 1, bf.row_idx.shape[1]), bf.n, dtype=torch.int32)
        vals = torch.zeros(p_pad, 1, bf.row_idx.shape[1])
        rows[:bf.p, 0], vals[:bf.p, 0] = bf.row_idx, bf.values
        g_mesh = scr.make_sparse_screen(mesh, bf.n, 16)(rows, vals, ty, tm)
        assert torch.equal(g_mesh[:bf.p], g_sparse) and not g_mesh[bf.p:].any()


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_sharded_slab_design_matches_reference(problem, layout):
    """A (1, 1)-mesh slab design: correlation, margins, the working-set
    gather and scatter, and the residency counters."""
    X, y, bf = problem["X"], problem["y"], problem["bf"]
    n, p = X.shape
    rows, vals, _ = tbf.to_slabs(bf, 1)
    if layout == "flat":
        inner = SlabDesign(rows, vals, n)
        jinner = JSlabDesign(jnp.asarray(rows.numpy()), jnp.asarray(vals.numpy()), n)
    else:
        inner = BucketedSlabDesign.from_by_feature(bf)
        from repro.api import BucketedSlabDesign as JBucketed

        jinner = JBucketed.from_by_feature(problem["jbf"])
    d = ShardedDesign(inner, make_dev_mesh(1, 1, device="cpu"), tile=16)
    jd = JShardedDesign(jinner, j_make_dev_mesh(1, 1), tile=16)
    rng = np.random.default_rng(8)
    v = rng.standard_normal(n).astype(np.float32)
    beta = np.where(rng.random(p) < 0.3, rng.standard_normal(p), 0).astype(np.float32)
    before = engine.host_syncs
    np.testing.assert_allclose(d.correlation(torch.from_numpy(v)),
                               jd.correlation(jnp.asarray(v)), **TOL)
    assert engine.host_syncs == before + 1          # the buckets' row bound, once
    np.testing.assert_allclose(d.margins(torch.from_numpy(beta)),
                               jd.margins(jnp.asarray(beta)), **TOL)
    assert engine.host_syncs == before + 1
    mask = beta != 0
    sub, bsub, idx = d.gather(torch.from_numpy(beta), torch.from_numpy(mask), 64, k_cap=32)
    jsub, jbsub, jidx = jd.gather(jnp.asarray(beta), jnp.asarray(mask), 64, k_cap=32)
    _eq(sub.inner.row_idx, jsub.inner.row_idx)
    _eq(sub.inner.values, jsub.inner.values)
    _eq(idx, jidx)
    _eq(d.scatter(bsub, idx), jd.scatter(jbsub, jidx))
    _eq(d.scatter(bsub, idx), beta)
    assert d.slab_nbytes(16) == jd.slab_nbytes(16)
    st, jst = d._mesh_state(16), jd._mesh_state(16)
    assert (st.p_work, st.k_max, st.cap_tile) == (jst.p_work, jst.k_max, jst.cap_tile)
    _eq(st.feat_map, jst.feat_map)
    _eq(st.k_arr, jst.k_arr)
    _eq(inner.k_per_feature(), jinner.k_per_feature())
    stats, jstats = d.residency_stats()[16], jd.residency_stats()[16]
    for key in ("streamed", "n_buckets", "total_bytes", "puts", "bytes_h2d"):
        assert stats[key] == jstats[key], key


def test_residency_manager_resident_only(problem):
    sb = tbf.to_slab_buckets(problem["bf"], 1)
    mgr = BucketResidencyManager(sb.buckets, device="cpu")
    jmgr = JBucketResidencyManager(tuple((r.numpy(), v.numpy(), f) for r, v, f in sb.buckets))
    got = list(mgr.iter_buckets())
    assert len(got) == len(list(jmgr.iter_buckets())) == len(sb.buckets)
    # each step's prefetch of the next bucket is a hit too, as the reference counts
    assert mgr.stats() == jmgr.stats() and mgr.stats()["hits"] == 2 * len(sb.buckets) - 1
    assert mgr.stats()["puts"] == len(sb.buckets) and not mgr.stats()["streamed"]
    # a budget one byte short of the buckets streams them, as the reference
    streamed = BucketResidencyManager(sb.buckets, device="cpu", budget_bytes=sb.nbytes - 1)
    jstreamed = JBucketResidencyManager(
        tuple((r.numpy(), v.numpy(), f) for r, v, f in sb.buckets), budget_bytes=sb.nbytes - 1)
    assert streamed.streamed and streamed.stats() == jstreamed.stats()
    assert streamed.stats()["puts"] == 0 and streamed.min_budget_bytes == jstreamed.min_budget_bytes
    assert len(list(streamed.iter_buckets())) == len(list(jstreamed.iter_buckets()))
    assert streamed.stats() == jstreamed.stats()
    assert streamed.resident_bytes <= sb.nbytes - 1
