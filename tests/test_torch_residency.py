"""The port's streamed bucket residency (``repro_torch.data.residency``,
``ShardedDesign(device_budget_bytes=)``, ``Strategy.residency``) against
the reference's (``repro.data.residency.BucketResidencyManager``,
``repro.api``) on the same numpy buckets, on the CPU:

* the manager: ``min_budget_bytes``, the budget floor's error, the LRU
  order, and every counter after the same ``get`` / ``iter_buckets``
  sequence; the prefetch before the yield, the reentrancy guard, out of
  range; a put that fails once is retried, exhaustion raises
  ``RetriesExhausted``;
* ``resolve(...).residency`` as the reference resolves it;
* a streamed path equal to a resident one bit for bit on (1, 1) and
  (1, 4) meshes, over >= 3 buckets of mixed-density X;
* the port's streamed path against the reference's streamed path point
  by point (f gap < 1e-4, betas within rtol 1e-2 / atol 1e-3, counts
  equal) with the same misses, evictions, puts and bytes moved.

The reference runs on ``make_dev_mesh(1, 1)``: no fake-device process.
"""
import numpy as np
import pytest
import torch

import repro.data.byfeature as jbf
from repro.api import LogisticL1 as JLogisticL1
from repro.api import as_design as j_as_design
from repro.api import resolve as j_resolve
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.data.residency import BucketResidencyManager as JManager
from repro.launch.mesh import make_dev_mesh as j_make_dev_mesh
from repro_torch.api import LogisticL1, as_design, resolve
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data import byfeature as tbf
from repro_torch.data import residency
from repro_torch.data.residency import BucketResidencyManager
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.resilience import RetriesExhausted

torch.set_num_threads(2)
TILE = 16


def _buckets(sizes=(2, 3, 1, 2), k=8):
    """Host buckets of unequal sizes: (row_idx, values, feat_idx) numpy
    triples of p_b * k * 8 bytes each."""
    out, off = [], 0
    for i, p_b in enumerate(sizes):
        r = np.full((p_b, 1, k), i, np.int32)
        v = np.ones((p_b, 1, k), np.float32) * i
        out.append((r, v, np.arange(p_b) + off))
        off += p_b
    return tuple(out)


def _torch_buckets(buckets):
    return tuple((torch.from_numpy(r), torch.from_numpy(v), f) for r, v, f in buckets)


def _mixed_density_X(n, p, seed=0):
    """Stratified per-column nnz: several power-of-two K classes (streaming
    needs >= 3 buckets to ever evict)."""
    rng = np.random.default_rng(seed)
    levels = [4, 12, 28, min(60, n // 2)]
    X = np.zeros((n, p), np.float32)
    for j in range(p):
        rows = rng.choice(n, size=levels[j % len(levels)], replace=False)
        X[rows, j] = rng.normal(size=rows.size).astype(np.float32)
    return X


def _labels(X, seed=1):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=X.shape[1]) * (rng.random(X.shape[1]) < 0.3)
    prob = 1.0 / (1.0 + np.exp(-(X @ w)))
    return np.where(rng.random(X.shape[0]) < prob, 1.0, -1.0).astype(np.float32)


@pytest.fixture(scope="module")
def mixed():
    X = _mixed_density_X(128, 48)
    return X, _labels(X)


# ---------------------------------------------------------------------------
# the manager against the reference's
# ---------------------------------------------------------------------------

def test_manager_floor_and_counters_match_reference():
    hb = _buckets()
    total = sum(r.nbytes + v.nbytes for r, v, _ in hb)
    port = BucketResidencyManager(_torch_buckets(hb), device="cpu", budget_bytes=total - 1)
    ref = JManager(hb, budget_bytes=total - 1)
    assert port.min_budget_bytes == ref.min_budget_bytes == (3 + 1) * 64 + 64
    assert port.streamed and ref.streamed
    for cls, kw in ((BucketResidencyManager, dict(device="cpu")), (JManager, {})):
        src = _torch_buckets(hb) if cls is BucketResidencyManager else hb
        with pytest.raises(ValueError, match=f"raise the budget to >= {ref.min_budget_bytes}"):
            cls(src, budget_bytes=ref.min_budget_bytes - 1, **kw)
    # the same accesses: single gets (hits, misses, LRU evictions), two
    # full passes, then gets again; the LRU order and all counters agree
    # after every step
    budget = ref.min_budget_bytes + 64
    port = BucketResidencyManager(_torch_buckets(hb), device="cpu", budget_bytes=budget)
    ref = JManager(hb, budget_bytes=budget)
    steps = [("get", 0), ("get", 1), ("get", 0), ("get", 3), ("get", 2), ("iter", None),
             ("get", 1), ("iter", None), ("get", 3), ("get", 0)]
    for what, i in steps:
        if what == "get":
            pr, jr = port.get(i), ref.get(i)
            np.testing.assert_array_equal(pr[1].numpy(), np.asarray(jr[1]))
        else:
            got = [(r.numpy(), f) for r, _, f in port.iter_buckets()]
            want = [(np.asarray(r), f) for r, _, f in ref.iter_buckets()]
            for (a, fa), (b, fb) in zip(got, want, strict=True):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(fa, fb)
        assert port.resident_indices() == ref.resident_indices(), (what, i)
        assert port.stats() == ref.stats(), (what, i)
        assert port.resident_bytes <= budget
    s = port.stats()
    assert s["evictions"] > 0 and s["misses"] > s["n_buckets"] and s["hits"] > 0


def test_resident_manager_matches_reference():
    hb = _buckets()
    total = sum(r.nbytes + v.nbytes for r, v, _ in hb)
    for budget in (None, total):
        port = BucketResidencyManager(_torch_buckets(hb), device="cpu", budget_bytes=budget)
        ref = JManager(hb, budget_bytes=budget)
        assert not port.streamed and port.stats() == ref.stats()
        list(port.iter_buckets()), list(ref.iter_buckets())
        assert port.stats() == ref.stats() and port.stats()["misses"] == 0


def test_iteration_prefetches_is_not_reentrant_and_checks_range():
    hb = _buckets()
    total = sum(r.nbytes + v.nbytes for r, v, _ in hb)
    mgr = BucketResidencyManager(_torch_buckets(hb), device="cpu", budget_bytes=total - 1)
    it = mgr.iter_buckets()
    next(it)
    # bucket 1's put was dispatched before bucket 0 was yielded
    assert mgr.stats()["puts"] == 2 and set(mgr.resident_indices()) >= {0, 1}
    with pytest.raises(RuntimeError, match="not reentrant"):
        next(mgr.iter_buckets())
    assert len(list(it)) == len(hb) - 1          # the first pass still completes
    assert len(list(mgr.iter_buckets())) == len(hb)
    for i in (-1, len(hb)):
        with pytest.raises(IndexError, match="out of range"):
            mgr.get(i)


def test_put_is_retried_then_exhausted(monkeypatch):
    hb = _buckets()
    total = sum(r.nbytes + v.nbytes for r, v, _ in hb)
    real = residency.put_slab
    fails = {"left": 1}

    def flaky(r, v, device):
        if fails["left"]:
            fails["left"] -= 1
            raise RuntimeError("transient device allocation failure")
        return real(r, v, device)

    monkeypatch.setattr(residency, "put_slab", flaky)
    mgr = BucketResidencyManager(_torch_buckets(hb), device="cpu", budget_bytes=total - 1,
                                 retry_base_s=0.0)
    r, v = mgr.get(2)
    np.testing.assert_array_equal(v.numpy(), hb[2][1])
    assert mgr.stats()["retries"] == 1 and mgr.stats()["puts"] == 1
    fails["left"] = 10
    with pytest.raises(RetriesExhausted, match="gave up after 3 attempts") as info:
        mgr.get(3)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert mgr.stats()["retries"] == 3 and mgr.stats()["puts"] == 1


# ---------------------------------------------------------------------------
# strategy and the streamed path
# ---------------------------------------------------------------------------

def test_resolve_residency_matches_reference(mixed):
    X, _ = mixed
    slabs = tbf.to_slab_buckets(tbf.to_by_feature(X), 1)
    jslabs = jbf.to_slab_buckets(jbf.to_by_feature(X), 1)
    mesh, jmesh = make_dev_mesh(1, 1, device="cpu"), j_make_dev_mesh(1, 1)
    total = as_design(slabs, mesh=mesh, tile=TILE).slab_nbytes(TILE)
    assert total == j_as_design(jslabs, mesh=jmesh, tile=TILE).slab_nbytes(TILE)
    for budget in (None, total // 2, total - 1, total, 10 * total):
        d = as_design(slabs, mesh=mesh, tile=TILE, device_budget_bytes=budget)
        jd = j_as_design(jslabs, mesh=jmesh, tile=TILE, device_budget_bytes=budget)
        got = resolve(d, DGLMNETOptions(tile=TILE)).residency
        assert got == j_resolve(jd, JOptions(tile=TILE)).residency
        assert got == ("streamed" if budget is not None and budget < total else "resident")
    for mod_as, mod_resolve, m, opts in ((as_design, resolve, mesh, DGLMNETOptions),
                                         (j_as_design, j_resolve, jmesh, JOptions)):
        dense = mod_as(X, mesh=m, tile=TILE, device_budget_bytes=1024)
        with pytest.raises(ValueError, match="streams slab layouts only"):
            mod_resolve(dense, opts(tile=TILE))


def _path_pair(X, y, mesh, path_len=3):
    """(resident, streamed, streamed design) port paths over the same
    buckets, the budget one smallest bucket below the slab bytes."""
    slabs = tbf.to_slab_buckets(tbf.to_by_feature(X), 1)
    assert len(slabs.buckets) >= 3, slabs.k_classes
    opts = DGLMNETOptions(tile=TILE, max_iters=30)
    base = LogisticL1(opts, mesh=mesh, device="cpu").path(
        as_design(slabs, mesh=mesh, tile=TILE), y, path_len=path_len)
    sizing = as_design(slabs, mesh=mesh, tile=TILE)
    budget = sizing.slab_nbytes(TILE) - min(sizing.slab_bucket_nbytes(TILE))
    des = as_design(slabs, mesh=mesh, tile=TILE, device_budget_bytes=budget)
    assert resolve(des, opts).residency == "streamed"
    streamed = LogisticL1(opts, mesh=mesh, device="cpu").path(des, y, path_len=path_len)
    return base, streamed, des


@pytest.mark.parametrize("M", [1, 4])
def test_streamed_path_bit_identical_to_resident(mixed, M):
    X, y = mixed
    base, streamed, des = _path_pair(X, y, make_dev_mesh(1, M, device="cpu"))
    assert torch.equal(streamed.betas, base.betas)
    assert np.array_equal(streamed.f, base.f) and np.array_equal(streamed.nnz, base.nnz)
    assert streamed.screen == base.screen
    (stats,) = des.residency_stats().values()
    assert stats["streamed"] and stats["evictions"] > 0
    assert stats["misses"] > stats["n_buckets"]          # re-streamed across passes
    assert stats["bytes_h2d"] > stats["total_bytes"]
    assert stats["resident_bytes"] <= stats["budget_bytes"]


def test_streamed_path_matches_reference(mixed):
    X, y = mixed
    mesh, jmesh = make_dev_mesh(1, 1, device="cpu"), j_make_dev_mesh(1, 1)
    _, port, des = _path_pair(X, y, mesh)
    jslabs = jbf.to_slab_buckets(jbf.to_by_feature(X), 1)
    budget = des.device_budget_bytes
    jdes = j_as_design(jslabs, mesh=jmesh, tile=TILE, device_budget_bytes=budget)
    ref = JLogisticL1(opts=JOptions(tile=TILE, max_iters=30), mesh=jmesh).path(
        jdes, y, path_len=3)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert abs(a.lam - b.lam) <= 1e-6 * b.lam
        assert abs(a.f - b.f) / abs(b.f) < 1e-4, (a.f, b.f)
        np.testing.assert_allclose(a.beta.numpy(), np.asarray(b.beta), rtol=1e-2, atol=1e-3)
        assert a.nnz == b.nnz and a.screen == b.screen
    (stats,) = des.residency_stats().values()
    (jstats,) = jdes.residency_stats().values()
    for key in ("streamed", "n_buckets", "budget_bytes", "total_bytes", "misses",
                "evictions", "puts", "bytes_h2d", "hits", "resident_bytes"):
        assert stats[key] == jstats[key], (key, stats[key], jstats[key])
