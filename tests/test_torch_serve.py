"""The port's serving slice (``repro_torch.serve``,
``ops.slab_path_spmv``, ``launch/serve_glm.py``) against the reference's
``repro.serve`` on the same numpy inputs, on the CPU:

* ingestion (``hash_token``, ``encode_request``, ``k_capacity``,
  ``batch_capacity``, ``pack_requests``) bit-equal to the reference's;
* the batcher's stats under overload and deadline shedding, on an
  injected clock, equal to the reference's;
* the plain ``slab_path_spmv`` within rtol = atol = 1e-5 of the
  reference's, and at a uniform lambda bit-equal to the port's
  ``slab_spmv``;
* served scores bit-equal to ``decision_function`` on a local store and
  on a (1, 4) mesh store; a path the reference saved, served by the port,
  within 1e-5 of the reference's served scores;
* hot swaps under threads never mix versions, a swap frees the old
  stack, a NaN version is quarantined, the geometry is validated, and
  the launcher's smoke run passes.
"""
import gc
import os
import subprocess
import sys
import threading
import weakref
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.api import LogisticL1 as JLogisticL1
from repro.kernels.ops import slab_path_spmv as j_slab_path_spmv
from repro_torch.api import LogisticL1, PathResult, ShardedDesign, SlabDesign
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.resilience import RetriesExhausted
from repro_torch.serve import (InvalidRequest, NonFiniteScores, Overloaded, PathScorer,
                               PathStore, RequestBatcher, batch_capacity, encode_request,
                               hash_token, k_capacity, pack_requests)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 8


def _problem(seed=0, n=64, p=24, density=0.2):
    rng = np.random.default_rng(seed)
    X = ((rng.random((n, p)) < density) * rng.normal(size=(n, p))).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    return X, y


def _traffic(rng, p, count, tokens_per=12):
    return [{f"tok{t}": float(v) for t, v in zip(rng.integers(0, 4 * p, size=k),
                                                  rng.normal(size=k))}
            for k in rng.integers(1, tokens_per + 1, size=count)]


def _tokens_for(p):
    """One token per column that hashes exactly to that column."""
    toks = {}
    for j in range(p):
        t = 0
        while hash_token(f"tok{j}_{t}", p) != j:
            t += 1
        toks[j] = f"tok{j}_{t}"
    return toks


@pytest.fixture(scope="module")
def fitted():
    X, y = _problem()
    path = LogisticL1(DGLMNETOptions(tile=TILE), device="cpu").path(X, y, path_len=5)
    return X, y, path


def _rows_batch(X, p_pad_to=1):
    toks = _tokens_for(X.shape[1])
    reqs = [{toks[j]: float(X[i, j]) for j in range(X.shape[1]) if X[i, j] != 0.0}
            for i in range(X.shape[0])]
    return pack_requests([encode_request(r, X.shape[1]) for r in reqs], X.shape[1],
                         pad_p_to=p_pad_to)


# ---------------------------------------------------------------------------
# ingestion and batching against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,count,dp,pad_p_to,k_min", [
    (24, 10, 1, 1, 8), (50, 37, 2, 16, 4), (1000, 64, 1, 128, 8), (7, 0, 1, 1, 8)])
def test_ingest_bit_equal_to_reference(p, count, dp, pad_p_to, k_min):
    rng = np.random.default_rng(p + count)
    reqs = _traffic(rng, p, count) + [{}, {"a": 0.0, "b": 0.0}]
    # colliding tokens sum in sorted-token order, whatever the insertion order
    reqs.append(dict(reversed(list(_traffic(np.random.default_rng(1), 3, 1, 40)[0].items()))))
    for tok in ("tok1", "x", "été"):
        assert hash_token(tok, p) == jserve.hash_token(tok, p)
    enc, jenc = [], []
    for r in reqs:
        a, b = encode_request(r, p), jserve.encode_request(r, p)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == b[1].dtype == np.float32
        enc.append(a), jenc.append(b)
    for k in (0, 1, 8, 9, 100):
        assert k_capacity(k, k_min=k_min) == jserve.k_capacity(k, k_min=k_min)
    for b in (0, 1, 9, 300, 5000):
        assert batch_capacity(b) == jserve.batch_capacity(b)
    cap = batch_capacity(len(enc)) * dp
    got = pack_requests(enc, p, batch_cap=cap, dp=dp, pad_p_to=pad_p_to, k_min=k_min)
    want = jserve.pack_requests(jenc, p, batch_cap=cap, dp=dp, pad_p_to=pad_p_to, k_min=k_min)
    for f in ("row_idx", "values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.n_live, got.batch_cap, got.p, got.n_loc, got.p_pad) == \
        (want.n_live, want.batch_cap, want.p, want.n_loc, want.p_pad)
    with pytest.raises(InvalidRequest, match="non-finite"):
        encode_request({"a": float("nan")}, p)
    with pytest.raises(ValueError, match="power of two"):
        batch_capacity(4, b_min=10)


def test_batcher_stats_match_reference_under_overload_and_ttl():
    p = 32
    now = {"t": 100.0}
    clock = lambda: now["t"]  # noqa: E731
    kw = dict(max_batch=8, max_pending=12, default_ttl_s=5.0, clock=clock, pad_p_to=16)
    port, ref = RequestBatcher(p, **kw), jserve.RequestBatcher(p, **kw)
    reqs = _traffic(np.random.default_rng(3), p, 20)
    for i, r in enumerate(reqs):
        outcomes = []
        for b in (port, ref):
            try:
                b.submit(r, 0.1 * (i + 1), deadline_s=1.0 if i % 3 == 0 else None)
                outcomes.append("ok")
            except (Overloaded, jserve.Overloaded):
                outcomes.append("overloaded")
        assert outcomes[0] == outcomes[1]
        now["t"] += 0.25
    for b in (port, ref):
        with pytest.raises(ValueError):
            b.submit({"a": float("inf")}, 0.1)
    assert port.stats == ref.stats and len(port) == len(ref) == 12
    for _ in range(3):
        (gb, gl), (rb, rl) = port.drain(), ref.drain()
        np.testing.assert_array_equal(gb.row_idx, rb.row_idx)
        np.testing.assert_array_equal(gb.values, rb.values)
        np.testing.assert_array_equal(gl, rl)
        assert port.mark_scored() == ref.mark_scored() == gb.n_live
        assert port.stats == ref.stats
        now["t"] += 1.0
    s = port.stats
    assert s["rejected_overload"] == 8 and s["rejected_invalid"] == 1 and s["shed_expired"] > 0
    assert port.mark_scored() == 0
    with pytest.raises(ValueError, match="power of two"):
        RequestBatcher(p, max_batch=12)


# ---------------------------------------------------------------------------
# the scoring primitive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead", [(), (3,)])
def test_plain_slab_path_spmv_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    T, K, n, L = 40, 6, 30, 5
    B = int(np.prod(lead)) if lead else 1
    rows = rng.integers(0, n + 3, size=(B, T, K)).astype(np.int32)
    vals = rng.normal(size=(B, T, K)).astype(np.float32)
    betas = rng.normal(size=(L, B, T)).astype(np.float32)
    lam_idx = rng.integers(0, L, size=n).astype(np.int32)
    # allow[nonfinite-guard]: the reference's plain product is this test's oracle
    want = np.stack([np.asarray(j_slab_path_spmv(jnp.asarray(rows[b]), jnp.asarray(vals[b]),
                                                 jnp.asarray(lam_idx), jnp.asarray(betas[:, b]),
                                                 n_loc=n)) for b in range(B)])
    shp = lambda a: torch.from_numpy(a.reshape(*lead, *a.shape[1:]))  # noqa: E731
    got = ops.slab_path_spmv(shp(rows), shp(vals), torch.from_numpy(lam_idx),
                             torch.from_numpy(betas.reshape(L, *lead, T)), n_loc=n)
    np.testing.assert_allclose(got.numpy().reshape(B, n), want, rtol=1e-5, atol=1e-5)
    for lam in range(L):
        u = ops.slab_path_spmv(shp(rows), shp(vals), torch.full((n,), lam, dtype=torch.int32),
                               torch.from_numpy(betas.reshape(L, *lead, T)), n_loc=n)
        d = torch.from_numpy(betas[lam].reshape(*lead, T))
        assert torch.equal(u, ops.slab_spmv(shp(rows), shp(vals), d, n_loc=n))


def test_path_kernel_refuses_cpu_tensors():
    """The path mode's wrapper launches its kernel or raises: CPU tensors
    go to the plain version only through ``ops``."""
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")

    rows = torch.tensor([[0, 2], [1, 5]], dtype=torch.int32)
    vals = torch.ones(2, 2)
    before = slab_spmv.path_launches
    with pytest.raises(ValueError, match="CUDA"):
        slab_spmv.slab_path_spmv_kernel(slab_spmv.slab_order(rows, vals), vals,
                                        torch.zeros(5, dtype=torch.int32), torch.ones(1, 2),
                                        torch.zeros(5), n_loc=5)
    assert slab_spmv.path_launches == before


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [None, 4])
def test_served_scores_bit_equal_decision_function(fitted, M):
    X, _, path = fitted
    mesh = None if M is None else make_dev_mesh(1, M, device="cpu")
    store = PathStore(path, mesh=mesh, tile=TILE, device="cpu")
    scorer = PathScorer(store)
    batch = _rows_batch(X, store.pad_p_to)
    inner = SlabDesign(torch.from_numpy(batch.row_idx), torch.from_numpy(batch.values),
                       batch.batch_cap)
    design = inner if mesh is None else ShardedDesign(inner, mesh, tile=TILE)
    est = LogisticL1(DGLMNETOptions(tile=TILE), mesh=mesh, device="cpu")
    reads = engine.host_syncs
    for lam in range(len(path)):
        got, ver = scorer.score(batch, np.full(X.shape[0], path.lambdas[lam]))
        beta = torch.nn.functional.pad(path.betas[lam], (0, batch.p_pad - X.shape[1]))
        want = est.decision_function(design, beta=beta).numpy()[:X.shape[0]]
        assert ver == 1 and np.array_equal(got, want), lam
        # and the dense product, to float tolerance
        np.testing.assert_allclose(got, X @ path.betas[lam].numpy(), rtol=1e-5, atol=1e-5)
    # one counted read per scored batch, plus the mesh design's row bound
    assert engine.host_syncs - reads == len(path) + (M is not None)
    mixed = np.asarray(path.lambdas)[np.arange(X.shape[0]) % len(path)]
    got, _ = scorer.score(batch, mixed)
    want = np.einsum("ij,ij->i", X, path.betas.numpy()[np.arange(X.shape[0]) % len(path)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_checkpoint_serves_from_the_port(tmp_path):
    X, y = _problem(seed=4)
    ref_path = JLogisticL1().path(X, y, path_len=4)
    d = ref_path.save(str(tmp_path / "ref"))
    p = X.shape[1]
    reqs = _traffic(np.random.default_rng(9), p, 30)
    lams = np.asarray(ref_path.lambdas)[np.arange(30) % len(ref_path)]
    jbatch = jserve.pack_requests([jserve.encode_request(r, p) for r in reqs], p)
    want, _ = jserve.PathScorer(jserve.PathStore(ref_path)).score(jbatch, lams)
    store = PathStore.from_checkpoint(d, device="cpu")
    got, ver = PathScorer(store).score(
        pack_requests([encode_request(r, p) for r in reqs], p), lams)
    assert ver == 1
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    os.remove(os.path.join(d, "arrays.npz"))
    with pytest.raises(RetriesExhausted, match="CheckpointCorruption"):
        PathStore.from_checkpoint(d, device="cpu", attempts=2)


def test_hot_swap_under_threads_never_mixes_versions(fitted):
    X, _, path = fitted
    batch = _rows_batch(X)
    lams = np.full(X.shape[0], float(path.lambdas[-1]))
    flip = PathResult(lambdas=path.lambdas, betas=-path.betas, nnz=path.nnz, f=path.f,
                      n_iters=path.n_iters)
    store = PathStore(path, device="cpu")
    scorer = PathScorer(store)
    ref = {1: scorer.score(batch, lams)[0]}
    store.swap(flip)
    ref[0] = scorer.score(batch, lams)[0]
    assert not np.array_equal(ref[0], ref[1])
    stop = threading.Event()

    def swapper():
        i = 0
        while not stop.is_set():
            store.swap((path, flip)[i % 2])
            i += 1

    t = threading.Thread(target=swapper)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t.start()
    try:
        for _ in range(60):
            got, ver = scorer.score(batch, lams)
            assert np.array_equal(got, ref[ver % 2]), "a batch blended two versions"
    finally:
        stop.set()
        t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not t.is_alive()


def test_swap_releases_the_old_stack(fitted):
    X, _, path = fitted
    batch = pack_requests([encode_request({"a": 1.0}, X.shape[1])], X.shape[1])
    lam = np.full(1, float(path.lambdas[0]))
    version = lambda s: PathResult(lambdas=path.lambdas, betas=s * path.betas,  # noqa: E731
                                   nnz=path.nnz, f=path.f, n_iters=path.n_iters)
    store = PathStore(version(1.0), device="cpu")
    scorer = PathScorer(store)
    scorer.score(batch, lam)
    s0 = store.snapshot
    refs = weakref.ref(s0), weakref.ref(s0.betas)
    store.swap(version(-1.0))
    gc.collect()
    assert refs[0]() is not None, "the last-good snapshot went too early"
    store.swap(version(0.5))          # v1 falls off the one-deep last-good slot
    scorer.score(batch, lam)
    del s0
    gc.collect()
    assert refs[0]() is None and refs[1]() is None, "a retired stack is still held"


def test_nan_version_is_quarantined(fitted):
    X, _, path = fitted
    batch = _rows_batch(X)
    lams = np.full(X.shape[0], float(path.lambdas[-1]))
    store = PathStore(path, device="cpu")
    scorer = PathScorer(store)
    good, _ = scorer.score(batch, lams)
    bad_betas = path.betas.clone()
    col = int(torch.nonzero(path.betas[-1])[0])
    bad_betas[-1, col] = float("nan")
    store.swap(PathResult(lambdas=path.lambdas, betas=bad_betas, nnz=path.nnz, f=path.f,
                          n_iters=path.n_iters))
    got, ver = scorer.score(batch, lams)
    assert ver == 1 and store.quarantined == [2] and np.array_equal(got, good)
    fresh = PathStore(PathResult(lambdas=path.lambdas, betas=bad_betas, nnz=path.nnz,
                                 f=path.f, n_iters=path.n_iters), device="cpu")
    with pytest.raises(NonFiniteScores, match="no last-good snapshot"):
        PathScorer(fresh).score(batch, lams)


def test_scorer_and_store_validate_geometry(fitted):
    X, _, path = fitted
    p = X.shape[1]
    scorer = PathScorer(PathStore(path, device="cpu"))
    batch = pack_requests([encode_request({"a": 1.0}, p)], p)
    with pytest.raises(ValueError, match="lambdas for"):
        scorer.score(batch, np.ones(2))
    with pytest.raises(ValueError, match="hashed to p="):
        scorer.score(pack_requests([encode_request({"a": 1.0}, p + 1)], p + 1), np.ones(1))
    mesh_store = PathStore(path, mesh=make_dev_mesh(1, 2, device="cpu"), tile=TILE)
    assert mesh_store.pad_p_to == 16 and mesh_store.snapshot.p_pad == 32
    with pytest.raises(ValueError, match="pad_p_to"):
        PathScorer(mesh_store).score(batch, np.ones(1))
    with pytest.raises(ValueError, match="new store"):
        mesh_store.swap(PathResult(lambdas=path.lambdas, betas=path.betas[:, :-1],
                                   nnz=path.nnz, f=path.f, n_iters=path.n_iters))
    with pytest.raises(ValueError, match="empty path"):
        PathStore(device="cpu").swap(PathResult.from_points([]))
    with pytest.raises(ValueError, match="PathStore is empty"):
        PathStore(device="cpu").snapshot
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PathStore(path)


def test_serve_glm_smoke_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_glm", "--smoke",
                          "--device", "cpu", "--mesh", "1x2", "--steps", "5"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SERVE SMOKE OK" in out.stdout and "bit-equal" in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_glm", "--smoke"],
                             capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert out.returncode != 0 and "device='cpu'" in out.stderr
