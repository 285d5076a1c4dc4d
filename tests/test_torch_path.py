"""The port's screened regularization path (``repro_torch.api.LogisticL1.path``,
paper Algorithm 5) against the reference's ``repro.api.LogisticL1.path`` on
the same numpy problem (1280 x 128 at density 0.05, 20% held out; tile 16,
``path_len`` 6), point by point: the same lambda grid (rtol 1e-6), nnz,
active set, capacity, KKT rounds and deferred count, a relative
objective gap < 1e-4 and betas within rtol 1e-2 / atol 1e-3 (the
reference's fit-vs-fit tolerances; tight solves, rel_tol 1e-8, keep both
sides near the optimum). The reference's result crosses over through
``api.path_from_reference``.

* branch 1a (design order): a local dense design, a local slab design
  and, in a subprocess, a dense design on a (1, 4) mesh;
* branch 1b (the work axis): slab designs on a (1, 1) mesh in this
  process, flat and bucketed (the blocked cycle in the degradation
  ladder's paths), and on a (1, 4) mesh in a
  subprocess that gives JAX four CPU devices (as
  ``tests/test_torch_sparse_fit.py`` does);
* the reference's own path properties, on the port: screened equals
  unscreened, KKT-certified points, a sabotaged screen caught and
  recovered, the blitz carry equal to the reset path, the degradation
  ladder (``_solve`` tripped at one lambda in both packages), the
  ``regularization_path*`` shims bit-identical to the front door, the
  design eval's metrics, and ``lambda_max_design`` of a mesh slab design;
* the host-read contract: the port's driver reads (``engine.host_syncs``
  with each restricted solve's own reads taken out) equal the
  reference's driver ``device_get`` calls on the same path.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.estimator as jest
import repro.core.engine as jengine
from repro.api import BucketedSlabDesign as JBucketed
from repro.api import DenseDesign as JDenseDesign
from repro.api import LogisticL1 as JLogisticL1
from repro.api import ShardedDesign as JShardedDesign
from repro.api import SlabDesign as JSlabDesign
from repro.api import lambda_max_design as j_lambda_max_design
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.launch.mesh import make_dev_mesh as j_make_dev_mesh
from repro.train.metrics import metrics_from_scores as j_metrics_from_scores
import repro_torch.api.estimator as test_est
from repro_torch.api import (BucketedSlabDesign, DenseDesign, LogisticL1, PathResult,
                             ShardedDesign, SlabDesign, lambda_max_design, make_design_eval,
                             path_from_reference)
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.objective import margins
from repro_torch.core.regpath import regularization_path, regularization_path_distributed
from repro_torch.core.screening import nll_grad_abs
from repro_torch.data.byfeature import to_by_feature, to_slab_buckets, to_slabs
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.train.metrics import glm_eval_fn, metrics_from_scores

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 16
PATH_LEN = 6
OPTS = dict(tile=TILE, block=4, max_iters=150, rel_tol=1e-8)
SCREEN_KEYS = ("active", "capacity", "kkt_rounds", "deferred", "degraded", "skipped")


@pytest.fixture(scope="module")
def problem():
    ds = make_glm_dataset(GLMConfig(name="path", num_examples=1600, num_features=128,
                                    density=0.05),
                          np.random.default_rng(21), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    bf = to_by_feature(X)
    rows, vals, _ = to_slabs(bf, 1)
    return dict(X=X, y=y, bf=bf, rows=rows.numpy(), vals=vals.numpy(),
                X_test=ds.X_test.numpy(), y_test=ds.y_test.numpy())


def _cpu_mesh(M):
    return make_dev_mesh(1, M, device="cpu")


def _port_design(problem, kind, M=1):
    n = len(problem["y"])
    if kind == "dense":
        inner = DenseDesign(torch.from_numpy(problem["X"]))
    elif kind == "slab":
        inner = SlabDesign(torch.from_numpy(problem["rows"]), torch.from_numpy(problem["vals"]), n)
    else:
        inner = BucketedSlabDesign(to_slab_buckets(problem["bf"], 1), n)
    return inner if M is None else ShardedDesign(inner, _cpu_mesh(M), tile=TILE)


def _ref_design(problem, kind, M=1):
    import repro.data.byfeature as jbf

    n = len(problem["y"])
    if kind == "dense":
        inner = JDenseDesign(jnp.asarray(problem["X"]))
    elif kind == "slab":
        inner = JSlabDesign(jnp.asarray(problem["rows"]), jnp.asarray(problem["vals"]), n)
    else:
        inner = JBucketed(jbf.to_slab_buckets(jbf.to_by_feature(problem["X"]), 1), n)
    return inner if M is None else JShardedDesign(inner, j_make_dev_mesh(1, M), tile=TILE)


def _opts(mode="sequential", M=None):
    return dict(OPTS, cycle_mode=mode, **({} if M is not None else {"num_blocks": 4}))


def _port_path(problem, kind, M, mode="sequential", **kw):
    est = LogisticL1(DGLMNETOptions(**_opts(mode, M)),
                     mesh=None if M is None else _cpu_mesh(M), device="cpu")
    design = _port_design(problem, kind, M)
    if M is not None:
        design = ShardedDesign(design.inner, est.mesh, tile=TILE)
    return est.path(design, problem["y"], path_len=PATH_LEN, **kw)


def _ref_path(problem, kind, M, mode="sequential", **kw):
    est = JLogisticL1(opts=JOptions(**_opts(mode, M)))
    return est.path(_ref_design(problem, kind, M), jnp.asarray(problem["y"]),
                    path_len=PATH_LEN, **kw)


def _assert_paths_agree(port: PathResult, ref: PathResult):
    assert len(port) == len(ref) == PATH_LEN
    np.testing.assert_allclose(port.lambdas, ref.lambdas, rtol=1e-6)
    np.testing.assert_array_equal(port.statuses, ref.statuses)
    for i, (a, b) in enumerate(zip(port, ref)):
        assert a.nnz == b.nnz, (i, a.nnz, b.nnz)
        for key in SCREEN_KEYS:
            assert a.screen.get(key) == b.screen.get(key), (i, key, a.screen, b.screen)
        assert abs(a.f - b.f) / abs(b.f) < 1e-4, (i, a.f, b.f)
        np.testing.assert_allclose(a.beta.numpy(), b.beta.numpy(), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("kind,M,mode", [
    ("dense", None, "sequential"),          # 1a, local dense
    ("slab", None, "blocked"),              # 1a, local slab (densified solves)
    ("slab", 1, "sequential"),              # 1b, flat slabs on a (1, 1) mesh
    ("bucketed", 1, "sequential"),          # 1b, bucketed slabs on a (1, 1) mesh
])
def test_path_matches_reference(problem, kind, M, mode):
    densify = None if M is None else False  # slab meshes: the slab-native solver
    port = _port_path(problem, kind, M, mode, densify=densify)
    ref = path_from_reference(_ref_path(problem, kind, M, mode, densify=densify),
                              device="cpu")
    _assert_paths_agree(port, ref)
    assert port.all_ok and port.betas.shape == (PATH_LEN, problem["X"].shape[1])
    # the working set restricted the problem somewhere on the path
    assert any(pt.screen["active"] < problem["X"].shape[1] for pt in port)


@pytest.fixture(scope="module")
def reference_m4(problem, tmp_path_factory):
    """The reference's (1, 4)-mesh paths, flat slabs, bucketed slabs and
    dense, run in a subprocess with four fake CPU devices."""
    d = tmp_path_factory.mktemp("path_m4")
    np.savez(d / "in.npz", X=problem["X"], rows=problem["rows"], vals=problem["vals"],
             y=problem["y"])
    code = textwrap.dedent(f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.api import (BucketedSlabDesign, DenseDesign, LogisticL1, ShardedDesign,
                               SlabDesign)
        from repro.core.dglmnet import DGLMNETOptions
        from repro.data.byfeature import to_by_feature, to_slab_buckets
        from repro.launch.mesh import make_dev_mesh
        a = np.load({str(d / "in.npz")!r})
        n = len(a["y"])
        mesh = make_dev_mesh(1, 4)
        inner = dict(
            slab=SlabDesign(jnp.asarray(a["rows"]), jnp.asarray(a["vals"]), n),
            bucketed=BucketedSlabDesign(to_slab_buckets(to_by_feature(a["X"]), 1), n),
            dense=DenseDesign(jnp.asarray(a["X"])))
        out = {{}}
        for kind, des in inner.items():
            est = LogisticL1(opts=DGLMNETOptions(**{OPTS!r}))
            res = est.path(ShardedDesign(des, mesh, tile={TILE}), jnp.asarray(a["y"]),
                           path_len={PATH_LEN}, densify=False if kind != "dense" else None)
            out[kind] = dict(lambdas=res.lambdas.tolist(), betas=np.asarray(res.betas).tolist(),
                             nnz=res.nnz.tolist(), f=res.f.tolist(),
                             n_iters=res.n_iters.tolist(), screen=res.screen,
                             status=res.statuses.tolist(), metrics=res.metrics)
        print("RESULT " + json.dumps(out))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


class _Reloaded:
    """A reference PathResult's fields from the subprocess's JSON."""

    def __init__(self, d):
        self.lambdas, self.betas = np.asarray(d["lambdas"]), np.asarray(d["betas"], np.float32)
        self.nnz, self.f, self.n_iters = d["nnz"], d["f"], d["n_iters"]
        self.screen, self.metrics, self.status = d["screen"], d["metrics"], d["status"]


@pytest.mark.parametrize("kind", ["slab", "bucketed", "dense"])
def test_path_matches_reference_m4(problem, reference_m4, kind):
    port = _port_path(problem, kind, 4, densify=False if kind != "dense" else None)
    _assert_paths_agree(port, path_from_reference(_Reloaded(reference_m4[kind]), device="cpu"))
    if kind != "dense":
        # capacities are multiples of the mesh quantum M * tile
        assert all(pt.screen["capacity"] % (4 * TILE) == 0 for pt in port)


# ---------------------------------------------------------------------------
# the reference's own path properties, on the port
# ---------------------------------------------------------------------------

def test_screened_path_matches_unscreened(problem):
    full = _port_path(problem, "dense", None, screen=False)
    scr = _port_path(problem, "dense", None)
    for pf, ps in zip(full, scr):
        bf, bs = pf.beta.abs().numpy(), ps.beta.abs().numpy()
        disagree = (bf > 0) != (bs > 0)
        assert np.all(np.maximum(bf, bs)[disagree] < 1e-2), ps.lam
        assert abs(ps.nnz - pf.nnz) <= 2, (ps.lam, ps.nnz, pf.nnz)
        assert abs(ps.f - pf.f) / abs(pf.f) < 1e-4, (ps.lam, ps.f, pf.f)
    assert any(p.screen["active"] < problem["X"].shape[1] for p in scr)


@pytest.mark.parametrize("kind,M", [("dense", None), ("slab", 1)])
def test_screened_path_certified_by_kkt(problem, kind, M):
    X, y = torch.from_numpy(problem["X"]), torch.from_numpy(problem["y"])
    for pt in _port_path(problem, kind, M):
        g = nll_grad_abs(X, y, margins(X, pt.beta))
        inactive = pt.beta == 0
        assert bool((g[inactive] <= pt.lam * (1 + 2e-3) + 1e-5).all()), pt.lam


def test_sabotaged_screen_is_caught_and_recovered(problem, monkeypatch):
    """The strong rule made to drop the strongest feature it admits: the
    KKT check must catch it and the path must match the honest one."""
    honest = _port_path(problem, "slab", 1)
    real = test_est.strong_rule_mask
    hits = []

    def sabotaged(g_abs, lam, lam_prev, beta):
        mask = real(g_abs, lam, lam_prev, beta)
        top = int(torch.argmax(torch.where(beta == 0, g_abs, -1.0)))
        if bool(mask[top]):
            hits.append(lam)
            mask = mask.clone()
            mask[top] = False
        return mask

    monkeypatch.setattr(test_est, "strong_rule_mask", sabotaged)
    bad = _port_path(problem, "slab", 1, carry_working_set=False)
    assert hits
    for a, b in zip(bad, honest):
        if a.lam in hits:
            assert a.screen["kkt_rounds"] >= 2, a.screen
        assert abs(a.f - b.f) / abs(b.f) < 1e-4, (a.lam, a.f, b.f)


def test_blitz_carry_matches_reset_path(problem):
    reset = _port_path(problem, "dense", None, carry_working_set=False, violation_budget=None)
    blitz = _port_path(problem, "dense", None)
    actives = [p.screen["active"] for p in blitz]
    assert actives == sorted(actives)
    assert sum(p.screen["kkt_rounds"] for p in blitz) <= \
        sum(p.screen["kkt_rounds"] for p in reset)
    for pr, pb in zip(reset, blitz):
        assert abs(pb.nnz - pr.nnz) <= 2, (pb.lam, pb.nnz, pr.nnz)
        assert abs(pb.f - pr.f) / abs(pr.f) < 1e-4, (pb.lam, pb.f, pr.f)


def _tripping(real, trips: int, at: int = 2):
    """``_solve`` whose first ``trips`` solves at the ``at``-th distinct
    lambda report a line-search stall (status 2)."""
    seen, count = [], [0]

    def solve(design, y, lam, strat, **kw):
        res = real(design, y, lam, strat, **kw)
        if lam not in seen:
            seen.append(lam)
        if seen.index(lam) == at and count[0] < trips:
            count[0] += 1
            res.status = 2
        return res

    return solve


@pytest.mark.parametrize("trips,degraded", [(1, "rewarm"), (2, "sequential"),
                                            (99, "skipped")])
def test_degradation_ladder_matches_reference(problem, monkeypatch, trips, degraded):
    monkeypatch.setattr(test_est, "_solve", _tripping(test_est._solve, trips))
    monkeypatch.setattr(jest, "_solve", _tripping(jest._solve, trips))
    port = _port_path(problem, "slab", 1, "blocked")
    ref = path_from_reference(_ref_path(problem, "slab", 1, "blocked"), device="cpu")
    assert port[2].screen.get("degraded") == ref[2].screen.get("degraded") == degraded
    assert port[2].screen.get("skipped") == ref[2].screen.get("skipped")
    _assert_paths_agree(port, ref)
    if degraded == "skipped":
        assert port.statuses[2] == 2 and port.n_iters[2] == 0
        assert torch.equal(port.betas[2], port.betas[1])


def test_regpath_shims_equal_front_door(problem):
    opts = DGLMNETOptions(**_opts())
    a = regularization_path(problem["X"], problem["y"], path_len=4, opts=opts, device="cpu")
    b = LogisticL1(opts, device="cpu").path(DenseDesign(torch.from_numpy(problem["X"])),
                                            problem["y"], path_len=4)
    assert torch.equal(a.betas, b.betas) and list(a.f) == list(b.f)
    assert a.screen == b.screen
    mesh = _cpu_mesh(2)
    mopts = DGLMNETOptions(**_opts(M=2))
    sb = to_slab_buckets(problem["bf"], 1)
    c = regularization_path_distributed(sb, problem["y"], mesh, path_len=4, opts=mopts)
    d = LogisticL1(mopts, mesh=mesh, device="cpu").path(
        ShardedDesign(BucketedSlabDesign(sb, len(problem["y"])), mesh, tile=TILE),
        problem["y"], path_len=4)
    assert torch.equal(c.betas, d.betas) and list(c.f) == list(d.f)
    assert c.screen == d.screen and list(c.nnz) == list(d.nnz)


def test_design_eval_metrics_match_reference(problem):
    rng = np.random.default_rng(2)
    Xt, yt = problem["X_test"], problem["y_test"]
    beta = np.where(rng.random(Xt.shape[1]) < 0.3, rng.standard_normal(Xt.shape[1]),
                    0).astype(np.float32)
    scores = (Xt @ beta).astype(np.float32)
    got, want = metrics_from_scores(scores, yt), j_metrics_from_scores(scores, yt)
    assert got["auprc"] == want["auprc"] and got["accuracy"] == want["accuracy"]
    assert abs(got["logloss"] - want["logloss"]) <= 1e-6 * want["logloss"]
    assert glm_eval_fn(Xt, yt)(torch.from_numpy(beta)) == got
    bt = to_by_feature(Xt)
    fn = make_design_eval(SlabDesign.from_by_feature(bt), yt, mesh=_cpu_mesh(2), tile=TILE,
                          device="cpu")
    before = engine.host_syncs
    on_design = fn(torch.from_numpy(beta))
    assert engine.host_syncs == before + 2          # the row bound once, the scores
    fn(torch.from_numpy(beta))
    assert engine.host_syncs == before + 3
    for key in ("auprc", "accuracy", "logloss"):
        assert abs(on_design[key] - want[key]) <= 1e-5 * max(abs(want[key]), 1.0), key


def test_lambda_max_of_a_mesh_slab_design_matches_reference(problem):
    y = problem["y"]
    for kind in ("slab", "bucketed"):
        got = float(lambda_max_design(_port_design(problem, kind, 2), torch.from_numpy(y)))
        want = float(j_lambda_max_design(_ref_design(problem, kind, 1), jnp.asarray(y)))
        assert abs(got - want) <= 1e-6 * want, (kind, got, want)


def _count_reads(monkeypatch, real_solve, mod_name):
    """Wrap a package's ``_solve`` to total its own reads (the port's
    ``engine.host_syncs`` delta, or the reference's ``device_get`` calls
    made inside it)."""
    inside = [0]

    def solve(*a, **kw):
        before = counter()
        res = real_solve(*a, **kw)
        inside[0] += counter() - before
        return res

    if mod_name == "port":
        def counter():
            return engine.host_syncs
        monkeypatch.setattr(test_est, "_solve", solve)
    else:
        calls = [0]
        real_get = jengine.device_get

        def device_get(x):
            calls[0] += 1
            return real_get(x)

        def counter():
            return calls[0]
        monkeypatch.setattr(jengine, "device_get", device_get)
        monkeypatch.setattr(jest, "_solve", solve)
        return inside, calls
    return inside, None


@pytest.mark.parametrize("kind,M", [("dense", None), ("slab", 1), ("bucketed", 1)])
def test_driver_host_reads_match_reference(problem, monkeypatch, kind, M):
    p_inside, _ = _count_reads(monkeypatch, test_est._solve, "port")
    r_inside, r_calls = _count_reads(monkeypatch, jest._solve, "ref")
    engine.host_syncs = 0
    port = _port_path(problem, kind, M)
    port_driver = engine.host_syncs - p_inside[0]
    ref = _ref_path(problem, kind, M)
    ref_driver = r_calls[0] - r_inside[0]
    assert port_driver == ref_driver, (port_driver, ref_driver)
    # reads per point: 1 lambda_max, then per KKT round r the count, the slab
    # class (slab meshes), the violations, and for r < R the budget's and
    # the admitted counts; per point the final count and (nnz, f)
    per_round = 3 if M is not None else 2
    expect = 1 + sum(2 + per_round * pt.screen["kkt_rounds"] + 2 * (pt.screen["kkt_rounds"] - 1)
                     for pt in port)
    assert port_driver == expect
    assert all(a.screen == b.screen for a, b in zip(port, ref))


def test_path_refuses_what_is_not_ported(problem, tmp_path):
    est = LogisticL1(DGLMNETOptions(**_opts()), device="cpu")
    # resumable paths are ported (tests/test_torch_resilience.py); what the
    # reference refuses, the port refuses
    with pytest.raises(ValueError, match="requires resume_from"):
        est.path(problem["X"], problem["y"], path_len=2, checkpoint_every=1)
    with pytest.raises(ValueError, match="must be >= 1"):
        est.path(problem["X"], problem["y"], path_len=2, checkpoint_every=0,
                 resume_from=str(tmp_path / "progress"))
    res = est.path(problem["X"], problem["y"], path_len=2, checkpoint_every=1,
                   resume_from=str(tmp_path / "progress"))
    # a save / load round trip gives the same path back
    back = PathResult.load(res.save(str(tmp_path / "path")), device="cpu")
    assert torch.equal(back.betas, res.betas) and back.screen == res.screen
    assert np.array_equal(back.lambdas, res.lambdas) and np.array_equal(back.f, res.f)
    assert res.index_of(res.lambdas[1] * 1.1) == 1 and len(res[0:2]) == 2
    assert torch.equal(est.beta_, res.betas[-1]) and est.lam_ == res.lambdas[-1]
    with pytest.raises(IndexError):
        res[2]
    small = replace(DGLMNETOptions(**_opts()), max_iters=1)
    assert LogisticL1(small, device="cpu").path(problem["X"], problem["y"],
                                                path_len=1).n_iters[0] == 1
