"""The port's by-feature slab solve (``LogisticL1(opts, mesh=make_dev_mesh(1,
M)).fit(slabs, y, lam)``, device="cpu") against the JAX reference
``LogisticL1(opts).fit(ShardedDesign(SlabDesign(...), make_dev_mesh(1, M),
tile=...), y, lam, densify=...)`` on the same numpy problem (1024 x 100
training rows at density 0.05, tile 16, so p pads to M * 16), slab-native
(``densify=False``) and densify-once (``densify=True``):

* M = 1 in this process; M = 4 in a subprocess that gives JAX four CPU
  devices (``XLA_FLAGS`` set only there, as ``tests/test_api_mesh.py``
  does);
* tolerances are the reference's fit-vs-fit ones
  (``tests/test_distributed.py``): relative objective gap < 1e-4, betas
  within rtol 1e-2 / atol 1e-3;
* one outer iteration of the slab solve against the reference's, the
  strategy's choices against the reference's ``resolve``/``use_densify``,
  a local slab fit against the densified dense fit, scoring through the
  slabs, and the host-read contract (one read per outer iteration, one
  fetch, one entry read of the slabs' largest row).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import DenseDesign as JDenseDesign
from repro.api import LogisticL1 as JLogisticL1
from repro.api import ShardedDesign as JShardedDesign
from repro.api import SlabDesign as JSlabDesign
from repro.api import lambda_max_design as j_lambda_max_design
from repro.api import resolve as j_resolve
from repro.core.distributed import make_distributed_iteration_sparse as j_make_iteration
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.kernels.ops import logistic_stats as j_logistic_stats
from repro.launch.mesh import make_dev_mesh as j_make_dev_mesh
from repro_torch.api import (DenseDesign, LogisticL1, ShardedDesign, SlabDesign,
                             lambda_max_design, resolve)
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.distributed import (fit_distributed_sparse, layout_slabs,
                                          make_distributed_iteration_sparse,
                                          pad_features)
from repro_torch.data.byfeature import to_by_feature, to_slabs
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.kernels.ops import logistic_stats
from repro_torch.launch.mesh import make_dev_mesh

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 16
OPTS = dict(tile=TILE, block=4, max_iters=40)


def _fit_close(f, beta, ref_f, ref_beta):
    assert abs(f - ref_f) / abs(ref_f) < 1e-4, (f, ref_f)
    np.testing.assert_allclose(np.asarray(beta), np.asarray(ref_beta), rtol=1e-2, atol=1e-3)


@pytest.fixture(scope="module")
def problem():
    ds = make_glm_dataset(GLMConfig(name="sparse", num_examples=1280, num_features=100,
                                    density=0.05),
                          np.random.default_rng(7), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    rows, vals, _ = to_slabs(to_by_feature(X), 1)
    rows, vals = rows.numpy(), vals.numpy()
    lam = float(lambda_max_design(SlabDesign(torch.from_numpy(rows),
                                             torch.from_numpy(vals), len(y)),
                                  torch.from_numpy(y))) / 16
    return dict(X=X, y=y, rows=rows, vals=vals, lam=lam,
                X_test=ds.X_test.numpy(), y_test=ds.y_test.numpy())


def _port_fit(problem, M, densify, mode="sequential"):
    engine.host_syncs = 0
    est = LogisticL1(DGLMNETOptions(cycle_mode=mode, **OPTS),
                     mesh=make_dev_mesh(1, M, device="cpu"), device="cpu")
    design = SlabDesign(torch.from_numpy(problem["rows"]),
                        torch.from_numpy(problem["vals"]), len(problem["y"]))
    res = est.fit(design, problem["y"], problem["lam"], densify=densify)
    return est, res, engine.host_syncs


def _ref_fit(problem, M, densify, mode="sequential"):
    mesh = j_make_dev_mesh(1, M)
    design = JShardedDesign(JSlabDesign(jnp.asarray(problem["rows"]),
                                        jnp.asarray(problem["vals"]), len(problem["y"])),
                            mesh, tile=TILE)
    est = JLogisticL1(opts=JOptions(cycle_mode=mode, **OPTS))
    return est.fit(design, jnp.asarray(problem["y"]), problem["lam"], densify=densify)


def test_lambda_max_design_matches_reference(problem):
    jd = JSlabDesign(jnp.asarray(problem["rows"]), jnp.asarray(problem["vals"]),
                     len(problem["y"]))
    want = float(j_lambda_max_design(jd, jnp.asarray(problem["y"]))) / 16
    assert abs(problem["lam"] - want) <= 1e-6 * want
    dense = float(lambda_max_design(DenseDesign(torch.from_numpy(problem["X"])),
                                    torch.from_numpy(problem["y"]))) / 16
    assert abs(problem["lam"] - dense) <= 1e-6 * dense


@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_one_outer_iteration_matches_reference(problem, mode):
    """One slab-native outer iteration at a nonzero beta: (dbeta, dm,
    grad^T dbeta) against the reference's shard_map iteration on a (1, 1)
    mesh."""
    rng = np.random.default_rng(3)
    n_loc = len(problem["y"])
    rows, vals, _, _ = pad_features(torch.from_numpy(problem["rows"]),
                                    torch.from_numpy(problem["vals"]), None, n_loc, TILE)
    p_pad = rows.shape[0]
    beta = (0.1 * rng.standard_normal(p_pad) * (rng.random(p_pad) < 0.3)).astype(np.float32)
    beta[problem["rows"].shape[0]:] = 0.0
    m = problem["X"] @ beta[:problem["X"].shape[1]]
    y = problem["y"]
    opts = DGLMNETOptions(cycle_mode=mode, **OPTS)
    w, z, _ = logistic_stats(torch.from_numpy(m), torch.from_numpy(y))
    lay = layout_slabs(rows[:, 0], vals[:, 0], 1, TILE)
    dbeta, dm, gd = make_distributed_iteration_sparse(make_dev_mesh(1, 1, device="cpu"), opts)(
        lay, torch.from_numpy(y), torch.from_numpy(beta), torch.from_numpy(m),
        problem["lam"], w, z)
    jw, jz, _ = j_logistic_stats(jnp.asarray(m), jnp.asarray(y))
    jdb, jdm, jgd = j_make_iteration(j_make_dev_mesh(1, 1), JOptions(cycle_mode=mode, **OPTS))(
        (jnp.asarray(rows.numpy()), jnp.asarray(vals.numpy())), jnp.asarray(y),
        jnp.asarray(beta), jnp.asarray(m), problem["lam"], jw, jz)
    np.testing.assert_allclose(dbeta.numpy(), np.asarray(jdb), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dm.numpy(), np.asarray(jdm), rtol=1e-4, atol=1e-4)
    assert abs(float(gd) - float(jgd)) <= 1e-4 * abs(float(jgd))


@pytest.mark.parametrize("densify", [False, True])
@pytest.mark.parametrize("mode", ["sequential", "blocked"])
def test_slab_fit_matches_reference_m1(problem, densify, mode):
    _, res, syncs = _port_fit(problem, 1, densify, mode)
    ref = _ref_fit(problem, 1, densify, mode)
    assert res.ok and ref.ok
    assert res.beta.shape == (problem["X"].shape[1],)
    _fit_close(res.f, res.beta, ref.f, ref.beta)
    h = res.objective_history
    assert all(h[i + 1] <= h[i] + 1e-4 * abs(h[i]) for i in range(len(h) - 1)), h
    # one read per outer iteration + one fetch + the slabs' largest row
    assert syncs == res.n_iters + 2, (syncs, res.n_iters)


@pytest.fixture(scope="module")
def reference_m4(problem, tmp_path_factory):
    """The reference's M = 4 fits, run in a subprocess with four fake CPU
    devices."""
    d = tmp_path_factory.mktemp("m4")
    np.savez(d / "in.npz", rows=problem["rows"], vals=problem["vals"], y=problem["y"])
    code = textwrap.dedent(f"""
        import json
        import numpy as np, jax.numpy as jnp
        from repro.api import LogisticL1, ShardedDesign, SlabDesign
        from repro.core.dglmnet import DGLMNETOptions
        from repro.launch.mesh import make_dev_mesh
        a = np.load({str(d / "in.npz")!r})
        mesh = make_dev_mesh(1, 4)
        design = ShardedDesign(SlabDesign(jnp.asarray(a["rows"]), jnp.asarray(a["vals"]),
                                          len(a["y"])), mesh, tile={TILE})
        out = {{}}
        for densify in (False, True):
            est = LogisticL1(opts=DGLMNETOptions(**{OPTS!r}))
            res = est.fit(design, jnp.asarray(a["y"]), {problem["lam"]!r}, densify=densify)
            out[str(densify)] = dict(f=res.f, ok=res.ok, n_iters=res.n_iters,
                                     beta=np.asarray(res.beta).tolist())
        print("RESULT " + json.dumps(out))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("densify", [False, True])
def test_slab_fit_matches_reference_m4(problem, reference_m4, densify):
    _, res, syncs = _port_fit(problem, 4, densify)
    ref = reference_m4[str(densify)]
    assert res.ok and ref["ok"]
    _fit_close(res.f, res.beta, ref["f"], ref["beta"])
    assert syncs == res.n_iters + 2


def test_slab_native_and_densify_agree(problem):
    _, a, _ = _port_fit(problem, 4, False)
    _, b, _ = _port_fit(problem, 4, True)
    _fit_close(a.f, a.beta, b.f, b.beta)


@pytest.mark.parametrize("M", [1, 3])
def test_mesh_dense_fit(problem, M):
    """A dense design on a (1, M) mesh: X's features zero-padded to
    M * tile, M contiguous blocks -- the densify-once branch's solver. At
    M=1 against the reference's mesh fit; at M=3 (p = 100 pads to 144)
    against the port's slab-native fit of the same data."""
    opts = DGLMNETOptions(**OPTS)
    est = LogisticL1(opts, mesh=make_dev_mesh(1, M, device="cpu"), device="cpu")
    res = est.fit(torch.from_numpy(problem["X"]), problem["y"], problem["lam"])
    assert res.ok and res.beta.shape == (problem["X"].shape[1],)
    if M == 1:
        ref = JLogisticL1(opts=JOptions(**OPTS)).fit(
            JShardedDesign(JDenseDesign(jnp.asarray(problem["X"])), j_make_dev_mesh(1, 1),
                           tile=TILE), jnp.asarray(problem["y"]), problem["lam"])
        _fit_close(res.f, res.beta, ref.f, ref.beta)
    else:
        _, slab, _ = _port_fit(problem, M, False)
        _fit_close(res.f, res.beta, slab.f, slab.beta)


def test_local_slab_fit_equals_densified_dense_fit(problem):
    """A local SlabDesign densifies once and rides the dense solver: the
    same fit as the dense design, bit for bit, and the reference's."""
    opts = DGLMNETOptions(num_blocks=4, **OPTS)
    design = SlabDesign(torch.from_numpy(problem["rows"]), torch.from_numpy(problem["vals"]),
                        len(problem["y"]))
    a = LogisticL1(opts, device="cpu").fit(design, problem["y"], problem["lam"])
    b = LogisticL1(opts, device="cpu").fit(torch.from_numpy(problem["X"]), problem["y"],
                                           problem["lam"])
    assert a.f == b.f and torch.equal(a.beta, b.beta)
    ref = JLogisticL1(opts=JOptions(num_blocks=4, **OPTS)).fit(
        JSlabDesign(jnp.asarray(problem["rows"]), jnp.asarray(problem["vals"]),
                    len(problem["y"])), jnp.asarray(problem["y"]), problem["lam"])
    _fit_close(a.f, a.beta, ref.f, ref.beta)


def test_decision_function_on_slabs(problem):
    est, res, _ = _port_fit(problem, 4, False)
    X_test = problem["X_test"]
    rows, vals, _ = to_slabs(to_by_feature(X_test), 1)
    scores = est.decision_function(SlabDesign(rows, vals, X_test.shape[0]))
    np.testing.assert_allclose(scores.numpy(), X_test @ res.beta.numpy(), rtol=1e-5, atol=1e-5)
    jmesh = j_make_dev_mesh(1, 1)
    want = JLogisticL1(opts=JOptions(**OPTS), mesh=jmesh).decision_function(
        JShardedDesign(JSlabDesign(jnp.asarray(rows.numpy()), jnp.asarray(vals.numpy()),
                                   X_test.shape[0]), jmesh, tile=TILE),
        beta=jnp.asarray(res.beta.numpy()))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    labels = est.predict(SlabDesign(rows, vals, X_test.shape[0]))
    assert torch.equal(labels, torch.where(scores >= 0, 1.0, -1.0))


def test_fit_distributed_sparse_shim_equals_front_door(problem):
    mesh = make_dev_mesh(1, 2, device="cpu")
    opts = DGLMNETOptions(**OPTS)
    rows, vals = torch.from_numpy(problem["rows"]), torch.from_numpy(problem["vals"])
    y = torch.from_numpy(problem["y"])
    a = fit_distributed_sparse(rows, vals, y, problem["lam"], mesh, opts=opts)
    b = LogisticL1(opts, mesh=mesh, device="cpu").fit(SlabDesign(rows, vals, len(y)), y,
                                                      problem["lam"])
    assert a.f == b.f and torch.equal(a.beta, b.beta) and a.n_iters == b.n_iters


@pytest.mark.parametrize("densify", [None, False, True])
def test_strategy_matches_reference(problem, densify):
    rows, vals, y = problem["rows"], problem["vals"], problem["y"]
    for M in (1, 4):
        tmesh, jmesh = make_dev_mesh(1, M, device="cpu"), j_make_dev_mesh(1, 1)
        pairs = [
            (SlabDesign(torch.from_numpy(rows), torch.from_numpy(vals), len(y)),
             JSlabDesign(jnp.asarray(rows), jnp.asarray(vals), len(y))),
            (DenseDesign(torch.from_numpy(problem["X"])), JDenseDesign(jnp.asarray(problem["X"]))),
        ]
        for td, jd in pairs:
            designs = [(td, jd)]
            if M == 1:      # the reference's in-process mesh has one device
                designs.append((ShardedDesign(td, tmesh, tile=TILE),
                                JShardedDesign(jd, jmesh, tile=TILE)))
            for a, b in designs:
                for mode in ("sequential", "blocked", "auto"):
                    for tile in (16, 64):
                        s = resolve(a, DGLMNETOptions(tile=tile, cycle_mode=mode, block=4),
                                    densify=densify)
                        j = j_resolve(b, JOptions(tile=tile, cycle_mode=mode, block=4),
                                      densify=densify)
                        assert (s.execution, s.solver, s.opts.cycle_mode,
                                s.densify) == (j.execution, j.solver,
                                               j.opts.cycle_mode, j.densify)
                        for n_loc, k in ((1024, 11), (1024, 12), (252_000, 95)):
                            assert s.use_densify(n_loc, k) == j.use_densify(n_loc, k)


def test_mesh_entry_points_refuse_what_they_cannot_run(problem):
    design = SlabDesign(torch.from_numpy(problem["rows"]), torch.from_numpy(problem["vals"]),
                        len(problem["y"]))
    cpu_mesh = make_dev_mesh(1, 2, device="cpu")
    if not torch.cuda.is_available():
        # the estimator's default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LogisticL1(DGLMNETOptions(**OPTS), mesh=cpu_mesh).fit(design, problem["y"], 0.1)
    with pytest.raises(ValueError, match="different mesh"):
        LogisticL1(DGLMNETOptions(**OPTS), mesh=cpu_mesh, device="cpu").fit(
            ShardedDesign(design, make_dev_mesh(1, 2, device="cpu")), problem["y"], 0.1)
    # a flat slab is one bucket: a budget of 1 cannot double-buffer it,
    # and the path raises the reference's floor error
    with pytest.raises(ValueError, match="cannot double-buffer"):
        LogisticL1(DGLMNETOptions(device_budget_bytes=1, **OPTS), mesh=cpu_mesh,
                   device="cpu").path(design, problem["y"], path_len=2)
    with pytest.raises(ValueError, match="cannot double-buffer"):
        JLogisticL1(JOptions(device_budget_bytes=1, **OPTS), mesh=j_make_dev_mesh(1, 1)).path(
            JSlabDesign(jnp.asarray(problem["rows"]), jnp.asarray(problem["vals"]),
                        len(problem["y"])), problem["y"], path_len=2)
    bad = SlabDesign(design.row_idx, design.values, len(problem["y"]) - 200)
    with pytest.raises(ValueError, match="exceeds the local example count"):
        LogisticL1(DGLMNETOptions(**OPTS), mesh=cpu_mesh, device="cpu").fit(
            bad, problem["y"][:-200], 0.1)
