"""d-GLMNET across processes: the port's process mesh (``launch.mesh``
``ProcMesh`` over a ``torch.distributed`` gloo world of CPU ranks)
against the JAX reference's ``shard_map`` mesh of fake CPU devices.

* The reference runs once per module in one subprocess with 8 fake
  devices (as ``tests/test_distributed.py`` does): dense and slab fits on
  its (2, 4) and (1, 4) meshes (``fit_distributed`` /
  ``fit_distributed_sparse``, sequential cycle, no Pallas kernel), one
  outer step (``make_dglmnet_step`` / ``_sparse``), a 6-point screened
  slab path (``regularization_path_distributed``) and a 3-point screened
  path of a dense X (``LogisticL1.path``).
* The port runs the same numpy inputs as 8 spawned gloo ranks on a (2, 4)
  mesh (2 data x 4 model ranks, one feature block each) and 2 ranks on a
  (1, 4) mesh (two blocks each). Each rank is a subprocess that starts
  from a ``file://`` store in the test's own directory; every spawn has a
  deadline, and a rank past it fails the test instead of hanging.
* Tolerances are the reference's fit-vs-fit ones
  (``tests/test_distributed.py:222-226``): relative objective gap
  < 1e-4, betas within rtol 1e-2 / atol 1e-3; the path with the checks of
  ``tests/test_distributed.py:135-184``; one step within rtol 1e-3.
* Every rank of a run must hold the same bits (beta, histories, path);
  a world of one rank must be bit-equal to ``make_dev_mesh(1, 4)``.
* Each rank keeps only its piece of a design (its example shard of its
  run of the padded feature axis): its bytes, the restricted gather's
  blocks and merges, the Gram tile across ranks, ``decision_function``'s
  n rows on every rank, and the path's reductions over ``model`` are
  checked from the same spawn.
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.base import GLMConfig
from repro_torch.data.byfeature import to_by_feature, to_slab_buckets, to_slabs
from repro_torch.data.synthetic import make_glm_dataset

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a spawn (the reference's subprocess, or all ranks of a world) may take
DEADLINE = 300
DENSE = dict(tile=16, max_iters=40)
SLAB = dict(tile=16, max_iters=40)
PATH = dict(tile=16, max_iters=60, rel_tol=1e-7)
#: the slab step's tile: the reference's shard of 96 / 4 features must be a multiple of it
SSTEP = dict(tile=8, max_iters=40)
PATH_LEN = 6


def _inputs():
    """The three problems as numpy arrays (the port's generator, numpy
    seeds): dense (n 1024, p 128), slab (n 2048, p 96, density 0.004,
    slab-native) and the path's (n 1024, p 96, density 0.3, the
    reference path test's shape)."""
    def ds(n, p, density, seed):
        d = make_glm_dataset(GLMConfig(name="dist", num_examples=n, num_features=p,
                                       density=density),
                             np.random.default_rng(seed), device="cpu", test_frac=0.2)
        return d.X_train.numpy(), d.y_train.numpy()

    out = {}
    X, y = ds(1280, 128, 1.0, 3)
    out.update(dX=X, dy=y, dlam=np.float32(np.abs(X.T @ (0.5 * y)).max() / 32))
    X, y = ds(2560, 96, 0.004, 5)
    for dp in (1, 2):
        rows, vals, _ = to_slabs(to_by_feature(torch.from_numpy(X)), dp)
        out[f"srows{dp}"], out[f"svals{dp}"] = rows.numpy(), vals.numpy()
    out.update(sX=X, sy=y, slam=np.float32(np.abs(X.T @ (0.5 * y)).max() / 16))
    X, y = ds(1280, 96, 0.3, 11)
    rows, vals, _ = to_slabs(to_by_feature(torch.from_numpy(X)), 2)
    out.update(pX=X, py=y, prows=rows.numpy(), pvals=vals.numpy())
    rng = np.random.default_rng(1)
    beta = 0.05 * rng.standard_normal(128) * (rng.random(128) < 0.3)
    out.update(step_beta=beta.astype(np.float32))
    return out


REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.api import LogisticL1
from repro.core import DGLMNETOptions, fit_distributed, regularization_path_distributed
from repro.core.distributed import (fit_distributed_sparse, make_dglmnet_step,
                                    make_dglmnet_step_sparse)
from repro.launch.mesh import make_dev_mesh

work = sys.argv[1]
a = dict(np.load(f"{work}/inputs.npz"))
out = {}
for tag, mesh in (("2x4", make_dev_mesh(2, 4)), ("1x4", make_dev_mesh(1, 4))):
    dp = mesh.shape["data"]
    res = fit_distributed(jnp.asarray(a["dX"]), jnp.asarray(a["dy"]), float(a["dlam"]), mesh,
                          opts=DGLMNETOptions(num_blocks=4, **DENSE))
    out[f"dense{tag}_beta"], out[f"dense{tag}_f"] = np.asarray(res.beta), res.f
    res = fit_distributed_sparse(jnp.asarray(a[f"srows{dp}"]), jnp.asarray(a[f"svals{dp}"]),
                                 jnp.asarray(a["sy"]), float(a["slam"]), mesh,
                                 opts=DGLMNETOptions(num_blocks=4, **SLAB), densify=False)
    out[f"slab{tag}_beta"], out[f"slab{tag}_f"] = np.asarray(res.beta), res.f
mesh = make_dev_mesh(2, 4)
opts = DGLMNETOptions(num_blocks=4, **DENSE)
X, y, beta = jnp.asarray(a["dX"]), jnp.asarray(a["dy"]), jnp.asarray(a["step_beta"])
b, m, f, alpha = make_dglmnet_step(mesh, opts)(X, y, beta, X @ beta, float(a["dlam"]))
out.update(step_beta_new=np.asarray(b), step_f=float(f), step_alpha=float(alpha))
rows, vals, sy = jnp.asarray(a["srows2"]), jnp.asarray(a["svals2"]), jnp.asarray(a["sy"])
Xs = jnp.asarray(a["sX"])
sb = jnp.zeros(Xs.shape[1]).at[:8].set(0.1)
b, m, f, alpha = make_dglmnet_step_sparse(mesh, DGLMNETOptions(num_blocks=4, **SSTEP))(
    rows, vals, sy, sb, Xs @ sb, float(a["slam"]))
out.update(sstep_beta_new=np.asarray(b), sstep_f=float(f), sstep_alpha=float(alpha))
pts = regularization_path_distributed((jnp.asarray(a["prows"]), jnp.asarray(a["pvals"])),
                                      jnp.asarray(a["py"]), mesh, path_len=PATH_LEN,
                                      opts=DGLMNETOptions(num_blocks=4, **PATH))
out.update(path_lams=np.asarray([pt.lam for pt in pts]), path_f=np.asarray([pt.f for pt in pts]),
           path_nnz=np.asarray([pt.nnz for pt in pts]),
           path_betas=np.stack([np.asarray(pt.beta) for pt in pts]))
# the dense design's screened path on the same (2, 4) mesh
pts = LogisticL1(DGLMNETOptions(num_blocks=4, **PATH), mesh=mesh).path(
    jnp.asarray(a["pX"]), jnp.asarray(a["py"]), path_len=3)
out.update(dpath_f=np.asarray(pts.f), dpath_betas=np.asarray(pts.betas))
np.savez(f"{work}/reference.npz", **out)
print("OK reference")
"""

RANK = """
import json, sys
from datetime import timedelta
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.api import DenseDesign, LogisticL1, ShardedDesign, SlabDesign, as_design
from repro_torch.api import estimator
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.core.distributed import (fit_distributed, fit_distributed_sparse,
                                          make_dglmnet_step, make_dglmnet_step_sparse)
from repro_torch.core.regpath import regularization_path_distributed
from repro_torch.data.byfeature import to_by_feature, to_slab_buckets
from repro_torch.launch.mesh import init_process_mesh, world_scope

with world_scope():
    rank, world, data, work = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    a = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/inputs.npz").items()}
    mesh = init_process_mesh(data, 4, backend="gloo", init_method=f"file://{work}/store{world}",
                             world_size=world, rank=rank, device="cpu",
                             timeout=timedelta(seconds=120))
    out, msgs = {}, {}
    if data == 2:
        # the reference's guards (tests/test_distributed.py test_divisibility_and_slab_guards)
        cases = {
            "dense_n": lambda: fit_distributed(torch.ones(17, 16), torch.ones(17), 1.0, mesh),
            "slab_dp": lambda: fit_distributed_sparse(torch.zeros(16, 3, 4, dtype=torch.int32),
                                                      torch.zeros(16, 3, 4), torch.ones(18), 1.0,
                                                      mesh),
            "slab_shape": lambda: fit_distributed_sparse(torch.zeros(16, 2, 4, dtype=torch.int32),
                                                         torch.zeros(16, 3, 4), torch.ones(18),
                                                         1.0, mesh),
            "slab_n": lambda: fit_distributed_sparse(torch.zeros(16, 2, 4, dtype=torch.int32),
                                                     torch.zeros(16, 2, 4), torch.ones(17), 1.0,
                                                     mesh),
            "slab_rows": lambda: fit_distributed_sparse(torch.full((16, 2, 4), 30, dtype=torch.int32),
                                                        torch.zeros(16, 2, 4), torch.ones(18), 1.0,
                                                        mesh),
            # a design holds its piece cut at its own tile
            "tile_dense": lambda: LogisticL1(DGLMNETOptions(tile=8, max_iters=2), mesh=mesh,
                                             device="cpu").fit(
                ShardedDesign(DenseDesign(a["dX"]), mesh, tile=16), a["dy"], 1.0),
            "tile_slab": lambda: ShardedDesign(SlabDesign(a["srows2"], a["svals2"], len(a["sy"])),
                                               mesh, tile=16)._mesh_state(8),
        }
        for name, fn in cases.items():
            try:
                fn()
                msgs[name] = None
            except ValueError as e:
                msgs[name] = str(e)
    mesh.reset_stats()
    engine.host_syncs = 0
    res = fit_distributed(a["dX"], a["dy"], float(a["dlam"]), mesh, opts=DGLMNETOptions(**DENSE))
    out.update(dense_beta=res.beta.numpy(), dense_hist=np.asarray(res.objective_history),
               dense_alpha=np.asarray(res.alpha_history), dense_m=res.m.numpy())
    msgs["dense"] = dict(iters=res.n_iters, ok=res.ok, reads=engine.host_syncs, stats=mesh.stats())
    dp = data
    mesh.reset_stats()
    engine.host_syncs = 0
    res = fit_distributed_sparse(a[f"srows{dp}"], a[f"svals{dp}"], a["sy"], float(a["slam"]), mesh,
                                 opts=DGLMNETOptions(**SLAB), densify=False)
    out.update(slab_beta=res.beta.numpy(), slab_hist=np.asarray(res.objective_history))
    msgs["slab"] = dict(iters=res.n_iters, ok=res.ok, reads=engine.host_syncs, stats=mesh.stats())
    if data == 2:
        # the same problem as nnz-bucketed slabs (power-of-two K classes)
        buckets = to_slab_buckets(to_by_feature(a["sX"]), 2)
        engine.host_syncs = 0
        res = LogisticL1(DGLMNETOptions(**SLAB), mesh=mesh, device="cpu").fit(
            buckets, a["sy"], float(a["slam"]), densify=False)
        out.update(bucketed_beta=res.beta.numpy(), bucketed_hist=np.asarray(res.objective_history))
        msgs["bucketed"] = dict(iters=res.n_iters, ok=res.ok, reads=engine.host_syncs,
                                classes=len(buckets.buckets))
        b, m, f, alpha = make_dglmnet_step(mesh, DGLMNETOptions(**DENSE))(
            a["dX"], a["dy"], a["step_beta"], (a["dX"] @ a["step_beta"])[mesh.data_rank * 512:
                                                                        (mesh.data_rank + 1) * 512],
            float(a["dlam"]))
        out.update(step_beta_new=b.numpy(), step_f=f.numpy(), step_alpha=alpha.numpy())
        sb = torch.zeros(a["sX"].shape[1])
        sb[:8] = 0.1
        b, m, f, alpha = make_dglmnet_step_sparse(mesh, DGLMNETOptions(**SSTEP))(
            a["srows2"], a["svals2"], a["sy"], sb,
            (a["sX"] @ sb)[mesh.data_rank * 1024:(mesh.data_rank + 1) * 1024], float(a["slam"]))
        out.update(sstep_beta_new=b.numpy(), sstep_f=f.numpy(), sstep_alpha=alpha.numpy())
        # count the path's restricted solves (their iterations) and screens
        solves, screens = [], [0]
        real_solve, real_screen = estimator._solve, ShardedDesign._screen_abs_work

        def counted_solve(*args, **kw):
            res = real_solve(*args, **kw)
            solves.append(res.n_iters)
            return res

        def counted_screen(self, *args, **kw):
            screens[0] += 1
            return real_screen(self, *args, **kw)

        estimator._solve, ShardedDesign._screen_abs_work = counted_solve, counted_screen
        mesh.reset_stats()
        pts = regularization_path_distributed((a["prows"], a["pvals"]), a["py"], mesh,
                                              path_len=PATH_LEN, opts=DGLMNETOptions(**PATH))
        stats = mesh.stats()
        estimator._solve, ShardedDesign._screen_abs_work = real_solve, real_screen
        out.update(path_lams=np.asarray(pts.lambdas), path_f=np.asarray(pts.f),
                   path_nnz=np.asarray([pt.nnz for pt in pts]),
                   path_active=np.asarray([pt.screen["active"] for pt in pts]),
                   path_status=np.asarray(list(pts.statuses)), path_betas=pts.betas.numpy())
        msgs["path"] = dict(stats=stats, solves=solves, screens=screens[0], points=len(pts))
        # the dense design's screened path (its restricted designs routed by columns)
        pts = LogisticL1(DGLMNETOptions(**PATH), mesh=mesh, device="cpu").path(
            a["pX"], a["py"], path_len=3)
        out.update(dpath_f=np.asarray(pts.f), dpath_betas=pts.betas.numpy())
    # the split: each rank's piece of each layout, and what crosses to build
    # a restricted design
    n_s = len(a["sy"])
    pieces = {"flat": ShardedDesign(SlabDesign(a[f"srows{dp}"], a[f"svals{dp}"], n_s), mesh, tile=16),
              "bucketed": as_design(to_slab_buckets(to_by_feature(a["sX"]), dp), n=n_s, mesh=mesh,
                                    tile=16)}
    split = {"coords": [mesh.data_rank, mesh.model_rank]}
    for tag, des in pieces.items():
        st = des._mesh_state(16)
        split[tag] = dict(nbytes=des.slab_nbytes(), resident=des.residency_stats()[16]["total_bytes"],
                          lo=st.lo, p_work=st.p_work)
    dense = ShardedDesign(DenseDesign(a["dX"]), mesh, tile=16)
    split["dense_shape"] = list(dense.inner.X.shape)
    flat = pieces["flat"]
    st = flat._mesh_state(16)
    mask = torch.zeros(st.p_work, dtype=torch.bool)
    mask[:96:3] = True
    mesh.reset_stats()
    sub, _, _ = flat._gather_work(torch.zeros(st.p_work), mask, 64, st.k_max, tile=16)
    (rows_g, vals_g, _), = sub.inner.pieces
    split["gather"] = dict(stats=mesh.stats(), lo=sub.inner.lo, k=st.k_max)
    out.update(gather_rows=rows_g.numpy(), gather_vals=vals_g.numpy())
    # the Gram tile of features [16, 48) (across model ranks), on every rank
    n_d = len(a["dy"])
    wv, rv = 0.25 + (torch.arange(n_d) % 7) / 10.0, torch.sin(torch.arange(n_d, dtype=torch.float32))
    rows = slice(mesh.data_rank * (n_d // data), (mesh.data_rank + 1) * (n_d // data))
    G, c = dense.gram_tile(wv[rows], rv[rows], 16, 32)
    out.update(gram_dense_G=G.numpy(), gram_dense_c=c.numpy())
    sdes = ShardedDesign(SlabDesign.from_dense(a["dX"], data), mesh, tile=16)
    G, c = sdes.gram_tile(wv[rows], rv[rows], 16, 32)
    out.update(gram_slab_G=G.numpy(), gram_slab_c=c.numpy())
    # decision_function: every rank scores all 64 rows
    est = LogisticL1(DGLMNETOptions(**DENSE), mesh=mesh, device="cpu")
    beta = torch.from_numpy(out["dense_beta"])
    out.update(score_dense=est.decision_function(a["dX"][:64], beta=beta).numpy(),
               score_slab=est.decision_function(SlabDesign.from_dense(a["dX"][:64], data),
                                                beta=beta).numpy())
    msgs["split"] = split
    np.savez(f"{work}/w{world}_r{rank}.npz", **out)
    with open(f"{work}/w{world}_r{rank}.json", "w") as fh:
        json.dump(msgs, fh)
    print("OK rank", rank)
"""


def _settings(code: str) -> str:
    consts = (f"DENSE = {DENSE!r}\nSLAB = {SLAB!r}\nPATH = {PATH!r}\nSSTEP = {SSTEP!r}\n"
              f"PATH_LEN = {PATH_LEN}\n")
    return consts + textwrap.dedent(code)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **extra)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _launch(argv_list, env, workdir, tag):
    procs = []
    for i, argv in enumerate(argv_list):
        log = open(os.path.join(workdir, f"{tag}_{i}.log"), "w")
        procs.append((subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, env=env),
                      log))
    return procs


def _wait(groups, deadline: float):
    """Wait for every process of every group until ``deadline`` (a
    monotonic time); past it, kill them all and fail."""
    late = []
    for procs in groups:
        for proc, log in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                late.append(proc.args)
            finally:
                log.close()
    if late:
        for procs in groups:
            for proc, _ in procs:
                proc.kill()
                proc.wait()
        pytest.fail(f"spawned processes past their {DEADLINE} s deadline: {late}")


def _logs(workdir, tag):
    return "\n".join(open(os.path.join(workdir, f)).read()[-3000:]
                     for f in sorted(os.listdir(workdir)) if f.startswith(tag) and
                     f.endswith(".log"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and each port rank's, from one module run:
    the reference's subprocess and both port worlds start together."""
    work = str(tmp_path_factory.mktemp("dist"))
    np.savez(os.path.join(work, "inputs.npz"), **_inputs())
    ref = _launch([[sys.executable, "-c", _settings(REFERENCE), work]],
                  _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                       JAX_PLATFORMS="cpu"), work, "ref")
    worlds = {}
    for world, data in ((8, 2), (2, 1)):
        worlds[world] = _launch([[sys.executable, "-c", _settings(RANK), str(r),
                                  str(world), str(data), work] for r in range(world)],
                                _env(OMP_NUM_THREADS="1"), work, f"w{world}")
    _wait([ref, *worlds.values()], time.monotonic() + DEADLINE)
    for tag, procs in (("ref", ref), *((f"w{w}", p) for w, p in worlds.items())):
        bad = [proc.returncode for proc, _ in procs if proc.returncode]
        assert not bad, f"{tag} failed {bad}:\n{_logs(work, tag)}"
    out = {"ref": dict(np.load(os.path.join(work, "reference.npz")))}
    for world in worlds:
        out[world] = [(dict(np.load(os.path.join(work, f"w{world}_r{r}.npz"))),
                       json.load(open(os.path.join(work, f"w{world}_r{r}.json"))))
                      for r in range(world)]
    out["inputs"] = dict(np.load(os.path.join(work, "inputs.npz")))
    return out


def _fit_close(f, beta, ref_f, ref_beta):
    assert abs(f - ref_f) / abs(ref_f) < 1e-4, (f, ref_f)
    np.testing.assert_allclose(beta, ref_beta, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("world,kind", [(8, "dense"), (8, "slab"), (8, "bucketed"),
                                        (2, "dense"), (2, "slab")],
                         ids=["dense-2x4", "slab-2x4", "bucketed-2x4", "dense-1x4", "slab-1x4"])
def test_fit_matches_reference(runs, world, kind):
    """Fits against the reference's; the bucketed layout (2 or more K
    classes) against the reference's fit of the same problem's flat
    slabs."""
    tag = "2x4" if world == 8 else "1x4"
    out, msgs = runs[world][0]
    info = msgs[kind]
    assert info["ok"], info
    ref = "slab" if kind == "bucketed" else kind
    _fit_close(float(out[f"{kind}_hist"][-1]), out[f"{kind}_beta"],
               float(runs["ref"][f"{ref}{tag}_f"]), runs["ref"][f"{ref}{tag}_beta"])
    # every rank reads the device k + 1 times (k + 2 for slab layouts:
    # the entry read of the slabs' largest row)
    assert info["reads"] == info["iters"] + (1 if kind == "dense" else 2), info
    if kind == "bucketed":
        assert info["classes"] >= 2, info


@pytest.mark.parametrize("world,key", [(8, "dense"), (8, "slab"), (8, "bucketed"), (8, "path"),
                                       (8, "step"), (2, "dense"), (2, "slab")],
                         ids=["dense-2x4", "slab-2x4", "bucketed-2x4", "path-2x4", "step-2x4",
                              "dense-1x4", "slab-1x4"])
def test_ranks_hold_the_same_bits(runs, world, key):
    ranks = runs[world]
    keys = [k for k in ranks[0][0] if k.startswith(key) and not k.endswith("_m")]
    assert keys
    for out, _ in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][0][k], err_msg=k)


def test_margins_are_the_ranks_rows(runs):
    """``res.m`` is X @ beta on the rank's own example shard."""
    X = runs["inputs"]["dX"]
    for out, _ in runs[8]:
        beta = out["dense_beta"]
        full = X @ beta
        assert out["dense_m"].shape == (X.shape[0] // 2,)
        assert any(np.allclose(out["dense_m"], full[s], rtol=1e-4, atol=1e-4)
                   for s in (slice(0, X.shape[0] // 2), slice(X.shape[0] // 2, None)))


@pytest.mark.parametrize("kind", ["step", "sstep"])
def test_one_step_matches_reference(runs, kind):
    out, ref = runs[8][0][0], runs["ref"]
    np.testing.assert_allclose(out[f"{kind}_beta_new"], ref[f"{kind}_beta_new"], rtol=1e-3,
                               atol=1e-5)
    assert abs(float(out[f"{kind}_f"]) - ref[f"{kind}_f"]) <= 1e-4 * abs(ref[f"{kind}_f"])
    assert abs(float(out[f"{kind}_alpha"]) - ref[f"{kind}_alpha"]) <= 1e-3


def test_path_matches_reference(runs):
    """The 6-point screened slab path on (2, 4) against the reference's
    ``regularization_path_distributed``: per point the objective gap,
    nnz within 2, supports agreeing above 1e-2, betas within the fit
    tolerance, a KKT certificate at the port's solution, and a working
    set narrower than p somewhere."""
    out, ref, inp = runs[8][0][0], runs["ref"], runs["inputs"]
    X, y = inp["pX"].astype(np.float64), inp["py"].astype(np.float64)
    assert len(out["path_f"]) == PATH_LEN and not out["path_status"].any()
    np.testing.assert_allclose(out["path_lams"], ref["path_lams"], rtol=1e-6)
    for i in range(PATH_LEN):
        f, rf = float(out["path_f"][i]), float(ref["path_f"][i])
        assert abs(f - rf) / max(abs(rf), 1e-9) < 1e-4, (i, f, rf)
        assert abs(int(out["path_nnz"][i]) - int(ref["path_nnz"][i])) <= 2, i
        b, rb = out["path_betas"][i], ref["path_betas"][i]
        disagree = (np.abs(b) > 0) != (np.abs(rb) > 0)
        assert np.all(np.maximum(np.abs(b), np.abs(rb))[disagree] < 1e-2), i
        np.testing.assert_allclose(b, rb, rtol=1e-2, atol=1e-3)
        g = np.abs(X.T @ (1.0 / (1.0 + np.exp(-(X @ b))) - (y + 1.0) * 0.5))
        lam = float(out["path_lams"][i])
        assert np.all(g[b == 0] <= lam * (1 + 2e-3) + 1e-5), i
    assert (out["path_active"] < X.shape[1]).any()


def test_guards_raise_the_reference_messages(runs):
    """Each guard of ``tests/test_distributed.py``'s
    ``test_divisibility_and_slab_guards`` raises on every rank of the
    (2, 4) mesh with the reference's message (before any collective)."""
    want = {"dense_n": "data extent 2 must divide n=17",
            "slab_dp": "must equal the mesh data extent 2",
            "slab_shape": "must match and be (p, DP, K)",
            "slab_n": "data extent 2 must divide n=17",
            "slab_rows": "exceeds the local example count 9"}
    for _, msgs in runs[8]:
        for name, text in want.items():
            assert msgs[name] is not None and text in msgs[name], (name, msgs[name])


def test_split_design_is_cut_at_its_tile(runs):
    """A design split over ranks holds its run of the feature axis padded
    at its own tile: a solve or a residency at another tile raises (before
    any collective) instead of solving blocks the rank does not hold."""
    for _, msgs in runs[8]:
        for name in ("tile_dense", "tile_slab"):
            assert msgs[name] is not None and "cut at tile=16" in msgs[name], (name, msgs[name])


def test_collectives_per_iteration(runs):
    """The reductions a dense fit makes, per rank: over ``data`` f(beta0)
    and the snap-back once, then per iteration the fused NLL, one (G, c)
    per tile step (2 here), grad_dot, f(1), the golden section's 25
    batches and the ladder; over ``model`` dm and dbeta."""
    for world, axis_calls in ((8, lambda k: {"data": 2 + 31 * k, "model": 2 * k}),
                              (2, lambda k: {"model": 2 * k})):
        for _, msgs in runs[world]:
            info = msgs["dense"]
            calls = {ax: c for ax, (c, _) in info["stats"].items()}
            assert calls == axis_calls(info["iters"]), (world, info)


def _rank_of(msgs):
    return tuple(msgs["split"]["coords"])


def _padded_buckets(dp):
    """(padded width, K) of each work bucket of the slab problem's
    layouts, each bucket padded to M * tile = 64, as the tests build them."""
    X = torch.from_numpy(_inputs()["sX"])
    flat = to_slabs(to_by_feature(X), dp)[0]
    buckets = to_slab_buckets(to_by_feature(X), dp).buckets
    return {"flat": [(128, int(flat.shape[2]))],
            "bucketed": [(int(r.shape[0]) + (-int(r.shape[0])) % 64, int(r.shape[2]))
                         for r, _, _ in buckets]}


@pytest.mark.parametrize("world", [8, 2], ids=["2x4", "1x4"])
def test_each_rank_holds_its_piece(runs, world):
    """Rank (d, r) keeps its example shard of the r-th contiguous 1 / R of
    the padded work axis: a flat slab's bytes are the global padded bytes
    / (D R) on every rank; a bucketed layout's are the bytes of the bucket
    ranges in its run (the runs of a data row add up to the global / D);
    the dense shard is (n / D, p_pad / R)."""
    data = 2 if world == 8 else 1
    ranks = world // data
    widths = _padded_buckets(data)
    n = len(runs["inputs"]["dy"])
    row_sums = {}
    for _, msgs in runs[world]:
        d, r = _rank_of(msgs)
        split = msgs["split"]
        for tag, buckets in widths.items():
            p_work = sum(w for w, _ in buckets)
            lo, hi = r * p_work // ranks, (r + 1) * p_work // ranks
            want, off = 0, 0
            for w, k in buckets:
                want += max(0, min(hi, off + w) - max(lo, off)) * k * 8
                off += w
            info = split[tag]
            assert (info["lo"], info["p_work"]) == (lo, p_work), (tag, info)
            assert info["nbytes"] == info["resident"] == want, (tag, d, r, info, want)
            row_sums[(tag, d)] = row_sums.get((tag, d), 0) + want
        glob = 128 * data * widths["flat"][0][1] * 8
        assert split["flat"]["nbytes"] == glob // (data * ranks)
        assert split["dense_shape"] == [n // data, 128 // ranks]
    for (tag, _), total in row_sums.items():
        assert total == sum(w * k for w, k in widths[tag]) * 8, tag


@pytest.mark.parametrize("world", [8, 2], ids=["2x4", "1x4"])
def test_restricted_gather_moves_one_block_at_a_time(runs, world):
    """The screened path's restricted design is split like the design:
    rank r holds the r-th cap / R of the working set, each slab moved from
    its owner with its row sentinel intact, in R merges over ``model`` of
    one block each (rows and values in one int32 reduction)."""
    inp = runs["inputs"]
    data = 2 if world == 8 else 1
    ranks = world // data
    rows_g, vals_g = inp[f"srows{data}"], inp[f"svals{data}"]
    n_loc = len(inp["sy"]) // data
    pad = 128 - rows_g.shape[0]
    rows_p = np.concatenate([rows_g, np.full((pad, *rows_g.shape[1:]), n_loc, np.int32)])
    vals_p = np.concatenate([vals_g, np.zeros((pad, *vals_g.shape[1:]), np.float32)])
    idx = np.full(64, 128)
    idx[:32] = np.arange(0, 96, 3)
    w = 64 // ranks
    for out, msgs in runs[world]:
        d, r = _rank_of(msgs)
        info = msgs["split"]["gather"]
        block = idx[r * w:(r + 1) * w]
        live = block < 128
        want_rows = np.where(live[:, None], rows_p[np.minimum(block, 127), d], n_loc)
        want_vals = np.where(live[:, None], vals_p[np.minimum(block, 127), d], 0.0)
        np.testing.assert_array_equal(out["gather_rows"][:, 0], want_rows)
        np.testing.assert_array_equal(out["gather_vals"][:, 0], want_vals)
        assert info["lo"] == r * w
        calls, nbytes = info["stats"]["model"]
        assert calls == ranks and nbytes == ranks * 2 * w * info["k"] * 4, info


@pytest.mark.parametrize("world", [8, 2], ids=["2x4", "1x4"])
@pytest.mark.parametrize("layout", ["dense", "slab"])
def test_gram_tile_across_model_ranks(runs, world, layout):
    """``gram_tile`` of features [16, 48), which span model ranks, is the
    whole tile's (G, c) on every rank."""
    X = runs["inputs"]["dX"].astype(np.float64)
    n = X.shape[0]
    wv, rv = 0.25 + (np.arange(n) % 7) / 10.0, np.sin(np.arange(n, dtype=np.float32))
    Xf = X[:, 16:48]
    G, c = Xf.T @ (wv[:, None] * Xf), (wv[:, None] * Xf).T @ rv
    for out, _ in runs[world]:
        np.testing.assert_allclose(out[f"gram_{layout}_G"], G, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(out[f"gram_{layout}_c"], c, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("world", [8, 2], ids=["2x4", "1x4"])
@pytest.mark.parametrize("layout", ["dense", "slab"])
def test_decision_function_returns_every_row(runs, world, layout):
    """On a process mesh ``decision_function`` returns all n rows on every
    rank, as the reference's: each rank's piece summed over ``model``,
    the shards collected over ``data``; the same bits on every rank."""
    X = runs["inputs"]["dX"][:64].astype(np.float64)
    ranks = runs[world]
    first = ranks[0][0][f"score_{layout}"]
    assert first.shape == (64,)
    np.testing.assert_allclose(first, X @ ranks[0][0]["dense_beta"], rtol=1e-5, atol=1e-5)
    for out, _ in ranks[1:]:
        np.testing.assert_array_equal(out[f"score_{layout}"], first)


def test_path_collectives_per_lambda(runs):
    """The screened path's reductions over ``model`` on (2, 4), per rank:
    one collection per screen (lambda_max, each point's strong rule, each
    KKT pass), and per restricted solve R = 4 merges of its gather, the
    warm start's margins and 2 an iteration (dm, dbeta)."""
    for _, msgs in runs[8]:
        info = msgs["path"]
        want = info["screens"] + sum(4 + 1 + 2 * it for it in info["solves"])
        assert info["stats"]["model"][0] == want, info
        assert info["screens"] >= 1 + 2 * info["points"], info


def test_dense_path_on_split_design(runs):
    """The dense design's screened path on (2, 4), each rank holding its
    (n / 2, p_pad / 4) piece, against the reference's ``LogisticL1.path``
    of the same dense X on its (2, 4) mesh and against the port's
    ``make_dev_mesh(1, 4)`` path (the fit tolerance); the ranks hold the
    same bits."""
    from repro_torch.api import LogisticL1
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.launch.mesh import make_dev_mesh

    inp = runs["inputs"]
    dev = LogisticL1(DGLMNETOptions(**PATH), mesh=make_dev_mesh(1, 4, device="cpu"),
                     device="cpu").path(inp["pX"], inp["py"], path_len=3)
    out = runs[8][0][0]
    for want_f, want_betas in ((runs["ref"]["dpath_f"], runs["ref"]["dpath_betas"]),
                               (dev.f, dev.betas.numpy())):
        assert len(out["dpath_f"]) == len(want_f) == 3
        for i, f in enumerate(want_f):
            assert abs(out["dpath_f"][i] - f) / abs(f) < 1e-4, (i, out["dpath_f"][i], f)
        np.testing.assert_allclose(out["dpath_betas"], want_betas, rtol=1e-2, atol=1e-3)
    for other, _ in runs[8][1:]:
        np.testing.assert_array_equal(other["dpath_betas"], out["dpath_betas"])
        np.testing.assert_array_equal(other["dpath_f"], out["dpath_f"])


def _single_rank_world(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_process_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    return make_process_mesh(1, 4, backend="gloo", device="cpu")


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    mesh = _single_rank_world(tmp_path)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["dense", "slab", "path"])
def test_world_of_one_is_bit_equal_to_dev_mesh(world_of_one, kind):
    """A one-rank process mesh skips every collective: its fits and path
    are bit for bit a ``make_dev_mesh(1, 4)``'s, with the same host
    reads."""
    from repro_torch.api import LogisticL1, SlabDesign
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.launch.mesh import make_dev_mesh

    inp = _inputs()
    runs = []
    for mesh in (world_of_one, make_dev_mesh(1, 4, device="cpu")):
        engine.host_syncs = 0
        if kind == "dense":
            est = LogisticL1(DGLMNETOptions(**DENSE), mesh=mesh, device="cpu")
            res = est.fit(inp["dX"], inp["dy"], float(inp["dlam"]))
            runs.append((res.beta, res.objective_history, engine.host_syncs))
        elif kind == "slab":
            design = SlabDesign(torch.from_numpy(inp["srows1"]), torch.from_numpy(inp["svals1"]),
                                len(inp["sy"]))
            est = LogisticL1(DGLMNETOptions(**SLAB), mesh=mesh, device="cpu")
            res = est.fit(design, inp["sy"], float(inp["slam"]), densify=False)
            runs.append((res.beta, res.objective_history, engine.host_syncs))
        else:
            rows, vals, _ = to_slabs(to_by_feature(torch.from_numpy(inp["pX"])), 1)
            est = LogisticL1(DGLMNETOptions(**PATH), mesh=mesh, device="cpu")
            pts = est.path(SlabDesign(rows, vals, len(inp["py"])), inp["py"], path_len=3)
            runs.append((pts.betas, list(pts.f), engine.host_syncs))
    (b1, h1, r1), (b2, h2, r2) = runs
    assert torch.equal(b1, b2) and h1 == h2 and r1 == r2


@pytest.mark.parametrize("part", ["streamed", "resumed", "faulted", "served"])
def test_not_ported_parts_raise_on_a_process_mesh(world_of_one, tmp_path, part):
    """What a process mesh once refused now runs: on a world of one rank a
    streamed path, a killed and resumed path, a fit under an injected
    fault and a store's served scores are bit-equal to the same calls on
    ``make_dev_mesh(1, 4)``, with the same host reads."""
    from repro_torch.api import LogisticL1, SlabDesign, as_design
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.data.byfeature import SlabBuckets
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.resilience import (EngineFault, FaultPlan, InjectedKill,
                                        inject_faults)
    from repro_torch.serve import PathScorer, PathStore, RequestBatcher

    inp = _inputs()
    rows, vals = torch.from_numpy(inp["srows1"]), torch.from_numpy(inp["svals1"])
    n = len(inp["sy"])
    runs = []
    for mesh in (world_of_one, make_dev_mesh(1, 4, device="cpu")):
        engine.host_syncs = 0
        if part == "streamed":
            w = rows.shape[0] // 3
            slabs = SlabBuckets(tuple((rows[i * w:(i + 1) * w], vals[i * w:(i + 1) * w],
                                       torch.arange(i * w, (i + 1) * w)) for i in range(3)),
                                n_loc=n, p=rows.shape[0])
            sizing = as_design(slabs, mesh=mesh, tile=16)
            budget = 2 * max(sizing.slab_bucket_nbytes(16))
            design = as_design(slabs, mesh=mesh, tile=16, device_budget_bytes=budget)
            est = LogisticL1(DGLMNETOptions(device_budget_bytes=budget, **PATH), mesh=mesh,
                             device="cpu")
            pts = est.path(design, inp["sy"], path_len=3)
            stats = design.residency_stats()[16]
            assert stats["streamed"] and stats["evictions"] > 0, stats
            runs.append((pts.betas, list(pts.f), engine.host_syncs))
        elif part == "resumed":
            design = SlabDesign(rows, vals, n)
            est = LogisticL1(DGLMNETOptions(**PATH), mesh=mesh, device="cpu")
            d = str(tmp_path / f"progress{len(runs)}")
            with pytest.raises(InjectedKill):
                with inject_faults(FaultPlan(kill_after_points=1)):
                    est.path(design, inp["sy"], path_len=3, checkpoint_every=1, resume_from=d)
            engine.host_syncs = 0
            pts = est.path(design, inp["sy"], path_len=3, checkpoint_every=1, resume_from=d)
            full = est.path(design, inp["sy"], path_len=3)
            assert torch.equal(pts.betas, full.betas) and list(pts.f) == list(full.f)
            runs.append((pts.betas, list(pts.f), engine.host_syncs))
        elif part == "faulted":
            est = LogisticL1(DGLMNETOptions(**SLAB), mesh=mesh, device="cpu")
            with inject_faults(FaultPlan(engine=EngineFault("margins", at_iter=2),
                                         engine_fires=1)):
                res = est.fit(SlabDesign(rows, vals, n), inp["sy"], float(inp["slam"]),
                              densify=False)
            assert res.status_name == "NONFINITE_OBJECTIVE" and res.n_iters == 1
            runs.append((res.beta, res.objective_history, engine.host_syncs))
        else:
            est = LogisticL1(DGLMNETOptions(**PATH), mesh=mesh, device="cpu")
            path = est.path(SlabDesign(rows, vals, n), inp["sy"], path_len=3)
            store = PathStore(path, mesh=mesh, tile=16, device="cpu")
            batcher = RequestBatcher(rows.shape[0], max_batch=16, dp=store.dp,
                                     pad_p_to=store.pad_p_to)
            rng = np.random.default_rng(0)
            for i in range(12):
                batcher.submit({f"tok{t}": float(rng.normal())
                                for t in rng.integers(0, 4 * rows.shape[0], size=5)},
                               float(path.lambdas[i % 3]))
            batch, lams = batcher.drain()
            engine.host_syncs = 0
            scores, ver = PathScorer(store).score(batch, lams)
            runs.append((torch.from_numpy(scores), [ver], engine.host_syncs))
    (b1, h1, r1), (b2, h2, r2) = runs
    assert torch.equal(b1, b2) and h1 == h2 and r1 == r2


def test_mesh_constructors_and_guards(world_of_one):
    from repro_torch.launch.mesh import (check_devices, make_dev_mesh, make_process_mesh,
                                         num_chips, parse_mesh)
    from repro_torch.sharding.collect import concat_replicated, replicate

    assert world_of_one.shape == {"data": 1, "model": 4} and world_of_one.ranks == 1
    assert world_of_one.local_blocks == 4 and num_chips(world_of_one) == 1
    assert world_of_one.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="process mesh"):
        make_dev_mesh(2, 4, device="cpu")
    with pytest.raises(ValueError, match="never switches backends"):
        make_process_mesh(1, 4, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="must divide the world size"):
        make_process_mesh(2, 4, backend="gloo", device="cpu")
    # the NCCL guard: one card per rank
    check_devices("nccl", [(1, "cuda:0"), (1, "cuda:1"), (2, "cuda:0")])
    with pytest.raises(ValueError, match="share cuda:0"):
        check_devices("nccl", [(1, "cuda:0"), (1, "cuda:0")])
    with pytest.raises(ValueError, match="needs a card"):
        check_devices("nccl", [(1, "cpu")])
    check_devices("gloo", [(1, "cuda:0"), (1, "cuda:0")])
    mesh = parse_mesh("1x4", backend="gloo", device="cpu")
    assert mesh.shape == {"data": 1, "model": 4} and mesh.ranks == 1
    with pytest.raises(ValueError, match="backend="):
        parse_mesh("1x4", device="cpu")
    # collection on an axis of one rank: the piece is the whole
    t = torch.arange(6.0)
    assert concat_replicated(t, world_of_one) is t
    with pytest.raises(ValueError, match="one rank holds the whole axis"):
        replicate(t[:2], world_of_one, start=2, size=6)


def test_dev_mesh_parse_and_count_without_a_world():
    from repro_torch.launch.mesh import DevMesh, num_chips, parse_mesh

    mesh = parse_mesh("1x8", device="cpu")
    assert isinstance(mesh, DevMesh) and mesh.shape == {"data": 1, "model": 8}
    assert num_chips(mesh) == 1 and mesh.all_reduce(torch.ones(2), "data").sum() == 2
    with pytest.raises(ValueError, match="expected 'prod' or 'DxM'"):
        parse_mesh("four", device="cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        parse_mesh("prod")


def test_mesh_programs_resolve_as_live_solves(world_of_one):
    """``mesh_programs`` hands out the layout's step and screen: on a world
    of one the dense step is bit-equal to the DevMesh step, and the
    screen to ``make_sparse_screen``."""
    from repro_torch.api.strategy import mesh_programs
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.core.screening import make_sparse_screen
    from repro_torch.launch.mesh import make_dev_mesh

    inp = _inputs()
    X, y = torch.from_numpy(inp["dX"]), torch.from_numpy(inp["dy"])
    beta = torch.from_numpy(inp["step_beta"])
    opts = DGLMNETOptions(cycle_mode="auto", **DENSE)
    outs = []
    for mesh in (world_of_one, make_dev_mesh(1, 4, device="cpu")):
        step, screen = mesh_programs(mesh, opts, layout="dense")
        assert screen is None
        outs.append(step(X, y, beta, X @ beta, float(inp["dlam"])))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    rows = torch.from_numpy(inp["srows1"])
    vals = torch.from_numpy(inp["svals1"])
    step, screen = mesh_programs(world_of_one, opts, layout="slab", n_loc=len(inp["sy"]))
    pad = (-rows.shape[0]) % 16
    rows = torch.cat([rows, rows.new_full((pad, 1, rows.shape[2]), len(inp["sy"]))])
    vals = torch.cat([vals, vals.new_zeros((pad, 1, vals.shape[2]))])
    sy, m = torch.from_numpy(inp["sy"]), torch.zeros(len(inp["sy"]))
    want = make_sparse_screen(world_of_one, len(inp["sy"]), 16)(rows, vals, sy, m)
    assert torch.equal(screen(rows, vals, sy, m), want)
    with pytest.raises(ValueError, match="unknown layout"):
        mesh_programs(world_of_one, opts, layout="csr")
