"""The rest of the process mesh: streamed residency, fault injection,
checkpoint-resume and serving on a ``launch.mesh.ProcMesh``, and the pod
axis, against the JAX reference's (2, 4) and (2, 1, 2) meshes of fake
CPU devices.

* The reference runs once per module in one subprocess with 8 fake
  devices (as ``tests/test_torch_distributed.py`` runs it): a streamed
  4-point path on (2, 4) (the shape of ``tests/test_residency.py``'s
  ``test_streamed_path_bit_identical_2x4_mesh``, on the buckets below),
  the nan-inject drill of ``repro.launch.chaos_glm`` on (2, 4), a path
  fitted on (2, 4) and saved, and ``PathScorer``'s scores of one request
  batch from it (``tests/test_serve.py``'s mesh case), and a fit on
  ``parse_mesh("2x1x2")``.
* The port runs the same numpy inputs as 8 spawned gloo ranks on a
  (2, 4) mesh and 4 ranks on (2, 2) and (2, 1, 2) meshes of one world,
  beside the reference's subprocess. Each rank is a ``python -c`` started
  from a ``file://`` store in the module's own directory; the spawns share
  one deadline, past which every one of them is killed, and each is
  reaped in a ``finally``. No TCP port is used.
* Bit for bit on every rank: streamed == resident (fit and 4-point path,
  both cycle modes), a killed and resumed path == the uninterrupted one
  (also when one rank lost its newest slot), the served scores ==
  ``decision_function`` through the same mesh, (2, 1, 2) == (2, 2).
* Against the reference, its tolerances: fit vs fit a relative objective
  gap < 1e-4 and betas within rtol 1e-2 / atol 1e-3
  (``tests/test_distributed.py:222-226``); served scores within 1e-5 of
  the reference's ``PathScorer`` on the same saved path.

The streamed cell is 12 feature-range buckets of one K class (16
features each), so that each of the 4 model ranks holds 3 pieces and a
budget of 2 of them streams on every rank; the reference streams the same
buckets under its own budget.
"""
import __future__
import json
import os
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds all the spawns of the module may take together (about 130 s
#: alone on an 8-core host, twice that beside five busy test workers)
DEADLINE = 600
#: the streamed cell: 12 buckets of 16 features, tile 4, so M * tile = 16
BUCKETS, WIDTH = 12, 16
STREAM = dict(tile=4, max_iters=30)
DENSE = dict(tile=16, max_iters=40)
PATH_LEN = 4


def _inputs():
    """numpy inputs: the streamed cell (n 256, p 192, every feature 10
    examples, slabs of 2 example shards), the serve problem of
    ``tests/test_serve.py`` (n 64, p 24) and the pod cell (n 256, p 64,
    dense)."""
    from repro_torch.data.byfeature import to_by_feature, to_slabs

    rng = np.random.default_rng(0)
    n, p = 256, BUCKETS * WIDTH
    X = np.zeros((n, p), np.float32)
    for j in range(p):
        rows = rng.choice(n, size=10, replace=False)
        X[rows, j] = rng.normal(size=10).astype(np.float32)
    w = rng.normal(size=p) * (rng.random(p) < 0.3)
    y = np.where(rng.random(n) < 1.0 / (1.0 + np.exp(-(X @ w))), 1.0, -1.0).astype(np.float32)
    rows, vals, _ = to_slabs(to_by_feature(torch.from_numpy(X)), 2)
    out = dict(bX=X, by=y, brows=rows.numpy(), bvals=vals.numpy(),
               blam=np.float32(np.abs(X.T @ (0.5 * y)).max() / 8))
    rng = np.random.default_rng(1)
    Xs = ((rng.random((64, 24)) < 0.25) * rng.normal(size=(64, 24))).astype(np.float32)
    ys = np.where(rng.random(64) < 0.5, 1.0, -1.0).astype(np.float32)
    rng = np.random.default_rng(2)
    Xp = rng.normal(size=(256, 64)).astype(np.float32)
    wp = rng.normal(size=64) * (rng.random(64) < 0.3)
    yp = np.where(rng.random(256) < 1.0 / (1.0 + np.exp(-(Xp @ wp))), 1.0, -1.0)
    out.update(sX=Xs, sy=ys, pX=Xp, py=yp.astype(np.float32),
               plam=np.float32(np.abs(Xp.T @ (0.5 * yp)).max() / 16))
    return out


COMMON = """
import json, sys
import numpy as np

def requests(X, p, lambdas, hash_token):
    toks = {}
    for j in range(p):
        t = 0
        while hash_token(f"t{j}_{t}", p) != j:
            t += 1
        toks[j] = f"t{j}_{t}"
    return [({toks[j]: float(X[i, j]) for j in range(p) if X[i, j] != 0.0},
             float(lambdas[i % len(lambdas)])) for i in range(X.shape[0])]
"""

REFERENCE = """
import jax.numpy as jnp
from repro.api import LogisticL1, as_design
from repro.core import DGLMNETOptions, fit_distributed
from repro.data.byfeature import SlabBuckets
from repro.launch.mesh import make_dev_mesh, parse_mesh
from repro.resilience import EngineFault, FaultPlan, inject_faults
from repro.serve import PathScorer, PathStore, RequestBatcher, hash_token

work = sys.argv[1]
a = dict(np.load(f"{work}/inputs.npz"))
out = {}
mesh = make_dev_mesh(2, 4)
# the served path first: the port's ranks wait for it
path = LogisticL1(mesh=mesh).path(jnp.asarray(a["sX"]), jnp.asarray(a["sy"]), path_len=4)
path.save(f"{work}/ref_path")
open(f"{work}/ref_path.ready", "w").close()
store = PathStore(path, mesh=mesh, tile=8)
b = RequestBatcher(24, max_batch=128, dp=2, pad_p_to=store.pad_p_to)
for req, lam in requests(a["sX"], 24, path.lambdas, hash_token):
    b.submit(req, lam)
batch, lams = b.drain()
out["serve_scores"], _ = PathScorer(store).score(batch, lams)
# the streamed path on the 12 feature-range buckets
W = a["brows"].shape[0] // WIDTH
buckets = SlabBuckets(tuple((jnp.asarray(a["brows"][i * WIDTH:(i + 1) * WIDTH]),
                             jnp.asarray(a["bvals"][i * WIDTH:(i + 1) * WIDTH]),
                             np.arange(i * WIDTH, (i + 1) * WIDTH)) for i in range(W)),
                      n_loc=len(a["by"]) // 2, p=a["brows"].shape[0])
opts = DGLMNETOptions(**STREAM)
base = LogisticL1(opts=opts, mesh=mesh).path(as_design(buckets, mesh=mesh, tile=STREAM["tile"]),
                                            a["by"], path_len=PATH_LEN)
sizing = as_design(buckets, mesh=mesh, tile=STREAM["tile"])
budget = sizing.slab_nbytes(STREAM["tile"]) - min(sizing.slab_bucket_nbytes(STREAM["tile"]))
des = as_design(buckets, mesh=mesh, tile=STREAM["tile"], device_budget_bytes=budget)
streamed = LogisticL1(opts=opts, mesh=mesh).path(des, a["by"], path_len=PATH_LEN)
assert np.array_equal(np.asarray(streamed.betas), np.asarray(base.betas))
out.update(stream_f=np.asarray(streamed.f), stream_betas=np.asarray(streamed.betas),
           stream_lams=np.asarray(streamed.lambdas))
# the nan-inject drill (repro.launch.chaos_glm scenario_nan_inject) on (2, 4)
est = LogisticL1(opts=DGLMNETOptions(**DENSE), mesh=mesh)
X, y = jnp.asarray(a["bX"]), jnp.asarray(a["by"])
healthy = est.fit(X, y, float(a["blam"]))
with inject_faults(FaultPlan(engine=EngineFault("margins", at_iter=3), engine_fires=1)):
    res = est.fit(X, y, float(a["blam"]))
nb = len(res.objective_history)
again = est.fit(X, y, float(a["blam"]))
out.update(nan_status=res.status_name, nan_iters=res.n_iters,
           nan_prefix=res.objective_history == healthy.objective_history[:nb],
           nan_finite=bool(np.isfinite(np.asarray(res.beta)).all()),
           nan_again=bool(np.array_equal(np.asarray(again.beta), np.asarray(healthy.beta))),
           nan_healthy_f=healthy.f)
# the pod axis
pm = parse_mesh("2x1x2")
res = fit_distributed(jnp.asarray(a["pX"]), jnp.asarray(a["py"]), float(a["plam"]), pm,
                      opts=DGLMNETOptions(num_blocks=2, **DENSE))
out.update(pod_beta=np.asarray(res.beta), pod_f=res.f, pod_shape=dict(pm.shape))
np.savez(f"{work}/reference.npz", **{k: v for k, v in out.items() if k != "pod_shape"})
json.dump({k: out[k] for k in ("nan_status", "nan_iters", "nan_prefix", "nan_finite",
                               "nan_again", "pod_shape")},
          open(f"{work}/reference.json", "w"))
print("OK reference")
"""

RANK8 = """
import os, shutil, time
from datetime import timedelta
import torch
torch.set_num_threads(1)
from repro_torch.api import LogisticL1, PathResult, ShardedDesign, SlabDesign, as_design
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data.byfeature import SlabBuckets
from repro_torch.launch.mesh import init_process_mesh, make_dev_mesh, world_scope
from repro_torch.resilience import EngineFault, FaultPlan, InjectedKill, inject_faults
from repro_torch.serve import PathScorer, PathStore, RequestBatcher, hash_token

with world_scope():
    rank, work = int(sys.argv[1]), sys.argv[2]
    a = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/inputs.npz").items()}
    mesh = init_process_mesh(2, 4, backend="gloo", init_method=f"file://{work}/store8",
                             world_size=8, rank=rank, device="cpu", timeout=timedelta(seconds=120))
    out, msgs = {}, {"coords": [mesh.data_rank, mesh.model_rank]}
    n, p = len(a["by"]), a["brows"].shape[0]
    W = p // WIDTH

    def buckets():
        return SlabBuckets(tuple((a["brows"][i * WIDTH:(i + 1) * WIDTH],
                                  a["bvals"][i * WIDTH:(i + 1) * WIDTH],
                                  torch.arange(i * WIDTH, (i + 1) * WIDTH)) for i in range(W)),
                           n_loc=n // 2, p=p)

    tile = STREAM["tile"]
    sizing = as_design(buckets(), mesh=mesh, tile=tile)
    piece = sizing.inner
    pieces = [piece.piece_nbytes(r, mesh.model_ranks) for r in range(mesh.model_ranks)]
    budget = max(max(x + y for x, y in zip(nb, nb[1:])) for nb in pieces)
    msgs["stream"] = {"pieces": len(piece.pieces), "budget": budget}
    # a budget below some rank's floor raises on every rank, before any collective
    try:
        as_design(buckets(), mesh=mesh, tile=tile, device_budget_bytes=budget - 1)._mesh_state(tile)
        msgs["stream"]["floor_error"] = None
    except ValueError as e:
        msgs["stream"]["floor_error"] = str(e)
    for mode in ("sequential", "blocked"):
        opts = DGLMNETOptions(cycle_mode=mode, block=2, **STREAM)
        for kind in ("resident", "streamed"):
            des = as_design(buckets(), mesh=mesh, tile=tile,
                            device_budget_bytes=budget if kind == "streamed" else None)
            est = LogisticL1(opts, mesh=mesh, device="cpu")
            engine.host_syncs = 0
            res = est.fit(des, a["by"], float(a["blam"]), densify=False)
            fit_reads = engine.host_syncs
            engine.host_syncs = 0
            pts = est.path(des, a["by"], path_len=PATH_LEN)
            tag = f"{mode}_{kind}"
            out.update({f"{tag}_fit_beta": res.beta.numpy(),
                        f"{tag}_fit_hist": np.asarray(res.objective_history),
                        f"{tag}_path_betas": pts.betas.numpy(), f"{tag}_path_f": np.asarray(pts.f),
                        f"{tag}_path_lams": np.asarray(pts.lambdas)})
            msgs[tag] = dict(fit_reads=fit_reads, path_reads=engine.host_syncs,
                             stats=des.residency_stats()[tile], ok=bool(pts.all_ok))

    # checkpoint-resume, one shared directory, per-rank slots
    design = SlabDesign(a["brows"], a["bvals"], n)
    est = LogisticL1(DGLMNETOptions(**STREAM), mesh=mesh, device="cpu")
    engine.host_syncs = 0
    full = est.path(design, a["by"], path_len=PATH_LEN)
    plain_reads = engine.host_syncs
    d = f"{work}/progress"
    engine.host_syncs = 0
    ckpt = est.path(design, a["by"], path_len=PATH_LEN, checkpoint_every=1,
                    resume_from=f"{work}/ckpt_full")
    msgs["ckpt_reads"] = [plain_reads, engine.host_syncs]
    out["ckpt_betas"] = ckpt.betas.numpy()
    killed = None
    try:
        with inject_faults(FaultPlan(kill_after_points=2)):
            est.path(design, a["by"], path_len=PATH_LEN, checkpoint_every=1, resume_from=d)
    except InjectedKill as e:
        killed = str(e)
    msgs["killed"] = killed
    msgs["slots"] = sorted(os.listdir(f"{d}/rank-{rank:05d}"))
    engine.host_syncs = 0
    resumed = est.path(design, a["by"], path_len=PATH_LEN, checkpoint_every=1, resume_from=d)
    msgs["resume_reads"] = engine.host_syncs
    out.update(full_betas=full.betas.numpy(), full_f=np.asarray(full.f),
               resumed_betas=resumed.betas.numpy(), resumed_f=np.asarray(resumed.f))
    msgs["resumed_screen"] = resumed.screen == full.screen
    # rank 0 lost its newest slot (killed between its own saves): every rank
    # resumes from the newest point they all hold, and solves the last point again
    if rank == 0:
        shutil.rmtree(f"{d}/rank-00000/point-{PATH_LEN - 1:05d}")
    resumed2 = est.path(design, a["by"], path_len=PATH_LEN, checkpoint_every=1, resume_from=d)
    out["resumed2_betas"] = resumed2.betas.numpy()
    # a mismatched directory raises on every rank
    errs = {}
    for name, fn in {
            "grid": lambda: est.path(design, a["by"], path_len=3, checkpoint_every=1, resume_from=d),
            "foreign": lambda: est.path(design, a["by"], path_len=PATH_LEN, checkpoint_every=1,
                                        resume_from=f"{work}/single_r{rank}"),
            "dev_mesh": lambda: LogisticL1(DGLMNETOptions(**STREAM), mesh=make_dev_mesh(1, 4, device="cpu"),
                                           device="cpu").path(SlabDesign(a["brows"][:, :1], a["bvals"][:, :1], n // 2),
                                                              a["by"][:n // 2], path_len=PATH_LEN,
                                                              resume_from=d)}.items():
        if name == "foreign":
            one = LogisticL1(DGLMNETOptions(**STREAM), mesh=make_dev_mesh(1, 4, device="cpu"), device="cpu")
            try:
                with inject_faults(FaultPlan(kill_after_points=1)):
                    one.path(SlabDesign(a["brows"][:, :1], a["bvals"][:, :1], n // 2), a["by"][:n // 2],
                             path_len=PATH_LEN, checkpoint_every=1, resume_from=f"{work}/single_r{rank}")
            except InjectedKill:
                pass
        try:
            fn()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    msgs["resume_errors"] = errs

    # nan-inject (the chaos drill) on the dense cell
    est = LogisticL1(DGLMNETOptions(**DENSE), mesh=mesh, device="cpu")
    healthy = est.fit(a["bX"], a["by"], float(a["blam"]))
    with inject_faults(FaultPlan(engine=EngineFault("margins", at_iter=3), engine_fires=1)):
        res = est.fit(a["bX"], a["by"], float(a["blam"]))
    nb = len(res.objective_history)
    again = est.fit(a["bX"], a["by"], float(a["blam"]))
    msgs["nan"] = dict(status=res.status_name, iters=res.n_iters,
                       prefix=res.objective_history == healthy.objective_history[:nb],
                       finite=bool(torch.isfinite(res.beta).all()),
                       again=bool(torch.equal(again.beta, healthy.beta)), healthy_f=healthy.f)
    out["nan_beta"] = res.beta.numpy()

    # serving: the reference's saved path from a process-mesh store
    end = time.monotonic() + 240
    while not os.path.exists(f"{work}/ref_path.ready"):
        if time.monotonic() > end:
            raise SystemExit("the reference's path never landed")
        time.sleep(0.2)
    store = PathStore.from_checkpoint(f"{work}/ref_path", mesh=mesh, tile=8, device="cpu")
    path = PathResult.load(f"{work}/ref_path", device="cpu")
    scorer = PathScorer(store)
    b = RequestBatcher(24, max_batch=128, dp=store.dp, pad_p_to=store.pad_p_to)
    for req, lam in requests(a["sX"].numpy(), 24, path.lambdas, hash_token):
        b.submit(req, lam)
    batch, lams = b.drain()
    engine.host_syncs = 0
    scores, ver = scorer.score(batch, lams)
    out["serve_scores"] = scores
    inner = SlabDesign(torch.from_numpy(batch.row_idx), torch.from_numpy(batch.values), batch.batch_cap)
    sd = ShardedDesign(inner, mesh, tile=8)
    dest = LogisticL1(DGLMNETOptions(tile=8), mesh=mesh, device="cpu")
    equal = []
    for l in range(len(path)):
        beta = torch.nn.functional.pad(path.betas[l], (0, batch.p_pad - 24))
        ref = dest.decision_function(sd, beta=beta).numpy()[:batch.n_live]
        got, _ = scorer.score(batch, np.full(batch.n_live, path.lambdas[l]))
        equal.append(bool(np.array_equal(got, ref)))
    store.swap(PathResult(lambdas=path.lambdas, betas=torch.full_like(path.betas, float("nan")),
                          nnz=path.nnz, f=path.f, n_iters=path.n_iters))
    again, ver2 = scorer.score(batch, lams)
    msgs["serve"] = dict(reads=1, equal=equal, block=list(store.snapshot.betas.shape),
                         p_pad=store.snapshot.p_pad, version=ver, after_quarantine=ver2,
                         quarantined=store.quarantined, rescored=bool(np.array_equal(again, scores)))
    np.savez(f"{work}/w8_r{rank}.npz", **out)
    json.dump(msgs, open(f"{work}/w8_r{rank}.json", "w"))
    print("OK rank", rank)
"""

RANK4 = """
from datetime import timedelta
import torch
torch.set_num_threads(1)
from repro_torch.api import LogisticL1, SlabDesign
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data.byfeature import to_by_feature, to_slabs
from repro_torch.launch.mesh import (init_process_mesh, make_process_mesh,
                                     make_production_mesh, parse_mesh, world_scope)

with world_scope():
    rank, work = int(sys.argv[1]), sys.argv[2]
    a = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/inputs.npz").items()}
    flat = init_process_mesh(2, 2, backend="gloo", init_method=f"file://{work}/store4", world_size=4,
                             rank=rank, device="cpu", timeout=timedelta(seconds=120))
    pod = make_process_mesh(1, 2, pod=2, backend="gloo", device="cpu")
    out, msgs = {}, {"pod": dict(shape=pod.shape, axes=list(pod.axis_names), examples=pod.examples,
                                 example_rank=pod.example_rank, coords=[pod.pod_rank, pod.data_rank,
                                                                       pod.model_rank]),
                     "flat_coords": [flat.data_rank, flat.model_rank]}
    rows, vals, _ = to_slabs(to_by_feature(a["pX"]), 2)
    for tag, mesh in (("flat", flat), ("pod", pod)):
        est = LogisticL1(DGLMNETOptions(**DENSE), mesh=mesh, device="cpu")
        mesh.reset_stats()
        res = est.fit(a["pX"], a["py"], float(a["plam"]))
        out.update({f"{tag}_dense_beta": res.beta.numpy(),
                    f"{tag}_dense_hist": np.asarray(res.objective_history)})
        msgs[f"{tag}_stats"] = {k: v[0] for k, v in mesh.stats().items()}
        res = est.fit(SlabDesign(rows, vals, len(a["py"])), a["py"], float(a["plam"]),
                      densify=False)
        out.update({f"{tag}_slab_beta": res.beta.numpy(),
                    f"{tag}_slab_hist": np.asarray(res.objective_history)})
        pts = est.path(SlabDesign(rows, vals, len(a["py"])), a["py"], path_len=3)
        out.update({f"{tag}_path_betas": pts.betas.numpy(), f"{tag}_path_f": np.asarray(pts.f)})
    parsed = parse_mesh("2x1x2", backend="gloo", device="cpu")
    msgs["parsed"] = dict(shape=parsed.shape, ranks=parsed.ranks, kind=type(parsed).__name__)
    errs = {}
    for name, fn in {"world": lambda: parse_mesh("3x1x2", backend="gloo", device="cpu"),
                     "multipod": lambda: make_production_mesh(multi_pod=True, backend="gloo")}.items():
        try:
            fn()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    msgs["errors"] = errs
    np.savez(f"{work}/w4_r{rank}.npz", **out)
    json.dump(msgs, open(f"{work}/w4_r{rank}.json", "w"))
    print("OK rank", rank)
"""


def _code(body: str) -> str:
    consts = (f"STREAM = {STREAM!r}\nDENSE = {DENSE!r}\nPATH_LEN = {PATH_LEN}\n"
              f"WIDTH = {WIDTH}\n")
    return consts + textwrap.dedent(COMMON) + textwrap.dedent(body)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _spawn(work, groups):
    """Start every process of ``groups`` ({tag: [argv, ...]}, with an env
    each), wait for all of them under one deadline, and kill and reap
    every one of them in a ``finally``. Returns {tag: [returncode]}."""
    procs = {}
    try:
        for tag, (argvs, env) in groups.items():
            procs[tag] = []
            for i, argv in enumerate(argvs):
                log = open(os.path.join(work, f"{tag}_{i}.log"), "w")
                try:
                    procs[tag].append(subprocess.Popen(argv, stdout=log,
                                                       stderr=subprocess.STDOUT, env=env))
                finally:
                    log.close()
        end = time.monotonic() + DEADLINE
        late = []
        for tag, ps in procs.items():
            for proc in ps:
                try:
                    proc.wait(timeout=max(end - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    late.append(tag)
        if late:
            pytest.fail(f"spawned processes past their {DEADLINE} s deadline: {late}")
        return {tag: [proc.returncode for proc in ps] for tag, ps in procs.items()}
    finally:
        for ps in procs.values():
            for proc in ps:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()


def _logs(work, tag):
    return "\n".join(open(os.path.join(work, f)).read()[-3000:]
                     for f in sorted(os.listdir(work))
                     if f.startswith(tag + "_") and f.endswith(".log"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, each port rank's, and the two launchers'
    output, from one spawn of everything together."""
    work = str(tmp_path_factory.mktemp("meshops"))
    np.savez(os.path.join(work, "inputs.npz"), **_inputs())
    rank_env = _env(OMP_NUM_THREADS="1")
    launcher = [sys.executable, "-m"]
    codes = _spawn(work, {
        "ref": ([[sys.executable, "-c", _code(REFERENCE), work]],
                _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                     JAX_PLATFORMS="cpu")),
        "w8": ([[sys.executable, "-c", _code(RANK8), str(r), work]
                for r in range(8)], rank_env),
        "w4": ([[sys.executable, "-c", _code(RANK4), str(r), work]
                for r in range(4)], rank_env),
        "serve": ([launcher + ["repro_torch.launch.serve_glm", "--smoke", "--mesh", "2x2",
                               "--backend", "gloo", "--device", "cpu", "--spawn", "4",
                               "--steps", "4"]], rank_env),
        "chaos": ([launcher + ["repro_torch.launch.chaos_glm", "--smoke", "--mesh", "2x2",
                               "--backend", "gloo", "--device", "cpu", "--spawn", "4"]],
                  rank_env),
    })
    # a launcher's failure fails its own test alone
    for tag in ("ref", "w8", "w4"):
        assert not any(codes[tag]), f"{tag} failed {codes[tag]}:\n{_logs(work, tag)}"
    out = {"ref": dict(np.load(os.path.join(work, "reference.npz"))),
           "ref_msgs": json.load(open(os.path.join(work, "reference.json")))}
    for world in (8, 4):
        out[world] = [(dict(np.load(os.path.join(work, f"w{world}_r{r}.npz"))),
                       json.load(open(os.path.join(work, f"w{world}_r{r}.json"))))
                      for r in range(world)]
    for tag in ("serve", "chaos"):
        out[tag] = (codes[tag][0], _logs(work, tag))
    out["inputs"] = dict(np.load(os.path.join(work, "inputs.npz")))
    return out


def _fit_close(f, beta, ref_f, ref_beta):
    assert abs(f - ref_f) / abs(ref_f) < 1e-4, (f, ref_f)
    np.testing.assert_allclose(beta, ref_beta, rtol=1e-2, atol=1e-3)


def _same_on_every_rank(ranks, keys):
    for out, _ in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(out[k], ranks[0][0][k], err_msg=k)


# ---------------------------------------------------------------------------
# 1. streamed residency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sequential", "blocked"])
@pytest.mark.parametrize("what", ["fit_beta", "fit_hist", "path_betas", "path_f"])
def test_streamed_equals_resident_on_every_rank(runs, mode, what):
    """Each rank streams its 3 pieces through a budget of 2; the fit and
    the 4-point path are bit-equal to the resident ones, with the same
    host reads, and the same bits on every rank."""
    for out, msgs in runs[8]:
        np.testing.assert_array_equal(out[f"{mode}_streamed_{what}"],
                                      out[f"{mode}_resident_{what}"])
        st, rs = msgs[f"{mode}_streamed"], msgs[f"{mode}_resident"]
        assert st["ok"] and rs["ok"]
        assert st["stats"]["streamed"] and st["stats"]["evictions"] > 0, st
        assert st["stats"]["resident_bytes"] <= st["stats"]["budget_bytes"], st
        assert not rs["stats"]["streamed"]
        assert (st["fit_reads"], st["path_reads"]) == (rs["fit_reads"], rs["path_reads"])
        assert msgs["stream"]["pieces"] == 3
    _same_on_every_rank(runs[8], [f"{mode}_streamed_{what}"])


def test_streamed_budget_floor_raises_on_every_rank(runs):
    for _, msgs in runs[8]:
        err = msgs["stream"]["floor_error"]
        assert err is not None and "per rank cannot double-buffer" in err, err


def test_streamed_path_against_the_reference(runs):
    """The port's streamed 4-point path on (2, 4) against the reference's
    streamed path on its (2, 4) mesh, point by point (fit tolerance)."""
    out, ref = runs[8][0][0], runs["ref"]
    np.testing.assert_allclose(out["sequential_streamed_path_lams"], ref["stream_lams"],
                               rtol=1e-6)
    for i in range(PATH_LEN):
        _fit_close(float(out["sequential_streamed_path_f"][i]),
                   out["sequential_streamed_path_betas"][i],
                   float(ref["stream_f"][i]), ref["stream_betas"][i])


# ---------------------------------------------------------------------------
# 2. checkpoint-resume and fault injection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["resumed_betas", "resumed_f", "resumed2_betas", "ckpt_betas"])
def test_killed_path_resumes_bit_equal_on_every_rank(runs, key):
    """A path killed after point 2 on every rank, resumed from the shared
    directory, is bit-equal to the uninterrupted path, on every rank; so
    is one whose rank 0 lost its newest slot, and a checkpointed path."""
    want = "full_f" if key == "resumed_f" else "full_betas"
    for out, msgs in runs[8]:
        np.testing.assert_array_equal(out[key], out[want])
        assert msgs["killed"] and "after 2 path points" in msgs["killed"]
        assert msgs["slots"] == ["LATEST", "point-00000", "point-00001"], msgs["slots"]
        assert msgs["resumed_screen"]
    _same_on_every_rank(runs[8], [key])


def test_checkpointed_path_host_reads(runs):
    """One more read per checkpoint and one per resume (the ranks'
    agreement), as one device adds one per checkpoint."""
    for _, msgs in runs[8]:
        plain, ckpt = msgs["ckpt_reads"]
        assert ckpt == plain + PATH_LEN + 1, msgs["ckpt_reads"]


@pytest.mark.parametrize("case", ["grid", "foreign", "dev_mesh"])
def test_mismatched_progress_raises_on_every_rank(runs, case):
    for _, msgs in runs[8]:
        err = msgs["resume_errors"][case]
        assert err is not None and "different path" in err, (case, err)


def test_nan_inject_on_every_rank_matches_the_reference_drill(runs):
    """The chaos drill's nan-inject on (2, 4): every rank trips the same
    typed status after the same iteration, keeps a finite iterate whose
    history prefixes the healthy run's, and refits bit-identically; the
    reference's drill on its (2, 4) mesh ends the same way, at the same
    healthy objective (fit tolerance)."""
    ref = runs["ref_msgs"]
    first = runs[8][0][1]["nan"]
    for _, msgs in runs[8]:
        nan = msgs["nan"]
        assert nan == first
        assert (nan["status"], nan["iters"]) == (ref["nan_status"], ref["nan_iters"]) == \
            ("NONFINITE_OBJECTIVE", 2)
        assert nan["prefix"] and nan["finite"] and nan["again"]
        assert ref["nan_prefix"] and ref["nan_finite"] and ref["nan_again"]
    assert abs(first["healthy_f"] - float(runs["ref"]["nan_healthy_f"])) < \
        1e-4 * abs(float(runs["ref"]["nan_healthy_f"]))
    _same_on_every_rank(runs[8], ["nan_beta"])


# ---------------------------------------------------------------------------
# 3. serving from a process-mesh store
# ---------------------------------------------------------------------------

def test_served_scores_equal_decision_function_on_every_rank(runs):
    """Each rank keeps its (L, p_pad / R) block of the reference's saved
    path; at every lambda the whole batch's scores are bit-equal to
    ``decision_function`` through the same mesh, on every rank."""
    for _, msgs in runs[8]:
        s = msgs["serve"]
        assert all(s["equal"]) and len(s["equal"]) == 4, s
        assert s["block"] == [4, s["p_pad"] // 4], s
    _same_on_every_rank(runs[8], ["serve_scores"])


def test_served_scores_against_the_reference_scorer(runs):
    ref = runs["ref"]["serve_scores"]
    got = runs[8][0][0]["serve_scores"]
    assert got.shape == ref.shape == (64,)
    assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0)


def test_store_versions_and_quarantine_in_step(runs):
    """A poisoned swap is quarantined on every rank: every rank serves the
    same version before and after, with the same scores."""
    for _, msgs in runs[8]:
        s = msgs["serve"]
        assert (s["version"], s["after_quarantine"], s["quarantined"]) == (1, 1, [2]), s
        assert s["rescored"]


# ---------------------------------------------------------------------------
# 4. the pod axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["dense_beta", "dense_hist", "slab_beta", "slab_hist",
                                 "path_betas", "path_f"])
def test_pod_mesh_is_bit_equal_to_the_flat_mesh(runs, key):
    """(2, 1, 2) over 4 ranks runs the (2, 2) mesh's sums: its example axes
    reduce over the same ranks in one collective."""
    for out, _ in runs[4]:
        np.testing.assert_array_equal(out[f"pod_{key}"], out[f"flat_{key}"])
    _same_on_every_rank(runs[4], [f"pod_{key}"])


def test_pod_mesh_layout_and_collectives(runs):
    for r, (_, msgs) in enumerate(runs[4]):
        pod = msgs["pod"]
        assert pod["shape"] == {"pod": 2, "data": 1, "model": 2}
        assert pod["axes"] == ["pod", "data", "model"] and pod["examples"] == 2
        assert pod["coords"] == [r // 2, 0, r % 2] and pod["example_rank"] == r // 2
        assert msgs["flat_coords"] == [r // 2, r % 2]
        flat, podc = msgs["flat_stats"], msgs["pod_stats"]
        assert podc == {"pod+data": flat["data"], "model": flat["model"]}, (flat, podc)
        assert msgs["parsed"] == {"shape": {"pod": 2, "data": 1, "model": 2}, "ranks": 4,
                                  "kind": "ProcMesh"}


def test_pod_fit_against_the_reference(runs):
    ref = runs["ref"]
    out = runs[4][0][0]
    assert runs["ref_msgs"]["pod_shape"] == {"pod": 2, "data": 1, "model": 2}
    _fit_close(float(out["pod_dense_hist"][-1]), out["pod_dense_beta"], float(ref["pod_f"]),
               ref["pod_beta"])


@pytest.mark.parametrize("case,text", [("world", "pod x data extent 3 must divide the world size 4"),
                                       ("multipod", "needs 2 x 16 x 16 = 512 ranks")])
def test_pod_mesh_errors_over_a_world(runs, case, text):
    for _, msgs in runs[4]:
        err = msgs["errors"][case]
        assert err is not None and text in err, err


def test_parse_mesh_and_production_mesh_errors_without_a_world():
    from repro_torch.launch.mesh import DevMesh, make_production_mesh, parse_mesh

    with pytest.raises(ValueError, match="a pod axis spans ranks"):
        parse_mesh("2x1x4", device="cpu")
    with pytest.raises(ValueError, match="expected 'prod' or 'DxM'"):
        parse_mesh("1x2x3x4", device="cpu")
    mesh = parse_mesh("1x1x4", device="cpu")
    assert isinstance(mesh, DevMesh) and mesh.shape == {"data": 1, "model": 4}
    with pytest.raises(RuntimeError, match="torchrun"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="torchrun"):
        parse_mesh("prod-multipod")


def test_mesh_module_exports_the_reference_names():
    """``repro_torch.launch.mesh`` has every public name of
    ``repro.launch.mesh`` but its TPU roofline constants."""
    import repro.launch.mesh as ref
    import repro_torch.launch.mesh as port

    tpu = {"PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW_PER_LINK"}
    names = {n for n in dir(ref) if not n.startswith("_")
             and not isinstance(getattr(ref, n), (types.ModuleType, __future__._Feature))}
    assert tpu < names
    for name in sorted(names - tpu):
        assert callable(getattr(port, name, None)), name
    assert not tpu & set(dir(port))


# ---------------------------------------------------------------------------
# the launchers on spawned ranks
# ---------------------------------------------------------------------------

def test_serve_launcher_on_a_process_mesh(runs):
    rc, log = runs["serve"]
    assert rc == 0 and "SERVE SMOKE OK" in log, log[-3000:]
    assert "bit-equal to decision_function at all" in log


def test_chaos_launcher_on_a_process_mesh(runs):
    rc, log = runs["chaos"]
    assert rc == 0 and "CHAOS SMOKE OK" in log, log[-3000:]
    for name in ("nan-inject", "kill-resume", "corrupt", "overload", "lost-bucket"):
        assert f"# {name}:" in log, name
