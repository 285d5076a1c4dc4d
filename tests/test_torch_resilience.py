"""The port's resilience slice (``repro_torch.resilience``, the engine's
fault hook, resumable paths, the fault consults in residency and serving,
``repro_torch.launch.chaos_glm``) on the CPU, at the reference's tiny
sizes (256 x 64 at density 0.1, ``path_len`` 3-4), inputs made once as
numpy arrays from a seed:

* against the reference (``repro.resilience``, ``repro.api``): each
  ``EngineFault`` kind x mode gives the same status and ``n_iters`` and
  an objective history equal to the reference's within the fit tolerance
  (relative 1e-4), and an exact prefix of the port's healthy fit; a
  resume's grid validation raises the same errors; progress slots load in
  both directions; ``corrupt_checkpoint`` writes identical bytes for each
  mode and seed;
* within the port: a killed path resumes bit-identically (betas,
  lambdas, f, nnz, statuses, screen telemetry, metrics) on a local dense,
  a local slab, and flat and bucketed slab designs on a (1, 4) mesh; a
  checkpointed path reads the device as often as an unchecked one plus
  one read per checkpoint; transient and fatal lost buckets behave as the
  reference's ``lost-bucket`` drill says, with the manager's retries
  equal to the registry's; swap and load failures are retried;
  ``serve_delay`` stays scoped; the engine's fetch keeps its invariant;
* each scenario of ``repro_torch.launch.chaos_glm`` in-process with
  ``--device cpu --smoke --trace``, its counters checked.

The degradation ladder's labels under faults are held against the
reference in ``tests/test_torch_fault_parity.py``.
"""
import contextlib
import io
import os
import shutil
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.resilience as jres
from repro.api import LogisticL1 as JLogisticL1
from repro.checkpoint import save_pytree as j_save_pytree
from repro_torch.api import (BucketedSlabDesign, LogisticL1, PathResult, ShardedDesign,
                             SlabDesign, as_design, make_design_eval)
from repro_torch.checkpoint import CheckpointCorruption, save_pytree
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data.byfeature import to_by_feature, to_slab_buckets, to_slabs
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.launch import chaos_glm
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.obs import observe
from repro_torch.resilience import (EngineFault, FaultPlan, InjectedFault, InjectedKill,
                                    PathProgress, RetriesExhausted, active_plan,
                                    corrupt_checkpoint, inject_faults)
from repro_torch.serve import NonFiniteScores, PathScorer, PathStore, RequestBatcher

torch.set_num_threads(2)
LAM = 0.05
TILE = 16


@pytest.fixture(scope="module")
def tiny():
    ds = make_glm_dataset(GLMConfig(name="resilience", num_examples=256, num_features=64,
                                    density=0.1),
                          np.random.default_rng(0), device="cpu")
    X, y = ds.X_train.numpy(), ds.y_train.numpy()
    bf = to_by_feature(X)
    rows, vals, _ = to_slabs(bf, 1)
    return dict(X=X, y=y, bf=bf, rows=rows, vals=vals, X_test=ds.X_test.numpy(),
                y_test=ds.y_test.numpy())


def _cpu_est(opts=None, mesh=None):
    return LogisticL1(opts or DGLMNETOptions(), mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# the plan's plumbing and the retry
# ---------------------------------------------------------------------------

def test_engine_fault_validation_and_no_nesting():
    for bad in (dict(kind="margins", at_iter=0), dict(kind="gradients"),
                dict(kind="margins", mode="zero")):
        with pytest.raises(ValueError):
            EngineFault(**bad)
    with inject_faults(FaultPlan()):
        with pytest.raises(RuntimeError, match="no nesting"):
            with inject_faults(FaultPlan()):
                pass
    assert active_plan() is None


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_retry_call_backoff_and_exhaustion(pkg):
    """The reference's backoff test (``tests/test_resilience.py``) on both
    packages' ``retry_call``, with an injected sleep (no real sleeping),
    and the ``retry.*`` counters on each package's registry."""
    import importlib

    retry = importlib.import_module(f"{pkg}.resilience.retry")
    obs = importlib.import_module(f"{pkg}.obs")
    calls, delays = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    with obs.observe() as session:
        assert retry.retry_call(flaky, attempts=3, sleep=delays.append) == "ok"
        assert len(calls) == 3 and len(delays) == 2
        assert delays[1] == 2 * delays[0]        # exponential

        def always():
            raise RuntimeError("permanent")

        with pytest.raises(retry.RetriesExhausted) as ei:
            retry.retry_call(always, attempts=2, sleep=delays.append)
        assert isinstance(ei.value.__cause__, RuntimeError)
        with pytest.raises(ValueError):           # not in retry_on: no retry
            retry.retry_call(lambda: (_ for _ in ()).throw(ValueError("x")),
                             attempts=3, sleep=delays.append)
    assert len(delays) == 3
    assert session.registry.value("retry.retries") == 3
    assert session.registry.value("retry.exhausted") == 1


# ---------------------------------------------------------------------------
# the engine's fault hook against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def healthy_fits(tiny):
    port = _cpu_est().fit(tiny["X"], tiny["y"], LAM)
    ref = JLogisticL1().fit(jnp.asarray(tiny["X"]), jnp.asarray(tiny["y"]), LAM)
    return port, ref


@pytest.mark.parametrize("kind", ["margins", "stats", "linesearch"])
@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_engine_fault_matches_reference(tiny, healthy_fits, kind, mode):
    base, _ = healthy_fits
    plan = FaultPlan(engine=EngineFault(kind, at_iter=2, mode=mode), engine_fires=1)
    jplan = jres.FaultPlan(engine=jres.EngineFault(kind, at_iter=2, mode=mode),
                           engine_fires=1)
    s0 = engine.host_syncs
    with inject_faults(plan):
        port = _cpu_est().fit(tiny["X"], tiny["y"], LAM)
    reads = engine.host_syncs - s0
    with jres.inject_faults(jplan):
        ref = JLogisticL1().fit(jnp.asarray(tiny["X"]), jnp.asarray(tiny["y"]), LAM)
    assert port.status == int(ref.status) != engine.STATUS_OK
    assert port.status_name == ref.status_name
    assert port.n_iters == int(ref.n_iters) == 1
    assert bool(torch.isfinite(port.beta).all())
    # the certified prefix: exactly the port's healthy run, and the
    # reference's within the fit tolerance
    hist = port.objective_history
    assert hist == base.objective_history[:len(hist)]
    assert len(hist) == len(ref.objective_history)
    np.testing.assert_allclose(hist, ref.objective_history, rtol=1e-4)
    # two iterations ran (the second tripped): the reads of a healthy fit
    # cut there, one per iteration plus the fetch
    assert reads == 3


def test_nan_margins_trips_and_the_next_fit_is_healthy(tiny, healthy_fits):
    base, _ = healthy_fits
    with inject_faults(FaultPlan(engine=EngineFault("margins", at_iter=3), engine_fires=1)):
        res = _cpu_est().fit(tiny["X"], tiny["y"], LAM)
    assert res.status == engine.STATUS_NONFINITE_OBJECTIVE and res.n_iters == 2
    again = _cpu_est().fit(tiny["X"], tiny["y"], LAM)
    assert again.ok and torch.equal(again.beta, base.beta)
    assert again.objective_history == base.objective_history
    # stats poisoned at the first iteration: the warm start comes back
    with inject_faults(FaultPlan(engine=EngineFault("stats", at_iter=1, mode="inf"),
                                 engine_fires=1)):
        res = _cpu_est().fit(tiny["X"], tiny["y"], LAM)
    assert res.status == engine.STATUS_NONFINITE_OBJECTIVE and res.n_iters == 0
    assert torch.equal(res.beta, torch.zeros_like(res.beta))


def test_a_plan_without_an_engine_fault_changes_nothing(tiny, healthy_fits):
    base, _ = healthy_fits
    s0 = engine.host_syncs
    with inject_faults(FaultPlan(fail_swaps=1, serve_latency_s=0.5)):
        res = _cpu_est().fit(tiny["X"], tiny["y"], LAM)
    assert engine.host_syncs - s0 == base.n_iters + 1
    assert torch.equal(res.beta, base.beta)
    assert res.objective_history == base.objective_history


def test_fetch_rejects_ok_status_with_poisoned_history():
    z = torch.zeros(2)

    def state(status):
        return engine.SolverState(
            beta=z, m=z, f=torch.tensor(1.0), it=1, converged=torch.tensor(True),
            dbeta=z, dm=z, alpha=torch.tensor(1.0), f_new=torch.tensor(1.0),
            f_hist=torch.tensor([1.0, float("nan"), 0.0]), a_hist=torch.tensor([1.0, 0.0]),
            unit_steps=torch.tensor(1, dtype=torch.int32), status=status)

    with pytest.raises(RuntimeError, match="invariant"):
        engine.fetch(state(engine.STATUS_OK))
    # a tripped solve trims the poisoned tail instead of raising
    _, f_hist, a_hist = engine.fetch(state(engine.STATUS_NONFINITE_OBJECTIVE))
    assert f_hist == [1.0] and a_hist == []


# ---------------------------------------------------------------------------
# resumable paths
# ---------------------------------------------------------------------------

def _same_path(a: PathResult, b: PathResult):
    assert len(a) == len(b)
    assert torch.equal(a.betas, b.betas)
    assert np.array_equal(a.lambdas, b.lambdas)
    assert np.array_equal(a.f, b.f)
    assert np.array_equal(a.nnz, b.nnz)
    assert np.array_equal(a.n_iters, b.n_iters)
    assert np.array_equal(a.statuses, b.statuses)
    assert a.screen == b.screen
    assert a.metrics == b.metrics


def _layout(tiny, kind):
    n = len(tiny["y"])
    if kind == "dense":
        return tiny["X"], None, DGLMNETOptions()
    opts = DGLMNETOptions(tile=TILE, block=4)
    if kind == "slab":
        return SlabDesign(tiny["rows"], tiny["vals"], n), None, opts
    mesh = make_dev_mesh(1, 4, device="cpu")
    inner = (SlabDesign(tiny["rows"], tiny["vals"], n) if kind == "mesh-slab"
             else BucketedSlabDesign(to_slab_buckets(tiny["bf"], 1), n))
    return ShardedDesign(inner, mesh, tile=TILE), mesh, opts


@pytest.mark.parametrize("kind", ["dense", "slab", "mesh-slab", "mesh-bucketed"])
def test_killed_path_resumes_bit_identically(tiny, kind, tmp_path):
    design, mesh, opts = _layout(tiny, kind)
    eval_fn = make_design_eval(tiny["X_test"], tiny["y_test"], device="cpu")
    kw = dict(path_len=4, eval_fn=eval_fn)
    full = _cpu_est(opts, mesh).path(design, tiny["y"], **kw)
    assert full.all_ok
    d = str(tmp_path / "progress")
    with pytest.raises(InjectedKill):
        with inject_faults(FaultPlan(kill_after_points=2)):
            _cpu_est(opts, mesh).path(design, tiny["y"], checkpoint_every=1,
                                      resume_from=d, **kw)
    prog = PathProgress(d)
    assert prog.pointer() == 1 and prog.slots() == [0, 1]
    _, arrays, meta = prog.load_latest()
    assert meta["next_index"] == 2 and arrays["point_betas"].shape == (2, 64)
    resumed = _cpu_est(opts, mesh).path(design, tiny["y"], checkpoint_every=1,
                                        resume_from=d, **kw)
    _same_path(resumed, full)
    # resuming a finished path solves nothing and returns it whole
    s0 = engine.host_syncs
    again = _cpu_est(opts, mesh).path(design, tiny["y"], checkpoint_every=1,
                                      resume_from=d, **kw)
    _same_path(again, full)
    assert engine.host_syncs - s0 == 1                 # lambda_max alone


def test_checkpointed_path_reads_once_more_per_checkpoint(tiny, tmp_path):
    design, mesh, opts = _layout(tiny, "mesh-slab")
    s0 = engine.host_syncs
    plain = _cpu_est(opts, mesh).path(design, tiny["y"], path_len=4)
    plain_reads = engine.host_syncs - s0
    s0 = engine.host_syncs
    ckpt = _cpu_est(opts, mesh).path(design, tiny["y"], path_len=4, checkpoint_every=2,
                                     resume_from=str(tmp_path / "p"))
    assert engine.host_syncs - s0 == plain_reads + 2
    _same_path(ckpt, plain)
    assert PathProgress(str(tmp_path / "p")).slots() == [3]      # keep=2 prunes slot 1


def test_path_resume_validates_grid_as_the_reference_does(tiny, tmp_path):
    X, y = tiny["X"], tiny["y"]
    errors = []
    for tag, fit_path, faults, kill in (
            ("port", lambda **kw: _cpu_est().path(X, y, **kw), inject_faults, InjectedKill),
            ("ref", lambda **kw: JLogisticL1().path(jnp.asarray(X), jnp.asarray(y), **kw),
             jres.inject_faults, jres.InjectedKill)):
        d = str(tmp_path / tag)
        plan = (FaultPlan if tag == "port" else jres.FaultPlan)(kill_after_points=1)
        with pytest.raises(kill):
            with faults(plan):
                fit_path(path_len=3, checkpoint_every=1, resume_from=d)
        got = []
        for kw in (dict(path_len=4, checkpoint_every=1, resume_from=d),
                   dict(path_len=3, checkpoint_every=1)):
            with pytest.raises(ValueError) as ei:
                fit_path(**kw)
            got.append(str(ei.value))
        errors.append(got)
    (port_diff, port_req), (ref_diff, ref_req) = errors
    assert "different path" in port_diff and "different path" in ref_diff
    assert "requires resume_from" in port_req and "requires resume_from" in ref_req


def test_progress_slots_load_in_both_directions(tiny, tmp_path):
    """A killed path's slot from each package, read by the other's
    ``PathProgress.load_latest``: the same arrays, dtypes and meta keys."""
    X, y = tiny["X"], tiny["y"]
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    with pytest.raises(InjectedKill):
        with inject_faults(FaultPlan(kill_after_points=2)):
            _cpu_est().path(X, y, path_len=3, checkpoint_every=1, resume_from=d_port)
    with pytest.raises(jres.InjectedKill):
        with jres.inject_faults(jres.FaultPlan(kill_after_points=2)):
            JLogisticL1().path(jnp.asarray(X), jnp.asarray(y), path_len=3,
                               checkpoint_every=1, resume_from=d_ref)
    for d in (d_port, d_ref):
        pi, pa, pm = PathProgress(d).load_latest()
        ji, ja, jm = jres.PathProgress(d).load_latest()
        assert pi == ji == 1 and pm == jm
        assert set(pm) == {"kind", "next_index", "lam_prev", "lams", "p", "p_cap",
                           "has_carry_mask", "points"}
        for k in ("beta", "m", "carry_mask", "point_betas"):
            assert pa[k].dtype == ja[k].dtype and np.array_equal(pa[k], ja[k]), k
        assert pa["carry_mask"].dtype == np.int8
        assert pa["point_betas"].shape == (2, 64) and pa["point_betas"].dtype == np.float32
    # the two packages saved the same path state, within the fit tolerance
    pm, jm = PathProgress(d_port).load_latest()[2], PathProgress(d_ref).load_latest()[2]
    np.testing.assert_allclose(pm["lams"], jm["lams"], rtol=1e-6)
    np.testing.assert_allclose([q["f"] for q in pm["points"]],
                               [q["f"] for q in jm["points"]], rtol=1e-4)


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "drop-meta"])
@pytest.mark.parametrize("seed", [0, 12345])
def test_corrupt_checkpoint_writes_the_references_bytes(tmp_path, mode, seed):
    src = str(tmp_path / "src")
    save_pytree({"betas": np.arange(24, dtype=np.float32).reshape(3, 8)}, src,
                meta={"kind": "PathResult", "p": 8})
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    shutil.copytree(src, port_dir)
    shutil.copytree(src, ref_dir)
    assert corrupt_checkpoint(port_dir, mode, seed=seed) == \
        jres.corrupt_checkpoint(ref_dir, mode, seed=seed).replace(ref_dir, port_dir)
    for name in sorted(os.listdir(src)):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(ref_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_checkpoint(port_dir, "shred")


def test_corrupted_newest_slot_rolls_back(tmp_path):
    prog = PathProgress(str(tmp_path), keep=2)
    for i in range(3):
        prog.save(i, {"beta": np.arange(3, dtype=np.float32) + i},
                  {"kind": "PathProgress", "next_index": i + 1})
    assert prog.pointer() == 2 and prog.slots() == [1, 2]      # pruned to keep
    corrupt_checkpoint(prog.slot(2), "bitflip")
    idx, arrays, meta = prog.load_latest()
    assert idx == 1 and meta["next_index"] == 2
    assert np.array_equal(arrays["beta"], np.arange(3, dtype=np.float32) + 1)
    with pytest.raises(CheckpointCorruption):
        prog.load(2)
    # a slot without meta cannot rebuild the driver: it is skipped too
    corrupt_checkpoint(prog.slot(1), "drop-meta")
    assert prog.load_latest() is None
    # a reference slot written with jax arrays reads here as well
    j_save_pytree({"beta": jnp.ones(3)}, prog.slot(7), step=7,
                  meta={"kind": "PathProgress", "next_index": 8})
    idx, arrays, _ = prog.load_latest()
    assert idx == 7 and np.array_equal(arrays["beta"], np.ones(3, np.float32))


# ---------------------------------------------------------------------------
# a lost bucket on the streamed residency
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def streamed_cell():
    args = type("A", (), {"n": 128, "p": 64})()
    X, y = chaos_glm.mixed_density_dataset(args)
    slabs = to_slab_buckets(to_by_feature(X), 1)
    mesh = make_dev_mesh(1, 1, device="cpu")
    opts = DGLMNETOptions(tile=TILE, max_iters=40)
    resident = _cpu_est(opts, mesh).path(as_design(slabs, mesh=mesh, tile=TILE), y,
                                         path_len=3)
    sizing = as_design(slabs, mesh=mesh, tile=TILE)
    budget = sizing.slab_nbytes(TILE) - min(sizing.slab_bucket_nbytes(TILE))
    return dict(y=y, slabs=slabs, mesh=mesh, opts=replace(opts, device_budget_bytes=budget),
                budget=budget, resident=resident)


def _streamed(cell):
    return as_design(cell["slabs"], mesh=cell["mesh"], tile=TILE,
                     device_budget_bytes=cell["budget"])


def test_transient_lost_bucket_is_retried_bit_identically(streamed_cell):
    cell = streamed_cell
    design = _streamed(cell)
    with observe() as obs, inject_faults(FaultPlan(fail_prefetches=2)):
        res = _cpu_est(cell["opts"], cell["mesh"]).path(design, cell["y"], path_len=3)
    stats = design.residency_stats()[TILE]
    assert stats["streamed"] and stats["evictions"] > 0 and stats["retries"] == 2
    assert obs.registry.value("faults.prefetch") == 2
    assert obs.registry.value("retry.retries") == stats["retries"]
    assert obs.registry.value("retry.exhausted") is None
    _same_path(res, cell["resident"])


def test_fatal_lost_bucket_dies_and_resumes(streamed_cell, tmp_path):
    cell = streamed_cell
    healthy = _streamed(cell)
    _cpu_est(cell["opts"], cell["mesh"]).path(healthy, cell["y"], path_len=3)
    puts = healthy.residency_stats()[TILE]["puts"]
    d = str(tmp_path / "progress")
    design = _streamed(cell)
    with observe() as obs, inject_faults(FaultPlan(fail_prefetches=3,
                                                   fail_prefetches_after=puts // 2)):
        with pytest.raises(RetriesExhausted) as ei:
            _cpu_est(cell["opts"], cell["mesh"]).path(design, cell["y"], path_len=3,
                                                      checkpoint_every=1, resume_from=d)
    assert isinstance(ei.value.__cause__, InjectedFault)
    assert obs.registry.value("retry.exhausted") == 1
    assert design.residency_stats()[TILE]["retries"] == obs.registry.value("retry.retries") == 2
    assert PathProgress(d).pointer() is not None          # died mid-path, after a checkpoint
    resumed = _cpu_est(cell["opts"], cell["mesh"]).path(_streamed(cell), cell["y"], path_len=3,
                                                        checkpoint_every=1, resume_from=d)
    _same_path(resumed, cell["resident"])


# ---------------------------------------------------------------------------
# serving under faults
# ---------------------------------------------------------------------------

def _path_result(p=16, seed=0):
    rng = np.random.default_rng(seed)
    return PathResult(lambdas=np.asarray([1.0, 0.5]),
                      betas=torch.from_numpy(rng.normal(size=(2, p)).astype(np.float32)),
                      nnz=np.asarray([3, 5]), f=np.asarray([1.0, 0.9]),
                      n_iters=np.asarray([2, 3]))


def test_swap_and_load_failures_are_retried(tmp_path):
    with observe() as obs:
        with inject_faults(FaultPlan(fail_swaps=2)):
            store = PathStore(_path_result(), device="cpu")   # attempts 1, 2 fail; 3 lands
        assert store.version == 1
        with inject_faults(FaultPlan(fail_swaps=3)):
            with pytest.raises(RetriesExhausted) as ei:
                store.swap(_path_result(), attempts=2)
        assert isinstance(ei.value.__cause__, InjectedFault)
        assert store.version == 1 and store.snapshot.version == 1
        d = str(tmp_path / "path")
        _path_result().save(d)
        with inject_faults(FaultPlan(fail_loads=1)):
            loaded = PathStore.from_checkpoint(d, device="cpu")
        assert loaded.version == 1
        corrupt_checkpoint(d, "bitflip")
        with pytest.raises(RetriesExhausted) as ei:
            PathStore.from_checkpoint(d, device="cpu", attempts=2)
        assert isinstance(ei.value.__cause__, CheckpointCorruption)
    reg = obs.registry
    assert reg.value("faults.swap") == 4 and reg.value("faults.load") == 1
    assert reg.value("serve.swaps") == 2 and reg.value("retry.exhausted") == 2


def test_serve_delay_is_scoped():
    import time

    store = PathStore(_path_result(), device="cpu")
    scorer = PathScorer(store)
    b = RequestBatcher(16, max_batch=8)
    b.submit({"x": 1.0}, 1.0)
    batch, lams = b.drain()
    with observe() as obs:
        ref = scorer.score(batch, lams)
        with inject_faults(FaultPlan(serve_latency_s=0.05)):
            t0 = time.perf_counter()
            got = scorer.score(batch, lams)
            # allow[bench-timing]: times an injected host-side sleep; score() reads its scores to the host before returning, so the section is host-synchronous
            slowed = time.perf_counter() - t0
        after = scorer.score(batch, lams)
    assert slowed >= 0.05                                   # the injected floor applies
    assert obs.registry.value("faults.serve_delay") == 1    # and only inside the plan
    assert np.array_equal(got[0], ref[0]) and np.array_equal(after[0], ref[0])
    # a poisoned store alone: a typed error, never NaN scores
    bad = _path_result()
    with pytest.raises(NonFiniteScores):
        PathScorer(PathStore(replace(bad, betas=torch.full_like(bad.betas, float("nan"))),
                             device="cpu")).score(batch, lams)


# ---------------------------------------------------------------------------
# the chaos drills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", chaos_glm.SCENARIOS)
def test_chaos_scenario(scenario, tmp_path):
    out = io.StringIO()
    prefix = str(tmp_path / "trace")
    with contextlib.redirect_stdout(out):
        chaos_glm.main(["--smoke", "--device", "cpu", "--scenario", scenario,
                        "--trace", prefix])
    text = out.getvalue()
    assert text.rstrip().endswith("CHAOS SMOKE OK"), text
    assert f"# trace: {scenario} fault counters fired" in text
    import json
    with open(prefix + ".summary.json") as fh:
        counters = json.load(fh)["counters"]
    assert all(counters.get(c) for c in chaos_glm.EXPECT[scenario]), counters
