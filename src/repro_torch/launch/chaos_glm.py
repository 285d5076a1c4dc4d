# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Chaos drills for the port's solver and serve stack: seeded fault
injection, the counterpart of ``repro/launch/chaos_glm.py``.

    PYTHONPATH=src python -m repro_torch.launch.chaos_glm --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.chaos_glm --smoke --mesh 1x4
    PYTHONPATH=src python -m repro_torch.launch.chaos_glm --smoke --mesh 2x4 \
        --backend gloo --device cpu --spawn 8
    PYTHONPATH=src python -m repro_torch.launch.chaos_glm --scenario kill-resume

Each scenario arms a deterministic :class:`repro_torch.resilience.FaultPlan`
and asserts the stack's contracted reaction, with the reference's
assertions:

* ``nan-inject``  -- NaN poisons the margins at outer iteration k; the
  engine must trip ``NONFINITE_OBJECTIVE``, return the last finite
  iterate (history an exact prefix of the healthy run), and a healthy
  fit afterwards must be bit-identical to the first;
* ``kill-resume`` -- the path driver is killed after N points (the
  checkpoint already landed); resuming from the progress directory must
  reproduce the uninterrupted path bit for bit;
* ``corrupt``     -- bit-flipped, truncated and meta-less checkpoints
  must surface as typed errors (never load silently), and the rotated
  progress store must roll back to the last good slot;
* ``overload``    -- the bounded serve loop under latency and swap
  faults: admission control rejects, deadlines shed at drain, a poisoned
  version is quarantined back to the last good snapshot;
* ``lost-bucket`` -- streamed bucket residency under prefetch failure: a
  transient lost bucket is absorbed by retry (the path bit-identical to
  the resident one); a fatal failure window placed mid-path kills the
  streamed solve after a checkpoint, and the resume reproduces the path
  bit for bit.

``--trace PATH`` runs the scenarios under ``repro_torch.obs.observe()``
and also asserts that each scenario's injected faults reached the
``faults.*`` / ``retry.*`` registry counters, live and in the exported
summary (``PATH.trace.json`` / ``PATH.events.jsonl`` /
``PATH.summary.json``). Runs on the card (``--device cuda``, the
default, raising without one) unless ``--device cpu`` is given.

With ``--backend`` (``launch.world``: under torchrun, or ``--spawn N``
ranks started from one command) ``--mesh DxM`` / ``PxDxM`` spans the
ranks of a ``torch.distributed`` world, as the reference's drills run on
its (2, 4) mesh: every rank draws the same data (trimmed to a multiple of
the example shards), arms the same plan and must reach the same outcome;
rank 0 prints. Kill-resume keeps per-rank progress slots. Lost-bucket
runs its transient window (every rank's puts fail twice and are retried;
the path bit-identical to the resident one); its fatal window does not
apply to a process mesh, since a put that fails for good fails on one
rank, whose peers would wait in their next collective until the group's
deadline.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from dataclasses import replace

import numpy as np
import torch

from repro_torch.api import LogisticL1, PathResult, as_design
from repro_torch.checkpoint import CheckpointCorruption, verify_payload
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data.byfeature import to_by_feature, to_slab_buckets
from repro_torch.data.residency import stream_floor
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import is_process_mesh, make_dev_mesh, world_scope
from repro_torch.launch.serve_glm import say, trim_rows
from repro_torch.launch.world import add_world_args, mesh_from_args, spawn_world
from repro_torch.obs import observe
from repro_torch.resilience import (EngineFault, FaultPlan, InjectedKill, PathProgress,
                                    RetriesExhausted, corrupt_checkpoint, inject_faults)
from repro_torch.serve import (InvalidRequest, NonFiniteScores, Overloaded, PathScorer,
                               PathStore, RequestBatcher)

SCENARIOS = ("nan-inject", "kill-resume", "corrupt", "overload", "lost-bucket")

#: fault counters (``repro_torch.resilience`` / ``repro_torch.obs``) each
#: scenario must bump when it runs under --trace; asserted against the
#: live registry and again against the exported summary
EXPECT = {
    "nan-inject": ("faults.engine",),
    "kill-resume": ("faults.kill",),
    "corrupt": ("retry.retries",),
    "overload": ("faults.swap", "faults.serve_delay"),
    "lost-bucket": ("faults.prefetch", "retry.retries"),
}


def _dataset(args, dev, mesh):
    cfg = GLMConfig(name="chaos-glm", num_examples=args.n, num_features=args.p,
                    density=0.1)
    ds = make_glm_dataset(cfg, np.random.default_rng(0), device=dev)
    return trim_rows(mesh, ds.X_train, ds.y_train)


def _estimator(mesh, dev, opts=None):
    return LogisticL1(opts or DGLMNETOptions(), mesh=mesh, device=dev)


def same_path(a: PathResult, b: PathResult) -> bool:
    """Bit-equal betas, lambdas, f, nnz, statuses and screen telemetry."""
    return (len(a) == len(b) and torch.equal(a.betas, b.betas)
            and np.array_equal(a.lambdas, b.lambdas) and np.array_equal(a.f, b.f)
            and np.array_equal(a.nnz, b.nnz) and np.array_equal(a.statuses, b.statuses)
            and a.screen == b.screen)


def scenario_nan_inject(args, mesh, dev) -> None:
    """NaN at iteration k trips the typed status; the next fit is healthy."""
    X, y = _dataset(args, dev, mesh)
    est = _estimator(mesh, dev)
    lam = 0.05
    base = est.fit(X, y, lam)
    assert base.ok and base.status_name == "OK"

    plan = FaultPlan(engine=EngineFault("margins", at_iter=3), engine_fires=1)
    with inject_faults(plan):
        res = est.fit(X, y, lam)
    assert res.status == engine.STATUS_NONFINITE_OBJECTIVE, res.status
    assert res.status_name == "NONFINITE_OBJECTIVE"
    assert res.n_iters == 2, res.n_iters    # last certified iterate
    assert bool(torch.isfinite(res.beta).all())
    nb = len(res.objective_history)
    assert res.objective_history == base.objective_history[:nb]

    again = est.fit(X, y, lam)
    assert again.ok and torch.equal(again.beta, base.beta)
    say(f"# nan-inject: status={res.status_name} after iter {res.n_iters}, beta "
        f"finite, healthy solve bit-identical")


def scenario_kill_resume(args, mesh, dev) -> None:
    """Mid-path kill + resume reproduces the path bit for bit."""
    X, y = _dataset(args, dev, mesh)
    est = _estimator(mesh, dev)
    kw = dict(path_len=args.path_len, screen=True)
    full = est.path(X, y, **kw)

    with tempfile.TemporaryDirectory() as d:
        killed = False
        try:
            with inject_faults(FaultPlan(kill_after_points=2)):
                est.path(X, y, checkpoint_every=1, resume_from=d, **kw)
        except InjectedKill:
            killed = True
        assert killed, "kill_after_points never fired"
        resumed = est.path(X, y, checkpoint_every=1, resume_from=d, **kw)
    assert same_path(resumed, full), "the resumed path differs from the uninterrupted one"
    say(f"# kill-resume: killed after 2/{len(full)} points, resume bit-identical "
        f"across all {len(full)} points")


def scenario_corrupt(args, mesh, dev) -> None:
    """Corrupted checkpoints surface typed errors; progress rolls back."""
    X, y = _dataset(args, dev, mesh)
    path = _estimator(mesh, dev).path(X, y, path_len=args.path_len)

    for mode in ("bitflip", "truncate", "drop-meta"):
        with tempfile.TemporaryDirectory() as d:
            path.save(d)
            assert verify_payload(d) is True
            corrupt_checkpoint(d, mode)
            try:
                PathStore.from_checkpoint(d, mesh=mesh, device=dev, attempts=2)
            except (CheckpointCorruption, RetriesExhausted, ValueError):
                pass
            else:
                raise SystemExit(f"FAIL: {mode} corruption loaded silently")

    with tempfile.TemporaryDirectory() as d:
        prog = PathProgress(d, keep=2)
        for i in range(2):
            prog.save(i, {"beta": np.arange(4, dtype=np.float32) + i},
                      {"kind": "PathProgress", "next_index": i + 1})
        corrupt_checkpoint(prog.slot(1), "bitflip")
        idx, arrays, meta = prog.load_latest()
        assert idx == 0, idx                # rolled back to the last good slot
        assert np.array_equal(arrays["beta"], np.arange(4, dtype=np.float32))
    say("# corrupt: bitflip/truncate/drop-meta all detected; progress rolled back to "
        "the last good slot")


def scenario_overload(args, mesh, dev) -> None:
    """The bounded serve loop under latency, overload and poisoned swaps."""
    X, y = _dataset(args, dev, mesh)
    path = _estimator(mesh, dev).path(X, y, path_len=args.path_len)

    with inject_faults(FaultPlan(fail_swaps=1, serve_latency_s=0.005)):
        store = PathStore(path, mesh=mesh, device=dev)   # survives the injected failure
        scorer = PathScorer(store)
        t = [0.0]
        batcher = RequestBatcher(store.snapshot.p, max_batch=32, dp=store.dp,
                                 pad_p_to=store.pad_p_to, max_pending=8, default_ttl_s=1.0,
                                 clock=lambda: t[0])
        rng = np.random.default_rng(0)
        rejected = 0
        for _ in range(12):                  # 8 admitted, 4 rejected
            req = {f"tok{int(v)}": float(rng.normal())
                   for v in rng.integers(0, 4 * store.snapshot.p, size=6)}
            try:
                batcher.submit(req, float(path.lambdas[0]))
            except Overloaded:
                rejected += 1
        try:
            batcher.submit({"x": float("inf")}, 1.0)
        except InvalidRequest:
            pass
        t[0] = 2.0                           # everything queued expires
        batch, lams = batcher.drain()
        assert batch.n_live == 0
        for i in range(4):                   # fresh, in-deadline traffic
            batcher.submit({f"tok{i}": 1.0}, float(path.lambdas[-1]))
        batch, lams = batcher.drain()
        scores, ver = scorer.score(batch, lams)
        assert np.all(np.isfinite(scores)) and len(scores) == 4

        # a poisoned hot swap: quarantine pins back to the good version
        bad = PathResult(lambdas=path.lambdas, betas=torch.full_like(path.betas, float("nan")),
                         nnz=path.nnz, f=path.f, n_iters=path.n_iters)
        store.swap(bad)
        scores2, ver2 = scorer.score(batch, lams)
        assert ver2 == ver and np.array_equal(scores2, scores)
        assert store.quarantined, "the poisoned version was not quarantined"

        bad_only = PathStore(bad, mesh=mesh, device=dev)
        try:
            PathScorer(bad_only).score(batch, lams)
        except NonFiniteScores:
            pass
        else:
            raise SystemExit("FAIL: a poisoned-only store served NaN scores")

    stats = batcher.stats
    assert stats["rejected_overload"] == rejected == 4, stats
    assert stats["rejected_invalid"] == 1, stats
    assert stats["shed_expired"] == 8, stats
    assert stats["drained"] == 4, stats
    say(f"# overload: served {len(scores)} scores at v{ver} under latency+swap faults; "
        f"quarantined={store.quarantined}; telemetry={stats}")


def mixed_density_dataset(args, seed: int = 0):
    """Numpy X with stratified per-column nnz, so that ``to_slab_buckets``
    gives several capacity classes: streamed residency needs at least 3
    buckets before the LRU can evict anything under a double buffer."""
    rng = np.random.default_rng(seed)
    n, p = args.n, args.p
    levels = [4, 12, 28, min(60, n // 2)]
    X = np.zeros((n, p), np.float32)
    for j in range(p):
        rows = rng.choice(n, size=levels[j % len(levels)], replace=False)
        X[rows, j] = rng.normal(size=rows.size).astype(np.float32)
    w = rng.normal(size=p) * (rng.random(p) < 0.3)
    prob = 1.0 / (1.0 + np.exp(-(X @ w)))
    y = np.where(rng.random(n) < prob, 1.0, -1.0).astype(np.float32)
    return X, y


def scenario_lost_bucket(args, mesh, dev) -> None:
    """Streamed bucket residency under prefetch failure: transient faults
    are absorbed by retry (bit-identical to resident); a fatal failure
    window mid-path kills the solve after a checkpoint and the resume
    reproduces the path bit for bit."""
    work_mesh = mesh if mesh is not None else make_dev_mesh(1, 1, device=dev)
    proc = is_process_mesh(work_mesh) and work_mesh.ranks > 1
    X, y = mixed_density_dataset(args)
    X, y = trim_rows(work_mesh, X, y)
    slabs = to_slab_buckets(to_by_feature(X), work_mesh.examples)
    assert len(slabs.buckets) >= 3, \
        f"need >= 3 capacity classes to stream, got {slabs.k_classes}"

    tile = 16
    opts = DGLMNETOptions(tile=tile, max_iters=40)
    kw = dict(path_len=args.path_len, screen=True)
    base = _estimator(work_mesh, dev, opts).path(
        as_design(slabs, mesh=work_mesh, tile=tile), y, **kw)

    sizing = as_design(slabs, mesh=work_mesh, tile=tile)
    if proc:
        # one budget on every rank: the largest floor of any rank's pieces
        budget = max(stream_floor(sizing.inner.piece_nbytes(r, work_mesh.model_ranks))
                     for r in range(work_mesh.model_ranks))
    else:
        budget = sizing.slab_nbytes(tile) - min(sizing.slab_bucket_nbytes(tile))
    opts_s = replace(opts, device_budget_bytes=budget)

    def streamed_design():
        return as_design(slabs, mesh=work_mesh, tile=tile, device_budget_bytes=budget)

    # transient: two consecutive put failures, absorbed by retry (3 attempts)
    with inject_faults(FaultPlan(fail_prefetches=2)):
        des = streamed_design()
        streamed = _estimator(work_mesh, dev, opts_s).path(des, y, **kw)
    stats = des.residency_stats()[tile]
    assert proc or (stats["streamed"] and stats["evictions"] > 0), stats
    assert stats["retries"] == 2, stats
    assert same_path(streamed, base), "the streamed path differs from the resident one"
    if proc:
        say(f"# lost-bucket: rank 0's {stats['n_buckets']} pieces under budget {budget}B "
            f"(streamed={stats['streamed']}, evictions={stats['evictions']}), two put "
            f"failures retried on every rank, the path bit-identical to the resident one; "
            f"the fatal window does not apply to a process mesh")
        return

    # fatal: a failure window >= the retry budget, placed after half the
    # healthy run's puts, so the path dies mid-solve with checkpoints down
    with tempfile.TemporaryDirectory() as d:
        ckpt = dict(checkpoint_every=1, resume_from=d)
        died = False
        try:
            with inject_faults(FaultPlan(fail_prefetches=3,
                                         fail_prefetches_after=stats["puts"] // 2)):
                _estimator(work_mesh, dev, opts_s).path(streamed_design(), y, **ckpt, **kw)
        except RetriesExhausted:
            died = True
        assert died, "the fatal prefetch window never fired"
        resumed = _estimator(work_mesh, dev, opts_s).path(streamed_design(), y, **ckpt, **kw)
    assert same_path(resumed, base), "the resumed streamed path differs from the resident one"
    say(f"# lost-bucket: streamed {stats['n_buckets']} buckets under budget {budget}B "
        f"(hit_rate={stats['hit_rate']:.2f}, evictions={stats['evictions']}), transient "
        f"faults retried, fatal window after {stats['puts'] // 2} puts resumed "
        f"bit-identically")


def run(names, args, mesh, dev) -> None:
    for name in names:
        globals()["scenario_" + name.replace("-", "_")](args, mesh, dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenario", default="all", choices=SCENARIOS + ("all",))
    ap.add_argument("--smoke", action="store_true", help="small shapes")
    ap.add_argument("--mesh", default="local",
                    help="'local' (default), '1xM' (a (1, M) mesh) or, with --backend, "
                         "'DxM' / 'PxDxM' over the world's ranks")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--p", type=int, default=128)
    ap.add_argument("--path-len", type=int, default=4)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="run under repro_torch.obs, assert each scenario's expected "
                         "faults.*/retry.* counters fired, and write PATH.trace.json / "
                         "PATH.events.jsonl / PATH.summary.json")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    add_world_args(ap)
    args = ap.parse_args(argv)
    if args.spawn:
        raise SystemExit(spawn_world("repro_torch.launch.chaos_glm",
                                     sys.argv[1:] if argv is None else argv, args.spawn))
    if args.smoke:
        args.n, args.p, args.path_len = min(args.n, 128), min(args.p, 64), \
            min(args.path_len, 3)
    dev = resolve_device(args.device)
    with world_scope():
        _chaos(args, dev)


def _chaos(args, dev) -> None:
    """The rank's run (or the one process's): the mesh, then the
    scenarios, checked against their counters under ``--trace``."""
    mesh = mesh_from_args(args, dev)
    if mesh is not None:
        dev = mesh.device

    todo = SCENARIOS if args.scenario == "all" else (args.scenario,)
    if args.trace is None:
        run(todo, args, mesh, dev)
    else:
        with observe() as obs:
            for name in todo:
                run((name,), args, mesh, dev)
                for cname in EXPECT[name]:
                    got = obs.registry.value(cname)
                    if not got:
                        raise SystemExit(
                            f"FAIL: scenario {name} ran under --trace but counter "
                            f"{cname} never fired (value={got})")
                say(f"# trace: {name} fault counters fired: " + ", ".join(
                    f"{c}={obs.registry.value(c)}" for c in EXPECT[name]))
        dumped = obs.summary().get("counters", {})
        for name in todo:
            for cname in EXPECT[name]:
                if not dumped.get(cname):
                    raise SystemExit(
                        f"FAIL: counter {cname} fired live but is missing from the "
                        f"summary dump")
        files = obs.export(f"{args.trace}.rank{mesh.rank}"
                           if is_process_mesh(mesh) and mesh.rank else args.trace)
        say(f"# trace: {files['trace']} (open in Perfetto) | summary: "
            f"{files['summary']} (python -m repro_torch.obs.report {files['summary']})")
    if args.smoke:
        say("CHAOS SMOKE OK")


if __name__ == "__main__":
    main()
