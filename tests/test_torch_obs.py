"""The port's copy of the metrics registry, tracer and exporters
(``repro_torch.obs``) held to the reference's behaviour: each case of the
reference's own registry, tracer and export tests (``tests/test_obs.py``)
runs on both packages' ``obs`` modules (the ``obs`` fixture), so the port
answers every case as ``repro.obs`` does. The two solver cases of the
reference's file (a traced tiny path whose phases add up and equals an
untraced one, and the batcher's stats with and without a registry) run
on both packages' solvers and serve layers at small sizes."""
import importlib
import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch


@pytest.fixture(params=["repro", "repro_torch"])
def obs(request):
    """One package's ``obs``: its public names plus its ``registry``,
    ``trace`` and ``report`` modules."""
    pkg = importlib.import_module(f"{request.param}.obs")
    return SimpleNamespace(
        MetricsRegistry=pkg.MetricsRegistry, Tracer=pkg.Tracer, ObsSession=pkg.ObsSession,
        chrome_trace=pkg.chrome_trace, summarize=pkg.summarize,
        render_summary=pkg.render_summary, observe=pkg.observe,
        registry=importlib.import_module(f"{request.param}.obs.registry"),
        trace=importlib.import_module(f"{request.param}.obs.trace"),
        report=importlib.import_module(f"{request.param}.obs.report"))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_basics(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("hits")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert reg.counter("hits") is c            # get-or-create
    reg.gauge("depth").set(7)
    assert reg.gauge("depth").value == 7.0
    h = reg.histogram("lat")
    for v in (0.001, 0.002, 0.004):
        h.observe(v)
    assert h.count == 3 and h.sum == pytest.approx(0.007)


def test_labels_key_separate_instruments(obs):
    reg = obs.MetricsRegistry()
    reg.counter("faults", kind="swap").inc()
    reg.counter("faults", kind="kill").inc(2)
    snap = reg.collect()["counters"]
    assert snap["faults{kind=swap}"] == 1
    assert snap["faults{kind=kill}"] == 2


def test_value_returns_none_for_never_created(obs):
    reg = obs.MetricsRegistry()
    assert reg.value("nope") is None
    reg.counter("yes").inc()
    assert reg.value("yes") == 1


def test_histogram_percentiles_sane(obs):
    h = obs.MetricsRegistry().histogram("lat")
    vals = [i * 1e-3 for i in range(1, 101)]    # 1ms .. 100ms
    for v in vals:
        h.observe(v)
    snap = h.snapshot()
    assert snap["count"] == 100
    assert snap["min"] == pytest.approx(1e-3)
    assert snap["max"] == pytest.approx(0.1)
    # log-bucketed interpolation: right order of magnitude, clamped range
    assert 0.02 <= snap["p50"] <= 0.08
    assert snap["p50"] <= snap["p95"] <= snap["p99"] <= snap["max"]


def test_empty_histogram_is_json_safe(obs):
    snap = obs.MetricsRegistry().histogram("lat").snapshot()
    assert snap == {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
    json.dumps(snap)                            # no NaN anywhere


def test_callback_mirrors_legacy_dict_lazily(obs):
    reg = obs.MetricsRegistry()
    legacy = {"drained": 0}
    reg.register_callback("serve.batcher", lambda: legacy)
    legacy["drained"] = 9                       # mutate AFTER registration
    assert reg.collect()["callbacks"]["serve.batcher"] == {"drained": 9}


def test_dead_callback_does_not_kill_collect(obs):
    reg = obs.MetricsRegistry()
    reg.register_callback("bad", lambda: 1 / 0)
    out = reg.collect()["callbacks"]["bad"]
    assert "error" in out and "ZeroDivisionError" in out["error"]


def test_disabled_helpers_return_null_singletons(obs):
    assert obs.registry.get_registry() is None
    assert obs.registry.counter("x") is obs.registry._NULL_COUNTER
    assert obs.registry.gauge("x") is obs.registry._NULL_GAUGE
    assert obs.registry.histogram("x") is obs.registry._NULL_HISTOGRAM
    assert obs.trace.get_tracer() is None
    assert obs.trace.span("x") is obs.trace._NULL_SPAN
    # all no-ops, no errors
    obs.registry.counter("x").inc()
    obs.registry.gauge("x").set(1)
    obs.registry.histogram("x").observe(0.1)
    with obs.trace.span("x") as sp:
        sp.set(k=1)
    obs.trace.event("x")


def test_use_registry_is_reentrant(obs):
    outer, inner = obs.MetricsRegistry(), obs.MetricsRegistry()
    with obs.registry.use_registry(outer):
        obs.registry.counter("n").inc()
        with obs.registry.use_registry(inner):
            obs.registry.counter("n").inc(10)
        obs.registry.counter("n").inc()
    assert obs.registry.get_registry() is None
    assert outer.value("n") == 2 and inner.value("n") == 10


def test_counter_inc_is_thread_safe(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("n")

    def worker():
        for _ in range(1000):
            c.inc()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 4000


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _fake_clock(times):
    it = iter(times)
    return lambda: next(it)


def test_spans_nest_and_record_parents(obs):
    tr = obs.Tracer(clock=_fake_clock([0.0, 1.0, 2.0, 3.0, 4.0]))
    with tr.span("outer", a=1) as outer:
        with tr.span("inner") as inner:
            inner.set(ok=True)
        outer.set(points=2)
    inner_rec, outer_rec = tr.spans          # completion order
    assert inner_rec["name"] == "inner" and inner_rec["args"] == {"ok": True}
    assert inner_rec["parent"] == outer_rec["sid"]
    assert outer_rec["parent"] is None
    assert outer_rec["args"] == {"a": 1, "points": 2}
    # rel to tracer start: construction ate tick 0, outer opened at 1
    assert outer_rec["ts"] == pytest.approx(1.0)
    assert outer_rec["dur"] == pytest.approx(3.0)
    assert inner_rec["dur"] == pytest.approx(1.0)
    assert tr.wall_s() == pytest.approx(4.0)


def test_sibling_threads_get_own_stacks(obs):
    tr = obs.Tracer()
    seen = {}

    def worker(name):
        with tr.span(name):
            pass

    with tr.span("main"):
        t = threading.Thread(target=worker, args=("side",))
        t.start()
        t.join()
    for r in tr.spans:
        seen[r["name"]] = r
    # the side thread's span must NOT have the main thread's span as
    # parent (stacks are thread-local) and gets its own small tid
    assert seen["side"]["parent"] is None
    assert seen["side"]["tid"] != seen["main"]["tid"]


# ---------------------------------------------------------------------------
# export + summary + report
# ---------------------------------------------------------------------------

def _toy_tracer(obs):
    tr = obs.Tracer(clock=_fake_clock([float(i) for i in range(20)]))
    with tr.span("path", path_len=2):
        with tr.span("lambda_point", index=0, lam=0.5) as sp:
            with tr.span("restricted_solve"):
                pass
            sp.set(nnz=3, status=0)
        with tr.span("lambda_point", index=1, lam=0.25) as sp:
            with tr.span("restricted_solve"):
                pass
            sp.set(nnz=5, status=0)
    return tr


def test_chrome_trace_events_are_complete_events(obs):
    doc = obs.chrome_trace(_toy_tracer(obs))
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert len(evs) == 5
    assert all(e["ph"] == "X" for e in evs)
    assert all(set(e) >= {"name", "ts", "dur", "pid", "tid", "args"}
               for e in evs)
    # microseconds: the 1s-per-tick fake clock makes every dur >= 1e6
    assert all(e["dur"] >= 1e6 for e in evs)
    json.dumps(doc)


def test_summarize_phases_and_per_lambda(obs):
    reg = obs.MetricsRegistry()
    reg.counter("faults.kill").inc()
    s = obs.summarize(_toy_tracer(obs), reg)
    assert s["spans"]["lambda_point"]["count"] == 2
    assert [r["name"] for r in s["roots"]] == ["path"]
    # phases = direct children of the root, grouped by name
    assert set(s["phases"]["path"]) == {"lambda_point"}
    assert len(s["per_lambda"]) == 2
    row = s["per_lambda"][0]
    assert row["index"] == 0 and row["nnz"] == 3
    assert set(row["phases"]) == {"restricted_solve"}
    assert s["counters"]["faults.kill"] == 1


def test_obs_session_export_and_report_cli(obs, tmp_path, capsys):
    sess = obs.ObsSession(_toy_tracer(obs), obs.MetricsRegistry())
    files = sess.export(str(tmp_path / "run"))
    assert set(files) == {"trace", "events", "summary"}
    with open(files["trace"]) as fh:
        assert json.load(fh)["traceEvents"]
    with open(files["events"]) as fh:
        lines = [json.loads(ln) for ln in fh]
    assert len(lines) == 5 and all("sid" in r for r in lines)
    assert obs.report.main([files["summary"]]) == 0
    out = capsys.readouterr().out
    assert "per-lambda phases" in out and "root span path" in out


def test_render_summary_serve_and_counter_lines(obs):
    reg = obs.MetricsRegistry()
    for v in (0.001, 0.002, 0.003):
        reg.histogram("serve.latency_s").observe(v)
    reg.counter("faults.swap").inc()
    reg.register_callback("residency.tile8",
                          lambda: {"hits": 3, "misses": 1, "evictions": 2,
                                   "bytes_h2d": 64})
    text = obs.render_summary(obs.summarize(None, reg))
    assert "serve submit->score latency (3 requests)" in text
    assert "residency.tile8: hit rate 0.75" in text
    assert "faults.swap=1" in text


def test_observe_is_nestable_and_restores(obs):
    with obs.observe() as outer:
        obs.registry.counter("n").inc()
        with obs.observe() as inner:
            obs.registry.counter("n").inc(5)
            with obs.trace.span("s"):
                pass
        obs.registry.counter("n").inc()
    assert obs.registry.get_registry() is None and obs.trace.get_tracer() is None
    assert outer.registry.value("n") == 2 and inner.registry.value("n") == 5
    assert [r["name"] for r in inner.tracer.spans] == ["s"] and not outer.tracer.spans


def test_the_two_packages_summarize_alike():
    """The same spans and counters give the same summary keys and counter
    values, and each package's report renders the other's summary."""
    summaries = []
    for name in ("repro", "repro_torch"):
        pkg = importlib.import_module(f"{name}.obs")
        clock = iter(float(i) for i in range(20))
        tr = pkg.Tracer(clock=lambda: next(clock))
        with tr.span("path", path_len=1):
            with tr.span("lambda_point", index=0, lam=0.5) as sp:
                sp.set(nnz=2, status=0)
        reg = pkg.MetricsRegistry()
        reg.counter("faults.engine").inc(3)
        reg.counter("retry.retries").inc()
        summaries.append(json.loads(json.dumps(pkg.summarize(tr, reg), default=str)))
    ref, port = summaries
    assert ref == port
    from repro.obs.report import render_summary as j_render
    from repro_torch.obs.report import render_summary as t_render
    assert j_render(port) == t_render(ref)


# ---------------------------------------------------------------------------
# the reference's two solver cases, on both packages
# ---------------------------------------------------------------------------

def _tiny_problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 24)).astype(np.float32)
    y = (rng.random(60) < 0.5).astype(np.float32)
    return X, y


def _tiny_path(pkg):
    """The reference's tiny dense path in package ``pkg``: returns a
    callable running it (betas as numpy) and a host-read counter."""
    X, y = _tiny_problem()
    if pkg == "repro":
        import jax.numpy as jnp

        from repro.api import DenseDesign, LogisticL1
        from repro.core.dglmnet import DGLMNETOptions

        est = LogisticL1(opts=DGLMNETOptions(num_blocks=4, tile=8, max_iters=5))
        design, yv = DenseDesign(jnp.asarray(X)), jnp.asarray(y)
        return lambda: est.path(design, yv, path_len=3), lambda p: np.asarray(p.betas), None
    from repro_torch.api import DenseDesign, LogisticL1
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions

    est = LogisticL1(DGLMNETOptions(num_blocks=4, tile=8, max_iters=5), device="cpu")
    design, yv = DenseDesign(torch.from_numpy(X)), torch.from_numpy(y)
    return lambda: est.path(design, yv, path_len=3), lambda p: p.betas.numpy(), engine


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_traced_tiny_path_phases_add_up(pkg):
    run, betas, engine = _tiny_path(pkg)
    observe = importlib.import_module(f"{pkg}.obs").observe
    if engine is not None:
        engine.host_syncs = 0
    with observe() as obs:
        path = run()
    traced_reads = engine.host_syncs if engine is not None else None
    s = obs.summary()
    root = s["roots"][0]
    assert root["name"] == "path" and root["args"]["path_len"] == 3
    assert root["args"]["points"] == len(path) == 3
    assert len(s["per_lambda"]) == 3
    for row in s["per_lambda"]:
        assert {"index", "lam", "nnz", "status", "dur_s"} <= set(row)
    # the direct children's totals account for the root's wall to within 5%
    covered = sum(s["phases"]["path"].values())
    assert covered <= root["dur_s"] * 1.0001
    assert covered >= root["dur_s"] * 0.95, (covered, root["dur_s"])
    # an untraced rerun is bit-identical, and (the port) reads the device
    # exactly as often
    if engine is not None:
        engine.host_syncs = 0
    path2 = run()
    assert np.array_equal(betas(path), betas(path2))
    if engine is not None:
        assert engine.host_syncs == traced_reads


def _drive_batcher(batcher, overloaded):
    for i in range(12):
        try:
            batcher.submit({f"tok{i}": 1.0}, 0.5)
        except overloaded:
            pass
    batcher.drain()
    return dict(batcher.stats)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_batcher_stats_bit_identical_with_and_without_obs(pkg):
    serve = importlib.import_module(f"{pkg}.serve")
    observe = importlib.import_module(f"{pkg}.obs").observe

    def build():
        return serve.RequestBatcher(16, max_batch=8, max_pending=8)

    stats_off = _drive_batcher(build(), serve.Overloaded)
    with observe() as obs:
        stats_on = _drive_batcher(build(), serve.Overloaded)
        mirrored = obs.registry.collect()["callbacks"]["serve.batcher"]
    assert stats_on == stats_off                 # the dict is untouched
    assert mirrored == stats_on                  # the registry mirrors it
