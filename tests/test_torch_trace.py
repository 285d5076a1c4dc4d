"""The port's spans and serve metrics (``repro_torch.obs`` placed in the
path driver, the residency manager and the serve layer) held against the
reference's, on the CPU, with inputs made once in numpy from a seed:

* the path's span tree (``path > lambda_grid / lambda_point >
  {screen_round, restricted_solve, kkt_check, point_finish}``) on a dense
  and a local slab design (256 x 64, ``path_len`` 6): the same names,
  nesting and counts in pre-order, and the same ``round``, ``active``,
  ``capacity``, ``violations``, ``index``, ``status``, ``path_len``,
  ``screen`` and ``points``, lambdas within 1e-5 relative;
* a traced path bit-equal to an untraced one, with the same
  ``engine.host_syncs``, on dense, local-slab and (1, 4)-mesh layouts;
* a streamed path: as many ``bucket_stream`` spans as residency misses,
  equal on both packages, and the residency callback equal to
  ``residency_stats()``;
* ``serve_glm --smoke --trace`` on both packages: the same serve span
  names and counts, ``serve.latency_s`` counting every request scored in
  the timed rounds, ``serve.swaps`` equal;
* ``examples/torch_quickstart.py --device cpu`` runs and prints its
  per-lambda phase report.
"""
import importlib
import json
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.byfeature as jbf
from repro.api import DenseDesign as JDense
from repro.api import LogisticL1 as JLogisticL1
from repro.api import SlabDesign as JSlab
from repro.api import as_design as j_as_design
from repro.core.dglmnet import DGLMNETOptions as JOptions
from repro.launch.mesh import make_dev_mesh as j_make_dev_mesh
from repro.obs import observe as j_observe
from repro_torch.api import (BucketedSlabDesign, DenseDesign, LogisticL1, ShardedDesign,
                             SlabDesign, as_design)
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions
from repro_torch.data import byfeature as tbf
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.obs import observe

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
N, P, PATH_LEN = 256, 64, 6
OPTS = dict(num_blocks=4, tile=8, max_iters=150, rel_tol=1e-8)
TREE_ARGS = ("round", "active", "capacity", "violations", "index", "status", "path_len",
             "screen", "points")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = (rng.normal(size=(N, P)) * (rng.random((N, P)) < 0.3)).astype(np.float32)
    w = np.zeros(P)
    w[:8] = rng.normal(size=8) * 2.0
    y = np.where(rng.random(N) < 1.0 / (1.0 + np.exp(-(X @ w))), 1.0, -1.0).astype(np.float32)
    rows, vals, _ = tbf.to_slabs(tbf.to_by_feature(X), 1)
    return dict(X=X, y=y, rows=rows.numpy(), vals=vals.numpy())


def span_tree(spans):
    """(name, depth, {tree args}, lam) per span in pre-order: span ids are
    handed out as spans open, so sorting by id walks the tree."""
    by_id = {r["sid"]: r for r in spans}

    def depth(r):
        d = 0
        while r["parent"] is not None:
            r, d = by_id[r["parent"]], d + 1
        return d

    return [(r["name"], depth(r), {k: r["args"][k] for k in TREE_ARGS if k in r["args"]},
             r["args"].get("lam")) for r in sorted(spans, key=lambda r: r["sid"])]


@pytest.mark.parametrize("kind", ["dense", "slab"])
def test_path_span_tree_matches_reference(problem, kind):
    X, y, n = problem["X"], problem["y"], N
    if kind == "dense":
        jd, td = JDense(jnp.asarray(X)), DenseDesign(torch.from_numpy(X))
    else:
        jd = JSlab(jnp.asarray(problem["rows"]), jnp.asarray(problem["vals"]), n)
        td = SlabDesign(torch.from_numpy(problem["rows"]), torch.from_numpy(problem["vals"]), n)
    with j_observe() as jo:
        JLogisticL1(opts=JOptions(**OPTS)).path(jd, jnp.asarray(y), path_len=PATH_LEN)
    with observe() as to:
        LogisticL1(DGLMNETOptions(**OPTS), device="cpu").path(td, torch.from_numpy(y),
                                                              path_len=PATH_LEN)
    ref, port = span_tree(jo.tracer.spans), span_tree(to.tracer.spans)
    assert [r[:3] for r in port] == [r[:3] for r in ref]
    names = [r[0] for r in port]
    assert names[0] == "path" and names.count("lambda_point") == PATH_LEN
    assert {"lambda_grid", "screen_round", "restricted_solve", "kkt_check",
            "point_finish"} <= set(names)
    for (_, _, _, a), (_, _, _, b) in zip(port, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= 1e-5 * abs(b), (a, b)


def _layouts(problem):
    X, n = problem["X"], N
    rows, vals = torch.from_numpy(problem["rows"]), torch.from_numpy(problem["vals"])
    mesh = make_dev_mesh(1, 4, device="cpu")
    bucketed = BucketedSlabDesign(tbf.to_slab_buckets(tbf.to_by_feature(X), 1), n)
    return {
        "dense": (lambda: DenseDesign(torch.from_numpy(X)), None),
        "slab": (lambda: SlabDesign(rows, vals, n), None),
        "mesh": (lambda: ShardedDesign(bucketed, mesh, tile=OPTS["tile"]), mesh),
    }


@pytest.mark.parametrize("kind", ["dense", "slab", "mesh"])
def test_traced_path_bit_equal_to_untraced(problem, kind):
    make, mesh = _layouts(problem)[kind]
    opts = DGLMNETOptions(**(dict(OPTS, num_blocks=1) if mesh is not None else OPTS))
    y = torch.from_numpy(problem["y"])
    runs = []
    for traced in (False, True):
        est = LogisticL1(opts, mesh=mesh, device="cpu")
        engine.host_syncs = 0
        if traced:
            with observe() as obs:
                res = est.path(make(), y, path_len=PATH_LEN)
        else:
            res = est.path(make(), y, path_len=PATH_LEN)
        runs.append((res, engine.host_syncs))
    (off, reads_off), (on, reads_on) = runs
    assert torch.equal(on.betas, off.betas)
    assert np.array_equal(on.f, off.f) and np.array_equal(on.nnz, off.nnz)
    assert on.screen == off.screen
    assert reads_on == reads_off
    names = [r["name"] for r in obs.tracer.spans]
    assert names.count("lambda_point") == PATH_LEN and names.count("path") == 1


def _mixed_density_X(n, p, seed=0):
    """Several power-of-two K classes, so the buckets stream and evict."""
    rng = np.random.default_rng(seed)
    levels = [4, 12, 28, min(60, n // 2)]
    X = np.zeros((n, p), np.float32)
    for j in range(p):
        rows = rng.choice(n, size=levels[j % len(levels)], replace=False)
        X[rows, j] = rng.normal(size=rows.size).astype(np.float32)
    return X


def test_streamed_path_bucket_streams_match_reference():
    X = _mixed_density_X(128, 48)
    rng = np.random.default_rng(1)
    w = rng.normal(size=48) * (rng.random(48) < 0.3)
    y = np.where(rng.random(128) < 1.0 / (1.0 + np.exp(-(X @ w))), 1.0, -1.0).astype(np.float32)
    tile = 16
    mesh, jmesh = make_dev_mesh(1, 1, device="cpu"), j_make_dev_mesh(1, 1)
    slabs = tbf.to_slab_buckets(tbf.to_by_feature(X), 1)
    sizing = as_design(slabs, mesh=mesh, tile=tile)
    budget = sizing.slab_nbytes(tile) - min(sizing.slab_bucket_nbytes(tile))
    des = as_design(slabs, mesh=mesh, tile=tile, device_budget_bytes=budget)
    jdes = j_as_design(jbf.to_slab_buckets(jbf.to_by_feature(X), 1), mesh=jmesh, tile=tile,
                       device_budget_bytes=budget)
    with observe() as to:
        LogisticL1(DGLMNETOptions(tile=tile, max_iters=30), mesh=mesh, device="cpu").path(
            des, y, path_len=3)
        mirrored = to.registry.collect()["callbacks"]
    with j_observe() as jo:
        JLogisticL1(opts=JOptions(tile=tile, max_iters=30), mesh=jmesh).path(jdes, y,
                                                                              path_len=3)
    (stats,) = des.residency_stats().values()
    (jstats,) = jdes.residency_stats().values()
    streams = [r for r in to.tracer.spans if r["name"] == "bucket_stream"]
    jstreams = [r for r in jo.tracer.spans if r["name"] == "bucket_stream"]
    assert stats["streamed"] and stats["misses"] > stats["n_buckets"]
    assert len(streams) == stats["misses"] == jstats["misses"] == len(jstreams)
    assert [r["args"]["bucket"] for r in streams] == [r["args"]["bucket"] for r in jstreams]
    # the callback is registered at residency build under the reference's name
    assert mirrored == {f"residency.tile{tile}": stats}


def _serve_glm(pkg, trace, monkeypatch, capsys):
    mod = importlib.import_module(f"{pkg}.launch.serve_glm")
    argv = ["serve_glm", "--smoke", "--trace", str(trace)]
    if pkg == "repro_torch":
        argv += ["--device", "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    mod.main()
    assert "SERVE SMOKE OK" in capsys.readouterr().out
    return json.loads(Path(f"{trace}.summary.json").read_text()), \
        json.loads(Path(f"{trace}.trace.json").read_text())


def test_serve_glm_trace_matches_reference(tmp_path, monkeypatch, capsys):
    serve_spans = ("serve", "encode", "drain", "score", "swap")
    out = {}
    for pkg in ("repro", "repro_torch"):
        summary, trace = _serve_glm(pkg, tmp_path / pkg, monkeypatch, capsys)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        counts = {name: sum(1 for e in events if e.get("name") == name and e.get("ph") == "X")
                  for name in serve_spans}
        out[pkg] = (summary, counts)
    (jsum, jcounts), (tsum, tcounts) = out["repro"], out["repro_torch"]
    assert tcounts == jcounts
    assert all(tcounts[name] > 0 for name in serve_spans)
    # --smoke: 64 requests per batch, 20 timed rounds
    assert tsum["histograms"]["serve.latency_s"]["count"] == 20 * 64
    assert jsum["histograms"]["serve.latency_s"]["count"] == 20 * 64
    assert tsum["counters"]["serve.swaps"] == jsum["counters"]["serve.swaps"] == 2
    assert tsum["callbacks"]["serve.batcher"] == jsum["callbacks"]["serve.batcher"]


def test_torch_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["torch_quickstart.py", "--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / "torch_quickstart.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "fit: status=OK" in out and "best: lambda=" in out
    assert "per-lambda phases" in out and "root span path" in out
