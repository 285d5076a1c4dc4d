# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""GLM path-serving launcher: batched online scoring of a certified path,
the counterpart of ``repro/launch/serve_glm.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_glm --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --smoke --mesh 1x4
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --smoke --mesh 2x4 \
        --backend gloo --device cpu --spawn 8
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --load-path ckpt/ \
        --batch 256 --steps 50
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --smoke --device cpu \
        --trace /tmp/serve

Fits (or loads with ``--load-path``, a ``PathResult.save`` checkpoint of
either package) a certified regularization path, publishes it into a
:class:`~repro_torch.serve.PathStore` on the device, then drives
synthetic hashed-token traffic through the
:class:`~repro_torch.serve.RequestBatcher` ->
:class:`~repro_torch.serve.PathScorer` loop -- one kernel launch per
batch, every request picking its own lambda -- and reports scores per
second. ``--smoke`` also checks the served scores bit-equal to
``LogisticL1.decision_function`` at every point of the path and swaps a
shorter path in mid-traffic. Runs on the card (``--device cuda``, the
default, raising without one) unless ``--device cpu`` is given.

``--mesh`` takes ``local``, ``1xM`` (a ``DevMesh`` store) or, with
``--backend`` (``launch.world``: under torchrun, or ``--spawn N`` ranks
started from one command), ``DxM`` / ``PxDxM`` / ``prod`` over the
ranks of a ``torch.distributed`` world: every rank fits the same path on
its piece of the design, keeps its block of the store, packs the same
traffic in the mesh's example shards and serves the whole batch's scores
(``launch.mesh.parse_mesh``); rank 0 prints.

``--trace PATH`` runs the launcher under ``repro_torch.obs.observe()``:
the rounds run in a ``serve(steps=)`` span around the batcher's
``encode`` / ``drain`` and the scorer's ``score`` spans (the store's
``swap`` and, when a path is fitted, the path's span tree beside them),
each scored request's submit -> score latency lands in the
``serve.latency_s`` histogram, and the launcher prints its p50 / p95 /
p99 and writes ``PATH.trace.json`` (Perfetto), ``PATH.events.jsonl`` and
``PATH.summary.json`` (``python -m repro_torch.obs.report
PATH.summary.json`` renders it).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.api import LogisticL1, PathResult, ShardedDesign, SlabDesign
from repro_torch.configs.base import GLMConfig
from repro_torch.core import engine
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import world_scope
from repro_torch.launch.world import add_world_args, is_rank_zero, mesh_from_args, spawn_world
from repro_torch.obs import observe
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import PathScorer, PathStore, RequestBatcher


def make_traffic(rng, p: int, count: int, lambdas, *, tokens_per: int = 12):
    """``count`` synthetic hashed-token requests (1 ... ``tokens_per``
    tokens each, drawn from [0, 4p), Gaussian values) and a lambda per
    request, uniform over ``lambdas``; ``rng`` a numpy ``Generator``."""
    reqs, lams = [], []
    for _ in range(count):
        k = int(rng.integers(1, tokens_per + 1))
        toks = rng.integers(0, 4 * p, size=k)
        reqs.append({f"tok{t}": float(v) for t, v in zip(toks, rng.normal(size=k))})
        lams.append(float(lambdas[int(rng.integers(0, len(lambdas)))]))
    return reqs, lams


def serve_loop(scorer, batcher, reqs, lams, *, steps: int):
    """``steps`` submit -> drain -> score rounds over the traffic. Returns
    (scores served, seconds, versions seen); each round ends at the
    scorer's host read of its scores, after which ``mark_scored`` records
    the batch's latencies. Under an active tracer the rounds run in one
    ``serve(steps=)`` span."""
    total, versions = 0, set()
    per = max(1, len(reqs) // steps)
    t0 = time.perf_counter()
    with obs_trace.span("serve", steps=steps):
        for s in range(steps):
            for r, lam in zip(reqs[s * per:(s + 1) * per], lams[s * per:(s + 1) * per]):
                batcher.submit(r, lam)
            batch, blams = batcher.drain()
            scores, ver = scorer.score(batch, blams)
            batcher.mark_scored()
            total += len(scores)
            versions.add(ver)
    # allow[torch-bench-timing]: scorer.score returns host numpy through a counted read, so every batch is complete before the clock stops
    return total, time.perf_counter() - t0, versions


def say(*args) -> None:
    """Print on rank 0 of a world (or in none)."""
    if is_rank_zero():
        print(*args)


def smoke_check(store, scorer, batch, n_live: int, path) -> None:
    """Served scores bit-equal to ``decision_function`` at every lambda of
    ``path``: through a ``SlabDesign`` of the packed batch on a local
    store, through a ``ShardedDesign`` over the store's mesh on a mesh
    store. Raises ``SystemExit`` on a mismatch."""
    dev = store.device
    inner = SlabDesign(torch.from_numpy(batch.row_idx).to(dev),
                       torch.from_numpy(batch.values).to(dev), batch.batch_cap)
    design = (ShardedDesign(inner, store.mesh, tile=store.tile)
              if store.mesh is not None else inner)
    est = LogisticL1(mesh=store.mesh, device=dev)
    for lam_i in range(len(path)):
        beta = torch.nn.functional.pad(path.betas[lam_i].to(dev),
                                       (0, batch.p_pad - path.betas.shape[1]))
        # allow[torch-host-sync]: the smoke check's reference scores (decision_function), an oracle beside the served read
        ref = est.decision_function(design, beta=beta).cpu().numpy()[:n_live]  # allow[torch-nonfinite-guard]: the oracle compared bit for bit, not served
        got, _ = scorer.score(batch, np.full(n_live, path.lambdas[lam_i]))
        if not np.array_equal(got, ref):
            raise SystemExit(
                f"FAIL: served scores not bit-equal to decision_function at lambda "
                f"index {lam_i} (max |diff| {np.max(np.abs(got - ref)):.3e})")
    say(f"# smoke: served scores bit-equal to decision_function at all {len(path)} "
        f"lambdas")


def trim_rows(mesh, X, y):
    """The first rows of (X, y) that the mesh's example shards divide."""
    n = y.shape[0] - y.shape[0] % (1 if mesh is None else mesh.examples)
    return X[:n], y[:n]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes, plus the bit-equality and hot-swap checks")
    ap.add_argument("--mesh", default="local",
                    help="'local' (default), '1xM' (a (1, M) mesh store) or, with "
                         "--backend, 'DxM' / 'PxDxM' / 'prod' over the world's ranks")
    ap.add_argument("--batch", type=int, default=64, help="max requests per scoring launch")
    ap.add_argument("--steps", type=int, default=20, help="drain -> score rounds to time")
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--p", type=int, default=512)
    ap.add_argument("--path-len", type=int, default=6)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--save-path", default=None,
                    help="directory to PathResult.save the fitted path to")
    ap.add_argument("--load-path", default=None,
                    help="serve a PathResult.save checkpoint instead of fitting")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="run under repro_torch.obs and write PATH.trace.json (Perfetto), "
                         "PATH.events.jsonl and PATH.summary.json with the span totals and "
                         "the submit -> score latency histogram")
    add_world_args(ap)
    args = ap.parse_args(argv)
    if args.spawn:
        raise SystemExit(spawn_world("repro_torch.launch.serve_glm",
                                     sys.argv[1:] if argv is None else argv, args.spawn))
    if args.smoke:
        args.n, args.p, args.path_len = min(args.n, 256), min(args.p, 128), \
            min(args.path_len, 4)
    dev = resolve_device(args.device)
    with world_scope():
        _serve(args, dev)


def _serve(args, dev) -> None:
    """The rank's run (or the one process's): the mesh, then :func:`_run`,
    traced under ``--trace``."""
    mesh = mesh_from_args(args, dev)
    if mesh is not None:
        dev = mesh.device
    if args.trace is None:
        _run(args, dev, mesh)
        return
    with observe() as obs:
        _run(args, dev, mesh)
    summary = obs.summary()
    hist = summary.get("histograms", {}).get("serve.latency_s")
    if hist and hist["count"]:
        say(f"# submit->score latency ({hist['count']} requests): "
            f"p50 {hist['p50'] * 1e3:.2f}ms / p95 {hist['p95'] * 1e3:.2f}ms / "
            f"p99 {hist['p99'] * 1e3:.2f}ms")
    if not is_rank_zero():
        return
    files = obs.export(args.trace)
    print(f"# trace: {files['trace']} (open in Perfetto) | summary: {files['summary']} "
          f"(python -m repro_torch.obs.report {files['summary']})")


def _run(args, dev, mesh) -> None:
    """Fit or load the path, serve the traffic, and (``--smoke``) check
    the served scores and a hot swap."""

    if args.load_path:
        path = PathResult.load(args.load_path, device=dev)
        say(f"# loaded path: L={len(path)} p={path.betas.shape[1]} from {args.load_path}")
    else:
        cfg = GLMConfig(name="serve-glm", num_examples=args.n, num_features=args.p,
                        density=0.1)
        ds = make_glm_dataset(cfg, np.random.default_rng(0), device=dev)
        X, y = trim_rows(mesh, ds.X_train, ds.y_train)
        path = LogisticL1(mesh=mesh, device=dev).path(X, y, path_len=args.path_len)
        say(f"# fitted path: L={len(path)} p={args.p} nnz={[int(v) for v in path.nnz]}")
    if args.save_path and is_rank_zero():
        path.save(args.save_path)
        print(f"# saved path to {args.save_path}")

    store = PathStore(path, mesh=mesh, tile=args.tile, device=dev)
    scorer = PathScorer(store)
    p = store.snapshot.p
    batcher = RequestBatcher(p, max_batch=args.batch, dp=store.dp, pad_p_to=store.pad_p_to)
    reqs, lams = make_traffic(np.random.default_rng(0), p, args.batch * args.steps,
                              path.lambdas)

    # one warm batch, then the timed rounds
    for r, lam in zip(reqs[:args.batch], lams[:args.batch]):
        batcher.submit(r, lam)
    warm_batch, warm_lams = batcher.drain()
    scorer.score(warm_batch, warm_lams)
    total, secs, _ = serve_loop(scorer, batcher, reqs, lams, steps=args.steps)
    say(f"# served {total} scores in {secs:.3f}s -> {total / max(secs, 1e-12):,.0f} "
        f"scores/sec (batch <= {args.batch}, mesh={args.mesh}, device={dev})")

    if args.smoke:
        smoke_check(store, scorer, warm_batch, warm_batch.n_live, path)
        # hot swap: publish a truncated path mid-traffic; each batch scores
        # against exactly one version
        sub = PathResult(lambdas=path.lambdas[:2], betas=path.betas[:2], nnz=path.nnz[:2],
                         f=path.f[:2], n_iters=path.n_iters[:2], metrics=path.metrics[:2],
                         screen=path.screen[:2])
        v_before = scorer.score(warm_batch, warm_lams)[1]
        store.swap(sub)
        got, v_after = scorer.score(warm_batch, warm_lams)
        if v_after != v_before + 1 or len(got) != warm_batch.n_live:
            raise SystemExit("FAIL: hot-swap version bookkeeping broken")
        if mesh is not None and mesh.ranks > 1:
            # every rank serves the same version
            seen = mesh.all_reduce(torch.tensor([v_after], dtype=torch.int64,
                                                device=dev if mesh.backend == "nccl" else "cpu"),
                                   mesh.axis_names)
            # allow[torch-nonfinite-guard]: an integer sum of the ranks' version numbers
            if int(engine.host_read(seen[0])) != v_after * mesh.ranks:
                raise SystemExit("FAIL: the ranks serve different store versions")
        say(f"# smoke: hot-swap v{v_before} -> v{v_after} served {len(got)} scores "
            f"without dropping the batch")
        say("SERVE SMOKE OK")


if __name__ == "__main__":
    main()
