# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""GLM path-serving launcher: batched online scoring of a certified path,
the counterpart of ``repro/launch/serve_glm.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve_glm --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --smoke --mesh 1x4
    PYTHONPATH=src python -m repro_torch.launch.serve_glm --load-path ckpt/ \
        --batch 256 --steps 50

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
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import LogisticL1, PathResult, ShardedDesign, SlabDesign
from repro_torch.configs.base import GLMConfig
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_dev_mesh
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
    scorer's host read of its scores."""
    total, versions = 0, set()
    per = max(1, len(reqs) // steps)
    t0 = time.perf_counter()
    for s in range(steps):
        for r, lam in zip(reqs[s * per:(s + 1) * per], lams[s * per:(s + 1) * per]):
            batcher.submit(r, lam)
        batch, blams = batcher.drain()
        scores, ver = scorer.score(batch, blams)
        batcher.mark_scored()
        total += len(scores)
        versions.add(ver)
    return total, time.perf_counter() - t0, versions


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
        ref = est.decision_function(design, beta=beta).cpu().numpy()[:n_live]
        got, _ = scorer.score(batch, np.full(n_live, path.lambdas[lam_i]))
        if not np.array_equal(got, ref):
            raise SystemExit(
                f"FAIL: served scores not bit-equal to decision_function at lambda "
                f"index {lam_i} (max |diff| {np.max(np.abs(got - ref)):.3e})")
    print(f"# smoke: served scores bit-equal to decision_function at all {len(path)} "
          f"lambdas")


def parse_mesh(spec: str, device):
    """``"local"`` -> None; ``"1xM"`` -> a (1, M) mesh on ``device``."""
    if spec == "local":
        return None
    try:
        data, model = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh takes 'local' or '1xM', got {spec!r}")
    return make_dev_mesh(data, model, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes, plus the bit-equality and hot-swap checks")
    ap.add_argument("--mesh", default="local",
                    help="'local' (default) or '1xM': a (1, M) mesh store")
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
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.p, args.path_len = min(args.n, 256), min(args.p, 128), \
            min(args.path_len, 4)
    dev = resolve_device(args.device)
    mesh = parse_mesh(args.mesh, dev)

    if args.load_path:
        path = PathResult.load(args.load_path, device=dev)
        print(f"# loaded path: L={len(path)} p={path.betas.shape[1]} from {args.load_path}")
    else:
        cfg = GLMConfig(name="serve-glm", num_examples=args.n, num_features=args.p,
                        density=0.1)
        ds = make_glm_dataset(cfg, np.random.default_rng(0), device=dev)
        path = LogisticL1(mesh=mesh, device=dev).path(ds.X_train, ds.y_train,
                                                      path_len=args.path_len)
        print(f"# fitted path: L={len(path)} p={args.p} nnz={path.nnz.tolist()}")
    if args.save_path:
        path.save(args.save_path)
        print(f"# saved path to {args.save_path}")

    store = PathStore(path, mesh=mesh, tile=args.tile, device=dev)
    scorer = PathScorer(store)
    p = store.snapshot.p
    batcher = RequestBatcher(p, max_batch=args.batch, pad_p_to=store.pad_p_to)
    reqs, lams = make_traffic(np.random.default_rng(0), p, args.batch * args.steps,
                              path.lambdas)

    # one warm batch, then the timed rounds
    for r, lam in zip(reqs[:args.batch], lams[:args.batch]):
        batcher.submit(r, lam)
    warm_batch, warm_lams = batcher.drain()
    scorer.score(warm_batch, warm_lams)
    total, secs, _ = serve_loop(scorer, batcher, reqs, lams, steps=args.steps)
    print(f"# served {total} scores in {secs:.3f}s -> {total / max(secs, 1e-12):,.0f} "
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
        print(f"# smoke: hot-swap v{v_before} -> v{v_after} served {len(got)} scores "
              f"without dropping the batch")
        print("SERVE SMOKE OK")


if __name__ == "__main__":
    main()
