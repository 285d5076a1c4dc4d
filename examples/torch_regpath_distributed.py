"""End-to-end run of the PyTorch port on a process mesh (the
counterpart of ``examples/regpath_distributed.py``): distributed d-GLMNET
against truncated gradient over a regularization path, on a (2, 4) mesh
of ``torch.distributed`` ranks -- 2 example shards x 4 feature blocks,
one block per rank.

Everything runs through the one front door, ``repro_torch.api.LogisticL1``
over ``ShardedDesign``-wrapped layouts: every rank builds the same data
from the seed and keeps its example shard; beta is whole on every rank.
The closing sections run the screened path (strong rule + KKT around the
mesh's restricted solves), on the dense design and on by-feature slabs
(``SlabDesign.from_dense(X, 2)``: no dense X in the solve), with test
AUPRC streamed through a sharded test design (``make_design_eval``).

    # on the CPU: spawns the 8 gloo ranks itself
    PYTHONPATH=src python examples/torch_regpath_distributed.py --device cpu
    # on cards: one rank per card, NCCL (2, 4 or 8 ranks: 2 x 1, 2 or 4 model ranks)
    PYTHONPATH=src torchrun --nproc-per-node 8 examples/torch_regpath_distributed.py

Rank 0 prints. ``--small`` runs a 4096 x 256 problem (the default is
the reference example's 16384 x 1024: about a minute on an 8-core CPU
host, ``--small`` about 25 s).
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import (DenseDesign, LogisticL1, ShardedDesign, SlabDesign,
                             lambda_max_design, make_design_eval)
from repro_torch.configs.base import GLMConfig
from repro_torch.core import DGLMNETOptions, TGOptions, truncated_gradient_fit
from repro_torch.data.synthetic import make_glm_dataset
from repro_torch.launch.mesh import init_process_mesh, make_production_mesh
from repro_torch.train.metrics import auprc

DATA, MODEL = 2, 4


def run(mesh, small: bool) -> None:
    dev = mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    n, p = (4096, 256) if small else (16384, 1024)
    ds = make_glm_dataset(GLMConfig(name="dist", num_examples=n * 5 // 4, num_features=p,
                                    density=0.2), np.random.default_rng(0), device=dev)
    X, y = ds.X_train, ds.y_train
    X_test_host, y_test_host = ds.X_test.cpu().numpy(), ds.y_test.cpu().numpy()
    design = ShardedDesign(DenseDesign(X), mesh, tile=64)
    lmax = float(lambda_max_design(design, y))
    say(f"mesh={mesh.shape} ranks={mesh.ranks} backend={mesh.backend} n={X.shape[0]} "
        f"p={p} device={dev}")

    say("\n-- d-GLMNET path (feature blocks over `model`, examples over `data`)")
    est = LogisticL1(DGLMNETOptions(tile=64, max_iters=40), mesh=mesh, device=dev,
                     warm_start=True)
    best_d = 0.0
    for i in range(1, 9):
        lam = lmax * 2.0 ** (-i)
        res = est.fit(design, y, lam)           # warm-started from beta_
        ap = auprc(X_test_host @ res.beta.cpu().numpy(), y_test_host)
        best_d = max(best_d, ap)
        say(f"  lambda={lam:9.3f} nnz={res.nnz:5d} f={res.f:12.2f} "
            f"iters={res.n_iters:3d} AUPRC={ap:.4f}")

    say("\n-- truncated-gradient baseline (8 simulated machines, rank 0)")
    best_tg = 0.0
    if mesh.rank == 0:
        for lr in (0.1, 0.5):
            snaps = truncated_gradient_fit(
                X, y, lmax / 64, opts=TGOptions(num_machines=8, passes=6, learning_rate=lr),
                generator=torch.Generator(device=dev).manual_seed(1), device=dev)
            for _, b in snaps:
                best_tg = max(best_tg, auprc(X_test_host @ b.cpu().numpy(), y_test_host))
            say(f"  lr={lr}: best-so-far AUPRC={best_tg:.4f}")
        say(f"\nd-GLMNET best {best_d:.4f} vs TG best {best_tg:.4f} -> "
            f"{'d-GLMNET wins' if best_d >= best_tg else 'TG wins'} (paper Figure 1 conclusion)")

    say("\n-- distributed screened path (strong rule + KKT around mesh restricted solves)")
    est = LogisticL1(DGLMNETOptions(tile=64, max_iters=40), mesh=mesh, device=dev)
    t0 = time.perf_counter()
    pts = est.path(design, y, path_len=8)
    dt = time.perf_counter() - t0
    for pt in pts:
        say(f"  lambda={pt.lam:9.3f} nnz={pt.nnz:5d} active={pt.screen['active']:5d}/{p} "
            f"kkt_rounds={pt.screen['kkt_rounds']}")
    say(f"  path wall-clock {dt:.2f}s; collectives per axis (calls, bytes) on rank 0: "
        f"{mesh.stats()}")

    say("\n-- the same path over by-feature slabs (no dense X in the solve), per-lambda "
        "AUPRC\n   through a sharded test design")
    slab_design = ShardedDesign(SlabDesign.from_dense(X, DATA), mesh, tile=64)
    n_test = (ds.X_test.shape[0] // DATA) * DATA
    eval_fn = make_design_eval(SlabDesign.from_dense(ds.X_test[:n_test], DATA),
                               ds.y_test[:n_test], mesh=mesh, tile=64, device=dev)
    t0 = time.perf_counter()
    pts_sp = est.path(slab_design, y, path_len=8, eval_fn=eval_fn)
    dt = time.perf_counter() - t0
    for pt, pt_sp in zip(pts, pts_sp):
        drift = abs(pt_sp.f - pt.f) / max(abs(pt.f), 1e-9)
        say(f"  lambda={pt_sp.lam:9.3f} nnz={pt_sp.nnz:5d} active={pt_sp.screen['active']:5d} "
            f"AUPRC={pt_sp.metrics['auprc']:.4f} |f-f_dense|/|f|={drift:.2e}")
    say(f"  sparse path wall-clock {dt:.2f}s (the screen sums each shard's slab "
        f"correlation over `data`)")


def _cpu_rank(rank: int, store: str, small: bool) -> None:
    torch.set_num_threads(1)
    mesh = init_process_mesh(DATA, MODEL, backend="gloo", init_method=f"file://{store}",
                             world_size=DATA * MODEL, rank=rank, device="cpu")
    try:
        run(mesh, small)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: under torchrun, NCCL, one card per rank) or "
                         "'cpu' (spawns the 8 gloo ranks)")
    ap.add_argument("--small", action="store_true", help="a 4096 x 256 problem")
    ap.add_argument("--deadline", type=float, default=1800.0,
                    help="seconds the spawned CPU ranks may take")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=_cpu_rank, args=(r, os.path.join(tmp, "store"),
                                                          args.small))
                     for r in range(DATA * MODEL)]
            for proc in procs:
                proc.start()
            end = time.monotonic() + args.deadline
            for proc in procs:
                proc.join(timeout=max(end - time.monotonic(), 0.1))
            late = [proc.pid for proc in procs if proc.is_alive()]
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            if late or any(proc.exitcode for proc in procs):
                print(f"ranks failed or passed the deadline: exit codes "
                      f"{[proc.exitcode for proc in procs]}", file=sys.stderr)
                return 1
        return 0
    mesh = make_production_mesh(data=DATA, model=MODEL)
    try:
        run(mesh, args.small)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
