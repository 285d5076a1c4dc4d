# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Training launcher (counterpart of ``repro/launch/train.py``), on one
card:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 100 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 4 --batch 2 --seq 64 --device cpu --ckpt /tmp/ckpt

Weights are drawn from a ``torch.Generator`` seeded with 0; the corpus
(1,000,000 Zipf tokens) and the batches from a numpy generator seeded
with 0, as the reference's; the schedule is ``warmup_cosine(lr,
max(steps // 10, 1), steps)``. The loss is read back at the reference's
intervals (every ``steps // 10`` steps and the last), the run's only host
reads. ``--ckpt`` writes the final state in the reference's layout
(``api.convert.reference_tree``), which ``repro.checkpoint.load_pytree``
reads. Sharded training (the reference's ``--mesh``) is not ported yet
(ROADMAP queue 1 item 5.10).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.convert import reference_tree
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import MODEL_CONFIGS
from repro_torch.data.lm_data import batches, zipf_corpus
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.optim import warmup_cosine
from repro_torch.train import make_train_state, make_train_step


def main(argv: Optional[list] = None):
    """Runs the launcher; returns the final train state."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(MODEL_CONFIGS))
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke() variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = MODEL_CONFIGS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} device={where}")

    state = make_train_state(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    sched = warmup_cosine(args.lr, max(args.steps // 10, 1), args.steps)
    rng = np.random.default_rng(0)
    corpus = zipf_corpus(rng, cfg.vocab_size, 1_000_000)
    it = batches(corpus, args.batch, args.seq, cfg=cfg, rng=rng, device=dev)
    step_fn = make_train_step(cfg, lr_schedule=sched)

    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step_fn(state, next(it))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            # allow[torch-host-sync]: the launcher's loss print, at the reference's intervals
            loss = float(metrics["loss"])
            # allow[torch-bench-timing]: the float() of the loss just above waits for the step
            print(f"step {i:5d} loss={loss:.4f} ({(time.time() - t0) / (i + 1):.2f}s/step)")
    if args.ckpt:
        save_pytree(reference_tree(state), args.ckpt, step=args.steps)
        print(f"checkpoint -> {args.ckpt}")
    return state


if __name__ == "__main__":
    main()
