#!/usr/bin/env python3
"""Digests of tinyllama-1.1b's serving and training outputs on the card, to
hold two trees of the port bit for bit against each other.

    python3 scripts/lm_digests.py [--src DIR]

runs the ``repro_torch`` under ``DIR`` (default: this checkout's ``src``)
on one CUDA card: tinyllama-1.1b at full width, weights and 8 prompts of
2048 tokens drawn on the card from seed 0 (as ``chip_smoke.py`` phase 11
draws them); the prefill's last logits through the flash kernel, the
first decode step's logits, 32 greedy tokens through
``launch.serve.generate``; then two AdamW training steps of 8 x 2048
tokens from seed 0 (as phase 12b: the Zipf corpus, ``warmup_cosine(3e-4,
1, 9)``). Prints one line of digests (the first 16 hex digits of the
SHA-256 of each output's float32 bytes). The first step's loss is a
forward pass; its grad norm and everything after it pass through the
backward, whose sums are not bit-reproducible on the card, so those
digests can differ between two runs of one tree. Run two trees in turns
in one card call (parent, change, change, parent) and compare.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def digest(torch, *values) -> str:
    h = hashlib.sha256()
    for v in values:
        h.update(v.detach().cpu().to(torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.data.lm_data import batches, zipf_corpus
    from repro_torch.launch.serve import generate, greedy, prefill
    from repro_torch.models import init_params
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import make_serve_step, make_train_state, make_train_step

    cfg = MODEL_CONFIGS["tinyllama-1.1b"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (8, 2048), generator=gen, device="cuda",
                            dtype=torch.int32)
    out = {}
    logits, cache = prefill(params, cfg, prompts, 2048 + 32)
    tok = greedy(logits)
    out["prefill"] = digest(torch, logits[:, -1])
    del logits
    step_logits, _, _ = make_serve_step(cfg)(params, cache, 2048, tok)
    out["decode"] = digest(torch, step_logits)
    del cache, step_logits
    tokens, _ = generate(params, cfg, prompts, tokens=32)
    out["tokens"] = digest(torch, tokens)
    del params

    state = make_train_state(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    step_fn = make_train_step(cfg, lr_schedule=warmup_cosine(3e-4, 1, 9))
    corpus = zipf_corpus(np.random.default_rng(0), cfg.vocab_size, 1_000_000)
    it = batches(corpus, 8, 2048, cfg=cfg, rng=np.random.default_rng(0), device="cuda")
    state, m1 = step_fn(state, next(it))
    out["train_step1_loss"] = digest(torch, m1["loss"])
    out["train_step1_grad_norm"] = digest(torch, m1["grad_norm"])
    state, m2 = step_fn(state, next(it))
    out["train_step2_loss"] = digest(torch, m2["loss"])
    out["train_weights"] = digest(torch, state["params"].embed, state["params"].lm_head)
    out["loss"] = [float(m1["loss"]), float(m2["loss"])]
    print(json.dumps({"src": str(args.src), "digests": out,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
