#!/usr/bin/env python3
"""How far the bf16 serving paths' logits drift from a float32 run of the
same weights, on the card: the flash kernel's prefill and the plain chunked
path's, each against the other and against float32.

    python3 scripts/lm_logit_drift.py [--arch ID[:LAYERS] ...]

For each architecture (default: tinyllama-1.1b, internlm2-1.8b,
qwen2.5-3b, qwen1.5-4b; ``ID:LAYERS`` keeps the first LAYERS layers) the
bf16 weights and 8 prompts of 2048 tokens are drawn on the card from seed
0 as ``chip_smoke.py``'s serving cells draw them. Three prefills give the
last position's logits: through the flash kernel (bf16), through the
plain chunked attention (bf16), and through the plain path with the same
weights cast to float32 and float32 activations (TF32 off). Prints one
JSON line per architecture: the plain bf16 logits' std, each pair's
largest absolute difference (with the float32 logit at that element) and
mean absolute difference, each also as a fraction of the std, and the
next-token argmax agreement of each bf16 path with float32. Where the
kernel's path lies as far from float32 as the plain path does, the
kernel-vs-plain difference is the bf16 arithmetic's own drift through
the layers, not a fault of the kernel.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "internlm2-1.8b", "qwen2.5-3b", "qwen1.5-4b")


def compare(a, b, std: float, ref) -> dict:
    """Largest and mean |a - b| (float32), each also over ``std``, with
    ``ref``'s value at the largest difference."""
    d = (a.float() - b.float()).abs()
    i = int(d.argmax())
    mx, mean = float(d.flatten()[i]), float(d.mean())
    return {"max": mx, "max_over_std": mx / std, "at_f32_logit": float(ref.flatten()[i]),
            "mean": mean, "mean_over_std": mean / std}


def drift(torch, arch: str) -> dict:
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init_params
    from repro_torch.train import make_prefill_step

    name, _, layers = arch.partition(":")
    cfg = MODEL_CONFIGS[name]
    if layers:
        cfg = replace(cfg, num_layers=int(layers))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (8, 2048), generator=gen, device="cuda",
                            dtype=torch.int32)
    with torch.no_grad():
        ops.reset_launch_counts()
        logits, _, _ = forward(params, {"tokens": prompts}, cfg, mode="prefill",
                               use_flash_kernel=True)
        launches = ops.launch_counts()["flash_attention"]
        last_k = logits[:, -1].float()
        del logits
        logits, _ = make_prefill_step(cfg, use_flash_kernel=False)(params, {"tokens": prompts})
        last_p = logits[:, -1].float()
        del logits
        cfg32 = replace(cfg, param_dtype="float32", compute_dtype="float32")
        params32 = init_params(None, cfg32, device="cuda")
        params32.load_state_dict(params.state_dict())
        del params
        logits, _ = make_prefill_step(cfg32, use_flash_kernel=False)(params32,
                                                                     {"tokens": prompts})
        last_f = logits[:, -1].float()
        del logits, params32
    torch.cuda.empty_cache()
    std = float(last_p.std())
    top = last_f.argmax(-1)
    return {"arch": arch, "layers": cfg.num_layers, "flash_launches": launches,
            "plain_std": std, "f32_max_abs_logit": float(last_f.abs().max()),
            "kernel_vs_plain": compare(last_k, last_p, std, last_f),
            "kernel_vs_f32": compare(last_k, last_f, std, last_f),
            "plain_vs_f32": compare(last_p, last_f, std, last_f),
            "argmax_agree_f32": {"kernel": float((last_k.argmax(-1) == top).float().mean()),
                                 "plain": float((last_p.argmax(-1) == top).float().mean())}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in args.arch:
        print(json.dumps(drift(torch, arch)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
