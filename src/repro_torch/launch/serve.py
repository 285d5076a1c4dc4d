# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Serving launcher (counterpart of ``repro/launch/serve.py`` and
``examples/serve_lm.py``): batched prefill, then greedy decode against the
cache, on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 8 --prompt-len 2048 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --batch 2 --prompt-len 128 --tokens 8 --device cpu

``--arch`` takes every registered LM: tinyllama-1.1b, qwen2.5-3b,
qwen1.5-4b and internlm2-1.8b (dense; the two qwen with QKV bias),
llama4-scout-17b-a16e (MoE), deepseek-v3-671b (MLA and MoE; its 61
layers are about 1.37 TB of bf16 weights, so one card serves it only
with ``--smoke``, and ``chip_smoke.py`` phase 18 a depth cut) and
mamba2-2.7b (SSD). Prefill runs each attention layer whose shape
qualifies through the flash-attention kernel (``use_flash_kernel=True``;
the prompt length must be a multiple of 128; MLA, whose q and v heads
differ in width, and a model with no attention layer never reach it),
its cache is spliced into a full-length cache (K/V, or MLA's latent and
rope key, at the front; SSM states whole), and each decode step writes
one slot (or the SSM states) in place. The loop reads nothing back per
token: the argmax stays on the device, ``cache_index`` is a Python int,
and the generated tokens are fetched once at the end. Weights and
prompts are drawn from one ``torch.Generator`` seeded with 0. Sharded
serving (the reference's ``--mesh``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import MODEL_CONFIGS
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import init_cache, init_params
from repro_torch.train import make_prefill_step, make_serve_step


def _splice(full, prefill_cache):
    """Copy the prefill cache into the full-length cache, in place, leaf by
    leaf as the reference splices: a leaf of the same shape (an SSM
    layer's conv and SSD states) is copied whole; otherwise the prefill
    leaf is written at the front of its first differing axis (the
    sequence axis 2 of the stacked (L, B, S, Hk, Dh) K and V, and of an
    MLA segment's (L, B, S, kv_lora) latent and (L, B, S, rope_dim) rope
    key). Returns ``full``."""
    def per_leaf(f, p):
        if isinstance(f, dict):
            for k in f:
                per_leaf(f[k], p[k])
            return
        if f.shape == p.shape:
            f.copy_(p)
            return
        axis = next(i for i, (a, b) in enumerate(zip(f.shape, p.shape)) if a != b)
        f.narrow(axis, 0, p.shape[axis]).copy_(p)

    for seg, pre in zip(full["segments"], prefill_cache["segments"]):
        per_leaf(seg, pre)
    return full


def prefill(params, cfg: ModelConfig, prompts, cache_len: int):
    """Prefill ``prompts`` (B, P) int32 through the flash kernel and splice
    its K/V into a fresh cache of ``cache_len`` slots. Returns (logits
    (B, P, padded_vocab), cache)."""
    logits, pre = make_prefill_step(cfg, use_flash_kernel=True)(params, {"tokens": prompts})
    cache = init_cache(cfg, prompts.shape[0], cache_len, device=prompts.device)
    return logits, _splice(cache, pre)


def greedy(logits):
    """The next token of each row, (B, 1) int32, left on the device."""
    return logits[:, -1, :].argmax(-1).to(torch.int32)[:, None]


def decode(params, cfg: ModelConfig, cache, start: int, tok, steps: int):
    """``steps`` greedy decode steps after ``tok`` (B, 1), writing cache
    slots ``start``, ``start + 1``, ... in place. Returns the list of each
    step's (B, 1) token, on the device."""
    serve = make_serve_step(cfg)
    outs = []
    for i in range(steps):
        _, nxt, cache = serve(params, cache, start + i, tok)
        tok = nxt[:, None]
        outs.append(tok)
    return outs


def generate(params, cfg: ModelConfig, prompts, *, tokens: int):
    """Greedy generation of ``tokens`` tokens after ``prompts`` (B, P) int32
    on the model's device. Returns (generated (B, tokens) int32 on the
    host, stats): the generated tokens are the run's one host read. stats
    holds ``prefill_ms`` (prefill, splice and the first token),
    ``decode_ms_per_token`` (CUDA events on a card, read after that fetch;
    the host clock on the CPU) and ``wall_s``."""
    plen = prompts.shape[1]
    events = None
    if prompts.is_cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
    t0 = time.perf_counter()
    logits, cache = prefill(params, cfg, prompts, plen + tokens)
    tok = greedy(logits)
    del logits
    if events:
        events[1].record()
    t1 = time.perf_counter()
    outs = [tok] + decode(params, cfg, cache, plen, tok, tokens - 1)
    if events:
        events[2].record()
    # allow[torch-host-sync]: the LM generation's one host read, which its launcher counts and chip_smoke.py checks
    gen = torch.cat(outs, dim=1).cpu()
    # allow[torch-bench-timing]: the .cpu() of the generated tokens just before the second read waits for the decode
    t2 = time.perf_counter()
    steps = max(tokens - 1, 1)
    if events:
        stats = {"prefill_ms": events[0].elapsed_time(events[1]),
                 "decode_ms_per_token": events[1].elapsed_time(events[2]) / steps}
    else:
        stats = {"prefill_ms": (t1 - t0) * 1e3, "decode_ms_per_token": (t2 - t1) * 1e3 / steps}
    stats["wall_s"] = t2 - t0
    return gen, stats


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(MODEL_CONFIGS))
    ap.add_argument("--smoke", action="store_true", help="the reduced smoke() variant")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    cfg = MODEL_CONFIGS[args.arch]
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(gen, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                            device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out, stats = generate(params, cfg, prompts, tokens=args.tokens)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = (f", peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
            if dev.type == "cuda" else "")
    print(f"arch={cfg.name} on {where}: generated {tuple(out.shape)}; prefill "
          f"{stats['prefill_ms']:.1f} ms, decode {stats['decode_ms_per_token']:.2f} ms/token "
          f"({args.batch * 1e3 / stats['decode_ms_per_token']:.0f} tokens/s){peak}")
    # allow[torch-host-sync]: prints tokens already on the host
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
