# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Prefill and decode steps (counterpart of ``repro/train/train_step.py``
``make_prefill_step`` / ``make_serve_step``). The training step and its
optimizers are not ported yet."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import forward


def make_prefill_step(cfg: ModelConfig, *, use_flash_kernel: bool = False):
    """prefill(params, batch) -> (last-position logits (B, 1, V), cache).
    ``use_flash_kernel`` sends each layer's full-sequence attention through
    the flash-attention kernel where the shape qualifies."""

    @torch.no_grad()
    def prefill(params, batch):
        logits, cache, _ = forward(params, batch, cfg, mode="prefill",
                                   use_flash_kernel=use_flash_kernel)
        return logits[:, -1:, :], cache

    return prefill


def make_serve_step(cfg: ModelConfig):
    """ONE new token against a cache of cache_len entries:
    serve(params, cache, cache_index, tokens (B, 1)) -> (logits, next
    token (B,) int32 on the device, cache written in place)."""

    @torch.no_grad()
    def serve(params, cache, cache_index: int, tokens):
        logits, new_cache, _ = forward(params, {"tokens": tokens}, cfg, mode="decode",
                                       cache=cache, cache_index=cache_index)
        next_tok = logits[:, -1, :].argmax(-1).to(torch.int32)
        return logits, next_tok, new_cache

    return serve
