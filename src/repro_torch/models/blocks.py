# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Per-layer blocks (counterpart of ``repro/models/blocks.py``), kind
``"attn"`` only: pre-norm attention plus a dense SwiGLU MLP. The other
kinds (moe, ssm, hybrid) raise "not ported yet"."""
from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_forward, init_attention, init_kv_cache
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def _not_ported(kind: str):
    return NotImplementedError(f"layer kind {kind!r} is not ported yet")


class Layer(nn.Module):
    """One ``"attn"`` layer: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, gen, cfg: ModelConfig, kind: str, dtype, *, device="cpu"):
        super().__init__()
        if kind != "attn":
            raise _not_ported(kind)
        d = cfg.d_model
        self.ln1 = init_norm(d, dtype, device=device)
        self.attn = init_attention(gen, cfg.attention, d, dtype, device=device)
        self.ln2 = init_norm(d, dtype, device=device)
        self.mlp = init_mlp(gen, d, cfg.d_ff, dtype, device=device)


def init_layer(gen, cfg: ModelConfig, kind: str, dtype, *, device="cpu") -> Layer:
    return Layer(gen, cfg, kind, dtype, device=device)


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int, dtype,
                     *, device="cpu"):
    """Decode-time cache for one layer of the given kind."""
    if kind != "attn":
        raise _not_ported(kind)
    return {"kv": init_kv_cache(cfg.attention, cfg.d_model, batch, cache_len, dtype,
                                device=device)}


def _attn_sub(p, x, cfg, positions, mode, cache, cache_index, window, use_flash_kernel):
    h = apply_norm(p.ln1, x, eps=cfg.norm_eps)
    y, new_kv = attention_forward(
        p.attn, h, cfg=cfg.attention, d_model=cfg.d_model, positions=positions,
        mode=mode, cache=cache, cache_index=cache_index, window=window,
        use_flash_kernel=use_flash_kernel,
    )
    return x + y, new_kv


def layer_forward(p, x, *, cfg: ModelConfig, kind: str, positions, mode: str = "train",
                  cache: Optional[dict] = None, cache_index=None, window: int = 0,
                  use_flash_kernel: bool = False):
    """Returns (x, new_cache or None, aux)."""
    if kind != "attn":
        raise _not_ported(kind)
    kv = cache.get("kv") if cache else None
    x, new_kv = _attn_sub(p, x, cfg, positions, mode, kv, cache_index, window,
                          use_flash_kernel)
    h = apply_norm(p.ln2, x, eps=cfg.norm_eps)
    x = x + apply_mlp(p.mlp, h)
    return x, ({"kv": new_kv} if new_kv is not None else None), {}
