# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Per-layer blocks (counterpart of ``repro/models/blocks.py``). Kinds:

- ``"attn"``: pre-norm attention plus a dense SwiGLU MLP;
- ``"moe"``: pre-norm attention plus the MoE FFN (and its shared expert);
- ``"ssm"``: the Mamba2 block (norm, SSD, residual).

The attention of both attention kinds is GQA (with QKV bias where the
config has it) or MLA (``cfg.attention.use_mla``), with the matching
decode cache. The hybrid kinds (zamba2's shared attention block) raise
"not ported yet"."""
from __future__ import annotations

from typing import Optional

from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_forward, init_attention, init_kv_cache
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.ssm import init_mamba2, init_ssm_cache, mamba2_forward

KINDS = ("attn", "moe", "ssm")


def _check_kind(kind: str):
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")


class Layer(nn.Module):
    """One layer: ``ln1``, ``attn``, ``ln2`` and ``mlp`` (kind ``"attn"``)
    or ``moe`` (kind ``"moe"``); ``ln`` and ``mamba`` (kind ``"ssm"``)."""

    def __init__(self, gen, cfg: ModelConfig, kind: str, dtype, *, device="cpu"):
        super().__init__()
        _check_kind(kind)
        d = cfg.d_model
        if kind == "ssm":
            self.ln = init_norm(d, dtype, device=device)
            self.mamba = init_mamba2(gen, cfg.ssm, d, dtype, device=device)
            return
        self.ln1 = init_norm(d, dtype, device=device)
        self.attn = init_attention(gen, cfg.attention, d, dtype, device=device)
        self.ln2 = init_norm(d, dtype, device=device)
        if kind == "attn":
            self.mlp = init_mlp(gen, d, cfg.d_ff, dtype, device=device)
        else:
            self.moe = init_moe(gen, cfg.moe, d, dtype, device=device)


def init_layer(gen, cfg: ModelConfig, kind: str, dtype, *, device="cpu") -> Layer:
    return Layer(gen, cfg, kind, dtype, device=device)


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int, dtype,
                     *, device="cpu"):
    """Decode-time cache for one layer of the given kind: ``{"kv": ...}``
    for the attention kinds, ``{"ssm": {"conv", "ssd"}}`` for ``"ssm"``."""
    _check_kind(kind)
    if kind == "ssm":
        return {"ssm": init_ssm_cache(cfg.ssm, cfg.d_model, batch, dtype, device=device)}
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
    """Returns (x, new_cache or None, aux): aux holds the MoE layer's
    auxiliary losses, and is empty for the other kinds."""
    _check_kind(kind)
    if kind == "ssm":
        h = apply_norm(p.ln, x, eps=cfg.norm_eps)
        y, new_ssm = mamba2_forward(p.mamba, h, cfg=cfg.ssm, d_model=cfg.d_model, mode=mode,
                                    cache=(cache.get("ssm") if cache else None))
        return x + y, ({"ssm": new_ssm} if new_ssm is not None else None), {}
    kv = cache.get("kv") if cache else None
    x, new_kv = _attn_sub(p, x, cfg, positions, mode, kv, cache_index, window,
                          use_flash_kernel)
    h = apply_norm(p.ln2, x, eps=cfg.norm_eps)
    aux = {}
    if kind == "attn":
        x = x + apply_mlp(p.mlp, h)
    else:
        y, aux = moe_forward(p.moe, h, cfg=cfg.moe)
        x = x + y
    return x, ({"kv": new_kv} if new_kv is not None else None), aux
