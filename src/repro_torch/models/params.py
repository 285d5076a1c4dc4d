# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Model API and parameter counting (counterpart of
``repro/models/params.py``), for the decoder-only LMs the port runs
(dense with or without QKV bias, MLA, MoE with its MTP head, Mamba2
SSD); encoder-decoder models are not ported yet.

Counts come from the port's own shapes: the model is built on the meta
device, which allocates nothing.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.transformer import LM, init_lm_cache, init_lm_params, lm_forward


def is_encdec(cfg: ModelConfig) -> bool:
    return cfg.encdec.enabled


def _check_decoder_only(cfg: ModelConfig):
    if is_encdec(cfg):
        raise NotImplementedError("encoder-decoder models are not ported yet")


def init_params(gen, cfg: ModelConfig, *, device=DEFAULT_DEVICE) -> LM:
    """The model's weights on ``device``, drawn from the torch.Generator
    ``gen`` (which must live on that device)."""
    _check_decoder_only(cfg)
    return init_lm_params(gen, cfg, device=resolve_device(device))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, *,
               device=DEFAULT_DEVICE):
    _check_decoder_only(cfg)
    return init_lm_cache(cfg, batch, cache_len, dtype, device=resolve_device(device))


def forward(params: LM, inputs, cfg: ModelConfig, **kw):
    _check_decoder_only(cfg)
    return lm_forward(params, inputs, cfg, **kw)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count of the port's model, built on the meta device.
    ``active_only`` weights the routed expert stacks by top_k / num_experts
    (not the shared expert), as the reference does for 6 N_active D model
    FLOPs: each of its stacked (L, ...) leaves is weighted and truncated to
    an integer, so the port sums a segment's layers per leaf first (the
    MTP head's layer is a leaf of its own, as the reference's one-layer
    stack is). The port counts in Python integers; the reference's int32
    ``jnp.prod`` wraps on a leaf of 2^31 elements or more (the stacked
    expert leaves of llama4 and deepseek-v3), so its number then differs
    from the port's by a multiple of 2^32."""
    _check_decoder_only(cfg)
    frac = cfg.moe.top_k / cfg.moe.num_experts if (cfg.moe.enabled and active_only) else 1.0
    leaves: dict = {}
    for name, p in LM(cfg, None, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "segments":
            parts = parts[:2] + parts[3:]          # layer j of segment i -> segment i's leaf
        key = ".".join(parts)
        leaves[key] = leaves.get(key, 0) + p.numel()
    total = 0
    for name, size in leaves.items():
        parts = name.split(".")
        is_expert = (parts[-1] in ("w_gate", "w_up", "w_down") and "moe" in parts
                     and "shared" not in parts)
        total += int(size * (frac if is_expert else 1.0))
    return total


def param_bytes(cfg: ModelConfig) -> int:
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return count_params_analytic(cfg) * itemsize
