# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Model API and parameter counting (counterpart of
``repro/models/params.py``), for the decoder-only LMs the port runs;
encoder-decoder models are not ported yet.

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


def count_params_analytic(cfg: ModelConfig) -> int:
    """Exact parameter count of the port's model, built on the meta device."""
    _check_decoder_only(cfg)
    return sum(p.numel() for p in LM(cfg, None, device="meta").parameters())


def param_bytes(cfg: ModelConfig) -> int:
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return count_params_analytic(cfg) * itemsize
