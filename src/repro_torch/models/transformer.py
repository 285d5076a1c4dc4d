# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Causal LM (counterpart of ``repro/models/transformer.py``) for the dense
attention architectures.

Layers are grouped into *segments* of consecutive identical kinds, as in
the reference. The reference stacks each segment's parameters on a
leading layer axis and runs ``lax.scan``; the port holds each segment as
an ``nn.ModuleList`` and loops over it. The decode cache keeps the
reference's stacked layout, one (n_layers, B, L, Hk, Dh) tensor per
segment for K and for V, and each layer writes its slice in place.
Frontends, multi-token prediction, the long-context modes, LayerNorm,
the GELU MLP, QKV bias and float16 are not ported yet: a config that
selects one raises when the model is built.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import init_layer, init_layer_cache, layer_forward
from repro_torch.models.layers import apply_norm, dense_init, embed_init, frozen, init_norm


def dtype_of(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def segments_of(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Group layer kinds into (kind, run-length) segments."""
    segs: List[Tuple[str, int]] = []
    for k in cfg.layer_kinds():
        if segs and segs[-1][0] == k:
            segs[-1] = (k, segs[-1][1] + 1)
        else:
            segs.append((k, 1))
    return segs


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class LM(nn.Module):
    """Parameters of a causal LM under the reference's names: ``embed``
    (padded_vocab, d), ``final_norm``, ``lm_head`` (d, padded_vocab) unless
    tied, and ``segments[i][j]``, layer j of segment i."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], *, device="cpu"):
        super().__init__()
        if cfg.frontend.kind != "none" or cfg.mtp_depth:
            raise NotImplementedError("frontends and multi-token prediction are not ported yet")
        if cfg.norm != "rmsnorm" or cfg.act != "silu":
            raise NotImplementedError(f"norm {cfg.norm!r} with activation {cfg.act!r} is not "
                                      f"ported yet (only rmsnorm with silu)")
        dtype = dtype_of(cfg.param_dtype)
        self.embed = frozen(embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device=device))
        self.final_norm = init_norm(cfg.d_model, dtype, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = frozen(dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype,
                                             device=device))
        self.segments = nn.ModuleList(
            nn.ModuleList(init_layer(gen, cfg, kind, dtype, device=device) for _ in range(n))
            for kind, n in segments_of(cfg))


def init_lm_params(gen: Optional[torch.Generator], cfg: ModelConfig, *, device="cpu") -> LM:
    """Weights drawn from ``gen`` (a generator on ``device``) in a fixed
    order; ``gen=None`` allocates without drawing."""
    return LM(cfg, gen, device=device)


def init_lm_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None, *, device="cpu"):
    dtype = dtype or dtype_of(cfg.compute_dtype)

    def seg_cache(kind, n):
        one = init_layer_cache(cfg, kind, batch, cache_len, dtype, device=device)
        return _tree_map(lambda x: x.new_zeros((n,) + tuple(x.shape)), one)

    return {"segments": [seg_cache(k, n) for k, n in segments_of(cfg)]}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def lm_hidden(
    params: LM,
    inputs: Dict[str, Any],
    cfg: ModelConfig,
    *,
    mode: str = "train",                  # train | prefill | decode
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,    # tokens already cached
    use_flash_kernel: bool = False,
):
    """The layers and the final norm: returns (final-norm hidden states
    (B, S, d_model) in the compute type, new_cache). Prefill's new cache
    holds the prompt's K/V stacked per segment; decode writes ``cache`` in
    place and returns it. The sparse probe (``core/probe.py``) reads these
    states; :func:`lm_forward` adds the head."""
    if any(inputs.get(k) is not None for k in ("patch_embeds", "frame_embeds")):
        raise NotImplementedError("frontend embeddings are not ported yet")
    cdtype = dtype_of(cfg.compute_dtype)
    tokens = inputs["tokens"]
    b, s = tokens.shape
    x = nn.functional.embedding(tokens, params.embed).to(cdtype)

    if mode == "decode":
        if cache_index is None:
            raise ValueError("decode needs a cache_index")
        positions = torch.full((b, s), cache_index, dtype=torch.int32, device=tokens.device)
    else:
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :].expand(b, s)

    window = cfg.attention.sliding_window
    new_seg_caches = []
    for i, (kind, _) in enumerate(segments_of(cfg)):
        seg_cache = cache["segments"][i] if cache is not None else None
        new_layers = []
        for j, layer in enumerate(params.segments[i]):
            c_l = _tree_map(lambda a: a[j], seg_cache) if seg_cache is not None else None
            x, new_c, _ = layer_forward(layer, x, cfg=cfg, kind=kind, positions=positions,
                                        mode=mode, cache=c_l, cache_index=cache_index,
                                        window=window, use_flash_kernel=use_flash_kernel)
            new_layers.append(new_c)
        if mode == "prefill":
            new_seg_caches.append(_tree_stack(new_layers))
        elif mode == "decode":
            new_seg_caches.append(seg_cache)

    h = apply_norm(params.final_norm, x, eps=cfg.norm_eps)
    new_cache = {"segments": new_seg_caches} if mode in ("prefill", "decode") else None
    return h, new_cache


def lm_head(params: LM, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, padded_vocab) from the final-norm hidden states."""
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h @ head.to(h.dtype)


def lm_forward(
    params: LM,
    inputs: Dict[str, Any],
    cfg: ModelConfig,
    *,
    mode: str = "train",                  # train | prefill | decode
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,    # tokens already cached
    use_flash_kernel: bool = False,
):
    """Returns (logits (B, S, padded_vocab) in the compute type, new_cache,
    aux): :func:`lm_hidden` then :func:`lm_head`."""
    h, new_cache = lm_hidden(params, inputs, cfg, mode=mode, cache=cache,
                             cache_index=cache_index, use_flash_kernel=use_flash_kernel)
    return lm_head(params, h, cfg), new_cache, {}
