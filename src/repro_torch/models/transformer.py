# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Causal LM (counterpart of ``repro/models/transformer.py``) for the dense
attention, MoE and Mamba2 SSD architectures.

Layers are grouped into *segments* of consecutive identical kinds, as in
the reference. The reference stacks each segment's parameters on a
leading layer axis and runs ``lax.scan``; the port holds each segment as
an ``nn.ModuleList`` and loops over it. The decode cache keeps the
reference's stacked layout, each leaf with a leading layer axis (K and V
(n_layers, B, L, Hk, Dh); an SSM layer's conv (n_layers, B, W - 1,
conv_dim) and SSD (n_layers, B, H, P, N) states), and each layer writes
its slice in place (an MLA layer's latent (n_layers, B, L, kv_lora) and
rope key (n_layers, B, L, rope_dim)). The layers' auxiliary outputs (the
MoE losses) are summed over layers, as the reference sums them.
DeepSeek-V3's multi-token prediction head (``mtp``: a (2d, d) projection
of the final hidden state beside the next token's embedding, then one
more layer of the last kind) runs in ``"train"`` mode only and adds
``aux["mtp_logits"]``, as in the reference. Frontends, the hybrid
blocks, the long-context modes, LayerNorm, the GELU MLP and float16 are
not ported yet: a config that selects one raises when the model is
built.

Remat: in ``"train"`` mode with ``cfg.remat`` set, while autograd records
and a weight requires grad, each layer runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the reference
wraps each layer in ``jax.checkpoint``: backward keeps each layer's input
and recomputes the rest. The values are the same; only memory changes.
Weights are built frozen (``requires_grad=False``); ``train.state``
turns them trainable.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


class MTP(nn.Module):
    """The multi-token prediction head: ``proj`` (2 d_model, d_model) and
    ``layer``, one layer of the config's last kind."""

    def __init__(self, cfg: ModelConfig, gen, dtype, *, device="cpu"):
        super().__init__()
        self.proj = frozen(dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype, device=device))
        self.layer = init_layer(gen, cfg, cfg.layer_kinds()[-1], dtype, device=device)


class LM(nn.Module):
    """Parameters of a causal LM under the reference's names: ``embed``
    (padded_vocab, d), ``final_norm``, ``lm_head`` (d, padded_vocab) unless
    tied, ``segments[i][j]``, layer j of segment i, and ``mtp`` when the
    config has ``mtp_depth`` (drawn after every other weight, as the
    reference draws it)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], *, device="cpu"):
        super().__init__()
        if cfg.frontend.kind != "none":
            raise NotImplementedError("frontends are not ported yet")
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
        if cfg.mtp_depth:
            self.mtp = MTP(cfg, gen, dtype, device=device)


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
    holds the prompt's K/V (and SSM states) stacked per segment; decode
    writes ``cache`` in place and returns it. The sparse probe
    (``core/probe.py``) reads these states; :func:`lm_forward` adds the
    head."""
    h, new_cache, _ = _hidden(params, inputs, cfg, mode=mode, cache=cache,
                              cache_index=cache_index, use_flash_kernel=use_flash_kernel)
    return h, new_cache


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :].expand(b, s)


def _hidden(params: LM, inputs, cfg: ModelConfig, *, mode, cache, cache_index,
            use_flash_kernel):
    """:func:`lm_hidden`, and the layers' aux outputs summed over layers."""
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
        positions = _positions(b, s, tokens.device)

    window = cfg.attention.sliding_window
    remat = (cfg.remat and mode == "train" and torch.is_grad_enabled()
             and any(p.requires_grad for p in params.parameters()))
    new_seg_caches = []
    aux_total: Dict[str, torch.Tensor] = {}
    for i, (kind, _) in enumerate(segments_of(cfg)):
        seg_cache = cache["segments"][i] if cache is not None else None
        new_layers = []
        for j, layer in enumerate(params.segments[i]):
            c_l = _tree_map(lambda a: a[j], seg_cache) if seg_cache is not None else None
            kw = dict(cfg=cfg, kind=kind, positions=positions, mode=mode, cache=c_l,
                      cache_index=cache_index, window=window, use_flash_kernel=use_flash_kernel)
            if remat:
                # no ported layer draws random numbers: no RNG state to replay;
                # the layer's aux comes out of the checkpoint with its output
                x, new_c, aux = checkpoint(layer_forward, layer, x, use_reentrant=False,
                                           preserve_rng_state=False, **kw)
            else:
                x, new_c, aux = layer_forward(layer, x, **kw)
            new_layers.append(new_c)
            for k, v in aux.items():
                aux_total[k] = aux_total[k] + v if k in aux_total else v
        if mode == "prefill":
            new_seg_caches.append(_tree_stack(new_layers))
        elif mode == "decode":
            new_seg_caches.append(seg_cache)

    h = apply_norm(params.final_norm, x, eps=cfg.norm_eps)
    new_cache = {"segments": new_seg_caches} if mode in ("prefill", "decode") else None
    return h, new_cache, aux_total


def lm_head(params: LM, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, S, padded_vocab) from the final-norm hidden states."""
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h @ head.to(h.dtype)


def mtp_logits(params: LM, tokens, h, cfg: ModelConfig):
    """The MTP head's logits (B, S, padded_vocab), predicting token t + 2:
    the final-norm hidden states ``h`` beside the embedding of the next
    token (the last row's wraps round, as the reference's ``jnp.roll``),
    through ``mtp.proj`` and ``mtp.layer`` in train mode (its aux
    dropped, no window, no flash kernel), then the LM head, unnormed."""
    b, s = tokens.shape
    emb_next = nn.functional.embedding(torch.roll(tokens, -1, dims=1), params.embed)
    x = torch.cat([h, emb_next.to(h.dtype)], dim=-1) @ params.mtp.proj.to(h.dtype)
    x, _, _ = layer_forward(params.mtp.layer, x, cfg=cfg, kind=cfg.layer_kinds()[-1],
                            positions=_positions(b, s, tokens.device), mode="train")
    return lm_head(params, x, cfg)


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
    aux): :func:`lm_hidden` then :func:`lm_head`; aux holds the MoE
    layers' losses summed over layers (empty for a model without MoE) and,
    in ``"train"`` mode with S > 1 and ``cfg.mtp_depth``, the MTP head's
    ``"mtp_logits"`` (:func:`mtp_logits`)."""
    h, new_cache, aux = _hidden(params, inputs, cfg, mode=mode, cache=cache,
                                cache_index=cache_index, use_flash_kernel=use_flash_kernel)
    logits = lm_head(params, h, cfg)
    tokens = inputs["tokens"]
    if cfg.mtp_depth and mode == "train" and tokens.shape[1] > 1:
        aux["mtp_logits"] = mtp_logits(params, tokens, h, cfg)
    return logits, new_cache, aux
