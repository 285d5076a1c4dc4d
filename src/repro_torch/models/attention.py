# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Attention (counterpart of ``repro/models/attention.py``), the GQA path:
RoPE, sliding window, and the KV cache for prefill and decode. MLA, QKV
bias, cross-attention and the sequence-sharded flash-decode are not
ported yet.

Full-sequence attention never builds an (S, S) score tensor for the whole
sequence: queries go in chunks of ``Q_CHUNK`` and the masks are made per
chunk from position vectors, as in the reference. GQA is computed grouped
(query head h against KV head h // (H / Hk)): the same products as the
reference's ``jnp.repeat`` of K/V to H heads, without the H/Hk-fold copy.

``use_flash_kernel`` is the reference's switch: plain causal or full
self-attention whose shape qualifies goes to ``kernels.ops.flash_attention``
(the hand-written kernel on the card, its plain version on the CPU). It
defaults to False, as in the reference. The kernel is forward-only, so
training keeps it off; its wrapper raises on an operand that requires
grad.

While autograd records, each query chunk of the chunked path runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the reference
wraps its chunk body in ``jax.checkpoint``: backward recomputes a chunk's
(C, Sk) scores instead of keeping every chunk's.

Modes: ``"train"``/``"prefill"`` attend over the whole sequence (prefill
also returns its K/V); ``"decode"`` writes the new token's K/V into the
cache at ``cache_index`` (a Python int) and attends over the written
slots. The port writes the cache in place, where the reference returns an
updated copy.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, frozen, matmul

NEG_INF = -1e30
Q_CHUNK = 1024          # query-chunk length for full-sequence attention


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projection weights ``wq``, ``wk``, ``wv``, ``wo`` (d_in, d_out)."""

    def __init__(self, gen, cfg: AttentionConfig, d_model: int, dtype, *, device="cpu"):
        super().__init__()
        if cfg.use_mla or cfg.qkv_bias:
            raise NotImplementedError("MLA attention and QKV bias are not ported yet")
        dh = cfg.resolved_head_dim(d_model)
        h, hk = cfg.num_heads, cfg.num_kv_heads
        self.wq = frozen(dense_init(gen, d_model, h * dh, dtype, device=device))
        self.wk = frozen(dense_init(gen, d_model, hk * dh, dtype, device=device))
        self.wv = frozen(dense_init(gen, d_model, hk * dh, dtype, device=device))
        self.wo = frozen(dense_init(gen, h * dh, d_model, dtype, device=device))


def init_attention(gen, cfg: AttentionConfig, d_model: int, dtype, *, device="cpu"):
    return Attention(gen, cfg, d_model, dtype, device=device)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: AttentionConfig, d_model: int, batch: int, cache_len: int, dtype,
                  *, device="cpu"):
    if cfg.use_mla:
        raise NotImplementedError("the MLA latent cache is not ported yet")
    dh = cfg.resolved_head_dim(d_model)
    shape = (batch, cache_len, cfg.num_kv_heads, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(buf, new, index: int):
    """Write (B, s, ...) new entries at position ``index`` along axis 1,
    in place; returns ``buf``."""
    buf[:, index:index + new.shape[1]] = new.to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# chunked scaled-dot-product attention (no (S, S) materialisation)
# ---------------------------------------------------------------------------


def _mask_chunk(q_pos, k_pos, *, causal, window, kv_limit):
    """(B, C, Sk) boolean mask for one query chunk."""
    m = torch.ones(q_pos.shape + (k_pos.shape[-1],), dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (q_pos[..., :, None] >= k_pos[..., None, :])
    if window:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    if kv_limit is not None:
        m = m & (k_pos <= kv_limit)[..., None, :]
    return m


def _sdpa_block(q, k, v, mask, *, scale):
    """q (B, C, H, Dh); k/v (B, Sk, Hk, Dh) with H a multiple of Hk; mask
    (B, C, Sk) or None. Scores and softmax in float32, output in v's type."""
    b, c, h, dh = q.shape
    hk = k.shape[2]
    qg = q.to(torch.float32).reshape(b, c, hk, h // hk, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32)) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(torch.float32))
    return out.reshape(b, c, h, v.shape[-1]).to(v.dtype)


def sdpa(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0, kv_limit=None,
         q_chunk: int = Q_CHUNK, use_flash_kernel: bool = False):
    """``use_flash_kernel`` routes plain causal/bidirectional self-attention
    through ``ops.flash_attention`` when the shape qualifies (no window or
    limit, Sq == Sk, S a multiple of 128, Dq == Dv), as the reference
    routes it to its Pallas kernel; the chunked path otherwise."""
    if (use_flash_kernel and window == 0 and kv_limit is None
            and q.shape[1] == k.shape[1] and q.shape[1] % 128 == 0
            and q.shape[-1] == v.shape[-1]):
        return ops.flash_attention(q, k, v, causal=causal)
    return _sdpa_torch(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
                       window=window, kv_limit=kv_limit, q_chunk=q_chunk)


def _sdpa_torch(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                kv_limit=None, q_chunk: int = Q_CHUNK):
    """Full attention with query chunking (the reference's ``_sdpa_jnp``).
    q (B, Sq, H, Dh); k/v (B, Sk, Hk, Dh); q_pos (B, Sq); k_pos (B or 1, Sk)."""
    sq = q.shape[1]
    if sq <= q_chunk or sq % q_chunk != 0:
        mask = _mask_chunk(q_pos, k_pos, causal=causal, window=window, kv_limit=kv_limit)
        return _sdpa_block(q, k, v, mask, scale=scale)

    def body(qi, pi, k, v):
        mask = _mask_chunk(pi, k_pos, causal=causal, window=window, kv_limit=kv_limit)
        return _sdpa_block(qi, k, v, mask, scale=scale)

    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    for lo in range(0, sq, q_chunk):
        args = (q[:, lo:lo + q_chunk], q_pos[:, lo:lo + q_chunk], k, v)
        outs.append(checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)
                    if remat else body(*args))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA forward
# ---------------------------------------------------------------------------


def attention_forward(
    p,
    x,                                   # (B, S, D)
    *,
    cfg: AttentionConfig,
    d_model: int,
    positions,                           # (B, S) int32
    mode: str = "train",                 # train | prefill | decode
    cache: Optional[dict] = None,
    cache_index: Optional[int] = None,   # tokens already cached
    window: int = 0,                     # 0 = full causal
    causal: bool = True,                 # False: bidirectional (encoder)
    use_flash_kernel: bool = False,
):
    """Returns (y (B, S, D), cache): prefill's new {"k", "v"}, decode's
    written cache, None in training."""
    if cfg.use_mla:
        raise NotImplementedError("MLA attention is not ported yet")
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim(d_model)
    h, hk = cfg.num_heads, cfg.num_kv_heads

    q = matmul(x, p.wq).reshape(b, s, h, dh)
    k = matmul(x, p.wk).reshape(b, s, hk, dh)
    v = matmul(x, p.wv).reshape(b, s, hk, dh)
    if cfg.use_mrope:
        raise NotImplementedError("M-RoPE is not ported yet")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    scale = 1.0 / (dh ** 0.5)

    if mode in ("train", "prefill"):
        out = sdpa(q, k, v, positions, positions, scale=scale, causal=causal,
                   window=window, use_flash_kernel=use_flash_kernel)
        new_cache = {"k": k, "v": v} if mode == "prefill" else None
        return matmul(out.reshape(b, s, h * dh), p.wo), new_cache

    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    if cache is None or cache_index is None:
        raise ValueError("decode needs a cache and a cache_index")
    cache_len = cache["k"].shape[1]
    ck = _cache_write(cache["k"], k, cache_index)
    cv = _cache_write(cache["v"], v, cache_index)
    k_pos = torch.arange(cache_len, dtype=torch.int32, device=x.device)[None, :]
    out = sdpa(q, ck, cv, positions, k_pos, scale=scale, causal=True, window=window,
               kv_limit=cache_index)
    return matmul(out.reshape(b, s, h * dh), p.wo), {"k": ck, "v": cv}
