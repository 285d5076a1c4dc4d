# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Attention (counterpart of ``repro/models/attention.py``): GQA with or
without QKV bias, MLA (DeepSeek-V3), RoPE, sliding window, and the KV
cache for prefill and decode. Cross-attention, M-RoPE and the
sequence-sharded flash-decode are not ported yet.

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
grad. MLA never reaches it, as in the reference: its query head is
``qk_nope_head_dim + qk_rope_head_dim`` wide and its value head
``v_head_dim``, and the kernel takes one width for both.

While autograd records, each query chunk of the chunked path runs under
``torch.utils.checkpoint.checkpoint`` (non-reentrant), as the reference
wraps its chunk body in ``jax.checkpoint``: backward recomputes a chunk's
(C, Sk) scores instead of keeping every chunk's.

Modes: ``"train"``/``"prefill"`` attend over the whole sequence (prefill
also returns its K/V, or MLA's latent and shared rope key); ``"decode"``
writes the new token's entries into the cache at ``cache_index`` (a
Python int) and attends over the written slots, MLA in the absorbed form
(``wkv_b``'s key half folded into the query, its value half applied to
the attended latent). The port writes the cache in place, where the
reference returns an updated copy.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_norm, apply_rope, dense_init, frozen, init_norm, matmul

NEG_INF = -1e30
Q_CHUNK = 1024          # query-chunk length for full-sequence attention


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA projection weights ``wq``, ``wk``, ``wv``, ``wo`` (d_in, d_out),
    and the biases ``bq``, ``bk``, ``bv`` (zeros) when the config has
    ``qkv_bias``."""

    def __init__(self, gen, cfg: AttentionConfig, d_model: int, dtype, *, device="cpu"):
        super().__init__()
        dh = cfg.resolved_head_dim(d_model)
        h, hk = cfg.num_heads, cfg.num_kv_heads
        self.wq = frozen(dense_init(gen, d_model, h * dh, dtype, device=device))
        self.wk = frozen(dense_init(gen, d_model, hk * dh, dtype, device=device))
        self.wv = frozen(dense_init(gen, d_model, hk * dh, dtype, device=device))
        self.wo = frozen(dense_init(gen, h * dh, d_model, dtype, device=device))
        if cfg.qkv_bias:
            self.bq = frozen(torch.zeros(h * dh, dtype=dtype, device=device))
            self.bk = frozen(torch.zeros(hk * dh, dtype=dtype, device=device))
            self.bv = frozen(torch.zeros(hk * dh, dtype=dtype, device=device))


class MLA(nn.Module):
    """Multi-head latent attention weights (the reference's ``_init_mla``):
    ``wq_a`` (d, q_lora), ``q_norm``, ``wq_b`` (q_lora, H (dn + dr)),
    ``wkv_a`` (d, kv_lora + dr: the latent and the shared rope key),
    ``kv_norm``, ``wkv_b`` (kv_lora, H (dn + dv)) and ``wo`` (H dv, d)."""

    def __init__(self, gen, cfg: AttentionConfig, d_model: int, dtype, *, device="cpu"):
        super().__init__()
        h = cfg.num_heads
        dq, dkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.wq_a = frozen(dense_init(gen, d_model, dq, dtype, device=device))
        self.q_norm = init_norm(dq, dtype, device=device)
        self.wq_b = frozen(dense_init(gen, dq, h * (dn + dr), dtype, device=device))
        self.wkv_a = frozen(dense_init(gen, d_model, dkv + dr, dtype, device=device))
        self.kv_norm = init_norm(dkv, dtype, device=device)
        self.wkv_b = frozen(dense_init(gen, dkv, h * (dn + dv), dtype, device=device))
        self.wo = frozen(dense_init(gen, h * dv, d_model, dtype, device=device))


def init_attention(gen, cfg: AttentionConfig, d_model: int, dtype, *, device="cpu"):
    if cfg.use_mla:
        return MLA(gen, cfg, d_model, dtype, device=device)
    return Attention(gen, cfg, d_model, dtype, device=device)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: AttentionConfig, d_model: int, batch: int, cache_len: int, dtype,
                  *, device="cpu"):
    if cfg.use_mla:
        return {"latent": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                                      device=device),
                "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_head_dim), dtype=dtype,
                                      device=device)}
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
    """Returns (y (B, S, D), cache): prefill's new {"k", "v"} (MLA's
    {"latent", "k_rope"}), decode's written cache, None in training."""
    if cfg.use_mla:
        return _mla_forward(p, x, cfg=cfg, positions=positions, mode=mode, cache=cache,
                            cache_index=cache_index, window=window, causal=causal)
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim(d_model)
    h, hk = cfg.num_heads, cfg.num_kv_heads

    q = matmul(x, p.wq)
    k = matmul(x, p.wk)
    v = matmul(x, p.wv)
    if cfg.qkv_bias:
        # in the promoted type, as jnp adds a bias of the weights' type
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hk, dh)
    v = v.reshape(b, s, hk, dh)
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


# ---------------------------------------------------------------------------
# MLA forward (DeepSeek-V3)
# ---------------------------------------------------------------------------


def _einsum(eq: str, a, b):
    """``jnp.einsum`` of two operands: both in their promoted type."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _mla_forward(p, x, *, cfg: AttentionConfig, positions, mode, cache, cache_index, window,
                 causal=True):
    """The reference's ``_mla_forward``. Both norms take the default eps
    (1e-5), not the model's ``norm_eps``; ``k_rope`` is one rotary key of
    ``qk_rope_head_dim`` shared by every head. Train and prefill build
    per-head K and V from the latent through the two halves of ``wkv_b``
    and attend through the chunked path; decode is the absorbed form, in
    float32, over the written latent and rope caches."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dkv = cfg.kv_lora_rank

    q_lat = apply_norm(p.q_norm, matmul(x, p.wq_a))
    q = matmul(q_lat, p.wq_b).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = matmul(x, p.wkv_a)                                     # (B, S, dkv + dr)
    latent = apply_norm(p.kv_norm, kv_a[..., :dkv])               # (B, S, dkv)
    k_rope = apply_rope(kv_a[..., dkv:], positions, cfg.rope_theta)  # (B, S, dr), shared

    scale = 1.0 / ((dn + dr) ** 0.5)
    wkv_b = p.wkv_b.reshape(dkv, h, dn + dv)
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]                 # (dkv, H, dn), (dkv, H, dv)

    if mode in ("train", "prefill"):
        k_nope = _einsum("bsk,khd->bshd", latent, wk_b)
        v = _einsum("bsk,khd->bshd", latent, wv_b)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr).to(k_nope.dtype)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = sdpa(qf, k, v, positions, positions, scale=scale, causal=causal, window=window)
        y = matmul(out.reshape(b, s, h * dv), p.wo)
        return y, ({"latent": latent, "k_rope": k_rope} if mode == "prefill" else None)

    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    if cache is None or cache_index is None:
        raise ValueError("decode needs a cache and a cache_index")
    lat_c = _cache_write(cache["latent"], latent, cache_index)    # (B, Sc, dkv)
    kr_c = _cache_write(cache["k_rope"], k_rope, cache_index)     # (B, Sc, dr)
    k_pos = torch.arange(lat_c.shape[1], dtype=torch.int32, device=x.device)[None, :]

    f32 = torch.float32
    q_abs = _einsum("bshd,khd->bshk", q_nope, wk_b)               # (B, S, H, dkv)
    logits = (torch.einsum("bshk,bck->bhsc", q_abs.to(f32), lat_c.to(f32))
              + torch.einsum("bshd,bcd->bhsc", q_rope.to(f32), kr_c.to(f32))) * scale
    mask = (k_pos[..., None, :] <= cache_index) & (positions[..., :, None] >= k_pos[..., None, :])
    if window:
        mask = mask & (positions[..., :, None] - k_pos[..., None, :] < window)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o_lat = torch.einsum("bhsc,bck->bshk", w, lat_c.to(f32))     # (B, S, H, dkv)
    out = torch.einsum("bshk,khd->bshd", o_lat, wv_b.to(f32))    # (B, S, H, dv)
    y = matmul(out.reshape(b, s, h * dv).to(x.dtype), p.wo)
    return y, {"latent": lat_c, "k_rope": kr_c}
