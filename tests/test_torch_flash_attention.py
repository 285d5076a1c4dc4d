"""The port's attention kernel layer on the CPU, against the JAX package on
the same numpy inputs.

* ``ops.flash_attention`` (a CPU tensor runs the plain version) and
  ``ref.flash_attention_ref`` against the reference's Pallas kernel in
  interpret mode and its ``ref.flash_attention_ref``, at the reference's
  sweep shapes, causal and full: float32 at atol 2e-5 and bfloat16 at
  atol 3e-2 (``tests/test_kernels.py``'s tolerances).
* GQA through ``sdpa(use_flash_kernel=True)`` against the reference's
  ``sdpa`` (atol 2e-5, ``tests/test_models.py``); a shape that does not
  qualify (S % 128 != 0) takes the chunked path in both packages.
* The card kernel's tile algorithm, written out in PyTorch here: skipping
  the KV tiles wholly above the diagonal under ``causal`` is exact (bit
  for bit the same as visiting them), and the algorithm matches the plain
  version.
* The bfloat16 route's arithmetic, emulated here: probabilities split
  into bf16 hi + lo per 64-key tile keep every output within half a bf16
  ulp plus 2e-5 (2^-8 |o| + 2e-5) of the float32 plain result at S = 1024,
  the bound ``chip_smoke.py`` holds the kernel to; probabilities rounded
  to bf16 alone break it, so the bound can tell the two apart.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version); here its wrapper must refuse CPU tensors.
"""
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as j_flash_attention
from repro.kernels.ref import flash_attention_ref as j_flash_attention_ref
from repro.models.attention import sdpa as j_sdpa
from repro_torch.kernels import ops, ref
flash_attention = import_module("repro_torch.kernels.flash_attention")
from repro_torch.models import attention as tattn

torch.set_num_threads(2)


def qkv(shape, hk=None, seed=0):
    b, s, h, d = shape
    rng = np.random.default_rng(seed)
    kv_shape = (b, s, hk or h, d)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32),
            rng.standard_normal(kv_shape, dtype=np.float32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("shape,blocks", [
    ((1, 256, 2, 64), (128, 128)),
    ((2, 512, 4, 32), (128, 64)),
    ((1, 128, 1, 128), (64, 128)),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep_matches_reference(shape, blocks, causal):
    q, k, v = qkv(shape, seed=shape[1] + shape[3])
    bq, bk = blocks
    want = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=bq, block_k=bk)
    want_ref = j_flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    got_ref = ref.flash_attention_ref(tq, tk, tv, causal=causal)
    for g in (got, got_ref):
        assert g.dtype == torch.float32 and g.shape == shape
        np.testing.assert_allclose(_f32(g), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(_f32(g), np.asarray(want_ref), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bfloat16_matches_reference(causal):
    q, k, v = qkv((1, 256, 2, 64), seed=11)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = j_flash_attention(jq, jk, jv, causal=causal, block_q=128, block_k=128)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32), atol=3e-2)
    np.testing.assert_allclose(
        _f32(got), np.asarray(j_flash_attention_ref(jq, jk, jv, causal=causal), np.float32),
        atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_flash_switch_gqa_matches_reference(causal, monkeypatch):
    """GQA (4 query heads on 2 KV heads) through the flash switch: the port
    hands grouped K/V to ops.flash_attention, the reference repeats them
    to 4 heads first; both against the reference's chunked path too."""
    b, s, h, hk, dh = 2, 256, 4, 2, 64
    q, k, v = qkv((b, s, h, dh), hk=hk, seed=9)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    scale = 1.0 / dh ** 0.5
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.asarray(pos))
    want_flash = j_sdpa(*jargs, scale=scale, causal=causal, use_flash_kernel=True)
    want_jnp = j_sdpa(*jargs, scale=scale, causal=causal, q_chunk=64)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, pos, pos))
    got = tattn.sdpa(*targs, scale=scale, causal=causal, use_flash_kernel=True)
    assert calls == [(b, s, hk, dh)]            # grouped K/V, not expanded
    np.testing.assert_allclose(_f32(got), np.asarray(want_flash), atol=2e-5)
    np.testing.assert_allclose(_f32(got), np.asarray(want_jnp), atol=2e-5)


def test_sdpa_unqualified_shape_takes_the_chunked_path(monkeypatch):
    """S = 96 is not a multiple of 128: with the switch on, both packages
    take the chunked path (the port never reaches ops.flash_attention)."""
    b, s, h, hk, dh = 2, 96, 4, 2, 32
    q, k, v = qkv((b, s, h, dh), hk=hk, seed=5)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want = j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                  jnp.asarray(pos), scale=0.2, use_flash_kernel=True, q_chunk=32)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: pytest.fail("unqualified shape reached the kernel"))
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, pos, pos))
    got = tattn.sdpa(*targs, scale=0.2, use_flash_kernel=True, q_chunk=32)
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=2e-5)


def test_gqa_maps_query_head_to_kv_head_by_division():
    """Query head h reads KV head h // (H / Hk), as jnp.repeat(k, g, axis=2)
    lays the heads out (not h % Hk)."""
    b, s, h, hk, d = 1, 128, 8, 2, 32
    q, k, v = qkv((b, s, h, d), hk=hk, seed=3)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)))
    g = h // hk
    want = j_flash_attention_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=2)),
                                 jnp.asarray(np.repeat(v, g, axis=2)))
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=2e-5)
    wrong = ref.flash_attention_ref(*map(torch.from_numpy, (q, np.tile(k, (1, 1, g, 1)),
                                                             np.tile(v, (1, 1, g, 1)))))
    assert not np.allclose(_f32(got), _f32(wrong), atol=1e-3)


def tile_algorithm(q, k, v, *, causal, skip, block=64):
    """The card kernel's algorithm in float32 PyTorch: per 64-row query
    tile, an online softmax over 64-key tiles with scores masked to
    -1e30, running max m, denominator l and accumulator; ``skip`` leaves
    out the KV tiles wholly above the diagonal, as the kernel does."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scale = 1.0 / d ** 0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, block):
        qt = q[:, q0:q0 + block].transpose(1, 2)                 # (b, h, Bq, d)
        m = torch.full((b, h, block, 1), -1e30)
        l = torch.zeros(b, h, block, 1)
        acc = torch.zeros(b, h, block, d)
        last = q0 // block + 1 if (causal and skip) else s // block
        for kt in range(last):
            k0 = kt * block
            sc = (qt @ k[:, k0:k0 + block].permute(0, 2, 3, 1)) * scale
            if causal:
                rows = torch.arange(q0, q0 + block)[:, None]
                cols = torch.arange(k0, k0 + block)[None, :]
                sc = torch.where(rows >= cols, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ v[:, k0:k0 + block].transpose(1, 2)
            m = m_new
        out[:, q0:q0 + block] = (acc / l.clamp_min(1e-30)).transpose(1, 2)
    return out


@pytest.mark.parametrize("shape,hk", [((2, 256, 4, 64), 1), ((1, 192, 2, 32), 2)])
def test_causal_tile_skipping_is_exact(shape, hk):
    q, k, v = map(torch.from_numpy, qkv(shape, hk=hk, seed=21))
    skipped = tile_algorithm(q, k, v, causal=True, skip=True)
    visited = tile_algorithm(q, k, v, causal=True, skip=False)
    assert torch.equal(skipped, visited)
    np.testing.assert_allclose(skipped.numpy(), _f32(ref.flash_attention_ref(q, k, v)),
                               atol=2e-5)
    full = tile_algorithm(q, k, v, causal=False, skip=True)
    np.testing.assert_allclose(full.numpy(),
                               _f32(ref.flash_attention_ref(q, k, v, causal=False)), atol=2e-5)


def bf16_route(q, k, v, *, causal, split=True, block=64):
    """The bfloat16 route of the card kernel in float32 PyTorch: online
    softmax per 64-key tile on the raw scores, p = 2^(s c - m c) with c =
    scale * log2(e), and P V with P rounded to bf16 as hi + lo (``split``)
    or as hi alone; the output cast to bf16 once, round to nearest."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    q, k, v = (t.float() for t in (q, k, v))
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    c = (1.0 / d ** 0.5) * 1.4426950408889634
    out = torch.empty(b, s, h, d)
    for q0 in range(0, s, block):
        qt = q[:, q0:q0 + block].transpose(1, 2)
        m = torch.full((b, h, block, 1), -1e30)
        l = torch.zeros(b, h, block, 1)
        acc = torch.zeros(b, h, block, d)
        for kt in range(q0 // block + 1 if causal else s // block):
            k0 = kt * block
            x = qt @ k[:, k0:k0 + block].permute(0, 2, 3, 1)
            if causal:
                rows = torch.arange(q0, q0 + block)[:, None]
                x = torch.where(rows >= torch.arange(k0, k0 + block)[None, :], x, -1e30)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            p = torch.exp2(x * c - m_new * c)
            alpha = torch.exp2(m * c - m_new * c)
            l = alpha * l + p.sum(-1, keepdim=True)
            vt = v[:, k0:k0 + block].transpose(1, 2)
            hi = p.bfloat16().float()
            acc = acc * alpha + hi @ vt
            if split:
                acc = acc + (p - hi).bfloat16().float() @ vt
            m = m_new
        out[:, q0:q0 + block] = (acc / l.clamp_min(1e-30)).transpose(1, 2)
    return out.bfloat16()


def _bf16_bound_ratio(split):
    q, k, v = (torch.from_numpy(a).bfloat16() for a in qkv((1, 1024, 4, 64), hk=1, seed=14))
    got = bf16_route(q, k, v, causal=True, split=split).float()
    p32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    return float(((got - p32).abs() / (2.0 ** -8 * p32.abs() + 2e-5)).max())


def test_bf16_route_split_probabilities_stay_within_half_an_ulp():
    """P = P_hi + P_lo in bf16 keeps the product as exact as float32: every
    output within 2^-8 |o| + 2e-5 of the float32 plain result."""
    assert _bf16_bound_ratio(split=True) <= 1.0


def test_bf16_route_rounded_probabilities_break_the_bound():
    """Rounding P to bf16 alone (2^-9 relative per probability) puts
    outputs near 0 past 2e-5: the card check would catch that kernel."""
    assert _bf16_bound_ratio(split=False) > 1.0


def test_bf16_operands_meet_the_tensor_map_rules():
    """bf16 operands reach the kernel with 16-byte aligned data and nonzero
    strides (a misaligned or broadcast view is copied), and an axis of
    length 1 is described with the stride a contiguous tensor would
    have."""
    base = torch.zeros(1, 128, 2, 72, dtype=torch.bfloat16)
    view = base[..., 4:68]                      # data 8 bytes past alignment
    fixed = flash_attention._tma_ready(view)
    assert fixed.is_contiguous() and torch.equal(fixed, view)
    aligned = base[..., 8:72]
    assert flash_attention._tma_ready(aligned) is aligned
    shared = base[:, :, :1, 8:72].expand(1, 128, 3, 64)  # one head's data three times
    assert flash_attention._tma_ready(shared).stride(2) == 64
    one = torch.zeros(1, 64, 1, 32).as_strided((1, 64, 1, 32), (4, 32, 3, 1))
    assert list(flash_attention._strides(one)) == [64 * 32, 32, 32]


@pytest.mark.parametrize("bad", ["cpu", "ragged", "heads", "dtype", "head_dim"])
def test_kernel_wrapper_refuses_what_it_cannot_launch(bad):
    """The wrapper launches its kernel or raises: never a CPU computation,
    never a silently unsupported shape."""
    q, k, v = map(torch.from_numpy, qkv((1, 128, 4, 64), hk=2))
    if bad == "ragged":
        q, k, v = q[:, :96], k[:, :96], v[:, :96]
    elif bad == "heads":
        k, v = k[:, :, :1].expand(1, 128, 3, 64), v[:, :, :1].expand(1, 128, 3, 64)
    elif bad == "dtype":
        q = q.double()
    elif bad == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    with pytest.raises((ValueError, TypeError)):
        flash_attention.flash_attention_kernel(q, k, v)
    assert flash_attention.launches == 0
