# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: forward attention with an online softmax over KV tiles.

Replaces the TPU kernel ``repro/kernels/flash_attention.py``
``flash_attention_pallas`` (its ``pl.pallas_call`` at line 84, body
``_flash_kernel``); source ``csrc/flash_attention.cu``.

q (B, S, H, D), k and v (B, S, Hk, D) -> (B, S, H, D) in q's type:
causal or full softmax attention with scale 1/sqrt(D), float32 sums and
statistics for float32 and bfloat16 inputs, masked scores at -1e30.
Query head h reads KV head h // (H / Hk), what the reference gets from
``jnp.repeat(k, H // Hk, axis=2)``, without building the expanded K/V.

Bound on the H100: operations (4 S^2 D B H FLOP, half of it under
``causal``, against about 2 bytes per element of q, k, v, o). One block
per 64-row query tile and head. bfloat16 runs on the tensor cores: a
producer warp fills a two-stage ring of K/V tiles with TMA, one consumer
warpgroup runs Q K^T and P V as ``wgmma`` with float32 accumulation, the
probabilities split into two bf16 halves (hi + lo) so that P V stays as
exact as the reference's float32 product. float32 runs FMA on the CUDA
cores. The plain version is ``ref.flash_attention_ref``.

Forward only, as the reference's kernel: an operand that requires grad
is refused, since autograd would take the kernel's output for a constant.
"""
from __future__ import annotations

import ctypes
import math

import torch

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

BLOCK = 64                       # query rows per block and keys per KV tile
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TMA_ENCODE_FAILED = -1              # the C entry point's code: no launch

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, p]
        lib.flash_attention_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.flash_attention_launch


def check_operands(q, k, v):
    """Validate q (B, S, H, D), k/v (B, S, Hk, D) for the kernel; returns
    (B, S, H, Hk, D)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,S,H,D), k = v (B,S,Hk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    Hk = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if Hk == 0 or H % Hk:
        raise ValueError(f"query heads {H} are not a multiple of KV heads {Hk}")
    if S % BLOCK:
        raise ValueError(f"sequence length {S} is not a multiple of {BLOCK}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention takes CUDA tensors on one device")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"float32 or bfloat16 operands of one type, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        if t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
                or t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"operands need a contiguous last axis, strides that are "
                             f"multiples of 4 and aligned data; got strides {t.stride()}")
    return B, S, H, Hk, D


def _tma_ready(t):
    """``t`` as the bf16 route's tensor maps can take it: 16-byte aligned
    data and nonzero strides that are 16-byte multiples (a contiguous copy
    otherwise, the only copy the route makes)."""
    if t.data_ptr() % 16 == 0 and all((s % 8 == 0 and s > 0) or n == 1
                                       for s, n in zip(t.stride()[:3], t.shape[:3])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(*ts):
    """Batch, sequence and head strides of each tensor, in elements; an
    axis of length 1 gets the stride a contiguous tensor would have (it is
    never stepped along, and a tensor map wants a 16-byte multiple)."""
    out = []
    for t in ts:
        for i in range(3):
            n = 1
            for size in t.shape[i + 1:]:
                n *= size
            out.append(n if t.shape[i] == 1 else t.stride(i))
    return (ctypes.c_longlong * len(out))(*out)


def flash_attention_kernel(q, k, v, *, causal: bool = True):
    """Attention of q (B, S, H, D) over k, v (B, S, Hk, D) on the card,
    read in place through their strides; returns a new (B, S, H, D)
    tensor of q's type."""
    global launches
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention is forward-only: an operand requires grad; "
                           "train through the chunked path (use_flash_kernel=False)")
    B, S, H, Hk, D = check_operands(q, k, v)
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      _strides(q, k, v, o), B, S, H, Hk, D, int(causal),
                      1.0 / math.sqrt(D), _DTYPES[q.dtype], stream)
    if err == _TMA_ENCODE_FAILED:
        raise RuntimeError("flash_attention: an operand's layout cannot be described "
                           "as a TMA tensor map")
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return o
