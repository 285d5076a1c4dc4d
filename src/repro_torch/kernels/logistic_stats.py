# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Triton kernel: fused logistic working statistics.

Replaces the TPU kernel ``repro/kernels/logistic_stats.py``
``logistic_stats_pallas`` (its ``pl.pallas_call`` at line 50). One pass
over the margin cache computes everything the outer iteration needs from
the examples axis (paper eq. (4)):

    p = clip(sigmoid(m), 1e-5, 1 - 1e-5), w = max(p(1-p), 1e-6),
    z = ((y+1)/2 - p)/w, and NLL partials sum softplus(-y m)

Bound on the H100: device memory. Each example moves 16 bytes (m and y
in, w and z out) for some twenty flops, far below the card's ratio of
operations to bytes. The design keeps the pass to that one sweep: one
program per BLOCK examples, masked ragged tail, contiguous vector loads
and stores, and one NLL partial per program written to a buffer that the
caller sums in a fixed order -- no atomics, so repeated runs are
bit-identical. The softplus is max(t, 0) + log1p(exp(-|t|)), which does
not overflow at any |m|.

Accuracy: z = ((y+1)/2 - p) / (p(1-p)) cancels in 1 - p as p -> 1, so one
ulp of p moves z by up to ~4e-4 relative. The kernel therefore computes p
as PyTorch's CUDA sigmoid does -- libdevice's expf and a correctly
rounded division (not the approximate exp2 and division Triton would
emit) -- and matches the plain version to rounding.

Triton is imported inside the launching function: a host without the
card imports this module but never launches.
"""
from __future__ import annotations

from functools import lru_cache

import torch

BLOCK = 1024

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

#: triton.language and its libdevice, bound when the kernel is first built
tl = None
libdevice = None


def _logistic_stats_kernel(m_ptr, y_ptr, w_ptr, z_ptr, nll_ptr, n,
                           BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    live = offs < n
    m = tl.load(m_ptr + offs, mask=live, other=0.0)
    y = tl.load(y_ptr + offs, mask=live, other=0.0)
    p = libdevice.div_rn(1.0, 1.0 + libdevice.exp(-m))
    p = tl.minimum(tl.maximum(p, 1e-5), 1.0 - 1e-5)          # P_EPS clamp
    w = tl.maximum(p * (1.0 - p), 1e-6)                      # W_MIN
    z = libdevice.div_rn((y + 1.0) * 0.5 - p, w)
    t = -y * m
    sp = tl.maximum(t, 0.0) + libdevice.log1p(libdevice.exp(-tl.abs(t)))
    sp = tl.where(live, sp, 0.0)
    tl.store(w_ptr + offs, w, mask=live)
    tl.store(z_ptr + offs, z, mask=live)
    tl.store(nll_ptr + pid, tl.sum(sp, axis=0))


@lru_cache(maxsize=1)
def _compiled():
    global tl, libdevice
    import triton
    import triton.language
    from triton.language.extra import libdevice as _libdevice

    tl, libdevice = triton.language, _libdevice
    return triton.jit(_logistic_stats_kernel)


def logistic_stats_kernel(m: torch.Tensor, y: torch.Tensor):
    """(w, z, nll) from margins m and labels y, both (n,) float32 contiguous
    CUDA tensors. Launches on the current stream."""
    global launches
    if not (m.is_cuda and y.is_cuda and m.device == y.device):
        raise ValueError("logistic_stats_kernel takes CUDA tensors on one device")
    if m.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"float32 only, got {m.dtype} and {y.dtype}")
    if m.dim() != 1 or m.shape != y.shape:
        raise ValueError(f"m and y must be (n,) of one shape, got "
                         f"{tuple(m.shape)} and {tuple(y.shape)}")
    if not (m.is_contiguous() and y.is_contiguous()):
        raise ValueError("m and y must be contiguous")
    n = m.shape[0]
    grid = max(1, -(-n // BLOCK))
    w = torch.empty_like(m)
    z = torch.empty_like(m)
    partials = torch.empty(grid, dtype=torch.float32, device=m.device)
    _compiled()[(grid,)](m, y, w, z, partials, n, BLOCK=BLOCK, num_warps=4)
    launches += 1
    return w, z, partials.sum()
