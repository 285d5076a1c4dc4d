# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: blocked semi-parallel coordinate-descent cycle on Gram
tiles.

Replaces the TPU kernel ``repro/kernels/blocked_cd.py``
``blocked_cd_pallas`` (its ``pl.pallas_call`` at line 132, body
``_make_blocked_cd_kernel`` at line 41); source ``csrc/blocked_cd.cu``.

Bound on the H100: latency, as ``gram_cd`` -- between F/B and F
dependent steps, each one barrier. The design is gram_cd's (one thread
block per feature block, all M in one launch, deltas through shared
memory) with each B-wide Jacobi step as one barrier. The per-block modes
and h = diag(G) + nu are computed here, outside the kernel, from G alone,
as the TPU wrapper does. At B=1 the kernel equals gram_cd bit for bit.
The plain version is ``ref.blocked_cd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.subproblem import blocked_cycle_modes
from repro_torch.kernels.gram_cd import check_tile_operands

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("blocked_cd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.blocked_cd_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, f, p]
        lib.blocked_cd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.blocked_cd_launch


def blocked_cd_kernel(G, c, beta, dbeta0, lam: float, nu: float, *,
                      block: int = 16):
    """d (M, F) such that dbeta <- dbeta0 + d (one blocked cycle per
    feature block); float32 contiguous CUDA tensors G (M, F, F) and c,
    beta, dbeta0 (M, F). Computes the modes and h, then launches."""
    check_tile_operands(G, (c, beta, dbeta0))
    if block < 1 or G.shape[-1] % block:
        raise ValueError(f"block={block} must divide the tile width F={G.shape[-1]}")
    modes = blocked_cycle_modes(G, block, nu=nu).contiguous()
    h = (G.diagonal(dim1=-2, dim2=-1) + nu).contiguous()
    return launch_blocked_cd(G, h, c, beta, dbeta0, modes, lam, block=block)


def launch_blocked_cd(G, h, c, beta, dbeta0, modes, lam: float, *, block: int):
    """The launch alone, from precomputed h = diag(G) + nu (M, F) and int32
    modes (M, F/B)."""
    global launches
    M, F = check_tile_operands(G, (h, c, beta, dbeta0))
    if block < 1 or F % block:
        raise ValueError(f"block={block} must divide the tile width F={F}")
    if (modes.dtype != torch.int32 or tuple(modes.shape) != (M, F // block)
            or modes.device != G.device or not modes.is_contiguous()):
        raise ValueError(f"modes must be contiguous int32 ({M}, {F // block}) "
                         f"on {G.device}")
    d = torch.empty_like(c)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    err = _launcher()(G.data_ptr(), h.data_ptr(), c.data_ptr(),
                      beta.data_ptr(), dbeta0.data_ptr(), modes.data_ptr(),
                      d.data_ptr(), M, F, block, float(lam), stream)
    if err:
        raise RuntimeError(f"blocked_cd launch failed: cudaError {err}")
    launches += 1
    return d
