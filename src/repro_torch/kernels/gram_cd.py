# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: one sequential coordinate-descent cycle on Gram tiles.

Replaces the TPU kernel ``repro/kernels/gram_cd.py`` ``gram_cd_pallas``
(its ``pl.pallas_call`` at line 66); source ``csrc/gram_cd.cu``.

Bound on the H100: latency, not bytes or flops. The cycle is F dependent
scalar steps; its bytes (G once, four F-vectors) and flops (2 M F^2) are
tiny. The design runs all M feature blocks of an outer iteration in one
launch, one thread block each, so the M chains proceed side by side; each
step costs one shared-memory broadcast and one barrier, and G's rows come
from L2 one step ahead. The plain version is ``ref.gram_cd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("gram_cd")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gram_cd_launch.argtypes = [p, p, p, p, p, i, i, f, f, p]
        lib.gram_cd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.gram_cd_launch


def check_tile_operands(G, vectors):
    """Validate G (M, F, F) and (M, F) vectors for the tile kernels (one
    thread per coordinate: F <= 1024)."""
    if G.dim() != 3 or G.shape[1] != G.shape[2]:
        raise ValueError(f"G must be (M, F, F), got {tuple(G.shape)}")
    M, F = G.shape[0], G.shape[1]
    if not 1 <= F <= 1024:
        raise ValueError(f"tile width F={F} outside 1..1024")
    for t in (G, *vectors):
        if not t.is_cuda or t.device != G.device:
            raise ValueError("tile kernels take CUDA tensors on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"float32 only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("tile kernel operands must be contiguous")
    for v in vectors:
        if tuple(v.shape) != (M, F):
            raise ValueError(f"expected ({M}, {F}), got {tuple(v.shape)}")
    return M, F


def gram_cd_kernel(G, c, beta, dbeta0, lam: float, nu: float):
    """d (M, F) such that dbeta <- dbeta0 + d, from G (M, F, F) and c,
    beta, dbeta0 (M, F); float32 contiguous CUDA tensors."""
    global launches
    M, F = check_tile_operands(G, (c, beta, dbeta0))
    d = torch.empty_like(c)
    stream = torch.cuda.current_stream(G.device).cuda_stream
    err = _launcher()(G.data_ptr(), c.data_ptr(), beta.data_ptr(),
                      dbeta0.data_ptr(), d.data_ptr(), M, F, float(lam),
                      float(nu), stream)
    if err:
        raise RuntimeError(f"gram_cd launch failed: cudaError {err}")
    launches += 1
    return d
