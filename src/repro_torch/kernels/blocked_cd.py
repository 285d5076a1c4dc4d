# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: blocked semi-parallel coordinate-descent cycle on Gram
tiles.

Replaces the TPU kernel ``repro/kernels/blocked_cd.py``
``blocked_cd_pallas`` (its ``pl.pallas_call`` at line 132, body
``_make_blocked_cd_kernel`` at line 41); source ``csrc/blocked_cd.cu``.

Bound on the H100: latency, as ``gram_cd`` -- between F/B and F
dependent steps. The design is gram_cd's (one warp per feature block,
all M in one launch, G in shared memory by 1-D TMA behind per-chunk
mbarriers, deltas by shuffle), and the kernel computes h = diag(G) + nu
and the per-block modes (the Gershgorin safeguard of
``core.subproblem.blocked_cycle_modes``) itself, in a prologue on the
shared-memory G: one launch per call and no PyTorch op around it. Its
row sums run in ascending column order, so its modes equal the plain
version's except where a ratio lies within rounding of the threshold
``dom_tol`` (``DOM_TOL`` by default), which the kernel takes as an
argument.
At B=1 the kernel equals gram_cd bit for bit. The plain version is
``ref.blocked_cd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.subproblem import DOM_TOL
from repro_torch.kernels.gram_cd import check_tile_operands, chunk_plan, current_stream

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

#: F-long 4-byte arrays beside the ring: c, h, base, two ratios, deltas, modes
VECTORS = 7

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("blocked_cd")
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.blocked_cd_launch.argtypes = [p, q, p, q, p, q, p, q, p, p,
                                          i, i, i, i, i, i, i, f, f, f, p]
        lib.blocked_cd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.blocked_cd_launch


def blocked_cd_kernel(G, c, beta, dbeta0, lam: float, nu: float, *,
                      block: int = 16, modes_out=None, dom_tol: float = DOM_TOL):
    """d (M, F) such that dbeta <- dbeta0 + d (one blocked cycle per
    feature block) from G (M, F, F) and c, beta, dbeta0 (M, F) float32
    CUDA tensors (vectors may be row-strided). ``modes_out``, an int32
    contiguous (M, F/B) tensor, receives the modes the kernel computed
    against the threshold ``dom_tol``."""
    global launches
    M, F, g_stride, (cs, bs, ds), bulk = check_tile_operands(G, (c, beta, dbeta0))
    if block < 1 or F % block:
        raise ValueError(f"block={block} must divide the tile width F={F}")
    if modes_out is not None and (
            modes_out.dtype != torch.int32 or tuple(modes_out.shape) != (M, F // block)
            or modes_out.get_device() != G.get_device() or not modes_out.is_contiguous()):
        raise ValueError(f"modes_out must be contiguous int32 ({M}, {F // block}) "
                         f"on {G.device}")
    plan = chunk_plan(F, VECTORS)
    d = G.new_empty((M, F))
    stream = current_stream(G.get_device())
    err = _launcher()(G.data_ptr(), g_stride, c.data_ptr(), cs, beta.data_ptr(), bs,
                      dbeta0.data_ptr(), ds, d.data_ptr(),
                      None if modes_out is None else modes_out.data_ptr(),
                      M, F, block, plan.rows, plan.stages, plan.smem, int(bulk),
                      float(lam), float(nu), float(dom_tol), stream)
    if err:
        raise RuntimeError(f"blocked_cd launch failed: cudaError {err}")
    launches += 1
    return d
