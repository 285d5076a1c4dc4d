# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: one sequential coordinate-descent cycle on Gram tiles.

Replaces the TPU kernel ``repro/kernels/gram_cd.py`` ``gram_cd_pallas``
(its ``pl.pallas_call`` at line 66); source ``csrc/gram_cd.cu``.

Bound on the H100: the latency of a chain of F dependent scalar steps.
Its bytes (G once, four F-vectors) and flops (2 M F^2) are tiny, and no
chain of F steps comes near their bound. The design runs all M feature
blocks of an outer iteration in one launch, one warp each with no block
barrier: lane l owns s_k for k = l + 32 i in registers, the owner of
coordinate j passes its delta to the other lanes by a shuffle, and G
arrives in shared memory by 1-D TMA in chunks of rows, each behind its
own mbarrier (:func:`chunk_plan`). The plain version is
``ref.gram_cd_ref``.

The (M, F) operands may be row-strided views with a unit inner stride
(such as ``beta[:, sl]``), so the solve passes its slices without copies
(:func:`tile_row_stride`).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

#: shared memory one block may claim on the H100 (bytes)
SMEM_LIMIT = 232_448
#: largest chunk of G rows that one TMA copy brings in (bytes)
CHUNK_BYTES = 32_768
#: the largest tile width the kernels take (32 lanes x 32 registers)
MAX_F = 1024

_lib = None


class ChunkPlan(NamedTuple):
    """How G (F x F float32) streams through shared memory: ``chunks`` of
    ``rows`` rows (the last may be shorter), ``stages`` chunk buffers
    (``stages == chunks``: the whole tile is resident; fewer: a ring
    refilled behind the chain), and the dynamic shared memory in bytes."""

    rows: int
    stages: int
    chunks: int
    smem: int

    @property
    def resident(self) -> bool:
        return self.stages >= self.chunks


def _smem_bytes(F: int, rows: int, stages: int, vectors: int) -> int:
    """Bytes of the kernels' shared-memory layout (csrc/cd_common.cuh):
    the ring, ``vectors`` F-long 4-byte arrays, padding to 16 bytes, one
    8-byte mbarrier per stage."""
    body = 4 * (stages * rows * F + vectors * F)
    return -(-body // 16) * 16 + 8 * stages


@lru_cache(maxsize=None)
def chunk_plan(F: int, vectors: int = 3) -> ChunkPlan:
    """The chunk plan of a width-F tile: rows per chunk a power of two up
    to 32 (so chunks never straddle a 32-row slab) and at most
    ``CHUNK_BYTES``, or F itself below 32; every chunk resident if they
    fit in ``SMEM_LIMIT`` beside ``vectors`` F-vectors (3 for gram_cd, 7
    for blocked_cd), else as many stages as fit."""
    if not 1 <= F <= MAX_F:
        raise ValueError(f"tile width F={F} outside 1..{MAX_F}")
    rows = 32
    while rows > 1 and rows * 4 * F > CHUNK_BYTES:
        rows //= 2
    rows = min(rows, F)
    chunks = -(-F // rows)
    if _smem_bytes(F, rows, chunks, vectors) <= SMEM_LIMIT:
        stages = chunks
    else:
        stages = chunks - 1
        while _smem_bytes(F, rows, stages, vectors) > SMEM_LIMIT:
            stages -= 1
        if stages < 2:
            raise ValueError(f"no two-stage ring of {rows}-row chunks fits at F={F}")
    return ChunkPlan(rows, stages, chunks, _smem_bytes(F, rows, stages, vectors))


def _row_stride(shape, stride, M: int, F: int) -> int:
    """The stride rule on a shape and strides: (M, F), unit inner stride."""
    if tuple(shape) != (M, F):
        raise ValueError(f"expected ({M}, {F}), got {tuple(shape)}")
    if F > 1 and stride[1] != 1:
        raise ValueError(f"tile vectors need a unit inner stride, got strides {stride}")
    return stride[0]


def tile_row_stride(t) -> int:
    """Row stride (in elements) of an (M, F) tile operand, which the kernels
    read in place: any row stride, a unit inner stride. Raises on others."""
    if t.dim() != 2:
        raise ValueError(f"tile vectors are (M, F), got {tuple(t.shape)}")
    return _row_stride(t.shape, t.stride(), *t.shape)


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a device (what
    ``torch.cuda.current_stream(i).cuda_stream`` gives, without building
    the stream object on every tile step)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _library():
    """The built gram_cd library (ctypes), with its entry points typed."""
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("gram_cd")
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.gram_cd_launch.argtypes = [p, q, p, q, p, q, p, q, p,
                                       i, i, i, i, i, i, f, f, p]
        lib.gram_cd_launch.restype = ctypes.c_int
        lib.cd_div_check_launch.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong, p, p]
        lib.cd_div_check_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tile_operands(G, vectors):
    """Validate G (M, F, F) with row-major tiles (any tile stride) and the
    (M, F) vectors for the tile kernels (F <= 1024). Returns (M, F, G's
    tile stride, the vectors' row strides, whether G may go by TMA). The
    solve calls this on every tile step, so it reads each tensor's
    attributes once."""
    shape = G.shape
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"G must be (M, F, F), got {tuple(shape)}")
    M, F = shape[0], shape[1]
    if not 1 <= F <= MAX_F:
        raise ValueError(f"tile width F={F} outside 1..{MAX_F}")
    dev = G.get_device()
    if dev < 0:
        raise ValueError("tile kernels take CUDA tensors on one device")
    for t in (G, *vectors):
        if t.get_device() != dev:
            raise ValueError("tile kernels take CUDA tensors on one device")
        if t.dtype is not torch.float32:
            raise TypeError(f"float32 only, got {t.dtype}")
    gs = G.stride()
    if F > 1 and (gs[2] != 1 or gs[1] != F):
        raise ValueError(f"G's tiles must be row-major, got strides {gs}")
    strides = tuple(_row_stride(v.shape, v.stride(), M, F) for v in vectors)
    bulk = F % 4 == 0 and gs[0] % 4 == 0 and G.data_ptr() % 16 == 0
    return M, F, gs[0], strides, bulk


def division_mismatches(n: int, seed: int = 0, device="cuda") -> int:
    """How many of n pseudo-random float32 pairs (t, h) the kernels' step
    divides differently, in any bit, from the IEEE division (csrc/gram_cd.cu
    ``cd_div_check_kernel``); a check of the card, not part of the cycle."""
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    err = _library().cd_div_check_launch(n, seed, bad.data_ptr(),
                                             current_stream(bad.get_device()))
    if err:
        raise RuntimeError(f"division check launch failed: cudaError {err}")
    # allow[torch-host-sync]: a one-off check of the card's division, not part of a solve
    return int(bad.item())


def gram_cd_kernel(G, c, beta, dbeta0, lam: float, nu: float):
    """d (M, F) such that dbeta <- dbeta0 + d, from G (M, F, F) and c,
    beta, dbeta0 (M, F) float32 CUDA tensors (vectors may be row-strided)."""
    global launches
    M, F, g_stride, (cs, bs, ds), bulk = check_tile_operands(G, (c, beta, dbeta0))
    plan = chunk_plan(F, 3)
    d = G.new_empty((M, F))
    stream = current_stream(G.get_device())
    err = _library().gram_cd_launch(
        G.data_ptr(), g_stride, c.data_ptr(), cs, beta.data_ptr(), bs, dbeta0.data_ptr(), ds,
        d.data_ptr(), M, F, plan.rows, plan.stages, plan.smem, int(bulk), float(lam),
        float(nu), stream)
    if err:
        raise RuntimeError(f"gram_cd launch failed: cudaError {err}")
    launches += 1
    return d
