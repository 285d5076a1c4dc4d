# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: weighted Gram tile and correlation from a feature slab.

Replaces the TPU kernel ``repro/kernels/sparse_slab.py``
``slab_gram_pallas`` (its ``pl.pallas_call`` at line 81); source
``csrc/slab_gram.cu``.

Computes, per feature block of a batch, G = X_F^T diag(w) X_F and
c = X_F^T (w r) from a (T, K) slab whose operands ``kernels.ops``
gathers and zeroes at sentinel slots (``_sentinel_zeroed``), as the TPU
wrapper does.

Bound on the H100: bytes, once the algorithm is right. The TPU's match
join does T^2 K^2 compare-and-FMA per tile (1.5e8 at T=128, K=95); this
kernel merges each pair of row-sorted slot lists instead, O(T^2 K)
steps. The invariant it needs -- each feature's slots sorted by row --
is established once per design by the caller (``core.distributed``
lays the slabs out sorted) or, for ``rows_sorted=False``, here by one
stable sort per call. All sums run in a fixed order: two launches give
bit-equal results. The plain versions are ``ref.slab_gram_join`` (what
a CPU tensor runs) and the densify oracle ``ref.slab_gram_ref``.
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

        lib = load("slab_gram")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.slab_gram_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.slab_gram_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.slab_gram_launch


def slab_gram_kernel(safe, wv, va, cva, *, n_loc: int, rows_sorted: bool = False):
    """(G (..., T, T), c (..., T)) from a slab (..., T, K) on the card:
    ``safe`` int32 rows clamped to n_loc, ``wv``/``va``/``cva`` float32
    gathered and sentinel-zeroed. ``rows_sorted`` says each feature's
    slots are already in row order; otherwise they are sorted here."""
    global launches
    if safe.dim() < 2 or any(t.shape != safe.shape for t in (wv, va, cva)):
        raise ValueError(f"slab operands must share one (..., T, K) shape, got "
                         f"{[tuple(t.shape) for t in (safe, wv, va, cva)]}")
    for t in (safe, wv, va, cva):
        if not t.is_cuda or t.device != safe.device:
            raise ValueError("slab_gram takes CUDA tensors on one device")
    if safe.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {safe.dtype}")
    if any(t.dtype != torch.float32 for t in (wv, va, cva)):
        raise TypeError("wv, va, cva must be float32")
    if not rows_sorted:                 # each feature's slots in row order
        safe, idx = torch.sort(safe, dim=-1, stable=True)
        wv, va, cva = (t.gather(-1, idx) for t in (wv, va, cva))
    *lead, T, K = safe.shape
    B = 1
    for s in lead:
        B *= s
    if B > 65535:
        raise ValueError(f"batch of {B} feature blocks exceeds the grid's 65535")
    safe, wv, va, cva = (t.contiguous() for t in (safe, wv, va, cva))
    G = torch.empty(*lead, T, T, dtype=torch.float32, device=safe.device)
    c = torch.empty(*lead, T, dtype=torch.float32, device=safe.device)
    stream = torch.cuda.current_stream(safe.device).cuda_stream
    err = _launcher()(safe.data_ptr(), wv.data_ptr(), va.data_ptr(),
                      cva.data_ptr(), G.data_ptr(), c.data_ptr(), B, T, K,
                      int(n_loc), stream)
    if err:
        raise RuntimeError(f"slab_gram launch failed: cudaError {err}")
    launches += 1
    return G, c
