# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: weighted Gram tile and correlation from a feature slab.

Replaces the TPU kernel ``repro/kernels/sparse_slab.py``
``slab_gram_pallas`` (its ``pl.pallas_call`` at line 81); source
``csrc/slab_gram.cu``.

Computes, per feature block of a batch, G = X_F^T diag(w) X_F and
c = X_F^T (w r) from a (T, K) slab of example rows (sentinel >= n_loc)
and values, the weights w and the block's residuals r. The TPU wrapper
gathers w v, v and v (w r), zeroed at the sentinel slots, before its
kernel (``kernels.ops._sentinel_zeroed`` here); this kernel gathers them
itself, with the same roundings, so one launch replaces about a dozen.

Bound on the H100: bytes. The TPU's match join does T^2 K^2
compare-and-FMA per tile (1.5e8 at T=128, K=95). This kernel needs each
feature's slots sorted by row -- established once per design by the
caller (``core.distributed`` lays the slabs out sorted) or, for
``rows_sorted=False``, here by one stable sort per call -- and the
tile's row-sorted order (:func:`slab_spmv.slab_order`, which the solve
builds once with its layout and shares with ``slab_spmv``): the slots on
one example row form one run of that order, and each G[a, b] sums the
runs of a's rows, staged in shared memory. All sums run in a fixed order
(a merge of the two row-sorted lists): two launches give bit-equal
results. The plain
versions are ``ref.slab_gram_join`` (what a CPU tensor runs, after the
gathers) and the densify oracle ``ref.slab_gram_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.slab_spmv import SlabOrder, _rows2d, slab_order

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("slab_gram")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.slab_gram_launch.argtypes = [p, q, p, q, p, p, q, p, q, p, q, p, p, p,
                                         i, i, i, i, p]
        lib.slab_gram_launch.restype = ctypes.c_int
        lib.slab_gram_scratch_ints.argtypes = [i, i, i]
        lib.slab_gram_scratch_ints.restype = ctypes.c_longlong
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def _scratch_ints(B: int, T: int, K: int) -> int:
    """Ints of global scratch a launch needs (0 when the tile's order fits
    in shared memory)."""
    return int(_launcher().slab_gram_scratch_ints(B, T, K))


def _slab3d(t, B: int, T: int, K: int):
    """``t`` (..., T, K) as a (B, T, K) view with contiguous (T, K) rows (a
    copy only if it has none)."""
    t3 = t if t.dim() == 3 else t.reshape(B, T, K)
    return t3 if t3.stride(2) == 1 and (t3.stride(1) == K or T == 1) else t3.contiguous()


def slab_gram_kernel(rows, vals, w, r, *, rows_sorted: bool = False,
                     order: SlabOrder = None):
    """(G (..., T, T), c (..., T)) on the card from a slab (..., T, K):
    int32 ``rows`` (sentinel >= n_loc = ``w.shape[0]``) and float32
    ``vals``, float32 weights ``w`` (n_loc,) and residuals ``r``
    (..., n_loc), gathered here. ``rows_sorted`` says each feature's slots
    are already in row order (otherwise they are sorted here); ``order``
    is the tile's :func:`slab_order` (built here when not given, and
    always for unsorted slots)."""
    global launches
    if rows.dim() < 2 or vals.shape != rows.shape:
        raise ValueError(f"rows and vals must share one (..., T, K) shape, got "
                         f"{tuple(rows.shape)}, {tuple(vals.shape)}")
    if w.dim() != 1 or r.shape != (*rows.shape[:-2], w.shape[0]):
        raise ValueError(f"expected w (n_loc,) and r (..., n_loc) for rows "
                         f"{tuple(rows.shape)}, got {tuple(w.shape)}, {tuple(r.shape)}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if any(t.dtype != torch.float32 for t in (vals, w, r)):
        raise TypeError("vals, w, r must be float32")
    for t in (rows, vals, w, r):
        if not t.is_cuda or t.device != rows.device:
            raise ValueError("slab_gram takes CUDA tensors on one device")
    n_loc = w.shape[0]
    *lead, T, K = rows.shape
    B = 1
    for s in lead:
        B *= s
    if B > 65535:
        raise ValueError(f"batch of {B} feature blocks exceeds the grid's 65535")
    if T + 5 * K > 51200:
        raise ValueError(f"tile T={T}, K={K} is too wide for one block's shared memory")
    if not rows_sorted:                 # each feature's slots in row order
        rows, idx = torch.sort(rows.clamp_max(n_loc), dim=-1, stable=True)
        vals = vals.gather(-1, idx)
        order = None
    if order is None:
        order = slab_order(rows)
    if (any(t.dtype != torch.int32 or not t.is_cuda for t in (order.rows_s, order.perm))
            or tuple(order.rows_s.shape) != (*lead, T * K)
            or order.perm.shape != order.rows_s.shape):
        raise ValueError(f"order must be int32 CUDA tensors of shape {(*lead, T * K)}")
    rows3, vals3 = _slab3d(rows, B, T, K), _slab3d(vals, B, T, K)
    rows_s, perm = _rows2d(order.rows_s, B, T * K), _rows2d(order.perm, B, T * K)
    r2, w = _rows2d(r, B, n_loc), w.contiguous()
    G = torch.empty(*lead, T, T, dtype=torch.float32, device=rows.device)
    c = torch.empty(*lead, T, dtype=torch.float32, device=rows.device)
    lib = _launcher()
    n_scratch = _scratch_ints(B, T, K)
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=rows.device)
               if n_scratch else None)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.slab_gram_launch(
        rows3.data_ptr(), rows3.stride(0), vals3.data_ptr(), vals3.stride(0),
        w.data_ptr(), r2.data_ptr(), r2.stride(0), rows_s.data_ptr(), rows_s.stride(0),
        perm.data_ptr(), perm.stride(0), G.data_ptr(), c.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, T, K, n_loc, stream)
    if err:
        raise RuntimeError(f"slab_gram launch failed: cudaError {err}")
    launches += 1
    return G, c
