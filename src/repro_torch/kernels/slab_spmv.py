# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: slab sparse matrix-vector product X_F d.

Replaces the TPU kernel ``repro/kernels/sparse_slab.py``
``slab_spmv_pallas`` (its ``pl.pallas_call`` at line 126); source
``csrc/slab_spmv.cu``.

Per batch row (a feature block), out[i] +/-= sum over the slots of
example row i of value * d[feature]: into a zeroed output for margins
(``ops.slab_spmv``), or subtracted in place from the (M, n) residuals of
every feature block in one launch (``ops.slab_residual_update``), which
can also advance the tile's coefficient update dbeta += d in the same
launch. :func:`slab_path_spmv_kernel` is the serving mode
(``ops.slab_path_spmv``): each example row reads its own row of a
stacked coefficient path.

Bound on the H100: bytes (12 per slot, one scattered 4-byte
read-modify-write per touched example row); the flops are nothing. The
TPU kernel compares every slot with every 256-row output block; this one
sums row-sorted runs: :func:`slab_order` sorts each batch row's slots by
example row once, when the slabs are laid out, and keeps the rows, the
slot indices and the values in that order, so the kernel reads three
unit-stride streams. Each block stages a chunk of them and d in shared
memory, and the thread at the start of each run sums it left to right in
sorted order. One writer per output row and a fixed order per sum: no
float atomics, bit-equal launches. The plain versions are
``ref.slab_spmv_scatter`` (what a CPU tensor runs) and the densify
oracle ``ref.slab_spmv_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

#: launches of the kernel since the last reset (see kernels.ops): the
#: margins and residual modes, and the path mode apart
launches = 0
path_launches = 0

#: sorted positions per block of the kernel (THREADS * ITEMS in the source)
CHUNK = 512

_lib = None


class SlabOrder(NamedTuple):
    """Slots of each batch row sorted by example row: ``rows_s`` the sorted
    rows and ``perm`` the slot (feature * K + k) each came from, both
    (..., T * K) int32, and ``vals_s`` the float32 values in that order.
    ``slab_gram`` reads only the first two, so ``vals_s`` may be None
    there; :func:`slab_spmv_kernel` needs all three."""

    rows_s: torch.Tensor
    perm: torch.Tensor
    vals_s: Optional[torch.Tensor] = None


def slab_order(rows, vals=None) -> SlabOrder:
    """The row-sorted order of a slab (..., T, K), one stable sort over
    each batch row's T * K slots (sentinels, the largest rows, last);
    given ``vals``, also the values in that order."""
    rows_s, perm = torch.sort(rows.flatten(-2), dim=-1, stable=True)
    vals_s = None if vals is None else vals.flatten(-2).gather(-1, perm).to(torch.float32)
    return SlabOrder(rows_s.to(torch.int32), perm.to(torch.int32), vals_s)


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("slab_spmv")
        p, i, q, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.slab_spmv_launch.argtypes = [p, p, q, p, q, p, q, p, q, p, q, p, q,
                                          i, i, i, i, i, f, p]
        lib.slab_spmv_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.slab_spmv_launch


def _rows2d(t, B: int, S: int):
    """``t`` as a (B, S) view with unit inner stride (a copy only if the
    leading axes cannot be merged)."""
    t2 = t.reshape(B, S)
    return t2 if S <= 1 or t2.stride(1) == 1 else t2.contiguous()


def slab_spmv_kernel(order: SlabOrder, vals, d, out, *, n_loc: int, sign: float,
                     dbeta=None):
    """out (..., n_out) += sign * X_F d on the card, in place, for a slab
    (..., T, K) given by its row-sorted ``order`` and float32 ``vals``,
    and d (..., T); the order must carry its values (``slab_order(rows,
    vals)``). Given ``dbeta`` (..., T), a view with unit inner stride, the
    launch also does dbeta += d. Returns ``out``."""
    global launches
    *lead, T, K = vals.shape
    S = T * K
    B = 1
    for s in lead:
        B *= s
    tensors = (order.rows_s, order.perm, vals, d, out) + (() if dbeta is None else (dbeta,))
    for t in tensors:
        if not t.is_cuda or t.device != vals.device:
            raise ValueError("slab_spmv takes CUDA tensors on one device")
    if order.rows_s.dtype != torch.int32 or order.perm.dtype != torch.int32:
        raise TypeError("the slab order must be int32")
    if any(t.dtype != torch.float32 for t in (vals, d, out)):
        raise TypeError("vals, d and out must be float32")
    if tuple(order.rows_s.shape) != (*lead, S) or order.perm.shape != order.rows_s.shape:
        raise ValueError(f"order must be {(*lead, S)}, got {tuple(order.rows_s.shape)}")
    if tuple(d.shape) != (*lead, T):
        raise ValueError(f"d must be {(*lead, T)}, got {tuple(d.shape)}")
    if tuple(out.shape[:-1]) != tuple(lead) or out.shape[-1] < n_loc:
        raise ValueError(f"out must be (*{lead}, >= {n_loc}), got {tuple(out.shape)}")
    if B > 65535:
        raise ValueError(f"batch of {B} feature blocks exceeds the grid's 65535")
    vals_s = order.vals_s
    if vals_s is None:
        raise ValueError("the order lacks its values: build it with slab_order(rows, vals)")
    if vals_s.dtype != torch.float32 or vals_s.shape != order.rows_s.shape:
        raise ValueError(f"order.vals_s must be float32 {(*lead, S)}")
    rs, pm = _rows2d(order.rows_s, B, S), _rows2d(order.perm, B, S)
    if rs.stride(0) != pm.stride(0):
        rs, pm = rs.contiguous(), pm.contiguous()
    vs = _rows2d(vals_s, B, S)
    d2 = _rows2d(d, B, T)
    o2 = out.reshape(B, out.shape[-1])
    if o2.data_ptr() != out.data_ptr() or (out.shape[-1] > 1 and o2.stride(1) != 1):
        raise ValueError("out must be a writable view with unit inner stride")
    db_ptr, db_stride = None, 0
    if dbeta is not None:
        if dbeta.dtype != torch.float32 or dbeta.shape != d.shape:
            raise ValueError(f"dbeta must be float32 {tuple(d.shape)}")
        db2 = dbeta.reshape(B, T)
        if db2.data_ptr() != dbeta.data_ptr() or (T > 1 and db2.stride(1) != 1):
            raise ValueError("dbeta must be a writable view with unit inner stride")
        db_ptr, db_stride = db2.data_ptr(), db2.stride(0)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = _launcher()(rs.data_ptr(), pm.data_ptr(), rs.stride(0), vs.data_ptr(),
                      vs.stride(0), d2.data_ptr(), d2.stride(0), o2.data_ptr(),
                      o2.stride(0), db_ptr, db_stride, None, 0, B, S, T, K,
                      int(n_loc), float(sign), stream)
    if err:
        raise RuntimeError(f"slab_spmv launch failed: cudaError {err}")
    launches += 1
    return out


# allow[torch-kernel-plain]: a mode of slab_spmv's kernel, whose plain version is ref.slab_path_spmv_scatter
def slab_path_spmv_kernel(order: SlabOrder, vals, lam_idx, betas, out, *, n_loc: int):
    """out (..., n_out) += X_F beta_{lam_idx[i]} on the card, in place: the
    slab (..., T, K) by its row-sorted ``order`` (with its values) and
    float32 ``vals``; ``lam_idx`` (n_loc,) int32 picks each example row's
    coefficient row of ``betas`` (L, ..., T), whose inner two strides are
    read as they are (batch row b's block at b * betas.stride(-2)). A
    sentinel slot never reads ``lam_idx``. At a uniform ``lam_idx == l``
    the result is bit-equal to :func:`slab_spmv_kernel` with d =
    ``betas[l]``. Returns ``out``."""
    global path_launches
    *lead, T, K = vals.shape
    S = T * K
    B = 1
    for s in lead:
        B *= s
    for t in (order.rows_s, order.perm, vals, lam_idx, betas, out):
        if not t.is_cuda or t.device != vals.device:
            raise ValueError("slab_path_spmv takes CUDA tensors on one device")
    if order.rows_s.dtype != torch.int32 or order.perm.dtype != torch.int32:
        raise TypeError("the slab order must be int32")
    if lam_idx.dtype != torch.int32 or tuple(lam_idx.shape) != (n_loc,):
        raise ValueError(f"lam_idx must be int32 ({n_loc},), got {lam_idx.dtype} "
                         f"{tuple(lam_idx.shape)}")
    if any(t.dtype != torch.float32 for t in (vals, betas, out)):
        raise TypeError("vals, betas and out must be float32")
    if tuple(order.rows_s.shape) != (*lead, S) or order.perm.shape != order.rows_s.shape:
        raise ValueError(f"order must be {(*lead, S)}, got {tuple(order.rows_s.shape)}")
    if betas.dim() != len(lead) + 2 or tuple(betas.shape[1:]) != (*lead, T):
        raise ValueError(f"betas must be (L, *{lead}, {T}), got {tuple(betas.shape)}")
    if tuple(out.shape[:-1]) != tuple(lead) or out.shape[-1] < n_loc:
        raise ValueError(f"out must be (*{lead}, >= {n_loc}), got {tuple(out.shape)}")
    if B > 65535:
        raise ValueError(f"batch of {B} feature blocks exceeds the grid's 65535")
    vals_s = order.vals_s
    if vals_s is None:
        raise ValueError("the order lacks its values: build it with slab_order(rows, vals)")
    if vals_s.dtype != torch.float32 or vals_s.shape != order.rows_s.shape:
        raise ValueError(f"order.vals_s must be float32 {(*lead, S)}")
    rs, pm = _rows2d(order.rows_s, B, S), _rows2d(order.perm, B, S)
    if rs.stride(0) != pm.stride(0):
        rs, pm = rs.contiguous(), pm.contiguous()
    vs = _rows2d(vals_s, B, S)
    b3 = betas.reshape(betas.shape[0], B, T)
    if b3.data_ptr() != betas.data_ptr() or (T > 1 and b3.stride(2) != 1):
        raise ValueError("betas must be a view with unit inner stride")
    li = lam_idx.contiguous()
    o2 = out.reshape(B, out.shape[-1])
    if o2.data_ptr() != out.data_ptr() or (out.shape[-1] > 1 and o2.stride(1) != 1):
        raise ValueError("out must be a writable view with unit inner stride")
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = _launcher()(rs.data_ptr(), pm.data_ptr(), rs.stride(0), vs.data_ptr(),
                      vs.stride(0), b3.data_ptr(), b3.stride(1), o2.data_ptr(),
                      o2.stride(0), None, 0, li.data_ptr(), b3.stride(0), B, S, T, K,
                      int(n_loc), 1.0, stream)
    if err:
        raise RuntimeError(f"slab_path_spmv launch failed: cudaError {err}")
    path_launches += 1
    return out
