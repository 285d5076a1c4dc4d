# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: one truncated-gradient pass per machine, the baseline's
inner loop (paper section 4.3).

Replaces no Pallas kernel: the reference's pass is the ``lax.scan`` of
``repro/core/truncated_gradient.py`` ``_tg_pass`` (lines 33-44), which XLA
compiles into one device loop. Eager PyTorch would run it as a host loop
of about seven launches per example -- some 140,000 launches for one pass
over the epsilon cell (n = 320,000, 16 machines) -- so the port gives the
whole pass one launch; source ``csrc/tg_pass.cu``.

Bound on the H100: the chain of ``steps`` dependent block reductions
(each step's dot product feeds the next step's update). Its bytes, X read
once, are far below that. The design: one thread block of ``THREADS``
threads per machine, beta in registers (``per`` coordinates a thread,
:func:`regs_per_thread`), the next row prefetched while the current step
reduces, the margin summed in a fixed order (each thread's coordinates in
order, then a shuffle tree per warp, then the same tree over the warps'
sums), one barrier per step, and no atomics: two launches are bit-equal.

The pass is chaotic at epsilon's width (a rounding difference in one
margin grows to 1e-1 in beta within a pass), so the plain version
(``ref.tg_pass_ref``) repeats the kernel's sum order and rounding op for
op, and both take exp in double: the card and the host then agree.
"""
from __future__ import annotations

import ctypes

import torch

#: threads per block (THREADS in the source)
THREADS = 512
#: instantiated registers-per-thread counts (template values of the source)
PER_CHOICES = (1, 2, 4, 8, 16)
#: the widest beta a block holds on chip
MAX_P = THREADS * PER_CHOICES[-1]

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

_lib = None


class TGWidthError(ValueError):
    """The kernel keeps a machine's beta on chip; wider data is refused
    (there is no fallback on the card)."""


def regs_per_thread(p: int) -> int:
    """The smallest instantiated count of coordinates per thread that
    covers p."""
    if p > MAX_P:
        raise TGWidthError(f"tg_pass keeps beta on chip: p={p} is above its {MAX_P} "
                           f"({THREADS} threads x {PER_CHOICES[-1]} registers)")
    return next(per for per in PER_CHOICES if per * THREADS >= p)


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("tg_pass")
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tg_pass_launch.argtypes = [v, v, v, v, i, i, i, i, f, f, f, v]
        lib.tg_pass_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.tg_pass_launch


def tg_pass_kernel(Xs: torch.Tensor, ys: torch.Tensor, beta: torch.Tensor, eta: float,
                   shrink: float, theta: float) -> torch.Tensor:
    """Each machine's beta after one pass over its shard, (M, p), from Xs
    (M, steps, p), ys (M, steps) and the shared warm start beta (p,), all
    float32 contiguous CUDA tensors on one device. ``eta``, ``shrink``
    (= eta * gravity in float32) and ``theta`` are host floats. One
    launch on the current stream."""
    global launches
    if not (Xs.is_cuda and ys.device == Xs.device and beta.device == Xs.device):
        raise ValueError("tg_pass_kernel takes CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in (Xs, ys, beta)):
        raise TypeError(f"float32 only, got {Xs.dtype}, {ys.dtype}, {beta.dtype}")
    if Xs.dim() != 3 or ys.shape != Xs.shape[:2] or beta.shape != Xs.shape[2:]:
        raise ValueError(f"expected Xs (M, steps, p), ys (M, steps), beta (p,); got "
                         f"{tuple(Xs.shape)}, {tuple(ys.shape)}, {tuple(beta.shape)}")
    if not (Xs.is_contiguous() and ys.is_contiguous() and beta.is_contiguous()):
        raise ValueError("Xs, ys and beta must be contiguous")
    M, steps, p = Xs.shape
    per = regs_per_thread(p)
    out = torch.empty((M, p), dtype=torch.float32, device=Xs.device)
    if M == 0 or p == 0:
        return out
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    err = _launcher()(Xs.data_ptr(), ys.data_ptr(), beta.data_ptr(), out.data_ptr(),
                      M, steps, p, per, eta, shrink, theta, stream)
    if err:
        raise RuntimeError(f"tg_pass launch failed: cudaError {err}")
    launches += 1
    return out
