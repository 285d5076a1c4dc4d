# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""CUDA kernel: fused logistic working statistics, the NLL reduced in the
same launch.

Replaces the TPU kernel ``repro/kernels/logistic_stats.py``
``logistic_stats_pallas`` (its ``pl.pallas_call`` at line 50); source
``csrc/logistic_stats.cu``. One pass over the margin cache computes
everything the outer iteration needs from the examples axis (paper eq.
(4)):

    p = clip(sigmoid(m), 1e-5, 1 - 1e-5), w = max(p(1-p), 1e-6),
    z = ((y+1)/2 - p)/w, and nll = sum softplus(-y m)

Bound on the H100: device memory. Each example moves 16 bytes (m and y
in, w and z out) for some twenty flops, far below the card's ratio of
operations to bytes. The design keeps the call to that one sweep and one
launch: a grid-stride pass sized to the SM count (:func:`grid`), float4
loads and stores where aligned, and the NLL reduced in a fixed order in
the same launch -- one partial per block, summed in block order by the
last block to finish (an integer ticket), which then resets the ticket.
No float atomics and no host read, so repeated launches are bit-identical
and the call can be captured in a CUDA graph. The ticket and the
partials are per-device buffers allocated once.

Accuracy: z = ((y+1)/2 - p) / (p(1-p)) cancels in 1 - p as p -> 1, so one
ulp of p moves z by up to ~4e-4 relative. The kernel therefore computes p
as PyTorch's CUDA sigmoid does -- libdevice's expf and a correctly
rounded division -- and every other operation with explicit rounding, so
it matches the plain version (``ref.logistic_stats_ref``) to rounding.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

#: threads per block (THREADS in the source)
THREADS = 256
#: most blocks per SM of the grid-stride pass
BLOCKS_PER_SM = 4

#: launches of the kernel since the last reset (see kernels.ops)
launches = 0

_lib = None
#: per device: (SM count, partials buffer, ticket)
_state: Dict[int, Tuple[int, torch.Tensor, torch.Tensor]] = {}


def grid(n: int, vec: bool, sms: int) -> int:
    """Blocks of the launch for n examples on a card of ``sms`` SMs: one
    thread per float4 (``vec``) or per example, at most BLOCKS_PER_SM per
    SM. The NLL's sum order depends on n, ``vec`` and this alone."""
    units = n // 4 if vec else n
    return max(1, min(-(-units // THREADS), BLOCKS_PER_SM * sms))


def _launcher():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load

        lib = load("logistic_stats")
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.logistic_stats_launch.argtypes = [p, p, p, p, q, i, i, p, p, p, p]
        lib.logistic_stats_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.logistic_stats_launch


def _device_state(dev: torch.device):
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    st = _state.get(idx)
    if st is None:
        sms = torch.cuda.get_device_properties(idx).multi_processor_count
        partials = torch.empty(BLOCKS_PER_SM * sms, dtype=torch.float32, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        st = _state[idx] = (sms, partials, ticket)
    return st


def logistic_stats_kernel(m: torch.Tensor, y: torch.Tensor):
    """(w, z, nll) from margins m and labels y, both (n,) float32 contiguous
    CUDA tensors; nll is a 0-d tensor. One launch on the current stream."""
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
    sms, partials, ticket = _device_state(m.device)
    w = torch.empty_like(m)
    z = torch.empty_like(m)
    nll = torch.empty((), dtype=torch.float32, device=m.device)
    vec = all(t.data_ptr() % 16 == 0 for t in (m, y, w, z))
    stream = torch.cuda.current_stream(m.device).cuda_stream
    err = _launcher()(m.data_ptr(), y.data_ptr(), w.data_ptr(), z.data_ptr(), n,
                      int(vec), grid(n, vec, sms), partials.data_ptr(),
                      ticket.data_ptr(), nll.data_ptr(), stream)
    if err:
        raise RuntimeError(f"logistic_stats launch failed: cudaError {err}")
    launches += 1
    return w, z, nll
