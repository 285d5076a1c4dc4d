# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Kernel dispatch, the counterpart of ``repro/kernels/ops.py``.

Every solver-facing kernel call goes through here, and the tensor's
device picks the implementation:

* a CUDA tensor launches the hand-written kernel (and raises if the
  kernel cannot build or launch -- there is no fallback);
* a CPU tensor runs the plain PyTorch version in ``kernels.ref``;
* any other device raises.

Each kernel module counts its own launches (``<module>.launches``);
:func:`launch_counts` reads them and :func:`reset_launch_counts` zeroes
them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.subproblem import NU
from repro_torch.kernels import blocked_cd as _blocked_cd
from repro_torch.kernels import gram_cd as _gram_cd
from repro_torch.kernels import logistic_stats as _logistic_stats
from repro_torch.kernels import ref

_KERNELS = {
    "logistic_stats": _logistic_stats,
    "gram_cd": _gram_cd,
    "blocked_cd": _blocked_cd,
}


def launch_counts() -> Dict[str, int]:
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def _on_cuda(*tensors) -> bool:
    """True for CUDA operands, False for CPU ones; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on mixed devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type == "cuda"


def logistic_stats(m, y):
    """Fused (w, z, nll) from margins -- one pass over the examples axis;
    the dispatch point the outer iteration uses (core/engine.py)."""
    if _on_cuda(m, y):
        return _logistic_stats.logistic_stats_kernel(m, y)
    return ref.logistic_stats_ref(m, y)


def gram_cd(G, c, beta, dbeta0, lam, nu=NU):
    """One sequential CD cycle on Gram tiles (M, F, F); returns d (M, F)."""
    if _on_cuda(G, c, beta, dbeta0):
        return _gram_cd.gram_cd_kernel(
            G.contiguous(), c.contiguous(), beta.contiguous(),
            dbeta0.contiguous(), lam, nu)
    return ref.gram_cd_ref(G, c, beta, dbeta0, lam, nu)


def prefer_blocked_cd(f: int, block: int) -> bool:
    """Tile-size heuristic for `cycle_mode="auto"`: the blocked cycle wins
    when it meaningfully shortens the dependent-step chain — at least two
    blocks per tile and a tile wide enough (F >= 32) that the F-step
    scalar chain, not the Gram matmul, dominates the tile (CPU-measured;
    the `--cycle` bench section tracks the crossover). Below that, or at
    block=1 (== the sequential chain), dispatch stays on ``gram_cd``."""
    return block > 1 and f >= 2 * block and f >= 32


def blocked_cd(G, c, beta, dbeta0, lam, nu=NU, *, block: int = 16):
    """Blocked semi-parallel CD cycle on Gram tiles (F/B dependent steps
    instead of F); same contract as :func:`gram_cd`."""
    if _on_cuda(G, c, beta, dbeta0):
        return _blocked_cd.blocked_cd_kernel(
            G.contiguous(), c.contiguous(), beta.contiguous(),
            dbeta0.contiguous(), lam, nu, block=block)
    return ref.blocked_cd_ref(G, c, beta, dbeta0, lam, nu, block=block)
