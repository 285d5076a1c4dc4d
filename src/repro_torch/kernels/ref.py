# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Plain PyTorch versions of every kernel of the port, the counterpart of
``repro/kernels/ref.py``. The CPU path runs them, and the card's kernels
are held against them."""
from __future__ import annotations

import torch

from repro_torch.core.objective import P_EPS, W_MIN, softplus
from repro_torch.core.subproblem import NU, cd_cycle_blocked_tile, cd_cycle_gram_tile


def logistic_stats_ref(m, y):
    """(w, z, nll) from margins: the fused working-statistics pass."""
    m = m.to(torch.float32)
    y = y.to(torch.float32)
    p = torch.sigmoid(m).clamp(P_EPS, 1.0 - P_EPS)
    w = torch.clamp_min(p * (1.0 - p), W_MIN)
    z = ((y + 1.0) * 0.5 - p) / w
    nll = softplus(-y * m).sum()
    return w, z, nll


def gram_cd_ref(G, c, beta, dbeta0, lam, nu=NU):
    """Plain version of kernels.gram_cd: the sequential chain, reading
    row j of G (batched over leading axes)."""
    f32 = torch.float32
    return cd_cycle_gram_tile(G.to(f32), c.to(f32), beta.to(f32),
                              dbeta0.to(f32), lam, nu)


def blocked_cd_ref(G, c, beta, dbeta0, lam, nu=NU, *, block=16):
    """Plain version of kernels.blocked_cd: the blocked cycle (bit-identical
    to the sequential chain at block=1)."""
    f32 = torch.float32
    return cd_cycle_blocked_tile(G.to(f32), c.to(f32), beta.to(f32),
                                 dbeta0.to(f32), lam, nu, block=block)
