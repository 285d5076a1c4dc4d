# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Line search (paper Algorithm 3), the counterpart of
``repro/core/linesearch.py``.

All evaluations are O(n + p) from the cached margins m = X@beta and
dm = X@dbeta:

    f(beta + a*dbeta) = sum_i softplus(-y (m + a dm)) + lam ||beta + a dbeta||_1

1. If a = 1 satisfies the Armijo test, take it (sparsity safeguard).
2. a_init = argmin_{delta<=a<=1} f(beta + a dbeta)  (golden section).
3. Armijo backtracking from a_init: f(a) <= f(0) + a*sigma*D.

The reference branches with ``lax.cond`` and ``while_loop`` on device.
Eager PyTorch cannot branch on a device value without reading it on the
host, so both branches are computed and ``torch.where`` selects: the
golden section always runs, and the backtracking ladder a_init * b^k,
k = 0..MAX_BACKTRACKS, is evaluated in one batch and the first accepted
rung taken (the reference's loop stops there, or at the last rung).
Nothing here reads a value on the host.

On a process mesh the margins are the rank's example shard and
``reduce`` sums each evaluation's NLL partials over the ``data`` axis:
one reduction per batch of trial points (both points of a golden
step, the whole ladder), so every rank selects from the same values.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.objective import l1_norm, neg_log_likelihood

GOLD = 0.6180339887498949

# Backtracking budget (b = 0.5 halving); exhausting it without an accepted
# step is the engine's LINESEARCH_STALLED trip-wire.
MAX_BACKTRACKS = 30


class LineSearchResult(NamedTuple):
    alpha: torch.Tensor
    f_new: torch.Tensor
    took_unit_step: torch.Tensor      # bool: step-1 short-circuit hit
    backtracks: torch.Tensor


def f_alpha(alpha, m, dm, y, beta, dbeta, lam, reduce=None):
    """f(beta + alpha dbeta) for a scalar alpha, or for each entry of a
    1-D tensor of alphas (one batched pass); ``reduce`` sums the NLL
    partials of a process mesh's example shards (all alphas at once)."""
    a = alpha[:, None] if torch.is_tensor(alpha) and alpha.dim() == 1 else alpha
    nll = neg_log_likelihood(m + a * dm, y)
    if reduce is not None:
        nll = reduce(nll)
    return nll + lam * l1_norm(beta + a * dbeta)


def armijo_D(grad_dot_dbeta, quad_term, beta, dbeta, lam, gamma=0.0):
    """D = grad(L)^T dbeta + gamma*dbeta^T H dbeta + lam(|beta+dbeta| - |beta|)."""
    return (grad_dot_dbeta + gamma * quad_term
            + lam * (l1_norm(beta + dbeta) - l1_norm(beta)))


def golden_section(fun, lo, hi, iters: int = 24):
    """Minimize a unimodal scalar function on [lo, hi] (fixed iterations).
    ``fun`` takes a 1-D tensor of points; each iteration evaluates its
    two new points in one call."""
    c = hi - GOLD * (hi - lo)
    d = lo + GOLD * (hi - lo)
    fc, fd = fun(torch.stack([c, d]))
    a, b = lo, hi
    for _ in range(iters):
        shrink = fc < fd
        b = torch.where(shrink, d, b)
        a = torch.where(shrink, a, c)
        c = b - GOLD * (b - a)
        d = a + GOLD * (b - a)
        fc, fd = fun(torch.stack([c, d]))
    return 0.5 * (a + b)


def line_search(m, dm, y, beta, dbeta, lam, grad_dot_dbeta, quad_term=0.0, *,
                f0=None, max_backtracks: int = MAX_BACKTRACKS, b: float = 0.5,
                sigma: float = 0.01, gamma: float = 0.0, delta: float = 1e-3,
                reduce=None) -> LineSearchResult:
    """Algorithm 3 from cached margins; ``f0`` is f(alpha=0) when the
    caller already holds it (the engine's fused-stats NLL), reduced;
    ``grad_dot_dbeta`` is reduced too."""
    dev = m.device
    if f0 is None:
        f0 = f_alpha(0.0, m, dm, y, beta, dbeta, lam, reduce)
    D = armijo_D(grad_dot_dbeta, quad_term, beta, dbeta, lam, gamma)
    f1 = f_alpha(1.0, m, dm, y, beta, dbeta, lam, reduce)
    unit_ok = f1 <= f0 + sigma * D

    def fun(a):
        return f_alpha(a, m, dm, y, beta, dbeta, lam, reduce)

    # scalars made on the device by a fill (a host->device copy would wait)
    lo = torch.full((), delta, dtype=torch.float32, device=dev)
    hi = torch.full((), 1.0, dtype=torch.float32, device=dev)
    a_init = golden_section(fun, lo, hi)
    # the ladder a_init * b^k, k = 0..max_backtracks (b a power of two makes
    # every rung exactly the reference's repeated product)
    k = torch.arange(max_backtracks + 1, device=dev)
    ladder = a_init * torch.pow(torch.full((), b, dtype=torch.float32, device=dev), k)
    f_ladder = fun(ladder)
    # the reference's loop continues while f(a) > f0 + a sigma D, and ends
    # at the budget (no item assignment: a host scalar written into a
    # device tensor would wait for the device)
    accept = torch.logical_not(f_ladder > f0 + ladder * sigma * D) | (k == max_backtracks)
    first = torch.argmax(accept.to(torch.int32)).reshape(1)
    return LineSearchResult(
        alpha=torch.where(unit_ok, hi, ladder.gather(0, first)[0]),
        f_new=torch.where(unit_ok, f1, f_ladder.gather(0, first)[0]),
        took_unit_step=unit_ok,
        backtracks=torch.where(unit_ok, 0, first[0]).to(torch.int32),
    )
