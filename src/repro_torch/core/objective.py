# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""L1-regularized logistic regression objective (paper eq. (1)-(4)),
the counterpart of ``repro/core/objective.py``.

All functions work from the margin cache m_i = beta^T x_i, so every
line-search/objective evaluation is O(n + p), never a pass over X.
Conventions: y in {-1, +1}; X dense (n, p) float32.
"""
from __future__ import annotations

import torch

# numerical guards (BBR/GLMNET-style probability clamp)
P_EPS = 1e-5
W_MIN = 1e-6


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as max(x, 0) + log1p(exp(-|x|)): no overflow at any
    |x| (``jax.nn.softplus``'s logaddexp form)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def margins(X: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    return X @ beta


def neg_log_likelihood(m: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """L(beta) = sum_i log(1 + exp(-y_i m_i)), computed stably; sums over
    the last axis."""
    return softplus(-y * m).sum(-1)


def l1_norm(beta: torch.Tensor) -> torch.Tensor:
    return beta.abs().sum(-1)


def objective(m, y, beta, lam, reduce=None) -> torch.Tensor:
    """f(beta) = L(beta) + lam * ||beta||_1, from cached margins. On a
    process mesh ``m`` and ``y`` are the rank's example shard and
    ``reduce`` (``mesh.all_reduce`` over ``data``) sums the NLL's
    partials; ``beta`` is whole on every rank."""
    nll = neg_log_likelihood(m, y)
    return (nll if reduce is None else reduce(nll)) + lam * l1_norm(beta)


def working_stats(m: torch.Tensor, y: torch.Tensor):
    """GLMNET working responses (paper eq. (4)): p = sigmoid(m) clamped to
    [P_EPS, 1 - P_EPS], w = max(p(1-p), W_MIN), z = ((y+1)/2 - p)/w."""
    p = torch.sigmoid(m).clamp(P_EPS, 1.0 - P_EPS)
    w = torch.clamp_min(p * (1.0 - p), W_MIN)
    z = ((y + 1.0) * 0.5 - p) / w
    return w, z


def grad_nll_from_margins(m, y, X) -> torch.Tensor:
    """nabla L(beta) = X^T (p - (y+1)/2)   (for the Armijo D term)."""
    return X.T @ (torch.sigmoid(m) - (y + 1.0) * 0.5)


def lambda_max(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Smallest lambda for which beta* = 0 (Algorithm 5 start): at beta=0
    the NLL residual is -y/2, so lambda_max = max_j |x_j^T (0.5 y)|."""
    return (X.T @ (0.5 * y)).abs().max()


def soft_threshold(x: torch.Tensor, a) -> torch.Tensor:
    """T(x, a) = sgn(x) max(|x| - a, 0)   (paper eq. (6))."""
    return torch.sign(x) * torch.clamp_min(x.abs() - a, 0.0)
