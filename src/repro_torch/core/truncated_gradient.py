# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Baseline: distributed online learning via truncated gradient, the
counterpart of ``repro/core/truncated_gradient.py``.

The paper's comparison system (section 4.3): Langford et al. (2009)
truncated-gradient online updates for L1 logistic regression, made
distributed per Agarwal et al. (2011) Algorithm 2 (first part): M
machines train independently on example shards, the parameters are
averaged after each pass and warm-start the next pass (the Vowpal Wabbit
protocol; VW's ``--l1 arg`` is lambda / n, mirrored here).

Torch mapping: the reference vmaps the machines and runs each pass as a
``lax.scan``; here one launch of ``kernels.ops.tg_pass`` runs every
machine's pass (one thread block per machine on the card, the plain
version on the host), and the machines' mean is a sum in machine order.
A fit reads nothing on the host: the snapshots stay on the data's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops


@dataclass(frozen=True)
class TGOptions:
    num_machines: int = 16
    passes: int = 25
    learning_rate: float = 0.1       # VW default
    decay: float = 0.5               # per-pass learning-rate decay (VW default)
    theta: float = float("inf")      # truncation threshold (inf = always shrink)


def _f32(x: float) -> float:
    """A host float rounded to float32, as the reference's ``jnp.float32``."""
    return float(np.float32(x))


def shrink(eta: float, gravity: float) -> float:
    """The truncation's step ``eta * gravity``, rounded to float32 as the
    reference multiplies its two float32 scalars: the ``shrink`` argument
    of ``kernels.ops.tg_pass``."""
    return float(np.float32(eta) * np.float32(gravity))


def _tg_pass(Xs, ys, beta, eta: float, gravity: float, theta: float):
    """One sequential online pass per machine with truncated gradient:
    Xs (M, n_per, p), ys (M, n_per), the shared warm start beta (p,) ->
    each machine's beta (M, p)."""
    return ops.tg_pass(Xs, ys, beta, _f32(eta), shrink(eta, gravity), _f32(theta))


def _tg_round(Xs, ys, beta, eta: float, gravity: float, opts: TGOptions):
    """One distributed round: each machine passes over its shard from the
    shared warm start; the results are averaged (Agarwal et al. Alg. 2),
    summed in machine order."""
    betas = _tg_pass(Xs, ys, beta, eta, gravity, opts.theta)
    total = betas[0]
    for b in betas[1:]:
        total = total + b
    return total / betas.shape[0]


def truncated_gradient_fit(
    X,
    y,
    lam: float,
    *,
    opts: TGOptions = TGOptions(),
    generator: Optional[torch.Generator] = None,
    snapshot_every: int = 1,
    device=DEFAULT_DEVICE,
) -> List[Tuple[int, torch.Tensor]]:
    """Returns [(pass_idx, beta)] snapshots (the paper saves beta after each
    pass and evaluates all of them on the test set), each beta on
    ``device``. ``generator`` (a generator on ``device``) shuffles the
    examples first by ``torch.randperm``; None keeps their order (the
    reference's ``key=None``)."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    n, p = X.shape
    m = opts.num_machines
    n_per = n // m
    if generator is not None:
        perm = torch.randperm(n, generator=generator, device=X.device)
        X, y = X[perm], y[perm]
    Xs = X[: n_per * m].reshape(m, n_per, p).contiguous()
    ys = y[: n_per * m].reshape(m, n_per).contiguous()

    gravity = lam / n                      # VW: --l1 arg = lambda / n
    beta = torch.zeros(p, dtype=torch.float32, device=X.device)
    snapshots = []
    for pass_idx in range(opts.passes):
        eta = opts.learning_rate * (opts.decay ** pass_idx)
        beta = _tg_round(Xs, ys, beta, eta, gravity, opts)
        if (pass_idx + 1) % snapshot_every == 0:
            snapshots.append((pass_idx + 1, beta))
    return snapshots
