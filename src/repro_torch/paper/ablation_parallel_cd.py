# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Ablation: why the paper's design (sequential CD within blocks, a
block-diagonal Hessian across blocks, one global line search) beats fully
parallel coordinate updates (Shotgun-style Jacobi, Bradley et al. 2011 --
the conflict problem of the paper's section 1), and where the blocked
semi-parallel cycle sits between the two. The counterpart of
``benchmarks/ablation_parallel_cd.py``, with its grid: n = 4096, p = 256,
rho in (0, 0.5, 0.9); sequential, blocked-B4 ... B32 and jacobi; M = 1
and 16; lambda_max / 32; the reference optimum from a 200-iteration
sequential fit at rel_tol 1e-10.

Per (rho, method, M): iterations, iterations to reach the reference
objective within ``TOL``, the convergence flag, the final relative gap and
the warm wall time per outer iteration. The data is drawn by numpy (the
reference's ``jax.random`` draws cannot be replayed)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.paper.common import Timer, emit

TOL = 1e-4          # iterations-to-tolerance: rel gap vs reference optimum
SHAPES = {"twin": (4096, 256), "tiny": (512, 64)}
RHOS = (0.0, 0.5, 0.9)
MACHINES = (1, 16)


def correlated_dataset(rng: np.random.Generator, n: int, p: int, rho: float):
    """Equicorrelated-ish features: x = sqrt(1-rho) z + sqrt(rho) shared;
    a 10% sparse truth of scale 3; logistic labels in {-1, +1}."""
    z = rng.standard_normal((n, p), dtype=np.float32)
    shared = rng.standard_normal((n, 1), dtype=np.float32)
    X = (np.sqrt(1 - rho) * z + np.sqrt(rho) * shared).astype(np.float32)
    beta_true = np.where(rng.random(p) < 0.1, rng.standard_normal(p) * 3.0, 0.0)
    prob = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = np.where(rng.random(n) < prob, 1.0, -1.0).astype(np.float32)
    return X, y


def iters_to_tol(history, f_ref, tol=TOL):
    """First outer iteration whose objective is within ``tol`` (relative)
    of the reference optimum; -1 if the run never got there."""
    for i, f in enumerate(history):
        if (f - f_ref) / abs(f_ref) < tol:
            return i
    return -1


def sweep_methods():
    """The three-way method grid: label -> DGLMNETOptions overrides."""
    grid = [("sequential", dict(method="gram"))]
    for b in (4, 8, 16, 32):
        grid.append((f"blocked-B{b}", dict(method="gram", cycle_mode="blocked", block=b)))
    grid.append(("jacobi", dict(method="jacobi")))
    return grid


def run(scale: str = "twin", device="cuda", *, warmup: bool = True):
    """Every (rho, method, M) cell; ``warmup`` runs each fit once untimed
    first, as the reference compiles it (``chip_smoke.py`` skips it: the
    card is warm by then). Returns one dict per cell."""
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions, fit
    from repro_torch.core.objective import lambda_max
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n, p = SHAPES[scale]
    out = []
    print("# rho,method,M,iters,iters_to_tol,converged,final_gap,warm_ms_per_iter")
    for rho in RHOS:
        X, y = correlated_dataset(np.random.default_rng([42, int(rho * 10)]), n, p, rho)
        X = torch.from_numpy(X).to(dev)
        y = torch.from_numpy(y).to(dev)
        lam = engine.host_read(lambda_max(X, y)) / 32
        ref = fit(X, y, lam, opts=DGLMNETOptions(num_blocks=1, method="gram", tile=64,
                                                 max_iters=200, rel_tol=1e-10),
                  device=device)
        for label, overrides in sweep_methods():
            for m in MACHINES:
                opts = DGLMNETOptions(num_blocks=m, tile=64, max_iters=150, **overrides)
                if warmup:
                    fit(X, y, lam, opts=opts, device=device)
                with Timer(device) as t:
                    res = fit(X, y, lam, opts=opts, device=device)
                gap = (res.f - ref.f) / abs(ref.f)
                itt = iters_to_tol(res.objective_history, ref.f)
                per_iter_us = t.dt * 1e6 / max(res.n_iters, 1)
                print(f"# {rho},{label},{m},{res.n_iters},{itt},"
                      f"{res.converged},{gap:.2e},{per_iter_us / 1e3:.2f}")
                emit(f"ablation.rho{rho}.{label}.M{m}", per_iter_us,
                     f"iters={res.n_iters};to_tol={itt};gap={gap:.1e}")
                out.append({"rho": rho, "method": label, "M": m, "iters": res.n_iters,
                            "to_tol": itt, "converged": res.converged, "gap": gap,
                            "f": res.f, "status": res.status_name,
                            "ms_per_iter": per_iter_us / 1e3})
    return out
