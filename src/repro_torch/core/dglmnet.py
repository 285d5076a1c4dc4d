# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""d-GLMNET (paper Algorithms 1-3) on one device, simulating M machines by
feature blocks: the counterpart of ``repro/core/dglmnet.py``.

* :class:`DGLMNETOptions` -- the reference's option bundle, same fields
  and the same eager validation. ``use_kernel`` is kept so bundles match,
  but the tensors' device, not an option, picks kernels or plain
  versions; ``device_budget_bytes`` is the mesh slab designs' residency
  budget (``api.strategy``, ``data.residency``).
* :func:`_iteration` -- one outer iteration, batched over the M blocks,
  on X laid out by ``layout_blocks``; :func:`dglmnet_iteration` the same
  on a dense X (the reference's jitted ``dglmnet_iteration``).
* :func:`fit` -- delegates to the front door
  ``repro_torch.api.LogisticL1``.
* :func:`fit_python_loop` -- the host-driven outer loop, the engine's
  oracle: one counted host read per iteration and one at the stop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import engine
from repro_torch.core.linesearch import f_alpha, line_search
from repro_torch.core.objective import margins, objective, working_stats
from repro_torch.core.subproblem import (
    layout_blocks,
    layout_coefs,
    solve_subproblem,
    unlayout_coefs,
)
from repro_torch.device import DEFAULT_DEVICE, resolve_device

_CYCLE_MODES = ("sequential", "blocked", "auto")
_METHODS = ("gram", "blocked", "residual", "jacobi")


@dataclass(frozen=True)
class DGLMNETOptions:
    num_blocks: int = 1              # M simulated machines (feature blocks)
    method: str = "gram"             # gram | blocked | residual | jacobi
    tile: int = 128                  # Gram tile size
    n_cycles: int = 1                # CD cycles per subproblem (paper: 1)
    use_kernel: bool = False         # kept for parity; the device decides
    max_iters: int = 100
    rel_tol: float = 1e-6            # relative objective decrease stop
    snap_tol: float = 1e-4           # alpha->1 snap-back tolerance (relative)
    nu: float = 1e-6
    # within-tile CD cycle: "sequential" (exact chain, the default),
    # "blocked" (semi-parallel B-wide Jacobi blocks with the Gershgorin
    # safeguard), or "auto" (kernels.ops.prefer_blocked_cd heuristic)
    cycle_mode: str = "sequential"
    block: int = 16                  # B: coordinates per semi-parallel block
    # device-residency budget for mesh slab layouts: below the padded
    # slab bytes the buckets stream from the host through every pass
    device_budget_bytes: Optional[int] = None

    def __post_init__(self):
        if self.cycle_mode not in _CYCLE_MODES:
            raise ValueError(
                f"unknown cycle_mode {self.cycle_mode!r}: expected one of "
                f"{_CYCLE_MODES} (the within-tile CD cycle flavour)"
            )
        if self.method not in _METHODS:
            raise ValueError(
                f"unknown method {self.method!r}: expected one of {_METHODS}"
            )
        if self.block < 1 or (self.block & (self.block - 1)):
            raise ValueError(
                f"block must be a power of two >= 1 (the Gershgorin "
                f"safeguard halves it down to 1), got {self.block}"
            )
        if self.tile < 1:
            raise ValueError(f"tile must be >= 1, got {self.tile}")
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {self.num_blocks}")
        if self.n_cycles < 1:
            raise ValueError(f"n_cycles must be >= 1, got {self.n_cycles}")
        if self.max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {self.max_iters}")
        if self.device_budget_bytes is not None \
                and self.device_budget_bytes < 1:
            raise ValueError(
                f"device_budget_bytes must be a positive byte count (or "
                f"None for fully-resident slabs), got "
                f"{self.device_budget_bytes}")


class FitState(NamedTuple):
    beta: torch.Tensor
    m: torch.Tensor                  # margin cache X @ beta
    f: torch.Tensor                  # objective value


@dataclass
class FitResult:
    beta: torch.Tensor
    f: float
    n_iters: int
    objective_history: List[float] = field(default_factory=list)
    alpha_history: List[float] = field(default_factory=list)
    unit_step_frac: float = 0.0
    converged: bool = False
    # engine.STATUS_* code; non-OK means the solve tripped a guardrail and
    # beta/f are the last certified iterate, not the final proposed step
    status: int = 0

    @property
    def nnz(self) -> int:
        return int((self.beta.abs() > 0).sum())

    @property
    def status_name(self) -> str:
        return engine.status_name(self.status)

    @property
    def ok(self) -> bool:
        return self.status == engine.STATUS_OK


def _iteration(Xt, y, beta, m, lam, opts: DGLMNETOptions, w=None, z=None):
    """One outer iteration: the M block subproblems at once -> combined
    (dbeta, dm, grad_dot).

    ``Xt`` is X laid out by ``core.subproblem.layout_blocks`` (M, nt, n,
    tile). The blocks are solved as one batch -- the same math as M
    machines solving independently (block-diagonal Hessian, paper eq.
    (9)). The engine passes the fused working stats (w, z) in.
    """
    if w is None:
        w, z = working_stats(m, y)
    p = beta.shape[0]
    bt = layout_coefs(beta, opts.num_blocks, opts.tile)
    dbeta_t, dm_b = solve_subproblem(
        Xt, w, z, bt, lam, method=opts.method, n_cycles=opts.n_cycles,
        nu=opts.nu, cycle_mode=opts.cycle_mode, block=opts.block)
    dbeta = unlayout_coefs(dbeta_t, p)                # "MPI_AllReduce" concat
    dm = dm_b.sum(0)                                  # sum of block margins
    # grad(L)^T dbeta from margins only: (p - (y+1)/2)^T dm
    grad_dot = torch.dot(torch.sigmoid(m) - (y + 1.0) * 0.5, dm)
    return dbeta, dm, grad_dot


def dglmnet_iteration(X, y, beta, m, lam, opts: DGLMNETOptions):
    """One outer iteration on a dense X (n, p): X laid out into the M
    blocks' tiles (one copy), then :func:`_iteration`. Returns (dbeta, dm,
    grad_dot)."""
    return _iteration(layout_blocks(X, opts.num_blocks, opts.tile), y, beta, m, lam, opts)


def build_solver(opts: DGLMNETOptions, *, fault=None):
    """The engine's outer loop with this bundle's iteration plugged in;
    ``fault`` (a ``resilience.EngineFault``) poisons one iteration."""

    def iteration(Xt, y, beta, m, lam, w, z):
        return _iteration(Xt, y, beta, m, lam, opts, w, z)

    return engine.make_solver(iteration, max_iters=opts.max_iters,
                              rel_tol=opts.rel_tol, snap_tol=opts.snap_tol, fault=fault)


def fit(X, y, lam: float, *, beta0: Optional[torch.Tensor] = None,
        opts: DGLMNETOptions = DGLMNETOptions(), device=DEFAULT_DEVICE,
        verbose: bool = False) -> FitResult:
    """Paper Algorithm 1 with the Algorithm 3 line search; delegates to the
    front door ``LogisticL1(opts, device=device).fit(DenseDesign(X), ...)``."""
    from repro_torch.api import DenseDesign, LogisticL1

    return LogisticL1(opts=opts, device=device).fit(
        DenseDesign(X), y, lam, beta0=beta0, verbose=verbose)


def fit_python_loop(X, y, lam: float, *, beta0: Optional[torch.Tensor] = None,
                    opts: DGLMNETOptions = DGLMNETOptions(), device=DEFAULT_DEVICE,
                    verbose: bool = False) -> FitResult:
    """The reference's host-driven outer loop, the oracle of the engine
    (``core/engine.py``): the same math as :func:`fit`, with the stop
    decided on the host in double from one counted read per iteration
    (alpha, the new objective and the unit-step flag, packed), one read of
    f(beta0) and one of the snap-back's f(alpha = 1) at the stop."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    p = X.shape[1]
    beta = (torch.zeros(p, dtype=torch.float32, device=dev) if beta0 is None
            else torch.as_tensor(beta0, dtype=torch.float32, device=dev))
    Xt = layout_blocks(X, opts.num_blocks, opts.tile)
    m = margins(X, beta)
    f = objective(m, y, beta, lam)

    hist, alphas = [engine.host_read(f)], []
    unit_steps = 0
    converged = False
    it = 0

    for it in range(1, opts.max_iters + 1):
        dbeta, dm, grad_dot = _iteration(Xt, y, beta, m, lam, opts)
        res = line_search(m, dm, y, beta, dbeta, lam, grad_dot)
        alpha, f_new, unit = engine.host_read(torch.stack(
            [res.alpha, res.f_new, res.took_unit_step.to(torch.float32)]))
        unit_steps += int(unit)
        alphas.append(alpha)

        rel_dec = (hist[-1] - f_new) / max(abs(hist[-1]), 1e-12)
        stop = rel_dec < opts.rel_tol or it == opts.max_iters

        if stop:
            # Sparsity snap-back: prefer alpha = 1 if the objective increase
            # is tolerable (keeps coordinates that landed exactly on 0). The
            # histories report the applied step: the recorded alpha is
            # overwritten and the promoted unit step counted.
            f_unit = engine.host_read(f_alpha(1.0, m, dm, y, beta, dbeta, lam))
            if f_unit <= f_new * (1.0 + opts.snap_tol) + 1e-12:
                if alpha != 1.0:
                    unit_steps += 1
                alpha, f_new = 1.0, f_unit
                alphas[-1] = alpha
            beta = beta + alpha * dbeta
            m = m + alpha * dm
            hist.append(f_new)
            converged = rel_dec < opts.rel_tol
            break

        beta = beta + alpha * dbeta
        m = m + alpha * dm
        hist.append(f_new)
        if verbose:
            print(f"  iter {it:3d}  f={hist[-1]:.6f}  alpha={alpha:.4f}")

    return FitResult(
        beta=beta,
        f=hist[-1],
        n_iters=it,
        objective_history=hist,
        alpha_history=alphas,
        unit_step_frac=unit_steps / max(it, 1),
        converged=converged,
    )
