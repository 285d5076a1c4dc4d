# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""``LogisticL1`` -- the port's front door, the counterpart of
``repro/api/estimator.py``.

This slice ports the local dense cell: ``fit`` (with ``warm_start``),
scoring (``decision_function``, ``predict_proba``, ``predict``) and
the sklearn-style surface. The estimator runs on ``device`` (default
``"cuda"``, raising without a card); data given as numpy arrays or
tensors elsewhere is moved there once, at the entry point.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.api.design import DenseDesign
from repro_torch.api.strategy import Strategy, resolve
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions, FitResult, build_solver
from repro_torch.core.subproblem import layout_blocks
from repro_torch.device import DEFAULT_DEVICE, resolve_device


def _fit_local_dense(X, y, lam, opts: DGLMNETOptions, beta0,
                     verbose: bool) -> FitResult:
    """Single-device dense solve: paper Algorithm 1 with the Algorithm 3
    line search (core/engine.py). X is laid out into (M, nt, n, tile)
    tiles once, here, and freed with the fit."""
    n, p = X.shape
    beta = (torch.zeros(p, dtype=torch.float32, device=X.device)
            if beta0 is None else beta0.to(device=X.device, dtype=torch.float32))
    m = X @ beta
    Xt = layout_blocks(X, opts.num_blocks, opts.tile)
    state = build_solver(opts)(Xt, y, beta, m, lam)
    del Xt
    host, hist, alphas = engine.fetch(state)
    it = host.it
    if verbose:
        for k in range(1, it + 1):
            print(f"  iter {k:3d}  f={hist[k]:.6f}  alpha={alphas[k - 1]:.4f}")
    return FitResult(
        beta=state.beta,
        f=hist[-1],
        n_iters=it,
        objective_history=hist,
        alpha_history=alphas,
        unit_step_frac=host.unit_steps / max(it, 1),
        converged=host.converged,
        status=host.status,
    )


def _solve(design: DenseDesign, y, lam, strat: Strategy, *, beta0=None,
           verbose: bool = False) -> FitResult:
    """Dispatch one solve to the strategy's implementation cell (the local
    dense cell is the only one ported)."""
    return _fit_local_dense(design.X, y, lam, strat.opts, beta0, verbose)


@dataclass
class LogisticL1:
    """L1-regularized logistic regression via d-GLMNET on one device.

    ``opts`` carries the solver knobs (validated eagerly). With
    ``warm_start=True``, successive ``fit`` calls seed from the
    previous solution (``beta_``), which may also come from the JAX
    package through ``api.convert.from_reference``.
    """

    opts: DGLMNETOptions = field(default_factory=DGLMNETOptions)
    device: str = DEFAULT_DEVICE
    warm_start: bool = False
    beta_: Optional[torch.Tensor] = field(default=None, repr=False)
    lam_: Optional[float] = field(default=None, repr=False)

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32,
                               device=resolve_device(self.device))

    def _design(self, data) -> DenseDesign:
        X = data.X if isinstance(data, DenseDesign) else data
        return DenseDesign(self._tensor(X))

    # -- one solve ---------------------------------------------------------

    def fit(self, data, y, lam: float, *, beta0=None,
            verbose: bool = False) -> FitResult:
        """One solve at ``lam``; returns :class:`FitResult`."""
        design = self._design(data)
        y = self._tensor(y)
        strat = resolve(design, self.opts)
        if beta0 is None and self.warm_start and self.beta_ is not None:
            beta0 = self.beta_
        if beta0 is not None:
            beta0 = self._tensor(beta0)
        res = _solve(design, y, float(lam), strat, beta0=beta0, verbose=verbose)
        self.beta_, self.lam_ = res.beta, float(lam)
        return res

    # -- scoring -----------------------------------------------------------

    def decision_function(self, data, *, beta=None):
        """X @ beta, with ``beta_`` (the last solve) unless ``beta=`` is
        given."""
        design = self._design(data)
        beta = self.beta_ if beta is None else beta
        if beta is None:
            raise ValueError("not fitted and no beta= given")
        return design.margins(self._tensor(beta))

    def predict_proba(self, data, *, beta=None):
        """P(y = +1 | x) = sigmoid(X @ beta)."""
        return torch.sigmoid(self.decision_function(data, beta=beta))

    def predict(self, data, *, beta=None, threshold: float = 0.0):
        """Hard labels in {-1, +1} at a margin ``threshold``."""
        scores = self.decision_function(data, beta=beta)
        return torch.where(scores >= threshold, 1.0, -1.0).to(torch.float32)

    # -- sklearn-style surface ---------------------------------------------

    @property
    def coef_(self):
        """Fitted coefficients (p,) -- sklearn naming for ``beta_``."""
        return self.beta_

    @property
    def intercept_(self) -> float:
        """Always 0.0: d-GLMNET fits no intercept -- append a constant
        feature column if one is needed."""
        return 0.0

    _PARAM_NAMES = ("opts", "device", "warm_start")

    def get_params(self, deep: bool = True) -> dict:
        """sklearn-style constructor-parameter dict."""
        return {name: getattr(self, name) for name in self._PARAM_NAMES}

    def set_params(self, **params) -> "LogisticL1":
        """sklearn-style parameter update; unknown names raise."""
        for name, value in params.items():
            if name not in self._PARAM_NAMES:
                raise ValueError(
                    f"unknown parameter {name!r} for LogisticL1: valid "
                    f"parameters are {self._PARAM_NAMES}"
                )
            setattr(self, name, value)
        return self
