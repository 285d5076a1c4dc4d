# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""``LogisticL1`` -- the port's front door, the counterpart of
``repro/api/estimator.py``.

Ported so far: ``fit`` (with ``warm_start`` and ``densify=``) on dense
and slab designs, locally or on a (1, M) mesh (``mesh=``, the by-feature
slab solve of paper Algorithm 4 with its M feature blocks as one batch
on the device), scoring (``decision_function``, ``predict_proba``,
``predict``; slab designs through ``kernels.slab_spmv``), the
sklearn-style surface and :func:`lambda_max_design`. The estimator runs
on ``device`` (default ``"cuda"``, raising without a card); data given
as numpy arrays or tensors elsewhere is moved there once, at the entry
point. The screened path comes with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

import torch

from repro_torch.api.design import ShardedDesign, as_design
from repro_torch.api.strategy import Strategy, resolve
from repro_torch.core import engine
from repro_torch.core.dglmnet import DGLMNETOptions, FitResult, build_solver
from repro_torch.core.distributed import (
    DistributedFitResult,
    _finish,
    check_slab_shapes,
    layout_slabs,
    make_distributed_iteration_sparse,
    make_slab_densifier,
    make_slab_margins,
    pad_features,
)
from repro_torch.core.subproblem import layout_blocks
from repro_torch.device import DEFAULT_DEVICE, resolve_device


def lambda_max_design(design, y):
    """Smallest lambda for which beta* = 0, from the design's correlation
    pass: ``max_j |x_j^T (0.5 y)|`` (at beta = 0 the NLL residual is
    exactly -y/2), so dense and slab layouts share one definition."""
    y = torch.as_tensor(y, dtype=torch.float32)
    return design.correlation(0.5 * y).abs().max()


def _dense_state(X, y, beta, m, lam, opts: DGLMNETOptions):
    """The engine's solve over X laid out into (M, nt, n, tile) tiles once,
    here (freed with the solve)."""
    Xt = layout_blocks(X, opts.num_blocks, opts.tile)
    return build_solver(opts)(Xt, y, beta, m, lam)


def _fit_local_dense(X, y, lam, opts: DGLMNETOptions, beta0,
                     verbose: bool) -> FitResult:
    """Single-device dense solve: paper Algorithm 1 with the Algorithm 3
    line search (core/engine.py)."""
    n, p = X.shape
    beta = (torch.zeros(p, dtype=torch.float32, device=X.device)
            if beta0 is None else beta0.to(device=X.device, dtype=torch.float32))
    state = _dense_state(X, y, beta, X @ beta, lam, opts)
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


def _fit_mesh_dense(X, y, lam, mesh, opts: DGLMNETOptions, beta0,
                    verbose: bool) -> DistributedFitResult:
    """Dense solve on a (1, M) mesh: X's features zero-padded to M * tile
    and split into the mesh's M contiguous blocks."""
    num_blocks = mesh.shape["model"]
    p = X.shape[1]
    pad = (-p) % (num_blocks * opts.tile)
    if pad:
        X = torch.nn.functional.pad(X, (0, pad))
        if beta0 is not None:
            beta0 = torch.nn.functional.pad(beta0, (0, pad))
    beta = (torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
            if beta0 is None else beta0)
    state = _dense_state(X, y, beta, X @ beta, lam,
                         replace(opts, num_blocks=num_blocks))
    return _finish(state, p, pad, verbose, "dist")


def _fit_mesh_slab(row_idx, values, y, lam, mesh, strat: Strategy, beta0,
                   verbose: bool) -> DistributedFitResult:
    """By-feature slab solve (p, 1, K) on a (1, M) mesh -- the
    webspam-scale layout where a dense X cannot exist. The subproblem
    family is the strategy's per-solve densify decision
    (``prefer_slab_gram`` or the explicit override): the slab kernels
    (``slab_gram``, the tile cycle, ``slab_spmv``) on slabs laid out once
    per fit, or one densify per solve feeding the dense solver."""
    opts = strat.opts
    num_blocks = mesh.shape["model"]
    n_loc = check_slab_shapes(row_idx, values, mesh, y.shape[0])
    p = row_idx.shape[0]
    # sentinel-row feature padding is safe: all-sentinel slabs contribute
    # nothing to any Gram tile, so their coordinates stay at 0
    row_idx, values, beta0, pad = pad_features(row_idx, values, beta0, n_loc,
                                               num_blocks * opts.tile)
    beta = (torch.zeros(row_idx.shape[0], dtype=torch.float32, device=y.device)
            if beta0 is None else beta0)
    if beta0 is None:
        m = torch.zeros_like(y)
    else:
        m = make_slab_margins(mesh, n_loc)(row_idx, values, beta)

    if strat.use_densify(n_loc, row_idx.shape[2]):
        X = make_slab_densifier(mesh, n_loc)(row_idx, values)
        state = _dense_state(X, y, beta, m, lam, replace(opts, num_blocks=num_blocks))
        del X
        return _finish(state, p, pad, verbose, "dist-sparse-dense")

    lay = layout_slabs(row_idx[:, 0], values[:, 0], num_blocks, opts.tile)
    solve = engine.make_solver(make_distributed_iteration_sparse(mesh, opts),
                               max_iters=opts.max_iters, rel_tol=opts.rel_tol,
                               snap_tol=opts.snap_tol)
    state = solve(lay, y, beta, m, lam)
    del lay
    return _finish(state, p, pad, verbose, "dist-sparse")


def _solve(design, y, lam, strat: Strategy, *, beta0=None, verbose: bool = False):
    """Dispatch one solve to the strategy's implementation cell."""
    if strat.execution == "local":
        X = design.X if design.layout == "dense" else design.densify()
        return _fit_local_dense(X, y, lam, strat.opts, beta0, verbose)
    inner = design.inner
    if design.layout == "dense":
        return _fit_mesh_dense(inner.X, y, lam, design.mesh, strat.opts,
                               beta0, verbose)
    return _fit_mesh_slab(inner.row_idx, inner.values, y, lam, design.mesh,
                          strat, beta0, verbose)


@dataclass
class LogisticL1:
    """L1-regularized logistic regression via d-GLMNET on one device.

    ``opts`` carries the solver knobs (validated eagerly); ``mesh`` (a
    ``launch.mesh.make_dev_mesh(1, M)`` on the same device) or a
    :class:`ShardedDesign` input selects the mesh solve. With
    ``warm_start=True``, successive ``fit`` calls seed from the
    previous solution (``beta_``), which may also come from the JAX
    package through ``api.convert.from_reference``.
    """

    opts: DGLMNETOptions = field(default_factory=DGLMNETOptions)
    mesh: Optional[object] = None
    device: str = DEFAULT_DEVICE
    warm_start: bool = False
    beta_: Optional[torch.Tensor] = field(default=None, repr=False)
    lam_: Optional[float] = field(default=None, repr=False)

    def _tensor(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32,
                               device=resolve_device(self.device))

    def _design(self, data, y=None):
        dev = resolve_device(self.device)
        n = None if y is None else int(len(y))
        design = as_design(data, n=n, mesh=self.mesh, tile=self.opts.tile)
        if isinstance(design, ShardedDesign):
            if self.mesh is not None and design.mesh is not self.mesh:
                raise ValueError(
                    "design is sharded over a different mesh than the estimator's")
            if design.mesh.device.type != dev.type:
                raise ValueError(
                    f"the mesh lives on {design.mesh.device}, the estimator "
                    f"on {dev}: build the mesh with device={self.device!r}")
        return design.to(dev)

    # -- one solve ---------------------------------------------------------

    def fit(self, data, y, lam: float, *, beta0=None, verbose: bool = False,
            densify: Optional[bool] = None):
        """One solve at ``lam``. Returns :class:`FitResult` (local) or
        :class:`DistributedFitResult` (mesh). ``densify`` overrides the
        slab solver's densify-once heuristic."""
        design = self._design(data, y)
        y = self._tensor(y)
        strat = resolve(design, self.opts, densify=densify)
        if beta0 is None and self.warm_start and self.beta_ is not None:
            beta0 = self.beta_
        if beta0 is not None:
            beta0 = self._tensor(beta0)
        res = _solve(design, y, float(lam), strat, beta0=beta0, verbose=verbose)
        self.beta_, self.lam_ = res.beta, float(lam)
        return res

    # -- scoring -----------------------------------------------------------

    def decision_function(self, data, *, beta=None):
        """X @ beta through the design (slab designs through
        ``kernels.slab_spmv``), with ``beta_`` (the last solve) unless
        ``beta=`` is given."""
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

    _PARAM_NAMES = ("opts", "mesh", "device", "warm_start")

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
