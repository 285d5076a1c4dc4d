# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""``LogisticL1`` -- the port's front door, the counterpart of
``repro/api/estimator.py``:

* ``fit(design, y, lam)`` -- one solve (with ``warm_start`` and
  ``densify=``) on dense, slab and bucketed designs, locally or on a
  (1, M) mesh (``mesh=``: the by-feature slab solve of paper Algorithm 4
  with its M feature blocks as one batch on the device);
* ``path(design, y)`` -- the warm-started, screened regularization path
  (paper Algorithm 5): strong-rule working sets, KKT-certified, solved
  restricted at power-of-two capacities, with the working set carried
  across points, a violation budget per KKT round, and the per-lambda
  degradation ladder (rewarm, sequential, skip);
* scoring (``decision_function``, ``predict_proba``, ``predict``), the
  sklearn-style surface, :func:`lambda_max_design` and
  :func:`make_design_eval`.

The estimator runs on ``device`` (default ``"cuda"``, raising without a
card); data given as numpy arrays or tensors elsewhere is moved there
once, at the entry point.

Host reads (all through ``engine.host_read``, counted): a solve's own
(one per outer iteration, one fetch, plus one entry read of a slab's
largest row); the path driver one where the reference's driver makes
one ``device_get`` -- lambda_max, per KKT round the working-set count,
the slab K class (slab meshes), the violation count and, when violators
are budgeted, the budget's and the admitted count, per point the final
count and (nnz, f). :func:`make_design_eval` reads each point's scores
once. A checkpointed path (``checkpoint_every=``) adds one read per
checkpoint: the warm-start chain and the points not yet on the host,
packed into one tensor (``engine.host_array``).

Trace spans (``repro_torch.obs``): under an active tracer the path emits
the reference's tree, ``path > lambda_grid / lambda_point >
{screen_round, restricted_solve, kkt_check, point_finish}``, with the
reference's arguments. Each span closes at a host read the driver makes
anyway, so work queued on the card between two reads is timed in the
span that owns the later read; tracing adds no read, and with no tracer
every span is the shared null span.

Faults (``repro_torch.resilience``): every solve consults
``arm_engine_fault()`` once (:func:`_dense_state`, which also serves the
mesh and densify-once solves, and the slab solver), and the path driver
calls ``maybe_kill`` after each point's checkpoint.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.api.design import ShardedDesign, as_design
from repro_torch.api.strategy import Strategy, resolve
from repro_torch.api.types import PathPoint, PathResult, _jsonable
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
from repro_torch.core.objective import objective
from repro_torch.core.screening import (
    _nll_residual,
    budgeted_admission,
    capacity_bucket,
    kkt_violations,
    strong_rule_mask,
    take_fill,
)
from repro_torch.core.subproblem import layout_blocks
from repro_torch.data.byfeature import k_class, scatter_features
from repro_torch.data.residency import put_slab
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import PathProgress, arm_engine_fault, maybe_kill


def lambda_max_design(design, y):
    """Smallest lambda for which beta* = 0, from the design's correlation
    pass: ``max_j |x_j^T (0.5 y)|`` (at beta = 0 the NLL residual is
    exactly -y/2), so dense and slab layouts share one definition."""
    y = torch.as_tensor(y, dtype=torch.float32)
    return design.correlation(0.5 * y).abs().max()


def _lambda_grid(lmax: float, path_len: int,
                 extra_lams: Optional[List[float]]) -> List[float]:
    lams = [lmax * 2.0 ** (-i) for i in range(1, path_len + 1)]
    if extra_lams:
        lams = sorted(set(lams) | set(extra_lams), reverse=True)
    return lams


def _screened_point(p_cap, lam, lam_prev, beta, m, *, grad_abs,
                    restricted_solve, empty_result, cap_tile, kkt_tol,
                    max_kkt_rounds, prev_mask=None,
                    violation_budget: Optional[int] = 512):
    """One path point of the strong-rule/KKT loop, solver- and
    layout-agnostic (masks and beta on the driver's feature axis;
    ``p_cap`` the capacity ceiling).

    ``grad_abs(m) -> |g|`` is the full gradient pass;
    ``restricted_solve(mask, cap, beta) -> (res, beta_full, m_full)``
    solves the capacity-``cap`` restricted problem warm-started from
    ``beta``. Only the counts cross to the host, each through one
    ``engine.host_read``. ``prev_mask`` carries the working set across
    points (blitz-style growth); within a point violators re-enter under
    a budget of ``min(violation_budget, 2 |A|)`` per round, the strongest
    first, lifted on the penultimate round so certification completes
    within ``max_kkt_rounds``. Returns (res, beta, m, info, mask).

    Spans: ``screen_round`` closes at the working-set count's read,
    ``restricted_solve`` at the solve's own last read, ``kkt_check`` at
    the violation count's read."""
    g_abs = grad_abs(m)
    mask = strong_rule_mask(g_abs, lam, lam_prev, beta)
    if prev_mask is not None:
        mask = torch.logical_or(mask, prev_mask)

    res = None
    rounds = 0
    cap = 0
    deferred = 0
    for rounds in range(1, max_kkt_rounds + 1):
        with obs_trace.span("screen_round", round=rounds) as sr:
            count = int(engine.host_read(mask.sum()))
            sr.set(active=count)
        if count == 0:
            # empty working set: beta stays 0
            beta_new, m_new = beta, m
            res = empty_result(beta)
        else:
            cap = capacity_bucket(count, p_cap, tile=cap_tile)
            with obs_trace.span("restricted_solve", active=count, capacity=cap):
                res, beta_new, m_new = restricted_solve(mask, cap, beta)
            if res.status:
                # a guardrail trip: certification cannot proceed on a
                # degraded iterate; return the input state (the last
                # certified point) for the driver's degradation ladder
                info = {"active": count, "capacity": cap, "kkt_rounds": rounds,
                        "deferred": deferred, "status": int(res.status)}
                return res, beta, m, info, mask
        with obs_trace.span("kkt_check", round=rounds) as kk:
            g_abs = grad_abs(m_new)
            viol = kkt_violations(g_abs, lam, mask, tol=kkt_tol)
            n_viol = int(engine.host_read(viol.sum()))
            kk.set(violations=n_viol)
        if n_viol == 0:
            break
        if violation_budget is not None and rounds < max_kkt_rounds - 1:
            budget = min(violation_budget, 2 * max(count, 1))
            admitted = budgeted_admission(viol, g_abs, budget)
            # ties at the cutoff may admit more than the budget
            deferred += n_viol - int(engine.host_read(admitted.sum()))
        else:
            admitted = viol                       # safety valve: admit all
        mask = torch.logical_or(mask, admitted)   # violators re-enter
        beta, m = beta_new, m_new                 # keep this round's progress
    else:
        raise RuntimeError(
            f"KKT check failed to certify within {max_kkt_rounds} rounds "
            f"at lambda={lam} (last violation count > 0)")

    info = {"active": int(engine.host_read(mask.sum())), "capacity": cap,
            "kkt_rounds": rounds, "deferred": deferred}
    return res, beta_new, m_new, info, mask


def _dense_state(X, y, beta, m, lam, opts: DGLMNETOptions):
    """The engine's solve over X laid out into (M, nt, n, tile) tiles once,
    here (freed with the solve); one fault consult per solve."""
    Xt = layout_blocks(X, opts.num_blocks, opts.tile)
    return build_solver(opts, fault=arm_engine_fault())(Xt, y, beta, m, lam)


def _host_state(arrays, dev):
    """Host arrays of a progress slot as tensors on ``dev``: to a card
    through pinned memory, without blocking the host."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)
    return {k: put(a) for k, a in arrays.items()}


def _save_progress(progress: PathProgress, pt_idx: int, lams, lam_prev, beta, m,
                   carry_mask, points, host_betas, p: int, p_cap: int) -> int:
    """Checkpoint the path driver's warm-start chain (``beta`` and ``m`` on
    the driver's axes, ``carry_mask``, ``lam_prev``) and the emitted points
    as one rotated :class:`PathProgress` slot, in the reference's format
    (``repro/api/estimator.py`` ``_save_progress``). The device state and
    the points not yet on the host (``host_betas[i] is None``) cross in one
    counted read; ``host_betas`` keeps each point's host copy for later
    checkpoints. float32 arrays round-trip npz exactly and the JSON meta
    round-trips Python floats exactly, so a resume continues
    bit-identically. Returns the payload bytes written."""
    fresh = [i for i, b in enumerate(host_betas) if b is None]
    parts = [beta, m] + ([carry_mask.to(torch.float32)] if carry_mask is not None else [])
    parts += [points[i].beta.to(torch.float32) for i in fresh]
    flat = engine.host_array(torch.cat([t.reshape(-1) for t in parts]))
    pieces = np.split(flat, np.cumsum([t.numel() for t in parts])[:-1])
    for i, piece in zip(fresh, pieces[len(parts) - len(fresh):]):
        host_betas[i] = piece
    tree = {
        "beta": pieces[0],
        "m": pieces[1],
        "carry_mask": (pieces[2].astype(np.int8) if carry_mask is not None
                       else np.zeros((1,), np.int8)),
        "point_betas": (np.stack(host_betas) if points
                        else np.zeros((0, p), np.float32)),
    }
    meta = {
        "kind": "PathProgress",
        "next_index": pt_idx + 1,
        "lam_prev": float(lam_prev),
        "lams": [float(v) for v in lams],
        "p": int(p),
        "p_cap": int(p_cap),
        "has_carry_mask": carry_mask is not None,
        "points": [
            {"lam": float(pt.lam), "nnz": int(pt.nnz), "f": float(pt.f),
             "n_iters": int(pt.n_iters), "metrics": _jsonable(pt.metrics),
             "screen": _jsonable(pt.screen), "status": int(pt.status)}
            for pt in points
        ],
    }
    directory = progress.save(pt_idx, tree, meta)
    return os.path.getsize(os.path.join(directory, "arrays.npz"))


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
                               snap_tol=opts.snap_tol, fault=arm_engine_fault())
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
    if design.layout == "slab":
        # under a device budget the slabs stay on the host until here
        rows, vals = put_slab(inner.row_idx, inner.values, y.device)
        return _fit_mesh_slab(rows, vals, y, lam, design.mesh, strat, beta0, verbose)
    # bucketed on a mesh: flatten through the bucket gather at the largest
    # K class, solve the flat slab problem, scatter back to the original
    # order (one work axis throughout: strat.opts.tile)
    tile = strat.opts.tile
    st = design._mesh_state(tile)
    p = design.shape[1]
    beta_full = (torch.zeros(p, dtype=torch.float32, device=y.device) if beta0 is None
                 else beta0.to(torch.float32))
    beta_work = take_fill(beta_full, st.feat_map, 0.0)
    mask_work = torch.ones(st.p_work, dtype=torch.bool, device=y.device)
    sub, beta_sub, idx = design._gather_work(beta_work, mask_work, st.p_work, st.k_max,
                                             tile=tile)
    res = _fit_mesh_slab(sub.inner.row_idx, sub.inner.values, y, lam, design.mesh,
                         strat, beta_sub, verbose)
    res.beta = design._work_to_original(scatter_features(res.beta, idx, st.p_work),
                                        tile=tile)
    return res


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
        budget = self.opts.device_budget_bytes
        design = as_design(data, n=n, mesh=self.mesh, tile=self.opts.tile,
                           device_budget_bytes=budget)
        if isinstance(design, ShardedDesign):
            if self.mesh is not None and design.mesh is not self.mesh:
                raise ValueError(
                    "design is sharded over a different mesh than the estimator's")
            if budget is not None and design.device_budget_bytes != budget:
                if design._states:
                    # the residency exists under the design's own budget:
                    # rebuilding it would double the device memory
                    warnings.warn(
                        f"ShardedDesign residency was already built with "
                        f"device_budget_bytes={design.device_budget_bytes} but the "
                        f"estimator's options say {budget}; keeping the existing "
                        f"residency -- build the design with the same budget to "
                        f"silence this", stacklevel=3)
                else:
                    design.device_budget_bytes = budget
            if design.mesh.device.type != dev.type:
                raise ValueError(
                    f"the mesh lives on {design.mesh.device}, the estimator "
                    f"on {dev}: build the mesh with device={self.device!r}")
            if (design.layout != "dense" and design._states
                    and self.opts.tile not in design._states):
                warnings.warn(
                    f"ShardedDesign is resident at tile={sorted(design._states)} but "
                    f"the estimator uses tile={self.opts.tile}; this puts a second "
                    f"copy of the padded slabs on the device -- build the design "
                    f"with tile={self.opts.tile} to share one residency",
                    stacklevel=3)
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

    # -- the regularization path -------------------------------------------

    def path(
        self,
        data,
        y,
        *,
        path_len: int = 20,
        eval_fn: Optional[Callable[[torch.Tensor], dict]] = None,
        extra_lams: Optional[List[float]] = None,
        verbose: bool = False,
        screen: bool = True,
        kkt_tol: float = 1e-3,
        max_kkt_rounds: int = 8,
        carry_working_set: bool = True,
        violation_budget: Optional[int] = 512,
        densify: Optional[bool] = None,
        checkpoint_every: Optional[int] = None,
        resume_from: Optional[str] = None,
    ) -> PathResult:
        """Warm-started screened regularization path (paper Algorithm 5):
        lambda = lambda_max * 2^{-i}, i = 1..path_len, each point solved
        restricted to the strong-rule/KKT-certified working set
        (capacity-bucketed), warm-started from the previous point.

        Returns a :class:`PathResult`: the coefficients stacked (L, p) and
        per-lambda telemetry (``screen``: active, capacity, kkt_rounds,
        deferred, and degraded/skipped where they apply). ``eval_fn(beta)``
        computes per-lambda metrics (:func:`make_design_eval` scores
        through a test design); ``screen=False`` runs the full-p
        warm-started loop (the screening tests' oracle);
        ``carry_working_set`` / ``violation_budget`` are the blitz-style
        growth knobs (:func:`_screened_point`).

        On a guardrail trip the driver degrades per lambda: re-warm-start
        from the previous certified point without the carried working
        set, then (``cycle_mode="blocked"``) the sequential cycle, then
        skip and mark the point, holding the last certified state.

        ``resume_from=`` names a progress directory
        (:class:`~repro_torch.resilience.PathProgress`): progress found
        there is resumed bit-identically from the last certified point;
        ``checkpoint_every=k`` (requires ``resume_from``) checkpoints every
        k-th point into it (atomic publish, CRC-checked payload). A
        directory written for another grid, ``p`` or work-axis width
        raises.

        Under an active ``repro_torch.obs`` tracer the path emits the
        ``path > lambda_grid / lambda_point > {screen_round,
        restricted_solve, kkt_check, point_finish}`` span tree, each
        ``lambda_point`` carrying its nnz, f and status; the spans close at
        the driver's own host reads, so a traced path reads the device as
        often as an untraced one and gives the same result."""
        if checkpoint_every is not None:
            if checkpoint_every < 1:
                raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
            if resume_from is None:
                raise ValueError(
                    "checkpoint_every= requires resume_from= (the progress directory "
                    "checkpoints are written to and resumed from)")
        with obs_trace.span("path", path_len=path_len, screen=screen) as sp:
            result = self._path_impl(
                data, y, path_len=path_len, eval_fn=eval_fn, extra_lams=extra_lams,
                verbose=verbose, screen=screen, kkt_tol=kkt_tol,
                max_kkt_rounds=max_kkt_rounds, carry_working_set=carry_working_set,
                violation_budget=violation_budget, densify=densify,
                checkpoint_every=checkpoint_every, resume_from=resume_from)
            sp.set(points=len(result))
            return result

    def _path_impl(self, data, y, *, path_len, eval_fn, extra_lams, verbose, screen,
                   kkt_tol, max_kkt_rounds, carry_working_set, violation_budget,
                   densify, checkpoint_every, resume_from) -> PathResult:
        design = self._design(data, y)
        y = self._tensor(y)
        strat = resolve(design, self.opts, densify=densify)
        opts = strat.opts
        n = int(y.shape[0])
        n_d, p = design.shape
        if n_d != n:
            raise ValueError(f"X rows {n_d} != len(y) {n}")

        sharded = isinstance(design, ShardedDesign)
        # the work-axis path only matters under screening (gradient passes
        # and masked gathers); screen=False keeps beta in design order
        slab_mesh = sharded and screen and design.layout in ("slab", "bucketed")
        front_packed = getattr(design.inner if sharded else design, "front_packed", True)
        to_output = None               # work-axis beta -> original order
        m = torch.zeros(n, dtype=torch.float32, device=y.device)

        if slab_mesh:
            # driver state (beta, masks, g_abs) on the mesh-padded,
            # bucket-permuted work axis; no order conversion until a point
            # is emitted
            st = design._mesh_state(opts.tile)
            p_cap = st.p_work

            def grad_abs(m_cur):
                return design._screen_abs_work(y, m_cur, tile=opts.tile)

            def make_restricted_solve(lam, strat_=strat):
                def restricted_solve(mask_work, cap, beta_work):
                    if front_packed:
                        # the working set's slab-capacity class: a solve
                        # pays only for the K its features carry
                        k_need = int(engine.host_read(
                            torch.where(mask_work, st.k_arr, 0).max()))
                        k_cap = k_class(k_need, st.k_max)
                    else:
                        k_cap = st.k_max
                    sub, beta_sub, idx = design._gather_work(
                        beta_work, mask_work, cap, k_cap, tile=opts.tile)
                    res = _solve(sub, y, lam, strat_, beta0=beta_sub)
                    return res, scatter_features(res.beta, idx, st.p_work), res.m
                return restricted_solve

            def to_output(beta_work):
                return design._work_to_original(beta_work, tile=opts.tile)
        else:
            p_cap = p

            def grad_abs(m_cur):
                return design.correlation(_nll_residual(m_cur, y)).abs()

            def make_restricted_solve(lam, strat_=strat):
                def restricted_solve(mask, cap, beta_cur):
                    sub, beta_sub, idx = design.gather(beta_cur, mask, cap)
                    res = _solve(sub, y, lam, strat_, beta0=beta_sub)
                    beta_full = design.scatter(res.beta, idx)
                    m_full = (res.m if getattr(res, "m", None) is not None
                              else sub.margins(res.beta))
                    return res, beta_full, m_full
                return restricted_solve

        with obs_trace.span("lambda_grid"):
            if slab_mesh:
                # at beta = 0 the NLL residual is exactly -y/2, so the screen
                # at zero margins is lambda_max; the buckets' row bound rides
                # the same read
                lmax, max_row = engine.host_read(torch.stack(
                    [grad_abs(m).max().double(), st.max_row.double()]))
                design._check_rows(st, int(max_row))
            else:
                lmax = engine.host_read(lambda_max_design(design, y))
            lams = _lambda_grid(float(lmax), path_len, extra_lams)
        beta = torch.zeros(p_cap, dtype=torch.float32, device=y.device)

        def empty_result(beta_cur):
            if strat.execution == "mesh":
                return DistributedFitResult(beta=beta_cur, f=float("nan"), n_iters=0,
                                            objective_history=[])
            return FitResult(beta=beta_cur, f=float("nan"), n_iters=0,
                             objective_history=[], alpha_history=[])

        lam_prev = float(lmax)
        carry_mask = None
        points: List[PathPoint] = []
        host_betas: List[Optional[np.ndarray]] = []   # the points' host copies
        start = 0
        progress = PathProgress(resume_from) if resume_from else None
        state = progress.load_latest() if progress is not None else None
        if state is not None:
            idx, arrays, meta = state
            if meta.get("kind") != "PathProgress":
                raise ValueError(f"{resume_from} is not a path-progress directory")
            if meta["lams"] != lams or meta["p"] != p or meta["p_cap"] != int(p_cap):
                raise ValueError(
                    f"progress in {resume_from} was written for a different path "
                    f"(grid/shape mismatch) -- point it at a fresh directory or rerun "
                    f"with the original arguments")
            dev_arrays = _host_state(arrays, y.device)
            beta, m = dev_arrays["beta"], dev_arrays["m"]
            if meta["has_carry_mask"]:
                carry_mask = dev_arrays["carry_mask"] != 0
            lam_prev = float(meta["lam_prev"])
            for j, d in enumerate(meta["points"]):
                points.append(PathPoint(
                    lam=float(d["lam"]), nnz=int(d["nnz"]), f=float(d["f"]),
                    n_iters=int(d["n_iters"]), beta=dev_arrays["point_betas"][j],
                    metrics=dict(d["metrics"]), screen=dict(d["screen"]),
                    status=int(d["status"])))
                host_betas.append(arrays["point_betas"][j])
            start = int(meta["next_index"])
            if verbose:
                print(f"resuming path at point {start}/{len(lams)} from "
                      f"{progress.slot(idx)}")

        def solve_point(lam, prev_mask, strat_):
            return _screened_point(
                p_cap, lam, lam_prev, beta, m, grad_abs=grad_abs,
                restricted_solve=make_restricted_solve(lam, strat_),
                empty_result=empty_result, cap_tile=strat_.cap_tile,
                kkt_tol=kkt_tol, max_kkt_rounds=max_kkt_rounds,
                prev_mask=prev_mask, violation_budget=violation_budget)

        for pt_idx in range(start, len(lams)):
            lam = lams[pt_idx]
            with obs_trace.span("lambda_point", index=pt_idx, lam=float(lam)) as pt_sp:
                if screen:
                    res, beta_new, m_new, info, mask = solve_point(lam, carry_mask, strat)
                    pt_status = int(res.status)
                    # the degradation ladder: a tripped solve never feeds the
                    # warm-start chain. (1) drop the carried working set and
                    # re-warm-start from the last certified point; (2) blocked
                    # cycles fall back to the sequential chain; (3) skip and mark,
                    # keeping the last certified state
                    if pt_status:
                        res, beta_new, m_new, info, mask = solve_point(lam, None, strat)
                        pt_status = int(res.status)
                        info["degraded"] = "rewarm"
                    if pt_status and opts.cycle_mode == "blocked":
                        seq_strat = resolve(design, replace(opts, cycle_mode="sequential"),
                                            densify=densify)
                        res, beta_new, m_new, info, mask = solve_point(lam, None, seq_strat)
                        pt_status = int(res.status)
                        info["degraded"] = "sequential"
                    if pt_status:
                        beta_new, m_new, mask = beta, m, carry_mask
                        info = {**info, "skipped": True, "degraded": "skipped"}
                    beta, m = beta_new, m_new
                    if carry_working_set and not pt_status:
                        carry_mask = mask
                else:
                    res = _solve(design, y, lam, strat, beta0=beta)
                    pt_status = int(res.status)
                    if pt_status:
                        # the unscreened loop: mark the point, hold the chain
                        info = {"skipped": True, "degraded": "skipped"}
                    else:
                        beta = res.beta
                        m = (res.m if getattr(res, "m", None) is not None
                             else design.margins(beta))
                        info = {}
                lam_prev = lam
                with obs_trace.span("point_finish"):
                    beta_out = to_output(beta) if to_output is not None else beta
                    # the point's one read: nnz, and f where the solve did not give it
                    nnz_dev = (beta_out.abs() > 0).sum().double()
                    if res.n_iters and not pt_status:
                        nnz, f = int(engine.host_read(nnz_dev)), float(res.f)
                    else:
                        nnz_h, f_h = engine.host_read(torch.stack(
                            [nnz_dev, objective(m, y, beta, lam).double()]))
                        nnz, f = int(nnz_h), float(f_h)
                    metrics = eval_fn(beta_out) if eval_fn else {}
                    points.append(PathPoint(lam=lam, nnz=nnz, f=f,
                                            n_iters=0 if pt_status else res.n_iters,
                                            beta=beta_out, metrics=metrics, screen=info,
                                            status=pt_status))
                    host_betas.append(None)
                    if verbose:
                        print(f"lambda={lam:10.4f} nnz={nnz:6d} f={f:12.4f} "
                              f"iters={points[-1].n_iters:3d} {info} {metrics}")
                    if (checkpoint_every is not None
                            and (pt_idx + 1 - start) % checkpoint_every == 0):
                        _save_progress(progress, pt_idx, lams, lam_prev, beta, m, carry_mask,
                                       points, host_betas, p, int(p_cap))
                pt_sp.set(nnz=nnz, f=f, status=pt_status)
                # the fault hook: a simulated process death between points, after
                # the checkpoint landed (as a real mid-path kill would find it)
                maybe_kill(pt_idx + 1)
        self.beta_ = points[-1].beta if points else None
        self.lam_ = lams[-1] if lams else None
        return PathResult.from_points(points)


# ---------------------------------------------------------------------------
# streamed per-lambda evaluation
# ---------------------------------------------------------------------------

def make_design_eval(test_data, y_test, *, mesh=None, tile: int = 128,
                     device=DEFAULT_DEVICE) -> Callable[[torch.Tensor], dict]:
    """``eval_fn`` for :meth:`LogisticL1.path` that scores through a test
    design on ``device`` (slab designs through ``kernels.slab_spmv``): only
    the (n_test,) scores reach the host, in one ``engine.host_read`` per
    point (a slab design on a mesh adds one entry read, its row bound, at
    the first). Metrics are the paper's Figure-1 set (``train.metrics``)."""
    from repro_torch.train.metrics import metrics_from_scores

    dev = resolve_device(device)
    design = as_design(test_data, n=int(len(y_test)), mesh=mesh, tile=tile).to(dev)
    # allow[torch-host-sync]: the test labels cross once, when the eval is built, not per point
    y_host = (y_test.detach().cpu().numpy() if torch.is_tensor(y_test)
              else np.asarray(y_test))

    def fn(beta):
        scores = design.margins(torch.as_tensor(beta, dtype=torch.float32, device=dev))
        return metrics_from_scores(np.asarray(engine.host_read(scores), np.float32), y_host)

    return fn
