# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The solver's outer loop (paper Algorithm 1) in eager PyTorch, the
counterpart of ``repro/core/engine.py``.

The reference runs the whole solve as one jitted ``lax.while_loop`` and
transfers to the host once per solve. Eager PyTorch decides the loop's
end on the host, so the port's contract is:

* **one host read per outer iteration**: a packed ``(done, status)``
  pair after the iteration's work is queued. Everything else in the
  iteration -- the fused working statistics, the subproblem, both
  branches of the line search (selected with ``torch.where``), the
  status lattice and the histories -- stays on the device;
* **one host read in** :func:`fetch`: the histories and counters,
  packed into one tensor.

A fit of k outer iterations therefore reads the device k + 1 times
(:data:`host_syncs` counts them). A solve given a ``fault`` (see
``repro_torch.resilience``) reads the same: a solve tripped at
iteration k reads k + 1 times, as a healthy one cut there would.

Other host reads go through the same counted doors, :func:`host_read`
and :func:`host_array`: a slab solve's entry read (k + 2), and the path
driver's reads (``api/estimator.py``). A checkpointed path
(``checkpoint_every=``) reads what the same path without checkpoints
reads plus one :func:`host_array` per checkpoint (beta, m, the carried
working set and the points not yet on the host, packed into one
tensor); a resumed path's first reads are its lambda_max, then the
points left, and the saved state reaches the card without a read.

On a process mesh (``launch.mesh.ProcMesh``) every rank runs this loop
on its example shard (m, y) with beta whole; ``reduce`` (the mesh's
``all_reduce`` over ``data``) sums every NLL partial -- f(beta0), the
fused NLL, each line-search batch, the snap-back's f(1) -- and the
iteration function reduces its own (G, c, dm, dbeta, grad_dot). So the
packed (done, status) is the same on every rank, each rank reads it
once per iteration, and the ranks' loops end together.

Replaying the iteration as a CUDA graph and checking ``done`` every few
iterations is left for later: the frozen-iterate lattice already makes
iterations after ``done`` no-ops.

Per iteration, ``logistic_stats`` (the kernel on the card) computes the
working statistics (w, z) once, and its NLL is the line search's f(0).

Status lattice: a non-finite step objective, an exhausted line search
that made the objective strictly worse, or a runaway objective sets the
matching ``STATUS_*`` code, stops the loop, and freezes (beta, m, f) at
the last certified iterate; the tripped step enters no history. The
snap-back epilogue then applies the final step with alpha = 1 if that
costs at most ``snap_tol`` relative objective, overwrites the last alpha
and counts the promoted unit step.

The histories are updated in place (they are the loop's own buffers).
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Tuple

import torch

from repro_torch.core.linesearch import (MAX_BACKTRACKS, LineSearchResult, f_alpha,
                                         line_search)
from repro_torch.core.objective import l1_norm, objective
from repro_torch.kernels.ops import logistic_stats

STATUS_OK = 0
STATUS_NONFINITE_OBJECTIVE = 1
STATUS_LINESEARCH_STALLED = 2
STATUS_DIVERGED = 3

STATUS_NAMES = {
    STATUS_OK: "OK",
    STATUS_NONFINITE_OBJECTIVE: "NONFINITE_OBJECTIVE",
    STATUS_LINESEARCH_STALLED: "LINESEARCH_STALLED",
    STATUS_DIVERGED: "DIVERGED",
}

# Objectives here are NLL + lam*||beta||_1 >= 0; a step whose objective
# exceeds this multiple of (f(beta0) + 1) is runaway, not line noise.
_DIVERGE_FACTOR = 1e4

#: host reads of device values made by the engine since the last reset
host_syncs = 0


def status_name(code: int) -> str:
    return STATUS_NAMES.get(int(code), f"UNKNOWN({int(code)})")


def host_read(t: torch.Tensor):
    """The one door from device to host (counted): the engine's reads,
    and the one-off entry reads of a solve's setup."""
    global host_syncs
    host_syncs += 1
    return t.tolist()


def host_array(t: torch.Tensor):
    """:func:`host_read` for bulk data (a path checkpoint's state): one
    counted read, returned as a numpy array."""
    global host_syncs
    host_syncs += 1
    return t.cpu().numpy()


class SolverState(NamedTuple):
    """Loop carry. ``it`` and ``status`` are host ints (the host reads
    the status every iteration); the rest lives on the device."""

    beta: torch.Tensor           # (p,)
    m: torch.Tensor              # (n,) margin cache X @ beta
    f: torch.Tensor              # objective at (beta, m)
    it: int                      # iterations certified
    converged: torch.Tensor      # bool: rel decrease < tol (vs iter budget)
    # final step stashed un-applied for the snap-back epilogue
    dbeta: torch.Tensor
    dm: torch.Tensor
    alpha: torch.Tensor
    f_new: torch.Tensor
    f_hist: torch.Tensor         # (max_iters + 1,), f_hist[0] = f(beta0)
    a_hist: torch.Tensor         # (max_iters,), line-search alphas
    unit_steps: torch.Tensor     # int32, Armijo unit-step short-circuits
    status: int = STATUS_OK


class HostState(NamedTuple):
    it: int
    status: int
    converged: bool
    unit_steps: int


_POISON = {"nan": float("nan"), "inf": float("inf")}


def _advance(iteration_fn, data, y, beta, m, lam, *, fault=None, fire: bool = False,
             reduce=None):
    """One outer step: fused working stats + subproblem + line search.

    ``fault`` (a ``resilience.EngineFault``) poisons this step when
    ``fire`` (a host bool: the loop knows its iteration) is set:
    ``"margins"`` replaces m before the working statistics, ``"stats"``
    replaces (w, z) after them (f0 keeps the healthy NLL), and
    ``"linesearch"`` forces an exhausted, strictly worse line search. An
    iteration that does not fire queues exactly the healthy ops.
    ``reduce`` sums NLL partials over a process mesh's example shards."""
    poison = fault is not None and fire
    if poison and fault.kind == "margins":
        m = torch.full_like(m, _POISON[fault.mode])
    w, z, nll0 = logistic_stats(m, y)
    if reduce is not None:
        nll0 = reduce(nll0)
    f0 = nll0 + lam * l1_norm(beta)
    if poison and fault.kind == "stats":
        w = torch.full_like(w, _POISON[fault.mode])
        z = torch.full_like(z, _POISON[fault.mode])
    dbeta, dm, grad_dot = iteration_fn(data, y, beta, m, lam, w, z)
    res = line_search(m, dm, y, beta, dbeta, lam, grad_dot, f0=f0, reduce=reduce)
    if poison and fault.kind == "linesearch":
        # +1.0 dominates any ulp noise between f0 and the carried
        # objective, so the stall guard's strict comparison always sees it
        res = LineSearchResult(
            alpha=torch.zeros_like(res.alpha),
            f_new=f0 + 1.0,
            took_unit_step=torch.zeros_like(res.took_unit_step),
            backtracks=torch.full_like(res.backtracks, MAX_BACKTRACKS))
    return dbeta, dm, res


def make_step(iteration_fn, *, reduce=None) -> Callable:
    """Single outer iteration ``step(data, y, beta, m, lam) -> (beta', m',
    f', alpha)``, for callers that run the loop themselves."""

    def step(data, y, beta, m, lam):
        dbeta, dm, res = _advance(iteration_fn, data, y, beta, m, lam, reduce=reduce)
        return beta + res.alpha * dbeta, m + res.alpha * dm, res.f_new, res.alpha

    return step


def _body(s: SolverState, dbeta, dm, res, it: int, *, max_iters: int,
          rel_tol: float):
    """Guardrails and bookkeeping of outer iteration ``it`` on device.
    Returns the new carry (status still the previous one) and the packed
    (done, status) tensor the host reads."""
    nonfinite = torch.logical_not(torch.isfinite(res.f_new))
    stalled = torch.logical_and(res.backtracks >= MAX_BACKTRACKS, res.f_new > s.f)
    diverged = res.f_new > _DIVERGE_FACTOR * (s.f_hist[0] + 1.0)
    status = torch.where(
        nonfinite, STATUS_NONFINITE_OBJECTIVE,
        torch.where(stalled, STATUS_LINESEARCH_STALLED,
                    torch.where(diverged, STATUS_DIVERGED, STATUS_OK)),
    ).to(torch.int32)
    tripped = status != STATUS_OK
    rel_dec = (s.f - res.f_new) / torch.clamp_min(s.f.abs(), 1e-12)
    converged = torch.logical_and(torch.logical_not(tripped), rel_dec < rel_tol)
    done = tripped | converged | (it >= max_iters)
    # mid-loop iterations apply the step; the stop iteration stashes it for
    # the epilogue; a tripped iteration applies and records nothing
    keep = torch.logical_not(done)
    s.f_hist[it] = torch.where(tripped, s.f_hist[it], res.f_new)
    s.a_hist[it - 1] = torch.where(tripped, s.a_hist[it - 1], res.alpha)
    new = s._replace(
        beta=torch.where(keep, s.beta + res.alpha * dbeta, s.beta),
        m=torch.where(keep, s.m + res.alpha * dm, s.m),
        f=torch.where(keep, res.f_new, s.f),
        converged=converged,
        dbeta=dbeta,
        dm=dm,
        alpha=res.alpha,
        f_new=res.f_new,
        unit_steps=s.unit_steps + torch.logical_and(
            res.took_unit_step, torch.logical_not(tripped)).to(torch.int32),
    )
    return new, torch.stack([done.to(torch.int32), status])


def _snap_back(s: SolverState, y, lam, snap_tol: float, reduce=None) -> SolverState:
    """Sparsity snap-back epilogue (paper section 3.3): prefer alpha = 1 on
    the final step if the objective increase is within snap_tol; applies
    the stashed step. On a tripped status the frozen carry stands."""
    if s.status != STATUS_OK:
        return s._replace(alpha=torch.zeros_like(s.alpha))
    f_unit = f_alpha(1.0, s.m, s.dm, y, s.beta, s.dbeta, lam, reduce)
    snap = f_unit <= s.f_new * (1.0 + snap_tol) + 1e-12
    alpha = torch.where(snap, torch.ones_like(s.alpha), s.alpha)
    f_fin = torch.where(snap, f_unit, s.f_new)
    snapped_up = torch.logical_and(snap, s.alpha != 1.0)
    s.f_hist[s.it] = f_fin
    s.a_hist[s.it - 1] = alpha
    return s._replace(
        beta=s.beta + alpha * s.dbeta,
        m=s.m + alpha * s.dm,
        f=f_fin,
        alpha=alpha,
        unit_steps=s.unit_steps + snapped_up.to(torch.int32),
    )


def make_solver(iteration_fn, *, max_iters: int, rel_tol: float,
                snap_tol: float, fault=None, reduce=None) -> Callable:
    """Builds ``solve(data, y, beta0, m0, lam) -> SolverState``: the outer
    loop with its guardrails and the snap-back epilogue. ``lam`` is a
    Python float. ``fault`` (a ``resilience.EngineFault``, from the
    estimator's one ``arm_engine_fault()`` consult per solve) poisons
    iteration ``fault.at_iter`` (1-based); the host reads stay one per
    iteration run, the poisoned one included. ``reduce`` sums NLL
    partials over a process mesh's example shards (module docstring)."""
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")

    def solve(data, y, beta0, m0, lam):
        lam = float(lam)
        f0 = objective(m0, y, beta0, lam, reduce)
        f_hist = torch.full((max_iters + 1,), math.nan, dtype=torch.float32,
                            device=m0.device)
        f_hist[0] = f0
        s = SolverState(
            beta=beta0, m=m0, f=f0, it=0,
            converged=torch.zeros((), dtype=torch.bool, device=m0.device),
            dbeta=torch.zeros_like(beta0), dm=torch.zeros_like(m0),
            alpha=torch.zeros((), dtype=torch.float32, device=m0.device),
            f_new=f0, f_hist=f_hist,
            a_hist=torch.full((max_iters,), math.nan, dtype=torch.float32,
                              device=m0.device),
            unit_steps=torch.zeros((), dtype=torch.int32, device=m0.device),
        )
        for it in range(1, max_iters + 1):
            dbeta, dm, res = _advance(iteration_fn, data, y, s.beta, s.m, lam, fault=fault,
                                      fire=fault is not None and it == fault.at_iter,
                                      reduce=reduce)
            s, flags = _body(s, dbeta, dm, res, it, max_iters=max_iters,
                             rel_tol=rel_tol)
            # allow[torch-nonfinite-guard]: the done flag and the status code, integers the device derives from its own isfinite checks of the objective
            done, status = host_read(flags)
            s = s._replace(status=status,
                           it=it if status == STATUS_OK else it - 1)
            if done:
                break
        return _snap_back(s, y, lam, snap_tol, reduce)

    return solve


def fetch(state: SolverState) -> Tuple[HostState, List[float], List[float]]:
    """The solve's closing host read: histories and counters in one
    transfer. Returns (host state, trimmed objective and alpha histories).

    An OK solve with a non-finite history row is a guardrail bug and
    raises; a tripped solve trims any non-finite tail."""
    packed = torch.cat([
        state.unit_steps.to(torch.float64).reshape(1),
        state.converged.to(torch.float64).reshape(1),
        state.f_hist.to(torch.float64),
        state.a_hist.to(torch.float64),
    ])
    vals = host_read(packed)
    unit_steps, converged = int(vals[0]), bool(vals[1])
    nf = state.f_hist.shape[0]
    it, status = state.it, state.status
    f_hist = vals[2:2 + nf][: it + 1]
    a_hist = vals[2 + nf:][:it]
    if status == STATUS_OK:
        bad = [k for k, v in enumerate(f_hist) if not math.isfinite(v)]
        if bad:
            raise RuntimeError(
                f"engine invariant violated: status=OK but f_hist has "
                f"non-finite entries at iterations {bad} — the guardrails "
                f"should have tripped")
    else:
        while len(f_hist) > 1 and not math.isfinite(f_hist[-1]):
            f_hist.pop()
        a_hist = a_hist[: max(len(f_hist) - 1, 0)]
    return HostState(it, status, converged, unit_steps), f_hist, a_hist
