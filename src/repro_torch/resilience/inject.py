# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Deterministic, seeded fault injection, the port's copy of
``repro/resilience/inject.py`` (the same plans, consults and counters).

One module owns every fault the stack can be asked to survive, so a chaos
run is a single :class:`FaultPlan` armed around the code under test:

    with inject_faults(FaultPlan(engine=EngineFault("margins", at_iter=3))):
        res = est.fit(X, y, lam)
    assert res.status == engine.STATUS_NONFINITE_OBJECTIVE

Hook protocol -- the production layers *consult* this module, they never
depend on it being armed:

* ``arm_engine_fault()`` -- the estimator consults it once per solve
  (``api/estimator.py``: the dense engine's solve, which also serves the
  mesh and densify-once solves, and the slab solver); a non-None
  :class:`EngineFault` goes to ``core.engine.make_solver(fault=)``, whose
  loop poisons the margins or working statistics (or forces a line-search
  stall) at ``at_iter``, on the device. With no plan armed the call is a
  cheap None and the solve queues exactly the healthy work.
* ``maybe_kill(points_done)`` -- the path driver calls this after each
  emitted point (after its checkpoint); raises :class:`InjectedKill` when
  the plan says so, simulating a mid-path process death.
* ``serve_delay()`` / ``take_swap_failure()`` / ``take_load_failure()``
  -- the serve layer's latency and transient-failure knobs (the latter
  two are consumable counters, so the retry-with-backoff paths can be
  exercised deterministically).
* ``take_prefetch_failure()`` -- the streamed bucket-residency manager's
  lost-bucket knob (``repro_torch.data.residency``): each consult either
  burns one of ``fail_prefetches_after`` healthy host->device puts or
  consumes one of ``fail_prefetches`` failures, so a drill can place the
  failure window mid-path deterministically (transient -> absorbed by
  retry; >= the retry budget -> the path dies and resumes through
  ``PathProgress``).
* :func:`corrupt_checkpoint` -- host-side, deterministic corruption of a
  checkpoint directory (bit flip / truncation / meta drop), byte for byte
  what the reference writes for the same mode and seed.

Everything here is stdlib-only. The plan is process-global under one
lock, so the serve batcher, store and scorer may consult it from any
thread. Every fault that actually *fires* bumps a ``faults.*`` counter on
the active ``repro_torch.obs`` metrics registry (a no-op when none is
armed), so chaos drills can assert that the expected faults happened.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

from repro_torch.obs import registry as _metrics


class InjectedFault(RuntimeError):
    """A failure raised (not computed) by the injection harness."""


class InjectedKill(InjectedFault):
    """Simulated process death (``FaultPlan.kill_after_points``)."""


#: EngineFault kinds: what gets poisoned, at outer iteration ``at_iter``
ENGINE_FAULT_KINDS = ("margins", "stats", "linesearch")


@dataclass(frozen=True)
class EngineFault:
    """A device-side fault given to one solve.

    ``kind``: ``"margins"`` poisons the margin cache entering the fused
    working-stats pass; ``"stats"`` poisons (w, z) entering the
    subproblem; ``"linesearch"`` forces a no-progress, backtrack-exhausted
    line-search result. ``mode`` picks the poison value (``"nan"`` or
    ``"inf"``). ``at_iter`` is the 1-based outer iteration that fires.
    """

    kind: str
    at_iter: int = 1
    mode: str = "nan"

    def __post_init__(self):
        if self.kind not in ENGINE_FAULT_KINDS:
            raise ValueError(
                f"unknown EngineFault kind {self.kind!r}: expected one of "
                f"{ENGINE_FAULT_KINDS}")
        if self.mode not in ("nan", "inf"):
            raise ValueError(f"mode must be 'nan' or 'inf', got {self.mode!r}")
        if self.at_iter < 1:
            raise ValueError(f"at_iter must be >= 1, got {self.at_iter}")


@dataclass(frozen=True)
class FaultPlan:
    """The full, deterministic description of one chaos scenario.

    ``engine_fires`` bounds how many solver acquisitions arm ``engine``
    (None = every one while the plan is active) — ``engine_fires=1``
    poisons exactly the next solve, so recovery paths (the path driver's
    degradation ladder) see a *transient* fault. ``fail_swaps`` /
    ``fail_loads`` are consumable counters making the next N
    ``PathStore.swap`` / checkpoint loads raise :class:`InjectedFault`
    (exercising retry-with-backoff). ``serve_latency_s`` sleeps every
    scorer dispatch by that much. ``fail_prefetches`` makes N consecutive
    slab-bucket host->device puts fail, after first letting
    ``fail_prefetches_after`` puts through healthy — the offset is what
    lands a lost-bucket fault mid-path instead of at residency build.
    """

    seed: int = 0
    engine: Optional[EngineFault] = None
    engine_fires: Optional[int] = None
    kill_after_points: Optional[int] = None
    serve_latency_s: float = 0.0
    fail_swaps: int = 0
    fail_loads: int = 0
    fail_prefetches: int = 0
    fail_prefetches_after: int = 0


class _ActivePlan:
    """Armed plan + its mutable consumable counters."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.engine_left = plan.engine_fires
        self.swaps_left = plan.fail_swaps
        self.loads_left = plan.fail_loads
        self.prefetch_ok_left = plan.fail_prefetches_after
        self.prefetches_left = plan.fail_prefetches


_LOCK = threading.Lock()
_ACTIVE: Optional[_ActivePlan] = None


@contextmanager
def inject_faults(plan: FaultPlan):
    """Arm ``plan`` for the dynamic extent of the block (process-global:
    the solver factories and serve hooks consult it from any thread).
    Nesting is an error — one scenario at a time keeps runs deterministic.
    """
    global _ACTIVE
    with _LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already armed (no nesting)")
        _ACTIVE = _ActivePlan(plan)
    try:
        yield plan
    finally:
        with _LOCK:
            _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    with _LOCK:
        a = _ACTIVE
    return None if a is None else a.plan


def arm_engine_fault() -> Optional[EngineFault]:
    """The engine fault to give the next solve, consuming one of
    ``engine_fires`` -- or None (no plan / fault exhausted)."""
    with _LOCK:
        a = _ACTIVE
        if a is None or a.plan.engine is None:
            return None
        if a.engine_left is None:
            _metrics.counter("faults.engine").inc()
            return a.plan.engine
        if a.engine_left <= 0:
            return None
        a.engine_left -= 1
        _metrics.counter("faults.engine").inc()
        return a.plan.engine


def maybe_kill(points_done: int) -> None:
    """Raise :class:`InjectedKill` when the armed plan says the process
    dies after ``points_done`` path points. No-op otherwise."""
    with _LOCK:
        a = _ACTIVE
        fire = (a is not None and a.plan.kill_after_points is not None
                and points_done >= a.plan.kill_after_points)
    if fire:
        _metrics.counter("faults.kill").inc()
        raise InjectedKill(
            f"injected kill after {points_done} path points "
            f"(plan: kill_after_points={a.plan.kill_after_points})")


def serve_delay() -> float:
    """Sleep the armed plan's serve latency; returns the seconds slept."""
    with _LOCK:
        a = _ACTIVE
        delay = 0.0 if a is None else a.plan.serve_latency_s
    if delay <= 0.0:
        return 0.0
    _metrics.counter("faults.serve_delay").inc()
    time.sleep(delay)
    return delay


def take_swap_failure() -> bool:
    """Consume one injected ``PathStore.swap`` failure, if any remain."""
    with _LOCK:
        a = _ACTIVE
        if a is None or a.swaps_left <= 0:
            return False
        a.swaps_left -= 1
        _metrics.counter("faults.swap").inc()
        return True


def take_load_failure() -> bool:
    """Consume one injected checkpoint-load failure, if any remain."""
    with _LOCK:
        a = _ACTIVE
        if a is None or a.loads_left <= 0:
            return False
        a.loads_left -= 1
        _metrics.counter("faults.load").inc()
        return True


def take_prefetch_failure() -> bool:
    """Consume one injected slab-bucket prefetch failure, if any remain.

    The first ``fail_prefetches_after`` consults are let through healthy
    (each burns one unit of the offset); the next ``fail_prefetches``
    consults return True. The residency manager calls this once per
    host->device put *attempt*, so retries burn failures too — a count
    below the retry budget is transient, at or above it is fatal.
    """
    with _LOCK:
        a = _ACTIVE
        if a is None or a.prefetches_left <= 0:
            return False
        if a.prefetch_ok_left > 0:
            a.prefetch_ok_left -= 1
            return False
        a.prefetches_left -= 1
        _metrics.counter("faults.prefetch").inc()
        return True


# ---------------------------------------------------------------------------
# host-side checkpoint corruption (deterministic)
# ---------------------------------------------------------------------------

CORRUPTION_MODES = ("bitflip", "truncate", "drop-meta")


def corrupt_checkpoint(directory: str, mode: str = "bitflip", *,
                       seed: int = 0) -> str:
    """Deterministically damage a checkpoint directory (the format of
    ``repro_torch.checkpoint``, which is the reference's).

    ``bitflip`` flips one bit of the array payload at a seed-derived
    offset (CRC-detectable); ``truncate`` keeps only the first half of
    the payload (length-mismatch-detectable); ``drop-meta`` removes the
    manifest's ``meta`` side channel (consumers that need it must fail
    typed, not KeyError). Returns a description of what was done.
    """
    payload = os.path.join(directory, "arrays.npz")
    manifest = os.path.join(directory, "manifest.json")
    if mode == "bitflip":
        with open(payload, "rb") as fh:
            data = bytearray(fh.read())
        if not data:
            raise ValueError(f"{payload} is empty — nothing to flip")
        off = seed % len(data)
        data[off] ^= 0x01
        with open(payload, "wb") as fh:
            fh.write(bytes(data))
        return f"flipped bit 0 of byte {off}/{len(data)} in {payload}"
    if mode == "truncate":
        size = os.path.getsize(payload)
        with open(payload, "rb") as fh:
            head = fh.read(size // 2)
        with open(payload, "wb") as fh:
            fh.write(head)
        return f"truncated {payload} from {size} to {size // 2} bytes"
    if mode == "drop-meta":
        with open(manifest) as fh:
            doc = json.load(fh)
        doc.pop("meta", None)
        with open(manifest, "w") as fh:
            json.dump(doc, fh, indent=1)
        return f"dropped the meta side channel from {manifest}"
    raise ValueError(
        f"unknown corruption mode {mode!r}: expected one of "
        f"{CORRUPTION_MODES}")
