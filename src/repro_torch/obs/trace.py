# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Nestable trace spans with a zero-cost disabled path, the port's copy
of ``repro/obs/trace.py``.

Stdlib-only: a span records two `time.perf_counter` reads and a dict
append -- it never touches device values, so enabling a trace cannot add
device->host transfers. Call sites belong at *existing* sync points (the
engine's counted ``engine.host_read``, ``engine.fetch``, the scorer's
read of its scores); asynchronous launches between sync points are
attributed to the span that owns the next sync, which is the honest
accounting for an asynchronous runtime. (The port places no spans yet:
the span tree below is the reference's, which the port's path and serve
loops are to mirror.)

The span tree mirrors the solver and serve loops::

    path > lambda_grid
         > lambda_point > screen_round
                        > restricted_solve > bucket_stream
                        > kkt_check        > bucket_stream
                        > point_finish
    serve > drain
          > encode        (from submit; parents under serve when nested)
          > score
          > swap

Nesting is tracked per-thread: each thread keeps its own span stack, so
a serve thread and a solver thread never corrupt each other's parents.

With no active tracer, `span()` returns a shared `_NULL_SPAN` singleton
whose `__enter__`/`__exit__`/`set` are no-ops.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

__all__ = ["Tracer", "event", "get_tracer", "span", "use_tracer"]


class _Span:
    """Context manager recording one timed span on `tracer`."""

    __slots__ = ("_tracer", "name", "args", "sid", "parent", "_t0", "_tid")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.sid = next(tracer._sid)
        self.parent: Optional[int] = None
        self._t0 = 0.0
        self._tid = 0

    def set(self, **kw: object) -> "_Span":
        """Attach result metadata (nnz, status, ...) to the open span."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack()
        self.parent = stack[-1].sid if stack else None
        self._tid = tracer._tid()
        stack.append(self)
        self._t0 = tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = self._tracer.clock()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._tracer._record(self, self._t0, t1 - self._t0, self._tid)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **kw: object) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects span records; thread-safe, append-only.

    Records are plain dicts (`name`, `ts`, `dur`, `tid`, `sid`,
    `parent`, `args`) with `ts`/`dur` in seconds relative to the
    tracer's construction — `repro_torch.obs.export` turns them into Chrome
    trace events / JSONL / summaries.
    """

    def __init__(self, clock=time.perf_counter) -> None:
        self.clock = clock
        self.t0 = clock()
        self.spans: List[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sid = itertools.count(1)
        self._tids: Dict[int, int] = {}

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            return tid

    def _record(self, sp: _Span, t0: float, dur: float, tid: int) -> None:
        rec = {
            "name": sp.name,
            "ts": t0 - self.t0,
            "dur": dur,
            "tid": tid,
            "sid": sp.sid,
            "parent": sp.parent,
            "args": sp.args,
        }
        with self._lock:
            self.spans.append(rec)

    def span(self, name: str, **args: object) -> _Span:
        return _Span(self, name, args)

    def event(self, name: str, **args: object) -> None:
        """Record an instantaneous (zero-duration) marker."""
        stack = self._stack()
        rec = {
            "name": name,
            "ts": self.clock() - self.t0,
            "dur": 0.0,
            "tid": self._tid(),
            "sid": next(self._sid),
            "parent": stack[-1].sid if stack else None,
            "args": args,
        }
        with self._lock:
            self.spans.append(rec)

    def wall_s(self) -> float:
        """Wall time covered so far: last span end (or now if none)."""
        with self._lock:
            if not self.spans:
                return self.clock() - self.t0
            return max(r["ts"] + r["dur"] for r in self.spans)


_ACTIVE: Optional[Tracer] = None
_ACTIVE_LOCK = threading.Lock()


def get_tracer() -> Optional[Tracer]:
    return _ACTIVE


def span(name: str, **args: object):
    tracer = _ACTIVE
    return _NULL_SPAN if tracer is None else tracer.span(name, **args)


def event(name: str, **args: object) -> None:
    tracer = _ACTIVE
    if tracer is not None:
        tracer.event(name, **args)


@contextmanager
def use_tracer(tracer: Optional[Tracer]) -> Iterator[None]:
    """Activate `tracer` for the enclosed block (re-entrant: the prior
    active tracer is restored on exit). Pass None to force-disable."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, tracer
    try:
        yield
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev
