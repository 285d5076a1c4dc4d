# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Thread-safe labeled metrics: Counter / Gauge / Histogram + registry,
the port's copy of ``repro/obs/registry.py``.

Stdlib-only by design: ``repro_torch.resilience`` reports every fault
that fires through it, so it must never pull in the numeric stack.

Two access modes:

* **Injectable instance**: construct a `MetricsRegistry` and pass it
  around (or activate it with `use_registry`). This is what `observe()`
  does.
* **Process-global helpers**: `counter(name)`, `gauge(name)`,
  `histogram(name)` resolve against the currently active registry. When
  none is active they return shared *null* instruments whose methods are
  no-ops — instrumented hot paths pay two attribute loads and a
  comparison, nothing else.

Legacy counter dicts (`batcher.stats`, `ResidencyCounters`) are mirrored
through `register_callback(name, fn)`: the callback is invoked lazily at
`collect()` time, so the legacy dict remains the single source of truth
and its values stay bit-identical to pre-obs behavior.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "get_registry",
    "histogram",
    "use_registry",
]


class Counter:
    """Monotonic counter. `inc` is atomic under the instrument lock."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (queue depth, resident bytes, ...)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# Log-spaced bucket edges: 1 microsecond .. ~67 seconds, factor 2 per
# bucket. Sub-microsecond observations land in the underflow bucket,
# >67s in the overflow bucket; min/max are tracked exactly so the
# percentile interpolation clamps to the true range.
_EDGES: Tuple[float, ...] = tuple(1e-6 * (2.0 ** i) for i in range(27))


class Histogram:
    """Log-bucketed histogram with interpolated percentiles.

    Tuned for latency-style values in seconds; arbitrary non-negative
    floats work (negative observations clamp into the underflow bucket).
    """

    __slots__ = ("name", "labels", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        # counts[i] counts observations in [_EDGES[i-1], _EDGES[i]);
        # counts[0] is the underflow bucket, counts[-1] the overflow one.
        self._counts = [0] * (len(_EDGES) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            self._counts[self._bucket(v)] += 1

    @staticmethod
    def _bucket(v: float) -> int:
        if v < _EDGES[0]:
            return 0
        if v >= _EDGES[-1]:
            return len(_EDGES)
        # log2 search beats bisect for a fixed geometric grid
        i = int(math.log2(v / _EDGES[0])) + 1
        # float fuzz at bucket boundaries: nudge into the right bin
        while i > 0 and v < _EDGES[i - 1]:
            i -= 1
        while i < len(_EDGES) and v >= _EDGES[i]:
            i += 1
        return i

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated q-th percentile (q in [0, 100]); None when empty."""
        with self._lock:
            if self._count == 0:
                return None
            target = (q / 100.0) * self._count
            seen = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if seen + c >= target:
                    lo = self._min if i == 0 else _EDGES[i - 1]
                    hi = self._max if i == len(_EDGES) else _EDGES[i]
                    lo = max(lo, self._min)
                    hi = min(hi, self._max)
                    if hi <= lo:
                        return lo
                    frac = (target - seen) / c
                    return lo + frac * (hi - lo)
                seen += c
            return self._max

    def snapshot(self) -> dict:
        """JSON-safe summary (None percentiles when empty, never NaN)."""
        with self._lock:
            count, total = self._count, self._sum
            vmin = self._min if count else None
            vmax = self._max if count else None
        return {
            "count": count,
            "sum": total,
            "min": vmin,
            "max": vmax,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class _NullCounter:
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    @property
    def value(self) -> int:
        return 0


class _NullGauge:
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0


class _NullHistogram:
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def percentile(self, q: float) -> Optional[float]:
        return None

    def snapshot(self) -> dict:
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "p50": None, "p95": None, "p99": None}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


def _key(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create instrument store keyed by name + sorted labels."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._callbacks: Dict[str, Callable[[], dict]] = {}

    def counter(self, name: str, **labels: object) -> Counter:
        key = _key(name, labels)
        with self._lock:
            inst = self._counters.get(key)
            if inst is None:
                inst = Counter(name, tuple(sorted(
                    (k, str(v)) for k, v in labels.items())))
                self._counters[key] = inst
            return inst

    def gauge(self, name: str, **labels: object) -> Gauge:
        key = _key(name, labels)
        with self._lock:
            inst = self._gauges.get(key)
            if inst is None:
                inst = Gauge(name, tuple(sorted(
                    (k, str(v)) for k, v in labels.items())))
                self._gauges[key] = inst
            return inst

    def histogram(self, name: str, **labels: object) -> Histogram:
        key = _key(name, labels)
        with self._lock:
            inst = self._histograms.get(key)
            if inst is None:
                inst = Histogram(name, tuple(sorted(
                    (k, str(v)) for k, v in labels.items())))
                self._histograms[key] = inst
            return inst

    def register_callback(self, name: str, fn: Callable[[], dict]) -> None:
        """Mirror an external counter surface (a legacy stats dict) onto
        the registry. `fn` is called lazily at `collect()` — the legacy
        structure stays the source of truth, bit-for-bit."""
        with self._lock:
            self._callbacks[name] = fn

    def value(self, name: str, **labels: object) -> Optional[int]:
        """Current value of a counter, or None if it was never created
        (useful for assertions that a code path did NOT fire)."""
        key = _key(name, labels)
        with self._lock:
            inst = self._counters.get(key)
        return None if inst is None else inst.value

    def collect(self) -> dict:
        """One JSON-safe snapshot of every instrument + callback."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
            callbacks = dict(self._callbacks)
        out = {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(histograms.items())},
            "callbacks": {},
        }
        for name, fn in sorted(callbacks.items()):
            try:
                out["callbacks"][name] = dict(fn())
            except Exception as err:  # a dead callback must not kill collect
                out["callbacks"][name] = {"error": repr(err)}
        return out


_ACTIVE: Optional[MetricsRegistry] = None
_ACTIVE_LOCK = threading.Lock()


def get_registry() -> Optional[MetricsRegistry]:
    return _ACTIVE


def counter(name: str, **labels: object):
    reg = _ACTIVE
    return _NULL_COUNTER if reg is None else reg.counter(name, **labels)


def gauge(name: str, **labels: object):
    reg = _ACTIVE
    return _NULL_GAUGE if reg is None else reg.gauge(name, **labels)


def histogram(name: str, **labels: object):
    reg = _ACTIVE
    return _NULL_HISTOGRAM if reg is None else reg.histogram(name, **labels)


@contextmanager
def use_registry(registry: Optional[MetricsRegistry]) -> Iterator[None]:
    """Activate `registry` for the enclosed block (re-entrant: the prior
    active registry is restored on exit). Pass None to force-disable."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, registry
    try:
        yield
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = prev
