# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""repro_torch.obs -- metrics registry and trace spans, the port's copy of
``repro.obs`` (stdlib only; the port imports nothing of ``repro``).

The subsystem has three rules that every instrumented call site obeys:

1. **Disabled means free.** With no active registry/tracer the module-level
   helpers (`counter`, `gauge`, `histogram`, `span`) return shared null
   singletons whose methods are no-ops -- a couple of attribute loads and a
   comparison per call site, no allocation, no locking.
2. **Timestamps only at existing sync points.** Spans wrap code that
   already synchronises with the device (the engine's counted
   ``engine.host_read``, ``engine.fetch``, the scorer's read of its
   scores). Tracing never adds a device->host transfer.
3. **Legacy counters stay the source of truth.** ``batcher.stats``,
   ``residency_stats()`` and friends are mirrored onto the registry
   through read-only callbacks (`register_callback`), never rewritten.

In the port today the registry carries the fault and retry counters of
``repro_torch.resilience`` (``faults.*``, ``retry.*``) and the store's
``serve.swaps``; spans and the other serve metrics come later. Typical
use::

    from repro_torch.obs import observe

    with observe() as obs:
        ...                     # a chaos drill, a path, a serve loop
    obs.export("run1")          # run1.trace.json / run1.summary.json / ...
    print(obs.summary()["counters"])

`run1.trace.json` opens directly in Perfetto / chrome://tracing.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

from repro_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    counter,
    gauge,
    get_registry,
    histogram,
    use_registry,
)
from repro_torch.obs.trace import Tracer, event, get_tracer, span, use_tracer
from repro_torch.obs.export import (
    chrome_trace,
    summarize,
    write_chrome_trace,
    write_jsonl,
    write_summary,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsSession",
    "Tracer",
    "chrome_trace",
    "counter",
    "event",
    "gauge",
    "get_registry",
    "get_tracer",
    "histogram",
    "observe",
    "render_summary",   # lazy: resolved from repro_torch.obs.report on access
    "span",
    "summarize",
    "use_registry",
    "use_tracer",
    "write_chrome_trace",
    "write_jsonl",
    "write_summary",
]


def __getattr__(name: str):
    # render_summary lives in repro_torch.obs.report; importing it eagerly here
    # would shadow `python -m repro_torch.obs.report` (runpy's found-in-
    # sys.modules warning), so resolve it lazily on attribute access
    if name == "render_summary":
        from repro_torch.obs.report import render_summary

        return render_summary
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ObsSession:
    """Handle on one `observe()` window: its tracer + registry + exports."""

    def __init__(self, tracer: Tracer, registry: MetricsRegistry) -> None:
        self.tracer = tracer
        self.registry = registry

    def summary(self) -> dict:
        return summarize(self.tracer, self.registry)

    def export(self, prefix: str) -> dict:
        """Write ``{prefix}.trace.json`` (Chrome trace-event format),
        ``{prefix}.events.jsonl`` and ``{prefix}.summary.json``; return
        ``{"trace": path, "events": path, "summary": path}``."""
        paths = {
            "trace": f"{prefix}.trace.json",
            "events": f"{prefix}.events.jsonl",
            "summary": f"{prefix}.summary.json",
        }
        write_chrome_trace(self.tracer, paths["trace"])
        write_jsonl(self.tracer, paths["events"])
        write_summary(self.summary(), paths["summary"])
        return paths


@contextmanager
def observe() -> Iterator[ObsSession]:
    """Activate a fresh tracer + registry for the enclosed block.

    Nestable and re-entrant: the previously active pair (if any) is
    restored on exit, so a traced benchmark can run inside a traced
    launcher without either clobbering the other.
    """
    tracer = Tracer()
    registry = MetricsRegistry()
    with use_tracer(tracer), use_registry(registry):
        yield ObsSession(tracer, registry)
