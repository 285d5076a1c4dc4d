# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Trace/metrics exporters: Chrome trace-event JSON, JSONL, summary; the
port's copy of ``repro/obs/export.py``.

The Chrome trace file loads directly in Perfetto (https://ui.perfetto.dev)
or chrome://tracing — spans become "X" (complete) events with
microsecond timestamps relative to the tracer's start. The summary JSON
is the machine-readable side file consumed by `repro_torch.obs.report`
and the chaos launcher's fault-counter assertions.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer

__all__ = [
    "chrome_trace",
    "summarize",
    "write_chrome_trace",
    "write_jsonl",
    "write_summary",
]


def _records(tracer: Tracer) -> List[dict]:
    with tracer._lock:
        return list(tracer.spans)


def chrome_trace(tracer: Tracer) -> dict:
    """Trace-event-format dict (the JSON object form, Perfetto-loadable)."""
    events = []
    for r in sorted(_records(tracer), key=lambda r: r["ts"]):
        events.append({
            "name": r["name"],
            "ph": "X",
            "ts": r["ts"] * 1e6,
            "dur": r["dur"] * 1e6,
            "pid": 0,
            "tid": r["tid"],
            "args": dict(r["args"]),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(tracer: Tracer, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(tracer), fh, default=str)


def write_jsonl(tracer: Tracer, path: str) -> None:
    """One span record per line, in completion order."""
    with open(path, "w") as fh:
        for r in _records(tracer):
            fh.write(json.dumps(r, default=str) + "\n")


def summarize(tracer: Optional[Tracer] = None,
              registry: Optional[MetricsRegistry] = None) -> dict:
    """Aggregate a tracer + registry into one JSON-safe summary dict.

    Keys (all optional depending on what was recorded):

    * ``wall_s`` — last span end relative to tracer start.
    * ``spans`` — per-name totals: ``{name: {count, total_s, mean_s, max_s}}``.
    * ``roots`` — top-level spans in order: ``[{name, dur_s, args}]``.
    * ``phases`` — per-root-name totals of *direct* children grouped by
      name: ``{"path": {"lambda_grid": s, "lambda_point": s}}``. For a
      single traced path solve the phase totals sum to the root span's
      duration minus inter-span gaps (strategy resolution, checkpoint
      bookkeeping) — within 5% of warm wall time.
    * ``per_lambda`` — one row per ``lambda_point`` span: its args
      (index, lam, nnz, status, ...), ``dur_s``, and direct-child phase
      totals (screen_round / restricted_solve / kkt_check / ...).
    * ``counters`` / ``gauges`` / ``histograms`` / ``callbacks`` — the
      registry's `collect()` snapshot, flattened in.
    """
    out: dict = {}
    if tracer is not None:
        records = _records(tracer)
        children: Dict[int, List[dict]] = {}
        per_name: Dict[str, dict] = {}
        roots: List[dict] = []
        for r in records:
            agg = per_name.setdefault(
                r["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += r["dur"]
            agg["max_s"] = max(agg["max_s"], r["dur"])
            if r["parent"] is None:
                roots.append(r)
            else:
                children.setdefault(r["parent"], []).append(r)
        for agg in per_name.values():
            agg["mean_s"] = agg["total_s"] / max(agg["count"], 1)

        def child_totals(rec: dict) -> Dict[str, float]:
            totals: Dict[str, float] = {}
            for c in children.get(rec["sid"], ()):
                totals[c["name"]] = totals.get(c["name"], 0.0) + c["dur"]
            return totals

        phases: Dict[str, Dict[str, float]] = {}
        for r in roots:
            fam = phases.setdefault(r["name"], {})
            for name, total in child_totals(r).items():
                fam[name] = fam.get(name, 0.0) + total

        per_lambda = [
            {**dict(r["args"]), "dur_s": r["dur"], "phases": child_totals(r)}
            for r in sorted(records, key=lambda r: r["ts"])
            if r["name"] == "lambda_point"
        ]

        out["wall_s"] = tracer.wall_s()
        out["spans"] = {k: per_name[k] for k in sorted(per_name)}
        out["roots"] = [{"name": r["name"], "dur_s": r["dur"],
                         "args": dict(r["args"])}
                        for r in sorted(roots, key=lambda r: r["ts"])]
        out["phases"] = phases
        out["per_lambda"] = per_lambda
    if registry is not None:
        out.update(registry.collect())
    return out


def write_summary(summary: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=2, default=str)
        fh.write("\n")
