# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Human-readable report over an obs summary JSON, the port's copy of
``repro/obs/report.py``.

    python -m repro_torch.obs.report run1.summary.json

Prints the per-lambda phase table (where each point of the path spent
its wall time), serve p50/p95/p99 latency when a serve histogram was
recorded, and the residency hit-rate when a residency manager was
registered. `render_summary` is the library entry point that prints the
same report inline.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

__all__ = ["main", "render_summary"]

# lambda_point children, in pipeline order, with compact column labels
_PHASE_COLS = (
    ("screen_round", "screen"),
    ("restricted_solve", "solve"),
    ("kkt_check", "kkt"),
    ("point_finish", "finish"),
)


def _fmt_s(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.4f}"


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 1e3:.2f}ms"


def _per_lambda_table(rows: List[dict]) -> List[str]:
    head = (f"{'idx':>4} {'lambda':>12} {'dur_s':>9} "
            + " ".join(f"{label:>9}" for _, label in _PHASE_COLS)
            + f" {'other':>9} {'nnz':>7}  status")
    lines = ["per-lambda phases (seconds):", head, "-" * len(head)]
    for row in rows:
        phases = row.get("phases", {})
        known = sum(phases.get(name, 0.0) for name, _ in _PHASE_COLS)
        other = max(row.get("dur_s", 0.0) - known, 0.0)
        lam = row.get("lam")
        lines.append(
            f"{row.get('index', '-'):>4} "
            f"{lam if lam is None else format(lam, '12.6g'):>12} "
            f"{row.get('dur_s', 0.0):>9.4f} "
            + " ".join(f"{phases.get(name, 0.0):>9.4f}"
                       for name, _ in _PHASE_COLS)
            + f" {other:>9.4f} {str(row.get('nnz', '-')):>7}"
            + f"  {row.get('status', '')}")
    return lines


def render_summary(summary: dict) -> str:
    """Render an obs summary dict (see `repro_torch.obs.export.summarize`)."""
    lines: List[str] = []
    wall = summary.get("wall_s")
    if wall is not None:
        lines.append(f"traced wall time: {wall:.3f}s")
    root_agg: dict = {}
    for root in summary.get("roots", []):
        agg = root_agg.setdefault(root["name"], [0, 0.0])
        agg[0] += 1
        agg[1] += root["dur_s"]
    for name, (count, total) in sorted(root_agg.items(),
                                       key=lambda kv: -kv[1][1]):
        mult = f" x{count}" if count > 1 else ""
        lines.append(f"  root span {name}{mult}: {total:.3f}s")
    phases = summary.get("phases", {})
    for root_name in sorted(phases):
        fam = phases[root_name]
        if not fam:           # leaf roots (stray encodes etc.): no table
            continue
        total = sum(fam.values())
        lines.append(f"phase totals under '{root_name}' "
                     f"(sum {total:.3f}s):")
        for name in sorted(fam, key=fam.get, reverse=True):
            lines.append(f"  {name:<18} {fam[name]:>9.4f}s")
    per_lambda = summary.get("per_lambda", [])
    if per_lambda:
        lines.append("")
        lines.extend(_per_lambda_table(per_lambda))

    hist = summary.get("histograms", {}).get("serve.latency_s")
    if hist and hist.get("count"):
        lines.append("")
        lines.append(
            f"serve submit->score latency ({hist['count']} requests): "
            f"p50 {_fmt_ms(hist['p50'])} / p95 {_fmt_ms(hist['p95'])} / "
            f"p99 {_fmt_ms(hist['p99'])} "
            f"(min {_fmt_ms(hist['min'])}, max {_fmt_ms(hist['max'])})")

    callbacks = summary.get("callbacks", {})
    for name in sorted(callbacks):
        stats = callbacks[name]
        if name.startswith("residency"):
            hits, misses = stats.get("hits", 0), stats.get("misses", 0)
            total = hits + misses
            if total:
                lines.append(
                    f"{name}: hit rate {hits / total:.2f} "
                    f"({hits} hits / {misses} misses, "
                    f"{stats.get('evictions', 0)} evictions, "
                    f"{stats.get('bytes_h2d', 0)} bytes h2d)")
        elif name == "serve.batcher":
            lines.append(f"{name}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(stats.items())))

    counters = summary.get("counters", {})
    interesting = {k: v for k, v in counters.items()
                   if k.startswith(("faults.", "retry.", "serve."))}
    if interesting:
        lines.append("counters: " + ", ".join(
            f"{k}={v}" for k, v in sorted(interesting.items())))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render an obs summary JSON (written by "
                    "ObsSession.export or chaos_glm's --trace flag) as a "
                    "phase report.")
    ap.add_argument("summary", help="path to a *.summary.json file")
    args = ap.parse_args(argv)
    with open(args.summary) as fh:
        summary = json.load(fh)
    print(render_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
