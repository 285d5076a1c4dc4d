# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's lint rules. Each module defines ``RULE_ID``, ``DOC`` and
``check(project) -> Iterable[Finding]``; every id starts with ``torch-``.

The reference's ``dead-code``, ``psum-axis``, ``retrace`` and
``sharded-concat`` rules have no object in the port (no ``jit``, no
``shard_map``; its dead-code roots are the line-1 pragma), and its
``bucket-residency`` and ``nonfinite-guard`` wait for a later slice
(ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.analysis.rules import bench_timing, host_sync, kernel_plain, metric_discipline

ALL_RULES = (host_sync, metric_discipline, bench_timing, kernel_plain)

RULES_BY_ID = {r.RULE_ID: r for r in ALL_RULES}
