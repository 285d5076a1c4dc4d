# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""The port's lint rules. Each module defines ``RULE_ID``, ``DOC`` and
``check(project) -> Iterable[Finding]``; every id starts with ``torch-``.

The reference's ``dead-code``, ``psum-axis``, ``retrace`` and
``sharded-concat`` rules have no object in the port (no ``jit``, no
``shard_map``; its dead-code roots are the line-1 pragma); its
``bucket-residency`` and ``nonfinite-guard`` are
``torch-bucket-residency`` and ``torch-nonfinite-guard`` here.
"""
from __future__ import annotations

from repro_torch.analysis.rules import (bench_timing, bucket_residency, host_sync, kernel_plain,
                                        metric_discipline, nonfinite_guard)

ALL_RULES = (host_sync, metric_discipline, bench_timing, kernel_plain, bucket_residency,
             nonfinite_guard)

RULES_BY_ID = {r.RULE_ID: r for r in ALL_RULES}
