# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Finding records and pragma suppression for the port's lint, with the
semantics of ``repro/analysis/findings.py`` minus its allowlist file.

A finding is suppressed by ``# allow[rule-id]: why`` on its line or on a
comment line directly above it. A pragma without a reason does not
suppress: it is itself a ``bad-pragma`` finding.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

#: per-line pragma: ``# allow[rule-id]: one-line justification``
PRAGMA_RE = re.compile(r"#\s*allow\[(?P<rule>[a-z0-9-]+)\]\s*:\s*(?P<why>\S.*)?$")
PRAGMA_ANY_RE = re.compile(r"#\s*allow\[")


@dataclass(frozen=True)
class Finding:
    file: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line} · {self.rule} · {self.message}"

    def as_json(self) -> dict:
        return {"file": self.file, "line": self.line, "rule": self.rule,
                "message": self.message}


def _pragma_allows(lines: List[str], f: Finding, bad: List[Finding]) -> bool:
    """Same-line pragma, or a standalone comment line directly above; a
    matching pragma without a reason is recorded in ``bad``."""
    candidates = []
    if 1 <= f.line <= len(lines):
        candidates.append(lines[f.line - 1])
        if f.line >= 2 and lines[f.line - 2].lstrip().startswith("#"):
            candidates.append(lines[f.line - 2])
    for text in candidates:
        if not PRAGMA_ANY_RE.search(text):
            continue
        m = PRAGMA_RE.search(text)
        if m and m.group("rule") == f.rule:
            if m.group("why"):
                return True
            bad.append(Finding(file=f.file, line=f.line, rule="bad-pragma",
                               message=f"allow[{f.rule}] pragma without a justification -- "
                                       f"add one after the colon"))
    return False


def suppress(findings: Sequence[Finding],
             lines_by_file: Dict[str, List[str]]) -> Tuple[List[Finding], List[Finding]]:
    """-> (kept, suppressed); bad-pragma findings are appended to kept."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    bad: List[Finding] = []
    for f in findings:
        if _pragma_allows(lines_by_file.get(f.file, []), f, bad):
            suppressed.append(f)
        else:
            kept.append(f)
    return kept + bad, suppressed
