# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Walk files, run the port's rules, apply pragmas, render findings: the
counterpart of ``repro/analysis/runner.py``.

``python -m repro_torch.analysis src/repro_torch chip_smoke.py`` exits 0
when every finding is fixed or carries a ``# allow[rule-id]: why``
pragma. There is no allowlist file. ``--format json``, ``--rules`` (ids,
comma-separated), ``--list-rules`` and ``--root`` behave as the
reference's.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.analysis.context import ModuleInfo, Project
from repro_torch.analysis.findings import Finding, suppress

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


@dataclass
class Report:
    findings: List[Finding]
    suppressed: List[Finding]
    n_files: int
    parse_errors: List[Finding] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors

    def as_json(self) -> dict:
        return {"version": 1, "ok": self.ok, "files": self.n_files,
                "findings": [f.as_json() for f in self.findings + self.parse_errors],
                "suppressed": [f.as_json() for f in self.suppressed]}


def _walk_py(paths: Sequence[str], root: str) -> List[str]:
    out: List[str] = []
    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            out.append(ap)
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__" and not d.startswith(".")]
            out.extend(os.path.join(dirpath, fn) for fn in sorted(filenames)
                       if fn.endswith(".py"))
    return sorted({os.path.relpath(ap, root).replace(os.sep, "/") for ap in out})


def load_project(paths: Sequence[str], *, root: Optional[str] = None):
    """-> (Project, parse-error findings)."""
    root = root or os.getcwd()
    modules, errors = [], []
    for rel in _walk_py(paths, root):
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            source = fh.read()
        try:
            modules.append(ModuleInfo.parse(rel, source))
        except SyntaxError as e:
            errors.append(Finding(file=rel, line=e.lineno or 1, rule="parse-error",
                                  message=f"file does not parse: {e.msg}"))
    return Project(root=root, modules=modules), errors


def run_analysis(paths: Sequence[str] = DEFAULT_PATHS, *, root: Optional[str] = None,
                 rules: Optional[Sequence[str]] = None) -> Report:
    from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

    project, parse_errors = load_project(paths, root=root)
    selected = ALL_RULES if rules is None else [RULES_BY_ID[r] for r in rules]
    findings: List[Finding] = []
    for rule in selected:
        findings.extend(rule.check(project))
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    kept, suppressed = suppress(findings, {m.path: m.lines for m in project.modules})
    return Report(findings=kept, suppressed=suppressed, n_files=len(project.modules),
                  parse_errors=parse_errors)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's lint: host reads through the engine's doors, metrics "
                    "through repro_torch.obs, synchronised timings, a plain version for "
                    "every kernel")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files or directories to scan (default: src/repro_torch "
                         "chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--rules", default=None, help="comma-separated rule ids (default: all)")
    ap.add_argument("--root", default=None,
                    help="the directory paths are relative to (default: cwd)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.RULE_ID:24s} {r.DOC}")
        return 0
    rules = args.rules.split(",") if args.rules else None
    unknown = [r for r in rules or () if r not in RULES_BY_ID]
    if unknown:
        ap.error(f"unknown rule id(s) {unknown}; --list-rules lists them")
    report = run_analysis(args.paths or DEFAULT_PATHS, root=args.root, rules=rules)
    if args.format == "json":
        print(json.dumps(report.as_json(), indent=2))
    else:
        for f in report.findings + report.parse_errors:
            print(f.render())
        print(f"# scanned {report.n_files} files: "
              f"{len(report.findings) + len(report.parse_errors)} finding(s), "
              f"{len(report.suppressed)} suppressed")
    return 0 if report.ok else 1
