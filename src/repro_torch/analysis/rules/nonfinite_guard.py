# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""torch-nonfinite-guard: a host crossing on the serve boundary or in the
engine with no finiteness check (the counterpart of the reference's
``nonfinite-guard``).

The serving stack's contract is that poison never reaches a caller: the
scores cross to the host once per batch, and that crossing is where
NaN/Inf is caught (``PathScorer.score`` quarantines the snapshot and
rescores); the engine's ``fetch`` reads the histories beside the typed
device-side ``status``. A new crossing in these layers without a check
is a hole in that contract: one poisoned coefficient row and the NaN
reaches a response.

Scope: ``serve/`` and ``core/engine.py`` of the package, and any module
of it that imports ``repro_torch.serve``. Within scope a function that
crosses a device value to the host -- ``engine.host_read`` /
``host_array`` (or the doors' own names), ``.item()``, ``.tolist()``,
``.numpy()`` or ``.cpu()`` -- must name ``isfinite`` / ``isnan``
somewhere in its body, or carry an ``allow[torch-nonfinite-guard]``
pragma saying why the value cannot be poisoned (a count, a status code,
an oracle beside the served read).
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.context import ModuleInfo, Project
from repro_torch.analysis.findings import Finding

RULE_ID = "torch-nonfinite-guard"
DOC = ("a device->host crossing in serve/ or core/engine.py with no isfinite/isnan check "
       "in the function -- poison can reach a caller")

_DOORS = ("host_read", "host_array")
_METHODS = ("item", "tolist", "numpy", "cpu")


def _in_scope(mod: ModuleInfo) -> bool:
    path = mod.package_path
    if path is None:
        return False
    if path.startswith("serve/") or path == "core/engine.py":
        return True
    return any(m == "repro_torch.serve" or m.startswith("repro_torch.serve.")
               for m in mod.imported_modules)


def _crossing(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr in _DOORS + _METHODS
    return isinstance(func, ast.Name) and func.id in _DOORS


def _has_guard(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        name = node.attr if isinstance(node, ast.Attribute) else (
            node.id if isinstance(node, ast.Name) else None)
        if name in ("isfinite", "isnan"):
            return True
    return False


def _outermost(mod: ModuleInfo):
    """The module's functions that no other function encloses (a nested
    function is checked with its encloser)."""
    inner = set()
    for fn in mod.functions():
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner.add(node)
    return [fn for fn in mod.functions() if fn not in inner]


def check(project: Project) -> Iterable[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if not _in_scope(mod):
            continue
        for fn in _outermost(mod):
            if fn.name in _DOORS and mod.package_path == "core/engine.py":
                continue   # the doors themselves: their callers hold the guard
            hits = [n for n in ast.walk(fn) if isinstance(n, ast.Call) and _crossing(n)]
            if not hits or _has_guard(fn):
                continue
            node = hits[0]
            out.append(Finding(
                file=mod.path, line=node.lineno, rule=RULE_ID,
                message=(f"{fn.name}() crosses a device value to the host with no "
                         f"isfinite/isnan check in the function -- on the serve/engine "
                         f"boundary poison must be caught at the crossing (or "
                         f"allow[{RULE_ID}] stating why this value cannot be poisoned)")))
    return out
