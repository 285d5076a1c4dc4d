# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""torch-metric-discipline: wall clocks and hand-rolled counters in the
library outside ``repro_torch.obs`` (the counterpart of the reference's
``metric-discipline``).

``repro_torch.obs`` is the port's one observability surface: spans own
wall time (closed at existing host reads), the registry owns counters,
and legacy stat dicts are mirrored onto it by ``register_metrics``
callbacks. A ``time.perf_counter()`` / ``time.monotonic()`` /
``time.time()`` call, or an ``x += ...`` onto a stats/counter/metric/
telemetry-named target, elsewhere in the library is a second telemetry
channel the trace summaries never see.

Scope: modules of the ``repro_torch`` package outside ``obs/`` and
``launch/`` (launchers time things for a living, as the reference's
allowlist exempts them). Increments inside a class that defines
``register_metrics`` are the sanctioned adapter shape and pass. A clock
read that is not a measurement (a deadline) carries an
``allow[torch-metric-discipline]`` pragma saying so.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from repro_torch.analysis.context import Project
from repro_torch.analysis.findings import Finding

RULE_ID = "torch-metric-discipline"
DOC = ("raw wall-clock call or ad-hoc counter increment in the library outside "
       "repro_torch.obs -- use obs spans / registry counters or a register_metrics adapter")

_EXEMPT = ("obs/", "launch/")
_CLOCKS = ("time.perf_counter", "time.monotonic", "time.time", "perf_counter", "monotonic")
#: substrings of the dotted target that mark a counter (not bare "count":
#: loop counters are not telemetry)
_COUNTERISH = ("stats", "counter", "metric", "telemetry")


def _target_chain(node: ast.AST) -> Optional[str]:
    """Dotted chain of an augmented-assignment target (``self._stats`` for
    ``self._stats["drained"] += n``); None for other targets."""
    if isinstance(node, ast.Subscript):
        return _target_chain(node.value)
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return ".".join(reversed(parts))


def _adapter_nodes(tree: ast.Module) -> Set[ast.AST]:
    """Nodes inside classes that define ``register_metrics``."""
    out: Set[ast.AST] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name == "register_metrics" for fn in node.body):
            out.update(ast.walk(node))
    return out


def check(project: Project) -> Iterable[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        sub = mod.package_path
        if sub is None or sub.startswith(_EXEMPT):
            continue
        exempt = _adapter_nodes(mod.tree)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and mod.qualname(node.func) in _CLOCKS:
                out.append(Finding(
                    file=mod.path, line=node.lineno, rule=RULE_ID,
                    message=(f"raw {mod.qualname(node.func)}() outside repro_torch.obs -- "
                             f"put the region in an obs.trace span so its time reaches "
                             f"the trace summaries (or allow[{RULE_ID}] stating why this "
                             f"is not a measurement)")))
            elif isinstance(node, ast.AugAssign) and node not in exempt:
                chain = _target_chain(node.target)
                if chain and any(w in chain.lower() for w in _COUNTERISH):
                    out.append(Finding(
                        file=mod.path, line=node.lineno, rule=RULE_ID,
                        message=(f"ad-hoc counter increment on {chain} outside "
                                 f"repro_torch.obs -- use obs.registry.counter(...) or "
                                 f"mirror the dict through a register_metrics adapter (or "
                                 f"allow[{RULE_ID}] stating why)")))
    return out
