# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""torch-bench-timing: a host-clock pair around CUDA work with nothing
that waits for the card between the two reads (the counterpart of the
reference's ``bench-timing``).

CUDA launches are asynchronous: without a ``torch.cuda.synchronize()``,
an event's or a stream's ``synchronize()``, or one of the engine's
counted host reads (``host_read`` / ``host_array``, which wait for the
work they read) between the two ``perf_counter`` reads, the pair times
the enqueue, not the work.

Scope: every scanned module that imports torch, and ``chip_smoke.py``
(which takes torch as an argument). Per function or class, two or more
clock reads with no synchronisation at or after the first of them and at
or before the last is a finding at the last read. A timed region that
waits by other means (it ends in a call whose result is read on the
host) carries an ``allow[torch-bench-timing]`` pragma saying so.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis.context import ModuleInfo, Project
from repro_torch.analysis.findings import Finding

RULE_ID = "torch-bench-timing"
DOC = ("perf_counter pair around CUDA work with no synchronize()/counted host read between "
       "the reads -- times the enqueue, not the work")

_CLOCKS = ("time.perf_counter", "perf_counter", "time.monotonic", "monotonic", "time.time")
_SYNC_CALLS = ("torch.cuda.synchronize", "synchronize", "host_read", "host_array")


def _in_scope(mod: ModuleInfo) -> bool:
    return mod.imports_torch or mod.path.rsplit("/", 1)[-1] == "chip_smoke.py"


def _scope_lines(scope: ast.AST, mod: ModuleInfo):
    clocks, syncs = [], []
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        q = mod.qualname(node.func)
        if q in _CLOCKS:
            clocks.append(node.lineno)
        elif q in _SYNC_CALLS or (isinstance(node.func, ast.Attribute)
                                  and node.func.attr in _SYNC_CALLS):
            syncs.append(node.lineno)
    return sorted(clocks), syncs


def _unsynced(scope: ast.AST, mod: ModuleInfo):
    clocks, syncs = _scope_lines(scope, mod)
    if len(clocks) < 2:
        return None
    if any(clocks[0] <= s <= clocks[-1] for s in syncs):
        return None
    return clocks[-1]


def check(project: Project) -> Iterable[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if not _in_scope(mod):
            continue
        # classes first: a timer may split its pair across methods; the
        # methods of a reported class are not reported again
        reported = set()
        scopes = [n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]
        scopes += [fn for fn in mod.functions()]
        for scope in scopes:
            if scope in reported:
                continue
            line = _unsynced(scope, mod)
            if line is None:
                continue
            if isinstance(scope, ast.ClassDef):
                reported.update(n for n in ast.walk(scope)
                                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
                name = f"class {scope.name}"
            else:
                name = f"{scope.name}()"
            out.append(Finding(
                file=mod.path, line=line, rule=RULE_ID,
                message=(f"{name} takes a perf_counter difference with no synchronize() or "
                         f"counted host read between the reads -- CUDA launches are "
                         f"asynchronous, so this times the enqueue; wait for the work "
                         f"before the second read (or allow[{RULE_ID}] stating how the "
                         f"timed region waits)")))
    return out
