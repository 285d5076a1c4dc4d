# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""torch-host-sync: a device read outside the engine's counted doors (the
counterpart of the reference's ``host-sync-in-jit``).

The port's contract is k + 1 host reads per fit of k outer iterations
(k + 2 for a slab fit) plus the path driver's, every one through
``core/engine.py``'s ``host_read`` or ``host_array``, where
``engine.host_syncs`` counts them and ``analysis.sanitize`` audits them.
A ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` on a CUDA tensor,
or a ``torch.cuda.synchronize()``, anywhere else in the library is a read
the count does not see.

Scope: modules of the ``repro_torch`` package, except the bodies of the
two doors. The rule cannot tell a tensor from a numpy array or a host
tensor, so a call that is not a device read on a solve's path (a numpy
scalar, a checkpoint's host copy, a launcher's print) carries an
``allow[torch-host-sync]`` pragma saying so.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.context import Project
from repro_torch.analysis.findings import Finding

RULE_ID = "torch-host-sync"
DOC = (".item()/.tolist()/.cpu()/.numpy()/torch.cuda.synchronize() in the library outside "
       "core/engine.py's counted doors (host_read, host_array)")

_METHODS = ("item", "tolist", "cpu", "numpy")
_SYNCS = ("torch.cuda.synchronize",)
#: the module and functions that are the sanctioned doors
_DOOR_MODULE, _DOORS = "core/engine.py", ("host_read", "host_array")


def _door_nodes(mod) -> Set[ast.AST]:
    if mod.package_path != _DOOR_MODULE:
        return set()
    return {n for fn in mod.tree.body
            if isinstance(fn, ast.FunctionDef) and fn.name in _DOORS
            for n in ast.walk(fn)}


def check(project: Project) -> Iterable[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if mod.package_path is None:
            continue
        doors = _door_nodes(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or node in doors:
                continue
            if mod.qualname(node.func) in _SYNCS:
                what = "torch.cuda.synchronize()"
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _METHODS:
                what = f".{node.func.attr}()"
            else:
                continue
            out.append(Finding(
                file=mod.path, line=node.lineno, rule=RULE_ID,
                message=(f"{what} outside the engine's counted doors -- a device read "
                         f"engine.host_syncs does not count; read through "
                         f"engine.host_read / host_array (or allow[{RULE_ID}] stating why "
                         f"this is not a device read on a solve's path)")))
    return out
