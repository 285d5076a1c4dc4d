# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""torch-kernel-plain: every kernel keeps its plain version, and the
dispatch reaches the plain version only off the card (the counterpart of
the reference's ``pallas-conventions``).

The port's kernels are held on the card against plain PyTorch versions
in ``kernels/ref.py``, and on the CPU the dispatch (``kernels/ops.py``)
runs those plain versions. Two conventions keep that honest:

1. every public ``<name>_kernel`` launcher in ``kernels/`` has a
   ``<name>_ref`` in ``kernels/ref.py``;
2. in ``kernels/ops.py``, a public function that reaches the plain
   version (a ``ref.`` call, or a private helper of ``ops.py`` that makes
   one) first tests ``_on_cuda(...)`` in an ``if`` whose body returns or
   raises, and reaches the plain version only after that ``if`` or in its
   ``else``: on a CUDA tensor it launches the kernel or raises, never
   falls back.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from repro_torch.analysis.context import ModuleInfo, Project
from repro_torch.analysis.findings import Finding

RULE_ID = "torch-kernel-plain"
DOC = ("a *_kernel launcher without its *_ref in kernels/ref.py, or kernels/ops.py reaching "
       "the plain version outside its non-CUDA branch")

_REF = "kernels/ref.py"
_OPS = "kernels/ops.py"
_GUARD = "_on_cuda"


def _top_defs(mod: ModuleInfo) -> List[ast.FunctionDef]:
    return [n for n in mod.tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _check_refs(project: Project) -> Iterable[Finding]:
    ref = project.in_package(_REF)
    ref_names: Optional[Set[str]] = (
        None if ref is None else {fn.name for fn in _top_defs(ref)})
    for mod in project.modules:
        sub = mod.package_path
        if sub is None or not sub.startswith("kernels/") or sub in (_REF, _OPS):
            continue
        for fn in _top_defs(mod):
            if fn.name.startswith("_") or not fn.name.endswith("_kernel"):
                continue
            base = fn.name[:-len("_kernel")]
            if ref_names is None or f"{base}_ref" not in ref_names:
                yield Finding(
                    file=mod.path, line=fn.lineno, rule=RULE_ID,
                    message=(f"kernel launcher {fn.name}() has no {base}_ref plain version "
                             f"in kernels/ref.py -- every kernel keeps a plain PyTorch "
                             f"version to be held against"))


def _is_plain_call(mod: ModuleInfo, node: ast.AST, helpers: Set[str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    q = mod.qualname(node.func) or ""
    return q.startswith("repro_torch.kernels.ref.") or q in helpers


def _plain_helpers(mod: ModuleInfo) -> Set[str]:
    """Private top-level functions of ops.py that reach the plain version,
    directly or through another such helper."""
    defs = {fn.name: fn for fn in _top_defs(mod) if fn.name.startswith("_")}
    helpers: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, fn in defs.items():
            if name not in helpers and any(_is_plain_call(mod, n, helpers)
                                           for n in ast.walk(fn)):
                helpers.add(name)
                changed = True
    return helpers


def _guard_if(stmt: ast.stmt) -> bool:
    """An ``if _on_cuda(...):`` whose body ends by returning or raising."""
    return (isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Call)
            and isinstance(stmt.test.func, ast.Name) and stmt.test.func.id == _GUARD
            and isinstance(stmt.body[-1], (ast.Return, ast.Raise)))


def _check_ops(project: Project) -> Iterable[Finding]:
    mod = project.in_package(_OPS)
    if mod is None:
        return
    helpers = _plain_helpers(mod)
    for fn in _top_defs(mod):
        if fn.name.startswith("_"):
            continue
        plain = [n for n in ast.walk(fn) if _is_plain_call(mod, n, helpers)]
        if not plain:
            continue
        allowed: Set[ast.AST] = set()
        guarded = False
        for stmt in fn.body:
            if guarded:
                allowed.update(ast.walk(stmt))
            elif _guard_if(stmt):
                guarded = True
                for s in stmt.orelse:
                    allowed.update(ast.walk(s))
        for node in plain:
            if node not in allowed:
                yield Finding(
                    file=mod.path, line=node.lineno, rule=RULE_ID,
                    message=(f"{fn.name}() reaches the plain version outside its non-CUDA "
                             f"branch -- test `if {_GUARD}(...):` first, launch the kernel "
                             f"(or raise) there, and run the plain version only after it"))


def check(project: Project) -> Iterable[Finding]:
    out: List[Finding] = list(_check_refs(project))
    out.extend(_check_ops(project))
    return out
