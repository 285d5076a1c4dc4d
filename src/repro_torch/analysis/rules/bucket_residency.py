# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""torch-bucket-residency: a slab placed on a device outside its one home
(the counterpart of the reference's ``bucket-residency``).

Slab device memory is budgeted in one module, ``data/residency.py``: the
``BucketResidencyManager`` owns the padded work buckets (LRU under
``device_budget_bytes``, pinned host copies, the side-stream copies and
their events, the lost-bucket retry and its injection point), and every
other slab placement (a flat design's solve, a serve request slab) goes
through its ``put_slab`` door. A ``.to(device)`` or ``.cuda()`` of slab
arrays anywhere else is invisible to the budget and to the drill: on a
process mesh it can hold a rank's whole piece on the card under a budget
that was meant to stream it.

The heuristic is name-based, as the reference's: a ``.to(...)`` that
names a device (a ``device=`` keyword, or a first argument that is not a
``torch`` dtype) or a ``.cuda()``, called on an expression whose last
name looks like a slab operand (``row_idx``, ``values``, ``rows``,
``vals``, ``r_b``, ``v_b``, ``rows_sub``, ``vals_sub``, or a name holding
``slab`` or ``row_idx``), is a finding in any module of the package but
``data/residency.py``. A placement of something else under such a name
says so in an ``allow[torch-bucket-residency]: reason`` pragma.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from repro_torch.analysis.context import Project
from repro_torch.analysis.findings import Finding

RULE_ID = "torch-bucket-residency"
DOC = (".to(device)/.cuda() of slab arrays outside data/residency.py -- place slabs "
       "through BucketResidencyManager / put_slab (the one home of the slab budget)")

#: the one module that places slabs on a device
_HOME = "data/residency.py"
_SLAB_NAMES = {"row_idx", "values", "rows", "vals", "r_b", "v_b", "rows_sub", "vals_sub"}
_DTYPES = {"float32", "float16", "bfloat16", "float64", "int32", "int64", "int8", "uint8",
           "bool", "float", "int", "long", "half", "double"}


def _trailing_name(node: ast.AST) -> Optional[str]:
    """The last identifier of an expression: ``row_idx`` for ``row_idx``,
    ``batch.row_idx`` and ``batch.row_idx[:, 0]``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_slabby(name: Optional[str]) -> bool:
    return name is not None and (name in _SLAB_NAMES or "slab" in name or "row_idx" in name)


def _is_dtype(mod, node: ast.AST) -> bool:
    q = mod.qualname(node)
    return q is not None and q.startswith("torch.") and q.split(".")[-1] in _DTYPES


def _places(mod, call: ast.Call) -> bool:
    """Whether ``x.to(...)`` / ``x.cuda(...)`` names a device."""
    attr = call.func.attr
    if attr == "cuda":
        return True
    if attr != "to":
        return False
    if any(k.arg == "device" for k in call.keywords):
        return True
    return bool(call.args) and not _is_dtype(mod, call.args[0])


def check(project: Project) -> Iterable[Finding]:
    out: List[Finding] = []
    for mod in project.modules:
        if mod.package_path is None or mod.package_path == _HOME:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and _places(mod, node)):
                continue
            name = _trailing_name(node.func.value)
            if _is_slabby(name):
                out.append(Finding(
                    file=mod.path, line=node.lineno, rule=RULE_ID,
                    message=(f"{name}.{node.func.attr}(...) places slab arrays on a device "
                             f"outside the residency budget -- use "
                             f"repro_torch.data.residency.put_slab (or the "
                             f"BucketResidencyManager for work buckets; or allow[{RULE_ID}] "
                             f"with why this is not slab data)")))
    return out
