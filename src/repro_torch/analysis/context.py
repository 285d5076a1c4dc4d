# allow[dead-code]: PyTorch port of repro, driven by chip_smoke.py and tests/test_torch_*.py
"""Parsed modules for the port's lint rules: alias-resolved dotted names
(``import torch.cuda as tc`` makes ``tc.synchronize`` resolve to
``torch.cuda.synchronize``) and where a module sits in the port, the
part of ``repro/analysis/context.py`` the port's rules need. Stdlib only.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import PurePosixPath
from typing import Dict, Iterator, List, Optional, Set

#: the package whose conventions the rules hold
PACKAGE = "repro_torch"


def qualname(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name of an expression, alias-resolved; None for anything that
    is not a (dotted) name."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(aliases.get(cur.id, cur.id))
    return ".".join(reversed(parts))


@dataclass
class ModuleInfo:
    path: str                           # posix path relative to the root
    source: str
    tree: ast.Module
    lines: List[str]
    aliases: Dict[str, str] = field(default_factory=dict)
    imported_modules: Set[str] = field(default_factory=set)

    @classmethod
    def parse(cls, path: str, source: str) -> "ModuleInfo":
        tree = ast.parse(source, filename=path)
        info = cls(path=PurePosixPath(path).as_posix(), source=source, tree=tree,
                   lines=source.splitlines())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    info.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
                    info.imported_modules.add(a.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                info.imported_modules.add(node.module)
                for a in node.names:
                    if a.name != "*":
                        info.aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return info

    def qualname(self, node: ast.AST) -> Optional[str]:
        return qualname(node, self.aliases)

    @property
    def imports_torch(self) -> bool:
        return any(m == "torch" or m.startswith("torch.") for m in self.imported_modules)

    @property
    def package_path(self) -> Optional[str]:
        """The path inside the port's package (``core/engine.py``), or None
        for a module outside it (a test, a script, ``chip_smoke.py``)."""
        parts = PurePosixPath(self.path).parts
        if PACKAGE not in parts:
            return None
        return "/".join(parts[parts.index(PACKAGE) + 1:])

    def functions(self) -> Iterator[ast.AST]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


@dataclass
class Project:
    root: str
    modules: List[ModuleInfo]

    def in_package(self, sub: str) -> Optional[ModuleInfo]:
        """The module at ``sub`` inside the port's package, if scanned."""
        return next((m for m in self.modules if m.package_path == sub), None)
