"""Style/correctness pass — the absorbed ``scripts/lint.py`` checks.

Checks: ``syntax-error``, ``tab``, ``trailing-ws``, ``long-line``,
``unused-import``, ``bare-except``, ``mutable-default``.
"""

from __future__ import annotations

import ast
import os
from typing import List

from .core import Finding, Pass, RepoIndex

MAX_COLS = 100


class _ImportCollector(ast.NodeVisitor):
    def __init__(self):
        self.imports = []   # (local_name, lineno, statement_desc)
        self.used = set()

    def visit_Import(self, node):
        for a in node.names:
            local = a.asname or a.name.split(".")[0]
            self.imports.append((local, node.lineno, a.name))

    def visit_ImportFrom(self, node):
        if node.module == "__future__":  # directives, not bindings
            return
        for a in node.names:
            if a.name == "*":
                continue
            local = a.asname or a.name
            self.imports.append((local, node.lineno, a.name))

    def visit_Name(self, node):
        self.used.add(node.id)

    def visit_Attribute(self, node):
        self.generic_visit(node)


class StylePass(Pass):
    name = "style"
    checks = ("syntax-error", "tab", "trailing-ws", "long-line",
              "unused-import", "bare-except", "mutable-default")

    def run(self, index: RepoIndex) -> List[Finding]:
        findings: List[Finding] = []
        for ctx in index.files:
            rel = ctx.rel
            for i, line in enumerate(ctx.lines, 1):
                if "\t" in line:
                    findings.append(Finding(rel, i, "tab", "tab character"))
                if line != line.rstrip():
                    findings.append(
                        Finding(rel, i, "trailing-ws", "trailing whitespace"))
                if len(line) > MAX_COLS:
                    findings.append(Finding(
                        rel, i, "long-line",
                        f"line longer than {MAX_COLS} cols"))
            if ctx.tree is None:
                e = ctx.syntax_error
                findings.append(Finding(rel, e.lineno or 1, "syntax-error",
                                        f"syntax error: {e.msg}"))
                continue
            # unused imports — skip __init__.py (re-export by design)
            if os.path.basename(ctx.path) != "__init__.py":
                findings += self._unused_imports(ctx)
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ExceptHandler) and node.type is None:
                    findings.append(Finding(rel, node.lineno, "bare-except",
                                            "bare except"))
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for d in list(node.args.defaults) + [
                            d for d in node.args.kw_defaults
                            if d is not None]:
                        if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                            findings.append(Finding(
                                rel, d.lineno, "mutable-default",
                                "mutable default argument"))
        return findings

    @staticmethod
    def _unused_imports(ctx) -> List[Finding]:
        col = _ImportCollector()
        col.visit(ctx.tree)
        exported = set()
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                exported |= {e.value for e in node.value.elts
                             if isinstance(e, ast.Constant)}
        return [Finding(ctx.rel, lineno, "unused-import",
                        f"unused import {what!r}")
                for local, lineno, what in col.imports
                if local not in col.used and local not in exported]
