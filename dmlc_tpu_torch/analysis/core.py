"""Framework spine: findings, per-file parse context, suppression
comments, the pass protocol, and the runner (the port of
``dmlc_tpu/analysis/core.py``, aimed at the port's tree).

Design: every pass sees a :class:`RepoIndex` (all files parsed once) so
cross-file invariants — the lock graph, the knob registry cross-check,
PASS_ENVS completeness — are first-class.  The strict invariants apply
to files under :data:`PACKAGE`; :data:`DEFAULT_ROOTS` is the port's
whole surface: the package, the root scripts that drive it on the card
and its parity tests.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["DEFAULT_ROOTS", "PACKAGE", "Finding", "FileContext",
           "RepoIndex", "Pass", "run_passes", "repo_root"]

#: the package the strict invariants (knob registry, lock graph,
#: contracts, races) apply to
PACKAGE = __name__.split(".")[0]

#: the surface a plain run covers: the package, the root scripts that
#: drive it on the card, and its parity tests (a root may be a glob)
DEFAULT_ROOTS = (PACKAGE, "chip_smoke.py", "chip_stores.py",
                 "tests/test_torch_*.py")

#: ``# dmlc-check: disable=check-a,check-b`` (optionally followed by a
#: ``-- reason`` tail, which is encouraged but not parsed)
_SUPPRESS_RE = re.compile(
    r"#\s*dmlc-check:\s*disable=([a-z0-9_*,-]+)")


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


class Finding:
    """One diagnostic: ``path:line: [check] message``."""

    __slots__ = ("rel", "line", "check", "message")

    def __init__(self, rel: str, line: int, check: str, message: str):
        self.rel = rel
        self.line = line
        self.check = check
        self.message = message

    def __str__(self) -> str:
        return f"{self.rel}:{self.line}: [{self.check}] {self.message}"

    def __repr__(self) -> str:
        return f"Finding({self!s})"

    def sort_key(self):
        return (self.rel, self.line, self.check)


class FileContext:
    """One parsed repo file: source, lines, AST (None on syntax error),
    and the line -> suppressed-check-ids map."""

    def __init__(self, path: str, root: str):
        self.path = path
        self.rel = os.path.relpath(path, root)
        with open(path, encoding="utf-8") as f:
            self.src = f.read()
        self.lines = self.src.splitlines()
        self.tree: Optional[ast.AST] = None
        self.syntax_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(self.src)
        except SyntaxError as e:
            self.syntax_error = e
        self.suppress: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                ids = {c.strip() for c in m.group(1).split(",") if c.strip()}
                self.suppress[i] = ids

    def suppressed(self, line: int, check: str) -> bool:
        """A finding is suppressed by a disable comment on its own line
        or on the directly preceding line (for lines that have no room
        left under the column limit)."""
        for ln in (line, line - 1):
            ids = self.suppress.get(ln)
            if ids and (check in ids or "*" in ids):
                return True
        return False


class RepoIndex:
    """Every file the run covers, parsed once, plus root metadata."""

    def __init__(self, paths: Sequence[str], root: Optional[str] = None):
        self.root = root or repo_root()
        self.files: List[FileContext] = [FileContext(p, self.root)
                                         for p in sorted(set(paths))]
        self.by_rel: Dict[str, FileContext] = {f.rel: f for f in self.files}

    def in_package(self, ctx: FileContext) -> bool:
        """True for files under the port's package — the surface the
        strict invariants (knob registry, lock graph, contracts) apply
        to."""
        return ctx.rel.startswith(PACKAGE + os.sep)

    def get(self, rel: str) -> Optional[FileContext]:
        return self.by_rel.get(rel)


class Pass:
    """Base pass: subclasses set ``name``/``checks`` and implement
    :meth:`run` returning raw findings (suppression is the runner's
    job, so passes stay simple)."""

    name = "base"
    checks: Tuple[str, ...] = ()

    def run(self, index: RepoIndex) -> List[Finding]:
        raise NotImplementedError


def default_paths(roots: Optional[Iterable[str]] = None,
                  root_dir: Optional[str] = None) -> List[str]:
    """Expand files/dirs/globs into the .py file list (plus extensionless
    executables whose shebang mentions python); ``roots`` defaults to
    :data:`DEFAULT_ROOTS`."""
    root_dir = root_dir or repo_root()
    out: List[str] = []
    for r in DEFAULT_ROOTS if roots is None else roots:
        path = os.path.join(root_dir, r)
        if set(r) & set("*?["):
            out.extend(sorted(p for p in glob.glob(path)
                              if os.path.isfile(p)))
        elif os.path.isfile(path):
            out.append(path)
        elif os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for f in filenames:
                    full = os.path.join(dirpath, f)
                    if f.endswith(".py"):
                        out.append(full)
                    elif not os.path.splitext(f)[1] and _py_shebang(full):
                        out.append(full)
    return out


def _py_shebang(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            first = f.readline(128)
        return first.startswith(b"#!") and b"python" in first
    except OSError:
        return False


def run_passes(index: RepoIndex, passes: Sequence[Pass]):
    """Run every pass; returns ``(findings, suppressed)`` with
    suppression comments already applied."""
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    for p in passes:
        for f in p.run(index):
            ctx = index.get(f.rel)
            if ctx is not None and ctx.suppressed(f.line, f.check):
                suppressed.append(f)
            else:
                findings.append(f)
    findings.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)
    return findings, suppressed


# ---- shared AST helpers used by several passes -------------------------

def call_name(node: ast.Call) -> Optional[str]:
    """Trailing name of the called function: ``f`` / ``obj.f`` -> 'f'."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def dotted_name(node: ast.expr) -> Optional[str]:
    """'a.b.c' for nested Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def literal_str(node: ast.expr,
                consts: Optional[Dict[str, str]] = None) -> Optional[str]:
    """A string literal, or a Name that resolves through the module's
    top-level ``CONST = "..."`` assignments."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if consts and isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def module_str_consts(tree: ast.AST) -> Dict[str, str]:
    """Top-level ``NAME = "literal"`` assignments of a module."""
    out: Dict[str, str] = {}
    for node in getattr(tree, "body", []):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.value.value
    return out


def enclosing_functions(tree: ast.AST):
    """Yield every (function_node, class_name_or_None) in the module."""
    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, cls
                yield from walk(child, cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, child.name)
            else:
                yield from walk(child, cls)
    yield from walk(tree, None)
