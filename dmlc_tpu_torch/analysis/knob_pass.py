"""Knob pass: every ``DMLC_*`` configuration surface resolves against
the port's ``config_registry.py`` (the port of
``dmlc_tpu/analysis/knob_pass.py``).

Checks:

``unregistered-knob``
    A literal ``DMLC_*`` env key read anywhere (``os.environ[...]``,
    ``os.environ.get``, ``os.getenv``, ``base.get_env``, or a
    ``*_env=`` keyword like ``RetryPolicy.from_env(retries_env=...)``)
    that has no :class:`config_registry.Knob`.

``unknown-knob-token``
    A literal ``DMLC_*`` token in any string (docstring, assertion,
    table) naming neither a registered knob, a registered-knob family
    prefix (``DMLC_COLL_`` is fine while some ``DMLC_COLL_*`` exists),
    nor a :data:`config_registry.NON_KNOB_TOKENS` entry — the typo'd
    README row or scrape assertion that documents a knob nobody reads.

``raw-env-read``
    ``os.environ``/``os.getenv`` on a ``DMLC_*`` key inside the
    port's package — must go through :func:`base.get_env` (typed,
    validated, one parse path).  Allowlisted exceptions only (inline
    suppression with a reason).

``pass-envs-missing`` / ``pass-envs-unknown``
    ``tracker/launch.py``'s ``PASS_ENVS`` vs the registry's
    ``pass_to_workers`` knobs: a knob that must be gang-uniform but is
    missing from the forward list (workers silently never receive it),
    or a forwarded ``DMLC_*`` name the registry does not know.

``knob-table-drift``
    The README block between the port's KNOB TABLE markers differs from
    ``config_registry.render_markdown_table()`` — regenerate with
    ``python -m dmlc_tpu_torch.analysis --write-knob-table``.  The
    port's table has markers of its own, in the README's port section,
    so it never touches the JAX package's generated table.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional, Set, Tuple

from .core import (PACKAGE, Finding, Pass, RepoIndex, call_name,
                   literal_str, module_str_consts)

_KNOB_TOKEN_RE = re.compile(r"DMLC_[A-Z0-9_]*[A-Z0-9]_?")
_ENV_READ_FUNCS = {"get_env"}
_RAW_READ_FUNCS = {"getenv"}

README_BEGIN = (f"<!-- BEGIN {PACKAGE.upper()} KNOB TABLE (generated by "
                f"python -m {PACKAGE}.analysis --write-knob-table; "
                f"do not edit) -->")
README_END = f"<!-- END {PACKAGE.upper()} KNOB TABLE -->"


def _registry():
    from .. import config_registry

    return config_registry


def readme_with_table(readme_src: str, table: str) -> Optional[str]:
    """``readme_src`` with the marker block replaced by ``table``;
    None when the markers are absent/malformed."""
    b = readme_src.find(README_BEGIN)
    e = readme_src.find(README_END)
    if b < 0 or e < 0 or e < b:
        return None
    head = readme_src[: b + len(README_BEGIN)]
    tail = readme_src[e:]
    return head + "\n\n" + table + "\n" + tail


class KnobPass(Pass):
    name = "knobs"
    checks = ("unregistered-knob", "unknown-knob-token", "raw-env-read",
              "pass-envs-missing", "pass-envs-unknown",
              "knob-table-drift")

    def run(self, index: RepoIndex) -> List[Finding]:
        reg = _registry()
        known = set(reg.names())
        findings: List[Finding] = []
        for ctx in index.files:
            if ctx.tree is None:
                continue
            if ctx.rel.startswith("tests" + os.sep):
                continue  # tests mint throwaway DMLC_TEST_* knobs
            consts = module_str_consts(ctx.tree)
            findings += self._scan_reads(index, ctx, consts, known)
            findings += self._scan_tokens(ctx, known, reg)
        findings += self._check_pass_envs(index, reg)
        findings += self._check_readme(index, reg)
        return findings

    # ---- env read sites -----------------------------------------------
    def _scan_reads(self, index, ctx, consts, known) -> List[Finding]:
        findings: List[Finding] = []
        in_pkg = index.in_package(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            for key, raw in self._read_keys(node, consts):
                if not key.startswith("DMLC_"):
                    continue
                if key not in known:
                    findings.append(Finding(
                        ctx.rel, node.lineno, "unregistered-knob",
                        f"env knob {key!r} read here but not registered "
                        f"in {PACKAGE}/config_registry.py"))
                if raw and in_pkg:
                    findings.append(Finding(
                        ctx.rel, node.lineno, "raw-env-read",
                        f"raw os.environ read of {key!r} — use "
                        f"base.get_env (typed, one parse path)"))
        # os.environ["KEY"] subscript loads
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)):
                base = node.value
                if (isinstance(base, ast.Attribute)
                        and base.attr == "environ"):
                    key = literal_str(node.slice, consts)
                    if key and key.startswith("DMLC_"):
                        if key not in known:
                            findings.append(Finding(
                                ctx.rel, node.lineno, "unregistered-knob",
                                f"env knob {key!r} read here but not "
                                f"registered in config_registry.py"))
                        if in_pkg:
                            findings.append(Finding(
                                ctx.rel, node.lineno, "raw-env-read",
                                f"raw os.environ[{key!r}] — use "
                                f"base.get_env"))
        return findings

    @staticmethod
    def _read_keys(node: ast.Call, consts) -> List[Tuple[str, bool]]:
        """(key, is_raw_os_read) pairs a call reads.  Covers
        ``os.environ.get(K)``, ``os.getenv(K)``, ``get_env(K, ...)``
        and ``xxx_env="K"`` keyword knob names."""
        out: List[Tuple[str, bool]] = []
        name = call_name(node)
        if name in _ENV_READ_FUNCS and node.args:
            k = literal_str(node.args[0], consts)
            if k:
                out.append((k, False))
        elif name in _RAW_READ_FUNCS and node.args:
            k = literal_str(node.args[0], consts)
            if k:
                out.append((k, True))
        elif name == "get" and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Attribute) \
                and node.func.value.attr == "environ" and node.args:
            k = literal_str(node.args[0], consts)
            if k:
                out.append((k, True))
        for kw in node.keywords:
            if kw.arg and kw.arg.endswith("_env"):
                k = literal_str(kw.value, consts)
                if k:
                    out.append((k, False))
        return out

    # ---- literal tokens (docstrings, tables, assertions) --------------
    def _scan_tokens(self, ctx, known: Set[str], reg) -> List[Finding]:
        findings: List[Finding] = []
        prefixes = {n.rsplit("_", 1)[0] + "_" for n in known}
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            for token in _KNOB_TOKEN_RE.findall(node.value):
                if self._token_ok(token, known, prefixes, reg):
                    continue
                findings.append(Finding(
                    ctx.rel, node.lineno, "unknown-knob-token",
                    f"DMLC_* token {token!r} matches no registered "
                    f"knob, knob-family prefix, or NON_KNOB_TOKENS "
                    f"entry in config_registry.py"))
        return findings

    @staticmethod
    def _token_ok(token: str, known: Set[str], prefixes: Set[str],
                  reg) -> bool:
        if token in known or token in reg.NON_KNOB_TOKENS:
            return True
        if token.endswith("_"):  # family prefix mention: DMLC_COLL_...
            return any(n.startswith(token) for n in known)
        return False

    # ---- PASS_ENVS completeness ---------------------------------------
    def _check_pass_envs(self, index: RepoIndex, reg) -> List[Finding]:
        rel = os.path.join(PACKAGE, "tracker", "launch.py")
        ctx = index.get(rel)
        if ctx is None or ctx.tree is None:
            return []  # partial run: launch.py not in scope
        names, line = self._parse_pass_envs(ctx.tree)
        if names is None:
            return [Finding(rel, 1, "pass-envs-missing",
                            "could not find the PASS_ENVS list literal")]
        findings: List[Finding] = []
        have = set(names)
        for knob in reg.pass_env_names():
            if knob not in have:
                findings.append(Finding(
                    rel, line, "pass-envs-missing",
                    f"{knob} is pass_to_workers in config_registry.py "
                    f"but absent from PASS_ENVS — set on the submit "
                    f"host, it would silently never reach ssh/tpu-vm "
                    f"workers"))
        known = set(reg.names())
        for n in names:
            if n.startswith("DMLC_") and n not in known:
                findings.append(Finding(
                    rel, line, "pass-envs-unknown",
                    f"PASS_ENVS forwards {n!r} which is not a "
                    f"registered knob"))
        return findings

    @staticmethod
    def _parse_pass_envs(tree) -> Tuple[Optional[List[str]], int]:
        for node in getattr(tree, "body", []):
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name)
                            and t.id == "PASS_ENVS"
                            for t in node.targets)
                    and isinstance(node.value, (ast.List, ast.Tuple))):
                vals = [e.value for e in node.value.elts
                        if isinstance(e, ast.Constant)]
                return vals, node.lineno
        return None, 0

    # ---- README generated table ---------------------------------------
    def _check_readme(self, index: RepoIndex, reg) -> List[Finding]:
        path = os.path.join(index.root, "README.md")
        if not os.path.exists(path):
            return []
        with open(path, encoding="utf-8") as f:
            src = f.read()
        want = readme_with_table(src, reg.render_markdown_table())
        if want is None:
            return [Finding("README.md", 1, "knob-table-drift",
                            f"missing the generated knob-table markers "
                            f"({README_BEGIN!r} ... {README_END!r})")]
        if want != src:
            return [Finding(
                "README.md", src[: src.find(README_BEGIN)].count("\n") + 1,
                "knob-table-drift",
                "README knob table differs from config_registry.py — "
                f"regenerate with python -m {PACKAGE}.analysis "
                "--write-knob-table")]
        return []
