"""Contract pass: cross-cutting exception/timeout/fault-site contracts
(the port of ``dmlc_tpu/analysis/contract_pass.py``).

``swallowed-exception``
    Inside the *protected paths* — the collective, feed, serving and
    integrity call chains — three typed exceptions MUST cascade to the
    driver loop: ``WorldResized`` (elastic resize re-entry),
    ``CorruptRecord`` (integrity policy dispatch) and
    ``EngineDraining`` (serving drain).  PR 7 and PR 9 each needed a
    post-review hardening round for exactly this class of bug: an
    ``except Exception``/``OSError``-shaped handler deep in a helper
    quietly ate the resize signal and the job hung.  This check flags
    any handler in a protected file whose caught type is broad enough
    to swallow one of them, unless the handler visibly re-raises
    (``raise`` / ``raise X from e``) or hands the exception object
    onward as a call argument (the transport pattern used by worker
    threads), or an earlier handler of the same ``try`` already
    catches the protected type.

``socket-no-timeout``
    A ``socket.socket(...)`` in the port's package whose enclosing function
    never calls ``settimeout``, or ``socket.create_connection``
    without a ``timeout=`` — a peer dying without a FIN then blocks
    the thread forever (the reference tracker's classic hang).

``unknown-fault-site``
    Literal ``DMLC_FAULT_SPEC`` values (tests, smokes, docstrings)
    must name sites that exist — the first component of each rule is
    checked against the extracted set of ``fault_point``/
    ``maybe_corrupt`` site literals, so a typo'd spec can no longer
    silently test nothing.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Set

from .core import (PACKAGE, Finding, Pass, RepoIndex, call_name,
                   literal_str, module_str_consts)

#: the typed exceptions that must propagate, and the handler types
#: broad enough to swallow them (all four subclass DMLCError, which
#: subclasses RuntimeError).  AlreadyFinished joined in PR 15: the
#: exactly-once terminal-transition signal — a broad sweep that eats
#: it also eats cache double-free errors behind the same handler.
PROTECTED_EXCEPTIONS = ("WorldResized", "CorruptRecord", "EngineDraining",
                        "AlreadyFinished")
_BROAD_TYPES = {"BaseException", "Exception", "RuntimeError", "DMLCError"}

#: files whose call chains carry the protected exceptions: the JAX
#: package's list, with the LM example at its place in the port
PROTECTED_FILES = tuple(f"{PACKAGE}/{rel}" for rel in (
    "tracker/client.py",
    "tracker/protocol.py",
    "parallel/overlap.py",
    "feed/device_feed.py",
    "io/recordio.py",
    "io/input_split.py",
    "io/cached_input_split.py",
    "serving/engine.py",
    "serving/scheduler.py",
    "serving/server.py",
    "serving/router.py",
    "telemetry/requests.py",
    "telemetry/slo.py",
    "feed/autotune.py",
    "resilience/selfheal.py",
    "examples/train_lm_recordio.py",
))

#: rule shape of one DMLC_FAULT_SPEC entry (see resilience/fault.py)
_SPEC_RULE_RE = re.compile(
    r"^(?P<site>[a-z0-9_.]+)(?:@[^=]*)?="
    r"(?:error|delay|kill|corrupt)(?::[^:;]*){0,2}$")

#: sites whose names are built dynamically (f-strings / parameters) —
#: extracted literals cannot see them, so they are declared here
DYNAMIC_FAULT_SITES = frozenset({
    "s3.request", "azure.request", "storage.response",
})

#: fault_point("site"...) / maybe_corrupt("site"...) site literals —
#: scanned over RAW source so sites instrumented inside embedded worker
#: programs (the smoke scripts ship workers as string literals) count
_SITE_CALL_RE = re.compile(
    r"(?:fault_point|maybe_corrupt)\(\s*['\"]([a-z0-9_.]+)['\"]")


class ContractPass(Pass):
    name = "contracts"
    checks = ("swallowed-exception", "socket-no-timeout",
              "unknown-fault-site")

    def run(self, index: RepoIndex) -> List[Finding]:
        findings: List[Finding] = []
        sites = self._fault_sites(index)
        for ctx in index.files:
            if ctx.tree is None:
                continue
            if ctx.rel.replace("\\", "/") in PROTECTED_FILES:
                findings += self._swallow_check(ctx)
            if index.in_package(ctx):
                findings += self._socket_check(ctx)
            # tests aim synthetic specs at made-up sites on purpose (the
            # injector's own unit tests); production surfaces may not
            if not ctx.rel.startswith("tests" + os.sep):
                findings += self._fault_spec_check(ctx, sites)
        return findings

    # ---- swallowed protected exceptions -------------------------------
    def _swallow_check(self, ctx) -> List[Finding]:
        findings: List[Finding] = []
        exempt_lines = self._del_method_lines(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            if node.lineno in exempt_lines:
                continue  # __del__ must never raise, by contract
            protected_handled = False
            for handler in node.handlers:
                names = self._handler_type_names(handler)
                if any(n in PROTECTED_EXCEPTIONS for n in names):
                    protected_handled = True
                    continue
                broad = (handler.type is None
                         or any(n in _BROAD_TYPES for n in names))
                if not broad or protected_handled:
                    continue
                if self._reraises_or_transports(handler):
                    continue
                findings.append(Finding(
                    ctx.rel, handler.lineno, "swallowed-exception",
                    f"handler catches "
                    f"{' | '.join(names) or 'everything'} in a "
                    f"protected path and neither re-raises nor "
                    f"transports — can swallow "
                    f"{'/'.join(PROTECTED_EXCEPTIONS)}"))
        return findings

    @staticmethod
    def _del_method_lines(tree) -> Set[int]:
        """Line numbers covered by ``__del__`` bodies (exempt: a raise
        during interpreter teardown is itself the bug)."""
        lines: Set[int] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) \
                    and node.name == "__del__":
                end = getattr(node, "end_lineno", node.lineno)
                lines.update(range(node.lineno, end + 1))
        return lines

    @staticmethod
    def _handler_type_names(handler: ast.ExceptHandler) -> List[str]:
        t = handler.type
        if t is None:
            return []
        elts = t.elts if isinstance(t, ast.Tuple) else [t]
        names = []
        for e in elts:
            if isinstance(e, ast.Attribute):
                names.append(e.attr)
            elif isinstance(e, ast.Name):
                names.append(e.id)
        return names

    @staticmethod
    def _reraises_or_transports(handler: ast.ExceptHandler) -> bool:
        """True when the handler re-raises (bare ``raise`` or ``raise X
        [from e]``) or passes the bound exception object *itself* as a
        call argument (the thread-boundary transport pattern, e.g.
        ``fut.set_exception(e)``; an f-string mention does not count —
        that keeps only the message, losing the type)."""
        bound = handler.name
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Raise):
                return True
            if bound and isinstance(sub, ast.Call):
                for a in sub.args:
                    if isinstance(a, ast.Name) and a.id == bound:
                        return True
                for k in sub.keywords:
                    if isinstance(k.value, ast.Name) \
                            and k.value.id == bound:
                        return True
            # stash-for-later: ``err = err or e`` (re-raised after the
            # drain loop) keeps the typed exception alive
            if bound and isinstance(sub, ast.Assign):
                if any(isinstance(n, ast.Name) and n.id == bound
                       for n in ast.walk(sub.value)):
                    return True
        return False

    # ---- socket timeouts ----------------------------------------------
    def _socket_check(self, ctx) -> List[Finding]:
        findings: List[Finding] = []
        # map: function node -> does it call .settimeout / .setblocking?
        for fn in self._functions_and_module(ctx.tree):
            has_settimeout = any(
                isinstance(n, ast.Call)
                and call_name(n) in ("settimeout", "setblocking")
                for n in ast.walk(fn))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name == "create_connection":
                    if not any(k.arg == "timeout" for k in node.keywords):
                        findings.append(Finding(
                            ctx.rel, node.lineno, "socket-no-timeout",
                            "socket.create_connection without timeout= "
                            "— hangs forever on a silent peer"))
                elif name == "socket" and isinstance(
                        node.func, ast.Attribute):
                    if not has_settimeout:
                        findings.append(Finding(
                            ctx.rel, node.lineno, "socket-no-timeout",
                            "socket.socket() in a function that never "
                            "calls settimeout — a dead peer blocks "
                            "this thread forever"))
        return findings

    @staticmethod
    def _functions_and_module(tree):
        """Top-level function scopes: each FunctionDef, plus the module
        body with nested functions pruned (so a module-level socket is
        judged by module-level settimeout calls only)."""
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        return funcs + [tree]

    # ---- fault_point site extraction + spec literals ------------------
    def _fault_sites(self, index: RepoIndex) -> Set[str]:
        sites: Set[str] = set(DYNAMIC_FAULT_SITES)
        for ctx in index.files:
            # raw-source regex: sees code AND the worker programs the
            # smoke scripts embed as string literals
            sites.update(_SITE_CALL_RE.findall(ctx.src))
            if ctx.tree is None:
                continue
            consts = module_str_consts(ctx.tree)
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                if name in ("fault_point", "maybe_corrupt") and node.args:
                    s = literal_str(node.args[0], consts)
                    if s:
                        sites.add(s)
                for kw in node.keywords:
                    if kw.arg == "site":
                        s = literal_str(kw.value, consts)
                        if s:
                            sites.add(s)
        return sites

    def _fault_spec_check(self, ctx, sites: Set[str]) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            for rule in self._spec_rules(node.value):
                site = _SPEC_RULE_RE.match(rule).group("site")
                base = site.split("@", 1)[0]
                # barrier.* sites are declared at their call sites with
                # literal names too, so exact membership is required
                if base not in sites:
                    findings.append(Finding(
                        ctx.rel, node.lineno, "unknown-fault-site",
                        f"DMLC_FAULT_SPEC rule {rule!r} names site "
                        f"{base!r} which no fault_point()/"
                        f"maybe_corrupt() call instruments — this "
                        f"spec silently tests nothing"))
        return findings

    @staticmethod
    def _spec_rules(value: str) -> List[str]:
        """Substrings of ``value`` that parse as fault-spec rules.
        Only strings that are *entirely* a spec (one or more
        ``;``-separated rules) are considered, so prose mentioning
        ``site=error`` shapes does not trip the check."""
        if "=" not in value or " " in value.strip():
            return []
        parts = [p.strip() for p in value.strip().split(";") if p.strip()]
        if not parts:
            return []
        if all(_SPEC_RULE_RE.match(p) for p in parts):
            return parts
        return []
