"""Concurrency pass: lock-region tracking over the AST (the port of
``dmlc_tpu/analysis/concurrency_pass.py``).

Three checks, all scoped to the port's package (the production surface
— scripts/tests may block freely):

``blocking-under-lock``
    A call that can block indefinitely — socket send/recv/accept/
    connect, ``FrameSocket`` framing I/O, pool ``acquire``,
    ``Thread.join``, ``time.sleep``, ``subprocess.*``,
    ``jax.device_put``, ``torch.cuda.synchronize`` — made while syntactically inside a ``with
    <lock>:`` region.  Every such call stalls every other thread that
    needs the lock (the PR 4 feed pipeline and the PR 9 background
    collective thread both hinge on never doing this).

``lock-cycle``
    The static lock-acquisition graph: an edge A -> B whenever B is
    acquired (directly, or via a one-level call into a function that
    acquires it) while A is held.  A cycle is a potential deadlock
    pair.  Lock nodes are class-qualified (``BufferPool._lock``);
    ``threading.Condition(lock)`` aliases collapse onto the underlying
    lock so a condition wait never fakes an edge.

``non-daemon-thread``
    ``threading.Thread(...)`` without ``daemon=True`` in a scope where
    nobody ``join``s — the classic hung-interpreter-at-exit bug.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import (Finding, Pass, RepoIndex, call_name, dotted_name,
                   enclosing_functions)

_LOCK_NAME_RE = re.compile(
    r"lock|mutex|^_?cv$|cond|^_avail$|^_not_empty$|^_not_full$", re.I)

#: method names that block on a peer/OS resource
_BLOCKING_METHODS = {
    "accept", "connect", "connect_ex", "recv", "recv_into", "recvfrom",
    "sendall", "send_int", "recv_int", "send_str", "recv_str",
    "recv_all", "makefile", "urlopen", "getaddrinfo",
    "create_connection",
}
_SUBPROCESS_FUNCS = {"run", "call", "check_call", "check_output",
                     "Popen", "communicate"}

#: method names shared with builtin containers/streams: an ``obj.m()``
#: call with one of these names must NOT resolve to a same-named class
#: method for the one-level lock propagation (``ent.blocks.extend(...)``
#: is a list extend, not ``PagedKVCache.extend``)
_AMBIGUOUS_METHOD_NAMES = {
    "extend", "append", "pop", "popleft", "get", "add", "update",
    "clear", "remove", "discard", "insert", "sort", "split", "strip",
    "read", "write", "readline", "flush", "close", "copy", "count",
    "index", "items", "keys", "values", "setdefault", "join", "touch",
}


def _final_name(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def _is_lockish(expr: ast.expr) -> bool:
    name = _final_name(expr)
    return bool(name and _LOCK_NAME_RE.search(name))


class _FuncInfo:
    """Per-function summary for the one-level lock-graph propagation."""

    __slots__ = ("rel", "cls", "name", "direct_locks", "calls_under")

    def __init__(self, rel: str, cls: Optional[str], name: str):
        self.rel = rel
        self.cls = cls
        self.name = name
        #: lock nodes this function acquires directly (any `with`)
        self.direct_locks: Set[Tuple[str, int]] = set()
        #: (held_lock_node, callee_key, lineno) for calls inside a region
        self.calls_under: List[Tuple[str, Tuple[str, str], int]] = []


class ConcurrencyPass(Pass):
    name = "concurrency"
    checks = ("blocking-under-lock", "lock-cycle", "non-daemon-thread")

    # ------------------------------------------------------------------
    def run(self, index: RepoIndex) -> List[Finding]:
        findings: List[Finding] = []
        funcs: Dict[Tuple[str, str], List[_FuncInfo]] = {}
        infos: List[_FuncInfo] = []
        for ctx in index.files:
            if not index.in_package(ctx) or ctx.tree is None:
                continue
            aliases = self._condition_aliases(ctx.tree)
            for fn, cls in enclosing_functions(ctx.tree):
                info = _FuncInfo(ctx.rel, cls, fn.name)
                findings += self._scan_function(ctx, fn, cls, aliases, info)
                infos.append(info)
                # callee keys: ("self", name) resolves within the class,
                # ("", name) within the module or across the package
                funcs.setdefault((cls or "", fn.name), []).append(info)
                funcs.setdefault(("", fn.name), []).append(info)
            findings += self._thread_check(ctx)
        findings += self._cycle_check(infos, funcs)
        return findings

    # ---- per-class Condition(lock) alias map --------------------------
    @staticmethod
    def _condition_aliases(tree: ast.AST) -> Dict[str, Dict[str, str]]:
        """{class: {cond_attr: lock_attr}} from
        ``self.A = threading.Condition(self.B)`` assignments."""
        out: Dict[str, Dict[str, str]] = {}
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            amap: Dict[str, str] = {}
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Attribute)
                        and isinstance(sub.value, ast.Call)
                        and call_name(sub.value) == "Condition"
                        and sub.value.args):
                    arg0 = sub.value.args[0]
                    if (isinstance(arg0, ast.Attribute)
                            and isinstance(sub.targets[0].value, ast.Name)
                            and sub.targets[0].value.id == "self"):
                        amap[sub.targets[0].attr] = arg0.attr
            if amap:
                out[node.name] = amap
        return out

    # ---- lock node naming ---------------------------------------------
    @staticmethod
    def _lock_node(ctx_rel: str, cls: Optional[str], expr: ast.expr,
                   aliases: Dict[str, Dict[str, str]]) -> str:
        mod = os.path.splitext(os.path.basename(ctx_rel))[0]
        dn = dotted_name(expr) or _final_name(expr) or "<lock>"
        if dn.startswith("self."):
            attr = dn[len("self."):]
            attr = aliases.get(cls or "", {}).get(attr, attr)
            return f"{cls or mod}.{attr}"
        return f"{mod}.{dn}"

    # ---- one function: regions, blocking calls, call summaries --------
    def _scan_function(self, ctx, fn, cls, aliases,
                       info: _FuncInfo) -> List[Finding]:
        findings: List[Finding] = []
        pass_self = self

        def handle(node, held: List[str]):
            """Process ONE node (which may itself be a With/Call), then
            its children — so a ``with`` directly inside another
            ``with`` body opens a nested region, not just ``with``
            nodes that happen to be grandchildren."""
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return  # deferred execution: not under this lock
            if isinstance(node, ast.With):
                locks_here = []
                for item in node.items:
                    if _is_lockish(item.context_expr):
                        lock = pass_self._lock_node(
                            ctx.rel, cls, item.context_expr, aliases)
                        info.direct_locks.add((lock, node.lineno))
                        if held:
                            info.calls_under.append(
                                (held[-1], ("<with>", lock),
                                 node.lineno))
                        locks_here.append(lock)
                for item in node.items:
                    handle(item.context_expr, held)
                inner = held + locks_here
                for stmt in node.body:
                    handle(stmt, inner)
                return
            if isinstance(node, ast.Call):
                if held:
                    findings.extend(pass_self._check_blocking_call(
                        ctx, node, held))
                    pass_self._note_call(info, node, held)
                # .acquire() outside `with`: counts as a direct
                # acquisition for the graph (lock receivers only)
                if (call_name(node) == "acquire"
                        and isinstance(node.func, ast.Attribute)
                        and _is_lockish(node.func.value)):
                    lock = pass_self._lock_node(
                        ctx.rel, cls, node.func.value, aliases)
                    info.direct_locks.add((lock, node.lineno))
                    if held:
                        info.calls_under.append(
                            (held[-1], ("<direct>", lock),
                             node.lineno))
            for child in ast.iter_child_nodes(node):
                handle(child, held)

        for child in ast.iter_child_nodes(fn):
            handle(child, [])
        return findings

    @staticmethod
    def _note_call(info: _FuncInfo, node: ast.Call,
                   held: List[str]) -> None:
        fn = node.func
        if isinstance(fn, ast.Name):
            info.calls_under.append((held[-1], ("", fn.id), node.lineno))
        elif isinstance(fn, ast.Attribute):
            if isinstance(fn.value, ast.Name) and fn.value.id == "self":
                key = (info.cls or "", fn.attr)
            elif fn.attr in _AMBIGUOUS_METHOD_NAMES:
                return  # container/stream method: never a class resolve
            else:
                key = ("", fn.attr)
            info.calls_under.append((held[-1], key, node.lineno))

    # ---- blocking calls -----------------------------------------------
    def _check_blocking_call(self, ctx, node: ast.Call,
                             held: List[str]) -> List[Finding]:
        name = call_name(node)
        dn = dotted_name(node.func) or ""
        what = None
        if dn == "time.sleep":
            what = "time.sleep"
        elif dn.startswith("subprocess.") and name in _SUBPROCESS_FUNCS:
            what = dn
        elif dn.startswith("jax.") and name in ("device_put",
                                                "block_until_ready"):
            what = dn
        elif dn == "torch.cuda.synchronize":
            what = dn
        elif name in _BLOCKING_METHODS:
            what = f".{name}()"
        elif name == "acquire" and isinstance(node.func, ast.Attribute) \
                and not _is_lockish(node.func.value):
            what = f"{_final_name(node.func.value)}.acquire() (pool/queue)"
        elif name == "join" and self._looks_like_thread_join(node):
            what = ".join() (thread)"
        if what is None:
            return []
        return [Finding(
            ctx.rel, node.lineno, "blocking-under-lock",
            f"{what} while holding {held[-1]} — every thread needing "
            f"the lock stalls behind this call")]

    @staticmethod
    def _looks_like_thread_join(node: ast.Call) -> bool:
        """``t.join()`` / ``t.join(timeout)`` / ``t.join(timeout=...)``
        — but not ``"sep".join(parts)`` (one non-numeric positional)."""
        if not isinstance(node.func, ast.Attribute):
            return False
        if isinstance(node.func.value, ast.Constant):
            return False  # "x".join(...)
        if node.keywords:
            return all(k.arg == "timeout" for k in node.keywords)
        if not node.args:
            return True
        if len(node.args) == 1:
            a = node.args[0]
            return isinstance(a, ast.Constant) and isinstance(
                a.value, (int, float))
        return False

    # ---- lock-order graph + cycles ------------------------------------
    def _cycle_check(self, infos, funcs) -> List[Finding]:
        # edge -> (rel, line, via) witness, first occurrence wins
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

        def add_edge(a: str, b: str, rel: str, line: int, via: str):
            if a != b:
                edges.setdefault((a, b), (rel, line, via))
            else:
                edges.setdefault((a, a), (rel, line, via))

        for info in infos:
            for held, key, line in info.calls_under:
                kind, name = key
                if kind == "<direct>" or kind == "<with>":
                    add_edge(held, name, info.rel, line, "nested acquire")
                    continue
                callees = funcs.get(key)
                if not callees:
                    continue
                if kind == "":
                    # a non-self receiver (or bare name) can never be a
                    # method of the CALLER's own class — calling that
                    # would need `self.`; drop those candidates
                    callees = [c for c in callees
                               if c.cls is None or c.cls != info.cls]
                # one-level propagation: the callee's direct locks are
                # acquired while `held` is held.  Cap the fan-out so a
                # generic method name ("close", "get") on an unknown
                # receiver cannot spray false edges across the package.
                if key[0] == "" and len(callees) > 3:
                    continue
                for cal in callees:
                    for lock, lline in cal.direct_locks:
                        add_edge(held, lock, cal.rel, lline,
                                 f"via {cal.cls or 'module'}.{cal.name}()"
                                 f" called at {info.rel}:{line}")
        # cycle detection (includes 2-cycles A->B->A and self-loops)
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        findings: List[Finding] = []
        seen_cycles: Set[Tuple[str, ...]] = set()
        for (a, b), (rel, line, via) in sorted(edges.items()):
            if a == b:
                findings.append(Finding(
                    rel, line, "lock-cycle",
                    f"lock {a} re-acquired while already held "
                    f"({via}) — deadlock for a non-reentrant lock"))
                continue
            if self._reachable(graph, b, a):
                cyc = tuple(sorted((a, b)))
                if cyc in seen_cycles:
                    continue
                seen_cycles.add(cyc)
                findings.append(Finding(
                    rel, line, "lock-cycle",
                    f"lock-order cycle: {a} -> {b} ({via}) while "
                    f"{b} -> ... -> {a} also exists — potential "
                    f"deadlock pair"))
        return findings

    @staticmethod
    def _reachable(graph: Dict[str, Set[str]], src: str,
                   dst: str) -> bool:
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(graph.get(n, ()))
        return False

    # ---- non-daemon threads -------------------------------------------
    def _thread_check(self, ctx) -> List[Finding]:
        findings: List[Finding] = []
        src = ctx.src
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and dotted_name(node.func) == "threading.Thread"):
                continue
            kw = {k.arg: k for k in node.keywords}
            d = kw.get("daemon")
            if d is not None and isinstance(d.value, ast.Constant) \
                    and d.value.value:
                continue
            # non-daemon (or dynamic daemon=): someone must join it —
            # accept any `.join(` in the file as the owner (coarse, but
            # the goal is catching threads NOBODY joins)
            if re.search(r"\.\s*join\s*\(", src):
                continue
            findings.append(Finding(
                ctx.rel, node.lineno, "non-daemon-thread",
                "non-daemon threading.Thread with no join owner in "
                "this file — hangs interpreter exit if the target "
                "blocks"))
        return findings
