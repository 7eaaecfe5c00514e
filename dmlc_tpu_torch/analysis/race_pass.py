"""Race pass: guarded-by classification of every threaded class's state
(the port of ``dmlc_tpu/analysis/race_pass.py``).

The concurrency pass (PR 10) verifies lock *ordering*; nothing verified
what each lock *guards*.  Both PR 13 review rounds found real
schedule-dependent bugs by hand (drain vs crash-requeue, hedge-clock
races) — this pass makes the discipline machine-checked: for every
class that owns a ``concurrency.make_lock``/``make_rlock`` lock (or
that starts a ``threading.Thread`` / owns a ``threading.Event`` — the
other two ways a class becomes multi-threaded), every mutable
attribute must fall into exactly one bucket:

  * **guarded** — all post-``__init__`` reads and writes happen while
    holding the same class-owned lock (``with self._lock:`` regions,
    ``threading.Condition(self._lock)`` aliases collapse onto the
    underlying lock, and helper methods whose every intra-class call
    site holds the lock inherit it — the ``_locked``-suffix pattern);
  * **immutable-after-init** — assigned in ``__init__`` and never
    written (or container-mutated) afterwards: unlocked reads are safe;
  * **explicitly exempted** — carries a
    ``# dmlc-check: guarded-by(<lock>)`` (this access runs with the
    named lock held by the *caller*, which the AST cannot see) or a
    ``# dmlc-check: unguarded(<reason>)`` (deliberately
    unsynchronized; the reason is mandatory) annotation, on the
    attribute's declaration line (covers every access) or on an
    individual access line.

Checks:

``unguarded-access``
    A post-init access to an attribute that has post-init writes, made
    with no class-owned lock held and no annotation — the mixed
    locked/unlocked access pattern that turns into a torn read the day
    the schedule cooperates.

``divergent-guard``
    One attribute protected by *different* locks at different sites
    (no single lock is common to every locked access), or an access
    that contradicts the attribute's declared ``guarded-by`` lock.
    Two locks that each cover half the sites exclude each other's
    threads from nothing.

``leaked-guarded-ref``
    ``return self._attr`` of a guarded mutable container — the caller
    receives the live reference and will iterate/read it after the
    lock is dropped.  Return a copy (``list(...)``/``dict(...)``)
    instead; every accessor in this repo already does.

``bad-annotation``
    A ``guarded-by`` naming a lock the class does not own, or an
    ``unguarded`` with an empty reason — annotation hygiene, so the
    exemption surface stays auditable.

Scope and limits (deliberate): classes only — module-level globals
guarded by module locks are the lockcheck watchdog's territory;
cross-object guarding (e.g. ``Replica`` fields mutated only under
``Router._lock``) is out of AST reach and must be documented on the
owning class; mutator calls are only treated as writes on attributes
whose initializer proves them mutable containers (list/dict/set/deque
literals and constructors, numpy buffers).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, Pass, RepoIndex, call_name, dotted_name

__all__ = ["RacePass", "guarded_region_map", "scan_class",
           "MUTATOR_METHODS"]

#: ``# dmlc-check: guarded-by(_lock)`` / ``# dmlc-check: unguarded(why)``
_ANNOT_RE = re.compile(
    r"#\s*dmlc-check:\s*(guarded-by|unguarded)\(([^)]*)\)")

#: container methods that mutate the receiver (list/dict/set/deque/
#: bytearray/ndarray surface).  Only applied to attributes whose
#: initializer proves a mutable container — ``.get``/``.items`` etc.
#: are reads and never listed here.
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "add", "discard",
    "setdefault", "sort", "reverse", "rotate", "fill",
})

#: initializer constructors that prove a mutable container
_MUTABLE_CTORS = frozenset({
    "list", "dict", "set", "deque", "defaultdict", "OrderedDict",
    "Counter", "bytearray",
})

#: numpy buffer constructors (subscript stores are writes; treated as
#: containers so ``.fill``/``.sort`` count too)
_BUFFER_CTORS = frozenset({"zeros", "empty", "ones", "full", "array"})

#: initializer constructors that prove an internally-synchronized
#: object: calling methods on it unlocked is its own contract, and the
#: reference itself only matters if re-published post-init (a write,
#: still checked).  Lock-owning classes discovered across the repo
#: index are added at run time.
_THREADSAFE_CTORS = frozenset({
    "Event", "Condition", "Lock", "RLock", "Semaphore",
    "BoundedSemaphore", "Barrier", "Thread", "local",
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
})


def _is_self_attr(node: ast.expr) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _Access:
    """One ``self.<attr>`` touch: where, what kind, which class locks
    were (syntactically or by inference) held."""

    __slots__ = ("attr", "line", "kind", "locks", "method", "nested")

    def __init__(self, attr: str, line: int, kind: str,
                 locks: frozenset, method: str, nested: bool):
        self.attr = attr
        self.line = line
        self.kind = kind  # read | write | mutcall:<name> | return
        self.locks = locks
        self.method = method
        self.nested = nested


class _MethodScan:
    __slots__ = ("name", "accesses", "self_calls", "region_sites")

    def __init__(self, name: str):
        self.name = name
        self.accesses: List[_Access] = []
        #: (callee, frozenset(held)) per ``self.m(...)`` call site
        self.self_calls: List[Tuple[str, frozenset]] = []
        #: with-statement acquire sites: (lineno, lock_attr)
        self.region_sites: List[Tuple[int, str]] = []


class _ClassScan:
    """Everything the checks need about one class."""

    def __init__(self, rel: str, node: ast.ClassDef):
        self.rel = rel
        self.node = node
        self.name = node.name
        self.lock_attrs: Set[str] = set()
        self.cond_alias: Dict[str, str] = {}
        self.threaded = False
        self.methods: Dict[str, _MethodScan] = {}
        #: attr -> (decl line, value kind) from first assignment seen
        #: (``__init__`` first, then anywhere)
        self.attr_decl: Dict[str, Tuple[int, str]] = {}
        self.inherited: Dict[str, frozenset] = {}
        self.init_only: Set[str] = set()


# ---------------------------------------------------------------------------
# per-class scan
# ---------------------------------------------------------------------------

def _value_kind(node: ast.expr, safe_classes: Set[str]) -> str:
    """container | safe | opaque, judged from an initializer expr."""
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return "container"
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in _MUTABLE_CTORS or name in _BUFFER_CTORS:
            return "container"
        if name in _THREADSAFE_CTORS or name in safe_classes:
            # Condition(make_lock(...)) et al count via the outer name
            return "safe"
    return "opaque"


def _lock_ctor(node: ast.expr) -> Optional[str]:
    """'lock' for make_lock/make_rlock(...) (possibly wrapped in
    threading.Condition(...)), else None."""
    if not isinstance(node, ast.Call):
        return None
    name = call_name(node)
    if name in ("make_lock", "make_rlock"):
        return "lock"
    if name == "Condition" and node.args \
            and isinstance(node.args[0], ast.Call) \
            and call_name(node.args[0]) in ("make_lock", "make_rlock"):
        return "lock"
    return None


def scan_class(rel: str, cls: ast.ClassDef,
               safe_classes: Set[str]) -> _ClassScan:
    scan = _ClassScan(rel, cls)

    # ---- pass 1: lock attrs, condition aliases, threadedness ----------
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr = _is_self_attr(node.targets[0])
            if attr is None:
                continue
            if _lock_ctor(node.value):
                scan.lock_attrs.add(attr)
                scan.threaded = True
            elif (isinstance(node.value, ast.Call)
                  and call_name(node.value) == "Condition"
                  and node.value.args):
                base = _is_self_attr(node.value.args[0])
                if base is not None:
                    scan.cond_alias[attr] = base
        if isinstance(node, ast.Call):
            dn = dotted_name(node.func) or ""
            if dn == "threading.Thread" or dn == "threading.Event":
                scan.threaded = True
    if not scan.threaded:
        return scan

    # ---- pass 2: per-method walk with lock-region tracking ------------
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _scan_method(scan, item, safe_classes)

    # ---- pass 3: inherited-lock fixpoint over intra-class calls -------
    _infer_inherited(scan)
    return scan


def _canon_lock(scan: _ClassScan, attr: str) -> Optional[str]:
    """The class-owned lock an attr name resolves to (through the
    Condition alias map), or None."""
    attr = scan.cond_alias.get(attr, attr)
    return attr if attr in scan.lock_attrs else None


def _scan_method(scan: _ClassScan, fn: ast.FunctionDef,
                 safe_classes: Set[str]) -> None:
    ms = _MethodScan(fn.name)
    scan.methods[fn.name] = ms
    in_init = fn.name == "__init__"
    nested_defs: List[ast.AST] = []

    def record(attr: str, line: int, kind: str, held: List[str],
               nested: bool) -> None:
        if attr in scan.lock_attrs or attr in scan.cond_alias:
            return  # the locks themselves are not guarded state
        if in_init and not nested:
            # first write in __init__ is the declaration site
            if kind == "write" and attr not in scan.attr_decl:
                scan.attr_decl[attr] = (line, "opaque")
            return  # pre-thread: exempt
        ms.accesses.append(_Access(attr, line, kind,
                                   frozenset(held), fn.name, nested))

    def handle(node: ast.AST, held: List[str], nested: bool,
               consumed: Set[int]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # deferred execution: runs later, with no lock inherited
            nested_defs.append(node)
            return
        if isinstance(node, ast.With):
            locks_here: List[str] = []
            for item in node.items:
                attr = _is_self_attr(item.context_expr)
                if attr is not None:
                    lock = _canon_lock(scan, attr)
                    if lock is not None:
                        locks_here.append(lock)
                        ms.region_sites.append((node.lineno, lock))
                handle(item.context_expr, held, nested, consumed)
            inner = held + locks_here
            for stmt in node.body:
                handle(stmt, inner, nested, consumed)
            return
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = _is_self_attr(node.value)
            if attr is not None:
                record(attr, node.lineno, "write", held, nested)
                consumed.add(id(node.value))
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute):
                attr = _is_self_attr(node.func.value)
                if attr is not None:
                    record(attr, node.lineno,
                           f"mutcall:{node.func.attr}", held, nested)
                    consumed.add(id(node.func.value))
                recv = node.func.value
                if isinstance(recv, ast.Name) and recv.id == "self":
                    ms.self_calls.append(
                        (node.func.attr, frozenset(held)))
        elif isinstance(node, ast.Return) and node.value is not None:
            attr = _is_self_attr(node.value)
            if attr is not None:
                record(attr, node.lineno, "return", held, nested)
                consumed.add(id(node.value))
        elif isinstance(node, ast.Attribute) and id(node) not in consumed:
            attr = _is_self_attr(node)
            if attr is not None:
                kind = ("write"
                        if isinstance(node.ctx, (ast.Store, ast.Del))
                        else "read")
                record(attr, node.lineno, kind, held, nested)
        for child in ast.iter_child_nodes(node):
            handle(child, held, nested, consumed)

    consumed: Set[int] = set()
    for child in fn.body:
        handle(child, [], False, consumed)
    # declaration-value kinds from __init__ assignments (plain and
    # annotated: ``self.x: List = []`` proves a container too)
    if in_init:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) \
                    and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                attr = _is_self_attr(t)
                if attr and attr in scan.attr_decl:
                    line, _ = scan.attr_decl[attr]
                    if line == node.lineno:
                        scan.attr_decl[attr] = (
                            line, _value_kind(value, safe_classes))
    # nested scopes run later on unknown threads: no lock context
    while nested_defs:
        nd = nested_defs.pop()
        body = nd.body if not isinstance(nd, ast.Lambda) else [nd.body]
        for child in body:
            handle(child, [], True, consumed)


def _infer_inherited(scan: _ClassScan) -> None:
    """Helper methods whose *every* non-init intra-class call site
    holds lock L run under L (the ``_locked``-suffix / private-helper
    pattern); helpers called only from ``__init__`` are pre-thread."""
    eligible = {name for name in scan.methods
                if name.startswith("_") or name.endswith("_locked")}
    eligible.discard("__init__")
    call_sites: Dict[str, List[Tuple[str, frozenset]]] = {}
    for ms in scan.methods.values():
        for callee, held in ms.self_calls:
            call_sites.setdefault(callee, []).append((ms.name, held))
    inherited: Dict[str, frozenset] = {
        name: frozenset() for name in scan.methods}
    for _ in range(4):  # small fixpoint: chains are shallow
        changed = False
        for name in eligible:
            sites = [s for s in call_sites.get(name, ())
                     if s[0] != "__init__"]
            if not sites:
                continue
            acc: Optional[frozenset] = None
            for caller, held in sites:
                eff = held | inherited.get(caller, frozenset())
                acc = eff if acc is None else (acc & eff)
            acc = acc or frozenset()
            if acc != inherited[name]:
                inherited[name] = acc
                changed = True
        if not changed:
            break
    scan.inherited = inherited
    for name in eligible:
        sites = call_sites.get(name, ())
        if sites and all(c == "__init__" for c, _ in sites):
            scan.init_only.add(name)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

class RacePass(Pass):
    name = "races"
    checks = ("unguarded-access", "divergent-guard", "leaked-guarded-ref",
              "bad-annotation")

    def run(self, index: RepoIndex) -> List[Finding]:
        safe_classes = self._lock_owning_classes(index)
        findings: List[Finding] = []
        for ctx in index.files:
            if not index.in_package(ctx) or ctx.tree is None:
                continue
            ann = self._annotations(ctx)
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    scan = scan_class(ctx.rel, node, safe_classes)
                    if scan.threaded:
                        findings += self._check_class(ctx, scan, ann)
        return findings

    # ---- repo-wide: classes that own a lock are thread-safe values ----
    @staticmethod
    def _lock_owning_classes(index: RepoIndex) -> Set[str]:
        out: Set[str] = set()
        for ctx in index.files:
            if not index.in_package(ctx) or ctx.tree is None:
                continue
            for node in ast.walk(ctx.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) \
                            and _lock_ctor(sub.value):
                        out.add(node.name)
                        break
        return out

    # ---- annotation comments ------------------------------------------
    @staticmethod
    def _annotations(ctx) -> Dict[int, Tuple[str, str]]:
        """line -> (kind, arg) for guarded-by/unguarded comments."""
        out: Dict[int, Tuple[str, str]] = {}
        for i, line in enumerate(ctx.lines, 1):
            m = _ANNOT_RE.search(line)
            if m:
                out[i] = (m.group(1), m.group(2).strip())
        return out

    @staticmethod
    def _ann_at(ann: Dict[int, Tuple[str, str]],
                line: int) -> Optional[Tuple[str, str]]:
        """Annotation on the line or the line directly above (same
        convention as suppression comments)."""
        return ann.get(line) or ann.get(line - 1)

    # ---- one class -----------------------------------------------------
    def _check_class(self, ctx, scan: _ClassScan,
                     ann: Dict[int, Tuple[str, str]]) -> List[Finding]:
        findings: List[Finding] = []
        by_attr: Dict[str, List[_Access]] = {}
        for ms in scan.methods.values():
            if ms.name in scan.init_only:
                continue  # helper only ever called from __init__
            inh = scan.inherited.get(ms.name, frozenset())
            for a in ms.accesses:
                if inh and not a.nested:
                    a = _Access(a.attr, a.line, a.kind, a.locks | inh,
                                a.method, a.nested)
                by_attr.setdefault(a.attr, []).append(a)

        for attr in sorted(by_attr):
            decl_line, kind = scan.attr_decl.get(attr, (0, "opaque"))
            accesses = by_attr[attr]
            if decl_line == 0:
                # declared lazily outside __init__: first write is the
                # declaration; value kind from that site is unknown
                writes = [a for a in accesses if a.kind == "write"]
                decl_line = writes[0].line if writes else accesses[0].line
            decl_ann = self._ann_at(ann, decl_line)
            declared_lock: Optional[str] = None
            if decl_ann is not None:
                akind, arg = decl_ann
                if akind == "unguarded":
                    if not arg:
                        findings.append(Finding(
                            ctx.rel, decl_line, "bad-annotation",
                            f"unguarded() on {scan.name}.{attr} needs "
                            f"a reason — the exemption must be "
                            f"auditable"))
                    continue  # whole attribute exempted
                declared_lock = _canon_lock(scan, arg) or arg
                if declared_lock not in scan.lock_attrs:
                    findings.append(Finding(
                        ctx.rel, decl_line, "bad-annotation",
                        f"guarded-by({arg}) on {scan.name}.{attr}: "
                        f"class owns no lock attribute {arg!r} "
                        f"(locks: {sorted(scan.lock_attrs) or 'none'})"))
                    continue

            findings += self._check_attr(
                ctx, scan, ann, attr, kind, declared_lock, accesses)
        return findings

    def _is_write(self, a: _Access, kind: str) -> bool:
        if a.kind == "write":
            return True
        if a.kind.startswith("mutcall:"):
            return (kind == "container"
                    and a.kind.split(":", 1)[1] in MUTATOR_METHODS)
        return False

    def _check_attr(self, ctx, scan: _ClassScan, ann, attr: str,
                    kind: str, declared_lock: Optional[str],
                    accesses: List[_Access]) -> List[Finding]:
        findings: List[Finding] = []
        has_writes = any(self._is_write(a, kind) for a in accesses)
        if not has_writes and declared_lock is None:
            return []  # immutable-after-init: unlocked reads are safe

        qual = f"{scan.name}.{attr}"
        guards_seen: Dict[str, int] = {}  # lock -> witness line
        common: Optional[frozenset] = None
        for a in accesses:
            site_ann = self._ann_at(ann, a.line)
            eff = set(a.locks)
            if site_ann is not None:
                akind, arg = site_ann
                if akind == "unguarded":
                    if not arg:
                        findings.append(Finding(
                            ctx.rel, a.line, "bad-annotation",
                            f"unguarded() on this access to {qual} "
                            f"needs a reason"))
                    continue
                lk = _canon_lock(scan, arg) or arg
                if lk not in scan.lock_attrs:
                    findings.append(Finding(
                        ctx.rel, a.line, "bad-annotation",
                        f"guarded-by({arg}) here: {scan.name} owns no "
                        f"lock attribute {arg!r}"))
                    continue
                eff.add(lk)
            if not eff:
                verb = ("written" if self._is_write(a, kind)
                        else "read")
                findings.append(Finding(
                    ctx.rel, a.line, "unguarded-access",
                    f"{qual} is {verb} here with no class lock held, "
                    f"but has locked/other-thread writes — annotate "
                    f"guarded-by(<lock>) if the caller holds it, "
                    f"unguarded(<reason>) if the race is by design, "
                    f"or take the lock"))
                continue
            for lk in eff:
                guards_seen.setdefault(lk, a.line)
            common = (frozenset(eff) if common is None
                      else common & frozenset(eff))
            if a.kind == "return" and kind == "container" and has_writes:
                findings.append(Finding(
                    ctx.rel, a.line, "leaked-guarded-ref",
                    f"returning the live {qual} container from under "
                    f"its lock — the caller reads it after release; "
                    f"return a copy (list(...)/dict(...))"))
        if common is not None and not common and len(guards_seen) > 1:
            locks = sorted(guards_seen)
            findings.append(Finding(
                ctx.rel, guards_seen[locks[0]], "divergent-guard",
                f"{qual} is guarded by different locks at different "
                f"sites ({', '.join(locks)}) — no single lock "
                f"protects every access, so the guards exclude "
                f"nothing"))
        elif declared_lock is not None and common is not None \
                and declared_lock not in common:
            locks = sorted(guards_seen) or ["none"]
            findings.append(Finding(
                ctx.rel, min(guards_seen.values(), default=1),
                "divergent-guard",
                f"{qual} is declared guarded-by({declared_lock}) but "
                f"some access holds only {', '.join(locks)}"))
        return findings


# ---------------------------------------------------------------------------
# static map for the DMLC_RACECHECK runtime cross-check
# ---------------------------------------------------------------------------

def guarded_region_map(index: RepoIndex) -> Dict[Tuple[str, int], str]:
    """``(file basename, with-statement line) -> expected runtime lock
    name`` for every ``with self.<lock>:`` acquire site of every
    threaded class in the index.  The expected name is the static node
    name ``Class.attr`` — the ``make_lock(name)`` convention — so the
    runtime watchdog (``DMLC_RACECHECK=1``) can cross-check that the
    lock actually held at an acquire site is the one the static
    guarded-by analysis believes protects that region's attributes."""
    safe = RacePass._lock_owning_classes(index)
    out: Dict[Tuple[str, int], str] = {}
    for ctx in index.files:
        if not index.in_package(ctx) or ctx.tree is None:
            continue
        base = os.path.basename(ctx.rel)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            scan = scan_class(ctx.rel, node, safe)
            if not scan.lock_attrs:
                continue
            for ms in scan.methods.values():
                for line, lock in ms.region_sites:
                    key = (base, line)
                    name = f"{scan.name}.{lock}"
                    if out.get(key, name) != name:
                        # two files share a basename and both acquire
                        # at this line: ambiguous, never cross-checked
                        out[key] = None
                    else:
                        out[key] = name
    return out
