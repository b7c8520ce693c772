"""R2: lock discipline for the threaded control plane.

For every class in ``scheduler/`` and ``agent/`` the rule:

1. finds its lock attributes (``self._lock = threading.Lock()`` and
   friends — any ``threading.Lock/RLock/Condition`` assignment);
2. infers the *guarded set*: underscore-prefixed ``self._*`` attributes
   that are **written under a lock** somewhere outside ``__init__`` —
   writing under the lock is the class's own declaration that the
   attribute is shared;
3. flags reads/writes of guarded attributes that happen outside any
   ``with self._lock:`` block in a *thread-entry or callback context*
   (a method passed to ``threading.Thread(target=...)``, registered as
   a callback, matching a callback naming pattern, or transitively
   called from one);
4. separately flags unsynchronized shared state: a ``self._*``
   attribute never protected by any lock, mutated from a thread-entry
   context and also accessed from other methods (the
   ``FileLeaderElector._leader`` class of bug).

Methods whose name ends in ``_locked`` are exempt by convention: the
caller holds the lock. Attributes initialized to inherently
thread-safe objects (Event, Queue, deque, locks) are exempt from (4).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

_LOCK_TYPES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
    # the runtime lock-witness wrappers construct (or wrap) the same
    # threading primitives — instrumented locks are still locks
    "witness_lock", "witness_condition",
    "lockwitness.witness_lock", "lockwitness.witness_condition",
    "cook_tpu_torch.utils.lockwitness.witness_lock",
    "cook_tpu_torch.utils.lockwitness.witness_condition",
}
# initialized-to types that are safe to share without an explicit lock
_THREADSAFE_TYPES = {
    "threading.Event", "threading.Lock", "threading.RLock",
    "threading.Condition", "threading.Semaphore", "threading.Barrier",
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "collections.deque",
    "Event", "Queue", "SimpleQueue", "deque",
}
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "add", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "sort", "put", "put_nowait",
}
_CALLBACK_NAME = re.compile(
    r"^(_?on_|_?handle_|do_[A-Z]|_?run$)|(_loop|_worker|_thread|_entry)$")


@dataclass
class _Access:
    attr: str
    line: int
    write: bool
    locked: bool
    owner: str            # innermost def name (nested defs included)
    method: str           # enclosing class method


@dataclass
class _ClassScan:
    name: str
    lock_attrs: set = field(default_factory=set)
    accesses: list = field(default_factory=list)
    # owner-name -> set of self-method names it calls
    calls: dict = field(default_factory=dict)
    # owners that are thread entry points / callbacks
    entry_owners: set = field(default_factory=set)
    # attr -> resolved dotted init value type (if a simple call)
    init_types: dict = field(default_factory=dict)
    methods: set = field(default_factory=set)
    # attr -> lock attr it was seen written under (for messages)
    guard_lock: dict = field(default_factory=dict)


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a `self.x` attribute expression."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _scan_class(mod: ModuleInfo, cls: ast.ClassDef) -> _ClassScan:
    scan = _ClassScan(name=cls.name)
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    scan.methods = {m.name for m in methods}

    # pass 1: lock attrs + init types (anywhere in the class, so locks
    # created lazily outside __init__ still count)
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            for t in targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if isinstance(node.value, ast.Call):
                    dotted = mod.resolve(node.value.func)
                    if dotted in _LOCK_TYPES:
                        scan.lock_attrs.add(attr)
                    if dotted:
                        # first assignment wins; covers lazily-created
                        # attrs (a Queue built outside __init__)
                        scan.init_types.setdefault(attr, dotted)

    # pass 2: accesses with lock context, per innermost def
    for m in methods:
        _scan_stmts(mod, scan, list(ast.iter_child_nodes(m)),
                    locked_by=None, owner=m.name, method=m.name)

    # entry owners: callback-looking names
    for m in methods:
        if _CALLBACK_NAME.search(m.name):
            scan.entry_owners.add(m.name)
    # transitive closure over self-method calls
    work = list(scan.entry_owners)
    while work:
        owner = work.pop()
        for callee in scan.calls.get(owner, ()):
            if callee in scan.methods and callee not in scan.entry_owners:
                scan.entry_owners.add(callee)
                work.append(callee)
    return scan


def _scan_stmts(mod: ModuleInfo, scan: _ClassScan, nodes: list,
                locked_by: str | None, owner: str, method: str) -> None:
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: new owner, lock context does NOT carry over
            # (the def usually runs later, on another thread)
            _scan_stmts(mod, scan, list(ast.iter_child_nodes(node)),
                        locked_by=None, owner=node.name, method=method)
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)):
            held = locked_by
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr in scan.lock_attrs:
                    held = attr
            _scan_stmts(mod, scan, list(node.body), held, owner, method)
            # the `with` items themselves (lock expr) need no scan
            continue
        _record_exprs(mod, scan, node, locked_by, owner, method)
        _scan_stmts(mod, scan, list(ast.iter_child_nodes(node)),
                    locked_by, owner, method)


def _record_exprs(mod: ModuleInfo, scan: _ClassScan, node: ast.AST,
                  locked_by: str | None, owner: str,
                  method: str) -> None:
    def record(attr: str, line: int, write: bool) -> None:
        scan.accesses.append(_Access(attr, line, write,
                                     locked_by is not None, owner,
                                     method))
        if write and locked_by is not None:
            scan.guard_lock.setdefault(attr, locked_by)

    if isinstance(node, ast.Attribute):
        attr = _self_attr(node)
        if attr is not None:
            record(attr, node.lineno,
                   isinstance(node.ctx, (ast.Store, ast.Del)))
    elif isinstance(node, ast.Subscript):
        # self._d[k] = v / del self._d[k]: a write of _d
        attr = _self_attr(node.value)
        if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
            record(attr, node.lineno, True)
    elif isinstance(node, ast.Call):
        fn = node.func
        # self._d.pop(...) and friends: a write of _d
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATOR_METHODS:
            attr = _self_attr(fn.value)
            if attr is not None:
                record(attr, node.lineno, True)
        # self.method(...) call graph edge
        if isinstance(fn, ast.Attribute):
            attr = _self_attr(fn)
            if attr is not None:
                scan.calls.setdefault(owner, set()).add(attr)
        # callbacks / thread targets: self.X or a local def passed as
        # an argument value
        for arg in list(node.args) + [k.value for k in node.keywords]:
            attr = _self_attr(arg)
            if attr is not None:
                scan.entry_owners.add(attr)
            elif isinstance(arg, ast.Name):
                # threading.Thread(target=campaign): nested def by name
                dotted = mod.resolve(node.func)
                if dotted and dotted.endswith("Thread"):
                    scan.entry_owners.add(arg.id)
        for kw in node.keywords:
            if kw.arg == "target":
                attr = _self_attr(kw.value)
                if attr is not None:
                    scan.entry_owners.add(attr)
                elif isinstance(kw.value, ast.Name):
                    scan.entry_owners.add(kw.value.id)


def check(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = _scan_class(mod, cls)
        findings += _check_guarded(mod, cls, scan)
        findings += _check_unguarded(mod, cls, scan)
    return findings


def _interesting(attr: str, scan: _ClassScan) -> bool:
    return (attr.startswith("_") and not attr.startswith("__")
            and attr not in scan.lock_attrs
            and attr not in scan.methods)


def _check_guarded(mod: ModuleInfo, cls: ast.ClassDef,
                   scan: _ClassScan) -> list[Finding]:
    if not scan.lock_attrs:
        return []
    guarded = {a.attr for a in scan.accesses
               if a.write and a.locked and a.method != "__init__"
               and _interesting(a.attr, scan)}
    out = []
    seen = set()
    for a in scan.accesses:
        if a.attr not in guarded or a.locked or a.method == "__init__":
            continue
        if a.owner not in scan.entry_owners:
            continue
        if a.method.endswith("_locked") or a.owner.endswith("_locked"):
            continue
        key = (a.attr, a.line)
        if key in seen:
            continue
        seen.add(key)
        lock = scan.guard_lock.get(a.attr, sorted(scan.lock_attrs)[0])
        kind = "write" if a.write else "read"
        out.append(Finding(
            "R2", mod.path, a.line, f"{cls.name}.{a.method}",
            f"{kind} of lock-guarded self.{a.attr} without holding "
            f"self.{lock} in thread-entry/callback context"))
    return out


def _check_unguarded(mod: ModuleInfo, cls: ast.ClassDef,
                     scan: _ClassScan) -> list[Finding]:
    if not scan.entry_owners:
        return []
    ever_locked = {a.attr for a in scan.accesses if a.locked}
    by_attr: dict[str, list[_Access]] = {}
    for a in scan.accesses:
        if _interesting(a.attr, scan) and a.attr not in ever_locked:
            by_attr.setdefault(a.attr, []).append(a)
    out = []
    for attr, accs in sorted(by_attr.items()):
        if scan.init_types.get(attr) in _THREADSAFE_TYPES:
            continue
        # accesses confined to one def are (almost always) confined to
        # one thread — campaign-loop scratch state like a renew cache
        # is not shared just because the loop runs on a thread
        owners = {a.owner for a in accs if a.method != "__init__"}
        if len(owners) <= 1:
            continue
        entry_writes = [a for a in accs if a.write
                        and a.owner in scan.entry_owners
                        and a.method != "__init__"]
        others = [a for a in accs
                  if a.method != "__init__"
                  and (a.owner not in scan.entry_owners or not a.write)]
        if not entry_writes or not others:
            continue
        w = entry_writes[0]
        o = others[0]
        out.append(Finding(
            "R2", mod.path, w.line, f"{cls.name}.{w.method}",
            f"self.{attr} is written from thread-entry/callback context "
            f"({w.method}) and accessed elsewhere ({o.method}) with no "
            "lock guarding it"))
    return out
