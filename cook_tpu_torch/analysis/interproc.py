"""Whole-package interprocedural model: call graph + lock summaries.

The per-module rules (R1-R10) reason about one AST at a time, which is
enough to pin chokepoints but not lock *order* — every real deadlock
found so far (the day-soak pair, the sizing hangs) spanned
functions, usually spanned files, and was caught dynamically minutes
into a soak. This module is the shared substrate that lets R11/R12
reason across the package:

* a **call graph** over every function/method in the scanned files,
  alias-aware through :meth:`ModuleInfo.resolve`, with a resolution
  ladder for attribute calls (self-dispatch through the class
  hierarchy, local/attribute type inference from constructor calls and
  annotations, a repo-native receiver-name hint table, and a sound
  name-based fallback for receivers nothing else can type);
* per-function **lock summaries**: which locks a function acquires
  directly (``with self._lock``, ``.acquire()``, the blessed store
  section helpers via their ``@contextmanager`` yield-held sets), and
  which callees it reaches while holding them;
* the global **lock-acquisition edge set**: ``A -> B`` iff some path
  acquires B while holding A, with one witness site (file:line and the
  function chain) kept per edge so a finding can say *where*.

Lock identity is the **witness name** when the lock is created through
:func:`cook_tpu_torch.utils.lockwitness.witness_lock` (the analyzer reads the
name literal out of the call, so the static graph and the runtime
lock-witness agree on vocabulary by construction), and ``Class.attr``
for plain ``threading.*`` locks. A list-of-locks attribute (the store's
shard locks) is modeled as ONE family node ``...[*]`` whose ordered
(ascending-index) self-acquisition is legal and whose unordered
self-acquisition is an R11 finding.

Deliberate approximations, chosen to over- rather than under-report
edges (the runtime witness gates on "no observed edge the model lacks",
so the static side must over-approximate):

* held-lock tracking is flow-insensitive across branches — an acquire
  inside ``if`` is held for the rest of the function body;
* an unresolvable receiver falls back to every package function of the
  same name, except names on the builtin-collection blocklist;
* functions registered as listeners/callbacks are dispatched at
  indirect callsites (a call through a loop variable over a
  ``*listener*``/``*callback*``/``*hook*`` container, or through a
  callable data attribute) whose normalized **slot** matches the one
  they escaped through — ``store.add_listener(f)`` makes ``f`` a
  candidate at ``for fn in self._listeners: fn(...)`` sites but not at
  ``self.on_heartbeat(...)`` sites; thread/executor targets are
  call-graph roots but are NOT dispatched at indirect sites and do NOT
  propagate the spawner's held set.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Optional

from cook_tpu_torch.analysis.core import ModuleInfo, _collect_aliases

# threading factories -> reentrant?
_LOCK_FACTORIES = {
    "threading.Lock": False, "Lock": False,
    "threading.RLock": True, "RLock": True,
    "threading.Condition": True, "Condition": True,
}
_WITNESS_FACTORIES = {"witness_lock", "witness_condition",
                      "lockwitness.witness_lock",
                      "lockwitness.witness_condition",
                      "cook_tpu_torch.utils.lockwitness.witness_lock",
                      "cook_tpu_torch.utils.lockwitness.witness_condition"}

# receiver-variable/attribute name -> class name, for receivers the
# type inference cannot reach (untyped constructor params mostly).
# Repo-native by design: this is cook_tpu_torch's own vocabulary.
RECEIVER_HINTS = {
    "store": "JobStore",
    "coord": "Coordinator",
    "coordinator": "Coordinator",
    "rp": "ResidentPool",
    "cluster": "AgentCluster",
    "batcher": "IngestBatcher",
    "ingest": "IngestBatcher",
    "_ingest": "IngestBatcher",
    "writer": "_PyLogWriter",
    "_log": "_PyLogWriter",
    "heartbeats": "HeartbeatWatcher",
    "liveness": "AgentLivenessTracker",
    "overload": "OverloadController",
    "tracer": "Tracer",
}

# attribute-call names never resolved by the everything-named-foo
# fallback: builtin container/file/concurrency methods that would drag
# half the package into every dict.get(). A package method shadowing
# one of these is reachable only through typed/hinted receivers.
_FALLBACK_BLOCKLIST = frozenset((
    "append", "appendleft", "extend", "insert", "add", "update", "get",
    "pop", "popleft", "popitem", "remove", "discard", "clear", "sort",
    "sorted", "copy", "setdefault", "items", "keys", "values", "count",
    "index", "join", "split", "strip", "startswith", "endswith",
    "encode", "decode", "format", "lower", "upper", "replace", "read",
    "readline", "readlines", "write", "writelines", "flush", "seek",
    "tell", "fileno", "put", "put_nowait", "get_nowait", "qsize",
    "empty", "full", "task_done", "set", "is_set", "wait", "notify",
    "notify_all", "acquire", "release", "locked", "cancel", "result",
    "done", "submit", "map", "total_seconds", "isoformat", "group",
    "groups", "groupdict", "match", "search", "findall", "sub",
    "hexdigest", "digest", "tolist", "item", "astype", "reshape",
    "close", "start", "poll", "terminate", "communicate",
    "send_signal", "recv", "send", "sendall",
))

# heads that are definitely not package modules — calls resolving here
# are leaves (no package function behind them)
_EXTERNAL_HEADS = frozenset((
    "threading", "queue", "os", "sys", "json", "time", "math", "re",
    "io", "zlib", "collections", "itertools", "functools", "logging",
    "contextlib", "dataclasses", "typing", "np", "numpy", "jax", "jnp",
    "socket", "struct", "ctypes", "subprocess", "shutil", "signal",
    "random", "uuid", "http", "urllib", "socketserver", "tempfile",
    "heapq", "bisect", "copy", "pickle", "base64", "hashlib", "enum",
    "string", "traceback", "warnings", "weakref", "abc", "argparse",
    "atexit", "errno", "select", "stat", "glob", "secrets",
))

_LISTENERISH = ("listener", "callback", "hook", "_cb", "subscriber")

# callsites whose function-valued arguments run LATER on another
# thread: the argument is a call-graph root, the spawner's held locks
# do not extend into it
_DEFER_ATTRS = frozenset(("submit", "map", "start", "call_later",
                          "call_soon", "apply_async"))

# callsite sentinel prefix: listener dispatch ("<escaped:slot>")
ESCAPED = "<escaped>"


def _slot(name: str) -> str:
    """Normalize a registration/dispatch channel name so the two ends
    meet: ``add_listener``/``_listeners``/``listener`` -> "listener",
    ``on_progress=`` kwarg / ``self.on_progress(...)`` -> "on_progress".
    Escaped callables only dispatch at indirect callsites whose slot
    matches the one they escaped through — a store listener is never
    "called" by an executor heartbeat callback site."""
    n = name.lstrip("_").lower()
    for pre in ("add_", "register_", "set_"):
        if n.startswith(pre):
            n = n[len(pre):]
    if "listener" in n or "subscrib" in n:
        return "listener"
    if "callback" in n or n.endswith("_cb") or n == "cb":
        return "callback"
    if "hook" in n:
        return "hook"
    return n


def _escaped_target(slot: str) -> str:
    return f"<escaped:{slot}>"


def _is_escaped(target: str) -> bool:
    return target.startswith("<escaped")


@dataclass(frozen=True)
class LockDef:
    name: str                  # canonical node name ("JobStore._lock")
    reentrant: bool
    witnessed: bool            # created through witness_lock/_condition
    family: bool = False       # list-of-locks node ("...[*]")
    path: str = ""
    line: int = 0


@dataclass
class Acq:
    lock: str
    line: int
    held: tuple                # lock names held at this acquisition
    ordered: bool = False      # ascending-index family acquisition


@dataclass
class CallSite:
    targets: tuple             # FuncInfo keys, or (ESCAPED,)
    held: tuple
    line: int
    label: str = ""            # source text-ish label for messages


@dataclass
class FuncInfo:
    key: str                   # "rel/path.py::Class.method"
    name: str
    cls: Optional[str]
    path: str
    line: int
    node: ast.AST = None
    acquires: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    is_contextmanager: bool = False
    yields_held: tuple = ()    # held set at first yield (contextmanagers)
    returns: list = field(default_factory=list)   # ast.Return nodes


@dataclass
class ClassInfo:
    name: str
    path: str
    line: int
    bases: list = field(default_factory=list)     # base class names
    methods: dict = field(default_factory=dict)   # name -> func key
    locks: dict = field(default_factory=dict)     # attr -> lock name
    attr_types: dict = field(default_factory=dict)  # attr -> class name
    callable_attrs: set = field(default_factory=set)  # data attrs holding
    #                                                   callables (params)


@dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    path: str                  # witness site (file of the held frame)
    line: int
    func: str                  # function whose body holds src
    via: str                   # "" for direct, else callee chain label
    ordered: bool = False      # blessed ascending family self-edge


class PackageModel:
    """The whole-package model R11/R12 run against."""

    def __init__(self):
        self.functions: dict[str, FuncInfo] = {}
        self.classes: dict[str, ClassInfo] = {}
        self.locks: dict[str, LockDef] = {}
        self.by_name: dict[str, list] = {}     # bare name -> [func keys]
        self.by_module: dict[str, dict] = {}   # dotted mod -> name->key
        self.escaped_by_slot: dict[str, set] = {}  # slot -> func keys
        self.thread_roots: set = set()         # func keys
        self._acq_closure: dict[str, frozenset] = {}
        self.edges: list[Edge] = []
        self._edge_index: dict[tuple, Edge] = {}

    # -- queries -------------------------------------------------------

    @property
    def escaped_listeners(self) -> set:
        """Union of every escaped callable, across all slots."""
        out: set = set()
        for keys in self.escaped_by_slot.values():
            out |= keys
        return out

    def dispatch(self, target: str) -> tuple:
        """Candidate function keys for a callsite target: the key
        itself, or — for an ``<escaped:slot>`` sentinel — the callables
        registered through that slot."""
        if not _is_escaped(target):
            return (target,)
        slot = target[len("<escaped:"):-1] if ":" in target else ""
        if slot:
            return tuple(self.escaped_by_slot.get(slot, ()))
        return tuple(self.escaped_listeners)

    def edge_set(self) -> set:
        return set(self._edge_index)

    def edge(self, src: str, dst: str) -> Optional[Edge]:
        return self._edge_index.get((src, dst))

    def acq_closure(self, key: str) -> frozenset:
        """Every (lock, ordered) this function can acquire, transitively."""
        return self._acq_closure.get(key, frozenset())

    def reaches(self, start_keys: Iterable[str],
                targets: Iterable[str]) -> bool:
        """True iff any target key is reachable from start_keys over
        call edges (deferred spawns excluded by construction)."""
        targets = set(targets)
        seen: set = set()
        work = list(start_keys)
        while work:
            k = work.pop()
            if k in seen:
                continue
            seen.add(k)
            if k in targets:
                return True
            fn = self.functions.get(k)
            if fn is None:
                continue
            for cs in fn.calls:
                for t in cs.targets:
                    for c in self.dispatch(t):
                        if c not in seen:
                            work.append(c)
        return False

    def reachable_from(self, start_keys: Iterable[str]) -> set:
        seen: set = set()
        work = list(start_keys)
        while work:
            k = work.pop()
            if k in seen:
                continue
            seen.add(k)
            fn = self.functions.get(k)
            if fn is None:
                continue
            for cs in fn.calls:
                for t in cs.targets:
                    for c in self.dispatch(t):
                        if c not in seen:
                            work.append(c)
        return seen

    def resolve_method(self, cls_name: str, meth: str) -> list:
        """Method lookup through the class hierarchy: the defining
        class, its ancestors, and (for polymorphic dispatch) any
        descendant override."""
        out: list[str] = []
        seen_cls: set = set()

        def ancestors(name: str):
            ci = self.classes.get(name)
            if ci is None or name in seen_cls:
                return
            seen_cls.add(name)
            yield ci
            for b in ci.bases:
                yield from ancestors(b)

        for ci in ancestors(cls_name):
            if meth in ci.methods:
                out.append(ci.methods[meth])
                break
        # descendant overrides (and the base's version when only the
        # subclass was typed)
        for name, ci in self.classes.items():
            if name == cls_name or meth not in ci.methods:
                continue
            if _is_descendant(self, name, cls_name) \
                    or _is_descendant(self, cls_name, name):
                k = ci.methods[meth]
                if k not in out:
                    out.append(k)
        return out


def _is_descendant(model: PackageModel, name: str, of: str,
                   _seen=None) -> bool:
    if _seen is None:
        _seen = set()
    if name in _seen:
        return False
    _seen.add(name)
    ci = model.classes.get(name)
    if ci is None:
        return False
    if of in ci.bases:
        return True
    return any(_is_descendant(model, b, of, _seen) for b in ci.bases)


# ----------------------------------------------------------------------
# model construction

def build_model(files: Iterable[tuple]) -> PackageModel:
    """files: iterable of (repo-relative path, source text)."""
    model = PackageModel()
    mods: list[tuple] = []
    for path, source in files:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        mod = ModuleInfo(tree=tree, source=source, path=path,
                         aliases=_collect_aliases(tree))
        mods.append(mod)

    for mod in mods:
        _index_module(model, mod)
    # contextmanager yield-held sets must exist BEFORE any caller's
    # body scan consumes them through `with self.section():`
    for mod in mods:
        _prescan_contextmanagers(model, mod)
    for mod in mods:
        _scan_module(model, mod)
    _compute_closures(model)
    _compute_edges(model)
    return model


def _dotted_module(path: str) -> str:
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    # anchor at the package root if present
    if "cook_tpu_torch" in parts:
        parts = parts[parts.index("cook_tpu_torch"):]
    return ".".join(parts)


def _index_module(model: PackageModel, mod: ModuleInfo) -> None:
    """Pass 1: classes, functions, lock attrs, attribute types."""
    dotted = _dotted_module(mod.path)
    mod_index = model.by_module.setdefault(dotted, {})

    def add_func(node, cls: Optional[str]):
        qual = f"{cls}.{node.name}" if cls else node.name
        key = f"{mod.path}::{qual}"
        fi = FuncInfo(key=key, name=node.name, cls=cls, path=mod.path,
                      line=node.lineno, node=node,
                      is_contextmanager=_is_contextmanager(mod, node))
        model.functions[key] = fi
        model.by_name.setdefault(node.name, []).append(key)
        if cls is None:
            mod_index[node.name] = key
        return key

    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add_func(node, None)
        elif isinstance(node, ast.ClassDef):
            ci = model.classes.setdefault(
                node.name, ClassInfo(name=node.name, path=mod.path,
                                     line=node.lineno))
            for b in node.bases:
                base = mod.resolve(b)
                if base:
                    ci.bases.append(base.split(".")[-1])
            for item in node.body:
                if isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    ci.methods[item.name] = add_func(item, node.name)
            _scan_class_attrs(model, mod, node, ci)


def _lock_from_value(model: PackageModel, mod: ModuleInfo,
                     value: ast.AST, cls: str, attr: str,
                     family: bool = False) -> Optional[str]:
    """Register a LockDef if `value` builds a lock; return its name."""
    if not isinstance(value, ast.Call):
        return None
    dotted = mod.resolve(value.func)
    if dotted is None:
        return None
    short = dotted.split(".")[-1]
    name = None
    if dotted in _WITNESS_FACTORIES or short in ("witness_lock",
                                                 "witness_condition"):
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            name = value.args[0].value
        reentrant = short == "witness_condition"
        for kw in value.keywords:
            if kw.arg == "reentrant" and isinstance(kw.value, ast.Constant):
                reentrant = bool(kw.value.value)
        if name is None:
            name = f"{cls}.{attr}"
        node_name = name + "[*]" if family and not name.endswith("[*]") \
            else name
        model.locks.setdefault(node_name, LockDef(
            name=node_name, reentrant=reentrant, witnessed=True,
            family=family, path=mod.path, line=value.lineno))
        return node_name
    if dotted in _LOCK_FACTORIES:
        node_name = f"{cls}.{attr}" + ("[*]" if family else "")
        model.locks.setdefault(node_name, LockDef(
            name=node_name, reentrant=_LOCK_FACTORIES[dotted],
            witnessed=False, family=family, path=mod.path,
            line=value.lineno))
        return node_name
    return None


def _scan_class_attrs(model: PackageModel, mod: ModuleInfo,
                      cls: ast.ClassDef, ci: ClassInfo) -> None:
    """Lock attributes, attribute types, callable data attrs."""
    params_by_method: dict[str, dict] = {}
    for m in cls.body:
        if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        anns = {}
        for a in m.args.args + m.args.kwonlyargs:
            if a.annotation is not None:
                t = mod.resolve(a.annotation)
                if t:
                    anns[a.arg] = t.split(".")[-1]
            else:
                anns.setdefault(a.arg, None)
        params_by_method[m.name] = anns
        # local var -> class name, for `br = CircuitBreaker(...);
        # self._breakers[h] = br`
        locals_ty: dict[str, str] = {}
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                d = mod.resolve(node.value.func)
                if d and d.split(".")[-1][:1].isupper():
                    locals_ty[node.targets[0].id] = d.split(".")[-1]
        for node in ast.walk(m):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
                # self._breakers: dict[str, CircuitBreaker] = {} — the
                # annotation names the element type
                attr = _self_attr(node.target)
                if attr is not None and \
                        isinstance(node.annotation, ast.Subscript):
                    ety = _container_elem_type(mod, node.annotation)
                    if ety:
                        ci.attr_types.setdefault(attr + "[]", ety)
            else:
                continue
            for t in targets:
                # self._breakers[key] = CircuitBreaker(...) / = br:
                # element type of a keyed-collection attribute
                if isinstance(t, ast.Subscript):
                    base = _self_attr(t.value)
                    if base is not None:
                        ety = None
                        if isinstance(value, ast.Call):
                            d = mod.resolve(value.func)
                            if d and (d.split(".")[-1] in model.classes
                                      or d.split(".")[-1][:1].isupper()):
                                ety = d.split(".")[-1]
                        elif isinstance(value, ast.Name):
                            ety = locals_ty.get(value.id)
                        if ety:
                            ci.attr_types.setdefault(base + "[]", ety)
                    continue
                attr = _self_attr(t)
                if attr is None:
                    continue
                # list-of-locks: [Lock() for ...] / [witness_lock(...)
                # for ...]
                if isinstance(value, ast.ListComp):
                    ln = _lock_from_value(model, mod, value.elt,
                                          cls.name, attr, family=True)
                    if ln:
                        ci.locks[attr] = ln
                    continue
                ln = _lock_from_value(model, mod, value, cls.name, attr)
                if ln:
                    ci.locks[attr] = ln
                    continue
                if isinstance(value, ast.Call):
                    dotted = mod.resolve(value.func)
                    if dotted:
                        short = dotted.split(".")[-1]
                        if short in model.classes or short[:1].isupper():
                            ci.attr_types.setdefault(attr, short)
                elif isinstance(value, ast.Name):
                    # self.x = param: use the annotation or a hint
                    pann = params_by_method.get(m.name, {})
                    if value.id in pann:
                        t = pann[value.id] or RECEIVER_HINTS.get(value.id)
                        if t:
                            ci.attr_types.setdefault(attr, t)
                        else:
                            ci.callable_attrs.add(attr)


def _container_elem_type(mod: ModuleInfo, ann: ast.Subscript) \
        -> Optional[str]:
    """Element type of a dict[K, V]/list[V]/set[V] annotation."""
    head = mod.resolve(ann.value)
    if head is None:
        return None
    head = head.split(".")[-1].lower()
    inner = ann.slice
    if head == "dict" and isinstance(inner, ast.Tuple) \
            and len(inner.elts) == 2:
        inner = inner.elts[1]
    elif head not in ("list", "set", "frozenset", "deque", "defaultdict"):
        return None
    if head == "defaultdict" and isinstance(inner, ast.Tuple) \
            and len(inner.elts) == 2:
        inner = inner.elts[1]
    ety = mod.resolve(inner) if not isinstance(inner, ast.Tuple) else None
    if ety and ety.split(".")[-1][:1].isupper():
        return ety.split(".")[-1]
    return None


def _is_contextmanager(mod: ModuleInfo, node) -> bool:
    for dec in node.decorator_list:
        d = mod.resolve(dec)
        if d and d.split(".")[-1] == "contextmanager":
            return True
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


# ----------------------------------------------------------------------
# pass 2: function bodies — acquisitions, callsites, escapes

class _BodyScan:
    def __init__(self, model: PackageModel, mod: ModuleInfo,
                 fi: FuncInfo, ci: Optional[ClassInfo]):
        self.model = model
        self.mod = mod
        self.fi = fi
        self.ci = ci
        self.held: list[tuple] = []     # (lock name, tag) stack
        self.local_types: dict[str, str] = {}   # var -> class name
        self.local_locks: dict[str, tuple] = {}  # var -> (lock, ordered)
        self.sorted_vars: set = set()
        # annotated params seed the type env
        args = fi.node.args
        for a in args.args + args.kwonlyargs + \
                ([args.vararg] if args.vararg else []) + \
                ([args.kwarg] if args.kwarg else []):
            if a is None:
                continue
            if a.annotation is not None:
                t = mod.resolve(a.annotation)
                if t:
                    self.local_types[a.arg] = t.split(".")[-1]

    # -- lock classification ------------------------------------------

    def _lock_of_expr(self, expr: ast.AST) -> Optional[tuple]:
        """(lock name, ordered) for an expression denoting a lock."""
        attr = _self_attr(expr)
        if attr is not None and self.ci is not None:
            ln = self.ci.locks.get(attr)
            if ln:
                return (ln, False)
            return None
        if isinstance(expr, ast.Name):
            return self.local_locks.get(expr.id)
        if isinstance(expr, ast.Subscript):
            # self._shard_locks[i] -> the family node
            base = _self_attr(expr.value)
            if base is not None and self.ci is not None:
                ln = self.ci.locks.get(base)
                if ln and ln.endswith("[*]"):
                    return (ln, True)   # single-index = trivially ordered
        if isinstance(expr, ast.Attribute):
            # another object's lock, e.g. `with self.store._lock:` —
            # type the receiver, then look the attr up in THAT class
            cls = self._class_of_expr(expr.value)
            if cls and cls in self.model.classes:
                ln = self.model.classes[cls].locks.get(expr.attr)
                if ln:
                    return (ln, False)
        return None

    def _class_of_expr(self, recv: ast.AST) -> Optional[str]:
        """Best-effort class name of a receiver expression (the same
        ladder _resolve_call walks for method dispatch)."""
        if isinstance(recv, ast.Name):
            if recv.id == "self" and self.ci is not None:
                return self.ci.name
            return self.local_types.get(recv.id) \
                or RECEIVER_HINTS.get(recv.id)
        attr = _self_attr(recv)
        if attr is not None and self.ci is not None:
            return self.ci.attr_types.get(attr) \
                or RECEIVER_HINTS.get(attr)
        if isinstance(recv, ast.Subscript):
            base = _self_attr(recv.value)
            if base is not None and self.ci is not None:
                return self.ci.attr_types.get(base + "[]")
        if isinstance(recv, ast.Call):
            return self._return_type(recv)
        return None

    def _cm_held(self, call: ast.Call) -> Optional[tuple]:
        """Locks held inside `with self.section():` for a contextmanager
        method — its held set at yield."""
        targets = self._resolve_call(call)
        out: list = []
        for t in targets:
            if _is_escaped(t):
                continue
            fn = self.model.functions.get(t)
            if fn is not None and fn.is_contextmanager and fn.yields_held:
                out.extend(fn.yields_held)
        return tuple(dict.fromkeys(out)) if out else None

    # -- call resolution ladder ---------------------------------------

    def _resolve_call(self, call: ast.Call) -> tuple:
        fn = call.func
        model = self.model
        if isinstance(fn, ast.Name):
            # local def / module-level / imported
            name = fn.id
            dotted = self.mod.aliases.get(name, name)
            head = dotted.split(".")[0]
            if head in _EXTERNAL_HEADS:
                return ()
            # class constructor
            short = dotted.split(".")[-1]
            if short in model.classes:
                init = model.classes[short].methods.get("__init__")
                return (init,) if init else ()
            # module function in this module
            mod_idx = model.by_module.get(_dotted_module(self.mod.path))
            if mod_idx and name in mod_idx:
                return (mod_idx[name],)
            # from-import: "pkg.mod.func"
            if "." in dotted:
                modname, func = dotted.rsplit(".", 1)
                idx = model.by_module.get(modname)
                if idx and func in idx:
                    return (idx[func],)
            return ()
        if not isinstance(fn, ast.Attribute):
            return ()
        meth = fn.attr
        recv = fn.value
        # self.foo()
        if isinstance(recv, ast.Name) and recv.id == "self" \
                and self.ci is not None:
            if meth in self.ci.callable_attrs:
                return (_escaped_target(_slot(meth)),)
            got = model.resolve_method(self.ci.name, meth)
            if got:
                return tuple(got)
            return self._fallback(meth)
        # typed receiver?
        cls_name = None
        if isinstance(recv, ast.Name):
            cls_name = self.local_types.get(recv.id) \
                or RECEIVER_HINTS.get(recv.id)
            if cls_name is None:
                dotted = self.mod.aliases.get(recv.id)
                if dotted:
                    head = dotted.split(".")[0]
                    if head in _EXTERNAL_HEADS:
                        return ()
                    idx = model.by_module.get(dotted)
                    if idx and meth in idx:
                        return (idx[meth],)
                    # imported class alias: ClassName.method
                    short = dotted.split(".")[-1]
                    if short in model.classes:
                        cls_name = short
        elif isinstance(recv, ast.Subscript):
            # self._breakers[h].snapshot(): keyed-collection elem type
            base = _self_attr(recv.value)
            if base is not None and self.ci is not None:
                cls_name = self.ci.attr_types.get(base + "[]")
        elif isinstance(recv, ast.Call):
            if isinstance(recv.func, ast.Name) \
                    and recv.func.id == "super" and self.ci is not None:
                # super().meth(): the nearest package ancestor's
                # override per base branch, or nothing when the base
                # is a builtin — falling through to the all-names
                # fallback would drag every same-named method in the
                # package (e.g. every __init__) into this summary
                out: list = []
                pending = list(self.ci.bases)
                seen_bases: set = set()
                while pending:
                    b = pending.pop(0)
                    if b in seen_bases:
                        continue
                    seen_bases.add(b)
                    bi = model.classes.get(b)
                    if bi is None:
                        continue
                    if meth in bi.methods:
                        out.append(bi.methods[meth])
                    else:
                        pending.extend(bi.bases)
                return tuple(out)
            # self._writer_barrier(w).sync(w): the inner call's return
            # annotation types the receiver
            cls_name = self._return_type(recv)
        else:
            attr = _self_attr(recv)
            if attr is not None and self.ci is not None:
                cls_name = self.ci.attr_types.get(attr) \
                    or RECEIVER_HINTS.get(attr)
                if cls_name is None and attr in self.ci.callable_attrs:
                    return (_escaped_target(_slot(attr)),)
            elif isinstance(recv, ast.Attribute):
                # module attr chain: pkg.mod.func(...)
                dotted = self.mod.resolve(fn)
                if dotted:
                    head = dotted.split(".")[0]
                    if head in _EXTERNAL_HEADS:
                        return ()
                    if "." in dotted:
                        modname, func = dotted.rsplit(".", 1)
                        idx = model.by_module.get(modname)
                        if idx and func in idx:
                            return (idx[func],)
        if cls_name:
            got = model.resolve_method(cls_name, meth)
            if got:
                return tuple(got)
        return self._fallback(meth)

    def _return_type(self, call: ast.Call) -> Optional[str]:
        """Class named by the return annotation of a call's resolved
        target (or the class itself for a constructor call)."""
        for t in self._resolve_call(call):
            if _is_escaped(t):
                continue
            fn = self.model.functions.get(t)
            if fn is None or fn.node is None:
                continue
            if fn.name == "__init__" and fn.cls:
                return fn.cls
            ann = getattr(fn.node, "returns", None)
            if ann is not None:
                d = self.mod.resolve(ann)
                if d:
                    return d.split(".")[-1]
        return None

    def _fallback(self, meth: str) -> tuple:
        if meth in _FALLBACK_BLOCKLIST:
            return ()
        return tuple(self.model.by_name.get(meth, ()))

    # -- escapes -------------------------------------------------------

    def _func_value_key(self, expr: ast.AST) -> Optional[str]:
        """Func key when an expression names a package function."""
        attr = _self_attr(expr)
        if attr is not None and self.ci is not None:
            return self.ci.methods.get(attr)
        if isinstance(expr, ast.Name):
            mod_idx = self.model.by_module.get(
                _dotted_module(self.mod.path))
            if mod_idx and expr.id in mod_idx:
                return mod_idx[expr.id]
            # nested def in the same function body: by bare name
            for k in self.model.by_name.get(expr.id, ()):
                if k.startswith(self.mod.path + "::"):
                    return k
        return None

    def _note_escapes(self, call: ast.Call, targets: tuple) -> None:
        model = self.model
        deferred = False
        fnode = call.func
        if isinstance(fnode, ast.Attribute) and \
                fnode.attr in _DEFER_ATTRS:
            deferred = True
        dotted = self.mod.resolve(fnode) or ""
        if dotted.split(".")[-1] == "Thread":
            deferred = True
        listenerish_call = isinstance(fnode, ast.Attribute) and any(
            s in fnode.attr.lower()
            for s in ("listener", "callback", "subscribe", "register",
                      "hook"))
        for kw in call.keywords:
            k = self._func_value_key(kw.value)
            if k is None:
                continue
            if kw.arg == "target" or deferred:
                model.thread_roots.add(k)
            elif kw.arg and (kw.arg.startswith("on_")
                             or any(s in kw.arg.lower()
                                    for s in _LISTENERISH)):
                model.escaped_by_slot.setdefault(
                    _slot(kw.arg), set()).add(k)
        for arg in call.args:
            k = self._func_value_key(arg)
            if k is None:
                continue
            if deferred:
                model.thread_roots.add(k)
            elif listenerish_call:
                model.escaped_by_slot.setdefault(
                    _slot(fnode.attr), set()).add(k)

    # -- the walk ------------------------------------------------------

    def run(self) -> None:
        node = self.fi.node
        self._stmts(list(node.body))

    def _stmts(self, body: list) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later; its body is scanned as part of
            # indexing only if module-level. Record as escape source.
            for inner in ast.walk(stmt):
                if isinstance(inner, ast.Call):
                    self._exprs(inner)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                got = self._with_item(item.context_expr)
                pushed += got
            self._stmts(stmt.body)
            for _ in range(pushed):
                self.held.pop()
            return
        if isinstance(stmt, ast.Assign):
            self._track_assign(stmt)
        if isinstance(stmt, ast.For):
            self._track_for(stmt)
            self._loop_family_self_edge(stmt)
            self._exprs(stmt.iter)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for h in stmt.handlers:
                self._stmts(h.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._exprs(stmt.test)
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
            return
        if isinstance(stmt, ast.Return):
            self.fi.returns.append(stmt)
            if stmt.value is not None:
                self._exprs(stmt.value)
            return
        self._exprs(stmt)

    def _with_item(self, expr: ast.AST) -> int:
        """Push held locks for one with-item; return push count."""
        got = self._lock_of_expr(expr)
        if got is not None:
            self._record_acq(got[0], expr.lineno, ordered=got[1])
            self.held.append(got)
            return 1
        if isinstance(expr, ast.Call):
            cm = self._cm_held(expr)
            self._exprs(expr)
            if cm:
                n = 0
                for ln in cm:
                    ld = self.model.locks.get(ln)
                    self._record_acq(ln, expr.lineno,
                                     ordered=bool(ld and ld.family))
                    self.held.append((ln, False))
                    n += 1
                return n
            return 0
        self._exprs(expr)
        return 0

    def _track_assign(self, stmt: ast.Assign) -> None:
        value = stmt.value
        for t in stmt.targets:
            if not isinstance(t, ast.Name):
                # self.x = <callable>: listener-style data attr — the
                # callable is dispatched at `self.x(...)` sites only
                attr = _self_attr(t)
                if attr is not None:
                    k = self._func_value_key(value)
                    if k is not None:
                        self.model.escaped_by_slot.setdefault(
                            _slot(attr), set()).add(k)
                continue
            var = t.id
            got = self._lock_of_expr(value)
            if got is not None:
                self.local_locks[var] = got
                continue
            if isinstance(value, ast.Call):
                dotted = self.mod.resolve(value.func)
                if dotted:
                    short = dotted.split(".")[-1]
                    if short in self.model.classes:
                        self.local_types[var] = short
                    elif short in ("sorted",):
                        self.sorted_vars.add(var)
            elif isinstance(value, ast.Name):
                if value.id in self.local_types:
                    self.local_types[var] = self.local_types[value.id]
                elif value.id in RECEIVER_HINTS:
                    self.local_types[var] = RECEIVER_HINTS[value.id]
            else:
                attr = _self_attr(value)
                if attr is not None and self.ci is not None:
                    ty = self.ci.attr_types.get(attr) \
                        or RECEIVER_HINTS.get(attr)
                    if ty:
                        self.local_types[var] = ty

    def _track_for(self, stmt: ast.For) -> None:
        """for lk in self._shard_locks: / for fn in self._listeners:"""
        if isinstance(stmt.target, ast.Tuple) and \
                len(stmt.target.elts) == 2 and \
                isinstance(stmt.target.elts[1], ast.Name) and \
                isinstance(stmt.iter, ast.Call) and \
                isinstance(stmt.iter.func, ast.Attribute) and \
                stmt.iter.func.attr == "items":
            # for h, b in self._breakers.items(): value elem type
            base = _self_attr(stmt.iter.func.value)
            if base is not None and self.ci is not None:
                ety = self.ci.attr_types.get(base + "[]")
                if ety:
                    self.local_types[stmt.target.elts[1].id] = ety
            return
        if not isinstance(stmt.target, ast.Name):
            return
        var = stmt.target.id
        it = stmt.iter
        if isinstance(it, ast.Call) and \
                isinstance(it.func, ast.Attribute) and \
                it.func.attr == "values":
            base = _self_attr(it.func.value)
            if base is not None and self.ci is not None:
                ety = self.ci.attr_types.get(base + "[]")
                if ety:
                    self.local_types[var] = ety
                    return
        # unwrap list(...) / reversed(...) / sorted(...)
        ordered = False
        rev = False
        while isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id in ("list", "reversed", "sorted"):
            if it.func.id == "sorted":
                ordered = True
            elif it.func.id == "reversed":
                rev = not rev
            it = it.args[0] if it.args else it
            if it is stmt.iter:
                break
        attr = _self_attr(it)
        if attr is not None and self.ci is not None:
            ln = self.ci.locks.get(attr)
            if ln and ln.endswith("[*]"):
                # iterating the family list in index order (a reversed
                # walk is NOT the blessed ascending order)
                self.local_locks[var] = (ln, not rev)
                return
            if any(s in attr.lower() for s in _LISTENERISH):
                self.local_locks.pop(var, None)
                # calls through this var dispatch to the callables
                # registered through the matching slot
                self.local_types[var] = _escaped_target(_slot(attr))
                return
        if isinstance(it, ast.Name) and (it.id in self.sorted_vars
                                         or ordered):
            # e.g. `for i in idxs:` where idxs = sorted(...): subscript
            # acquisitions in the body are ordered — handled at the
            # subscript site, which is already family-ordered
            pass

    def _loop_family_self_edge(self, stmt: ast.For) -> None:
        """A loop acquiring one lock-family member per iteration holds
        the earlier members while taking the later ones — record the
        family self-edge (ordered for the blessed ascending walk,
        which is what `for lk in self._shard_locks: lk.acquire()` and
        `for i in sorted(idxs): self._shard_locks[i].acquire()` are)."""
        for sub in ast.walk(stmt):
            exprs = []
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                exprs = [item.context_expr for item in sub.items]
            elif isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "acquire":
                exprs = [sub.func.value]
            for expr in exprs:
                got = self._lock_of_expr(expr)
                if got is not None and got[0].endswith("[*]"):
                    self.fi.acquires.append(
                        Acq(lock=got[0], line=sub.lineno,
                            held=(got[0],), ordered=got[1]))

    def _record_acq(self, lock: str, line: int, ordered: bool) -> None:
        held = tuple(dict.fromkeys(h for h, _ in self.held))
        self.fi.acquires.append(Acq(lock=lock, line=line, held=held,
                                    ordered=ordered))

    def _bind_comp_targets(self, node: ast.AST) -> None:
        """{h: b.snapshot() for h, b in self._breakers.items()} — type
        comprehension loop vars from keyed-collection element types."""
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.ListComp, ast.SetComp,
                                    ast.DictComp, ast.GeneratorExp)):
                continue
            for gen in sub.generators:
                it, tgt = gen.iter, gen.target
                if not (isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Attribute)):
                    continue
                base = _self_attr(it.func.value)
                if base is None or self.ci is None:
                    continue
                ety = self.ci.attr_types.get(base + "[]")
                if not ety:
                    continue
                if it.func.attr == "values" and isinstance(tgt, ast.Name):
                    self.local_types[tgt.id] = ety
                elif it.func.attr == "items" \
                        and isinstance(tgt, ast.Tuple) \
                        and len(tgt.elts) == 2 \
                        and isinstance(tgt.elts[1], ast.Name):
                    self.local_types[tgt.elts[1].id] = ety

    def _exprs(self, node: ast.AST) -> None:
        self._bind_comp_targets(node)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            # explicit acquire()/release()
            if isinstance(fn, ast.Attribute) and fn.attr in ("acquire",
                                                             "release"):
                got = self._lock_of_expr(fn.value)
                if got is not None:
                    if fn.attr == "acquire":
                        self._record_acq(got[0], sub.lineno,
                                         ordered=got[1])
                        self.held.append(got)
                    else:
                        for i in range(len(self.held) - 1, -1, -1):
                            if self.held[i][0] == got[0]:
                                del self.held[i]
                                break
                    continue
            # indirect call through a listener loop var
            if isinstance(fn, ast.Name) \
                    and _is_escaped(self.local_types.get(fn.id, "")):
                self._add_call((self.local_types[fn.id],),
                               sub.lineno, fn.id)
                continue
            targets = self._resolve_call(sub)
            self._note_escapes(sub, targets)
            if isinstance(fn, ast.Attribute) and fn.attr in _DEFER_ATTRS:
                continue   # deferred: no held propagation
            dotted = self.mod.resolve(fn) or ""
            if dotted.split(".")[-1] == "Thread":
                continue
            if targets:
                label = fn.attr if isinstance(fn, ast.Attribute) \
                    else (fn.id if isinstance(fn, ast.Name) else "?")
                self._add_call(targets, sub.lineno, label)

    def _add_call(self, targets: tuple, line: int, label: str) -> None:
        held = tuple(dict.fromkeys(h for h, _ in self.held))
        self.fi.calls.append(CallSite(targets=targets, held=held,
                                      line=line, label=label))


def _prescan_contextmanagers(model: PackageModel,
                             mod: ModuleInfo) -> None:
    for key, fi in list(model.functions.items()):
        if fi.path != mod.path or not fi.is_contextmanager:
            continue
        ci = model.classes.get(fi.cls) if fi.cls else None
        scan = _BodyScan(model, mod, fi, ci)
        fi.yields_held = _held_at_yield(scan, fi)


def _scan_module(model: PackageModel, mod: ModuleInfo) -> None:
    for key, fi in list(model.functions.items()):
        if fi.path != mod.path:
            continue
        ci = model.classes.get(fi.cls) if fi.cls else None
        scan = _BodyScan(model, mod, fi, ci)
        scan.run()


def _held_at_yield(scan: _BodyScan, fi: FuncInfo) -> tuple:
    """Re-walk the contextmanager to the first yield, tracking held.

    The main walk already consumed acquire/release into `fi.acquires`;
    for yield-held we need position-sensitivity, so replay statements
    until the first Yield and report what is held there."""
    held: list[str] = []

    class _Stop(Exception):
        pass

    def lock_of(expr):
        got = scan._lock_of_expr(expr)
        return got[0] if got else None

    def walk(body):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # bind loop vars first so `for lk in self._shard_locks:
            # lk.acquire()` counts the family as held at the yield
            for f in ast.walk(stmt):
                if isinstance(f, ast.For):
                    scan._track_for(f)
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.Yield, ast.YieldFrom)):
                    raise _Stop
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute):
                    ln = lock_of(sub.func.value)
                    if ln is None:
                        continue
                    if sub.func.attr == "acquire" and ln not in held:
                        held.append(ln)
                    elif sub.func.attr == "release" and ln in held:
                        held.remove(ln)
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                pushed = []
                for item in stmt.items:
                    ln = lock_of(item.context_expr)
                    if ln is not None and ln not in held:
                        held.append(ln)
                        pushed.append(ln)
                walk(stmt.body)
                for ln in pushed:
                    held.remove(ln)

    try:
        walk(list(fi.node.body))
    except _Stop:
        pass
    return tuple(held)


# ----------------------------------------------------------------------
# closures + edges

def _compute_closures(model: PackageModel) -> None:
    """A(F) = F's direct acquisitions ∪ A(callees), to fixpoint."""
    acq: dict[str, set] = {}
    for key, fi in model.functions.items():
        acq[key] = {(a.lock, a.ordered) for a in fi.acquires}
    changed = True
    while changed:
        changed = False
        for key, fi in model.functions.items():
            cur = acq[key]
            before = len(cur)
            for cs in fi.calls:
                for t in cs.targets:
                    for c in model.dispatch(t):
                        cur |= acq.get(c, set())
            if len(cur) != before:
                changed = True
    model._acq_closure = {k: frozenset(v) for k, v in acq.items()}


def _compute_edges(model: PackageModel) -> None:
    def add(src, dst, path, line, func, via, ordered):
        k = (src, dst)
        prev = model._edge_index.get(k)
        if prev is not None:
            # an unordered acquisition outranks a blessed ordered one:
            # R11 and the witness diff must see the worst case
            if prev.ordered and not ordered:
                model.edges.remove(prev)
            else:
                return
        e = Edge(src=src, dst=dst, path=path, line=line, func=func,
                 via=via, ordered=ordered)
        model._edge_index[k] = e
        model.edges.append(e)

    for key, fi in model.functions.items():
        sym = key.split("::", 1)[1]
        for a in fi.acquires:
            for h in a.held:
                if h == a.lock and a.ordered:
                    add(h, a.lock, fi.path, a.line, sym, "",
                        ordered=True)
                else:
                    add(h, a.lock, fi.path, a.line, sym, "",
                        ordered=False)
        for cs in fi.calls:
            if not cs.held:
                continue
            targets = []
            for t in cs.targets:
                targets.extend(model.dispatch(t))
            for t in targets:
                closure = model.acq_closure(t)
                if not closure:
                    continue
                tsym = t.split("::", 1)[1] if "::" in t else t
                for (lock, ordered) in closure:
                    for h in cs.held:
                        if h == lock and ordered:
                            add(h, lock, fi.path, cs.line, sym,
                                f"via {tsym}", ordered=True)
                        else:
                            add(h, lock, fi.path, cs.line, sym,
                                f"via {tsym}", ordered=False)


# ----------------------------------------------------------------------
# serialization (debugging + the witness diff)

def graph_json(model: PackageModel) -> dict:
    return {
        "locks": [
            {"name": l.name, "reentrant": l.reentrant,
             "witnessed": l.witnessed, "family": l.family,
             "site": f"{l.path}:{l.line}"}
            for l in sorted(model.locks.values(), key=lambda x: x.name)],
        "edges": [
            {"from": e.src, "to": e.dst, "ordered": e.ordered,
             "site": f"{e.path}:{e.line}", "func": e.func, "via": e.via}
            for e in sorted(model.edges, key=lambda x: (x.src, x.dst))],
    }
