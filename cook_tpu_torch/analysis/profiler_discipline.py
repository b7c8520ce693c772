"""R13: profiler discipline for the always-on cycle ledger.

The cycle profiler (obs/profiler.py) only holds its "always-on within
budget" bargain if two disciplines hold:

1. **Hot-path stamps go through the CycleRec.** Inside the coordinator
   cycle functions (``_match_cycle_resident``, ``_consume_cycle``,
   ``match_cycle``) a raw ``t_x = time.perf_counter()`` /
   ``time.monotonic()`` assignment is a phase boundary the profiler
   cannot see — the ledger silently under-reports the cycle and the
   blame shares lie.  Every boundary must be a ``rec.stamp()`` /
   ``rec.phase()`` (or ``rec.now()`` for per-item sub-timings).  Only
   single-name assignments of a *direct* clock call are flagged:
   ``self.skipped[...] = time.monotonic()`` (bookkeeping into a
   structure) and arithmetic like ``time.monotonic() + defer_for()``
   are not phase boundaries.

2. **Listeners fire outside the ledger lock.** In ``obs/`` modules, a
   reference to ``_listeners`` / ``_notify`` inside a ``with
   <...>_lock:`` block means a slow exporter (a blocking JSONL write)
   stalls the cycle thread that is committing a record — the exact
   inversion the profiler's one-lock design exists to prevent.
"""
from __future__ import annotations

import ast

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

# the coordinator cycle bodies whose phase boundaries must be CycleRec
# stamps (scheduler/coordinator.py and scheduler/resident.py)
_HOT_FUNCS = frozenset({"_match_cycle_resident", "_consume_cycle",
                        "match_cycle"})

_CLOCKS = frozenset({"time.perf_counter", "time.monotonic"})

_MSG_STAMP = ("raw clock assignment in a cycle hot path; use "
              "rec.stamp()/rec.phase() (or rec.now() for per-item "
              "sub-timings) so the profiler ledger sees the boundary")
_MSG_NOTIFY = ("listener notification inside a lock block; invoke "
               "listeners outside the lock so a slow exporter cannot "
               "stall the committing thread")


def _parents(tree: ast.Module) -> dict:
    out: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            out[child] = parent
    return out


def _enclosing(parents: dict, node: ast.AST) -> tuple:
    """(innermost enclosing function node, dotted Class.method symbol)
    — same walk the other rules use."""
    names = []
    scope = None
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if scope is None:
                scope = cur
            names.append(cur.name)
        elif isinstance(cur, ast.ClassDef):
            names.append(cur.name)
        cur = parents.get(cur)
    return scope, ".".join(reversed(names))


def _is_lock_with(item: ast.withitem, mod: ModuleInfo) -> bool:
    """True for ``with <chain ending in _lock>:`` (``self._lock``,
    ``profiler._lock``, ``self._remote_lock``...)."""
    expr = item.context_expr
    # unwrap a call like self._lock() — not the repo idiom, but cheap
    if isinstance(expr, ast.Call):
        expr = expr.func
    dotted = mod.resolve(expr)
    return bool(dotted) and dotted.split(".")[-1].endswith("_lock")


def _check_hot_stamps(mod: ModuleInfo, parents: dict) -> list:
    findings = []
    in_scope = mod.path.replace("\\", "/").endswith(
        ("scheduler/coordinator.py", "scheduler/resident.py"))
    if not in_scope:
        return findings
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or fn.name not in _HOT_FUNCS:
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            dotted = mod.resolve(node.value.func)
            if dotted in _CLOCKS:
                _scope, symbol = _enclosing(parents, node)
                findings.append(Finding("R13", mod.path, node.lineno,
                                        symbol, _MSG_STAMP))
    return findings


def _check_notify_outside_lock(mod: ModuleInfo, parents: dict) -> list:
    findings = []
    parts = mod.path.replace("\\", "/").split("/")
    if "obs" not in parts:
        return findings
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.With):
            continue
        if not any(_is_lock_with(item, mod) for item in node.items):
            continue
        for inner in ast.walk(node):
            name = None
            if isinstance(inner, ast.Attribute):
                name = inner.attr
            elif isinstance(inner, ast.Name):
                name = inner.id
            if name in ("_listeners", "_notify"):
                _scope, symbol = _enclosing(parents, inner)
                findings.append(Finding("R13", mod.path, inner.lineno,
                                        symbol, _MSG_NOTIFY))
    return findings


def check(mod: ModuleInfo) -> list:
    parents = _parents(mod.tree)
    return (_check_hot_stamps(mod, parents)
            + _check_notify_outside_lock(mod, parents))
