"""R12: durability-ack dominance ("201-after-fsync" as a checked
invariant).

Every REST handler path that acks a state-mutating request with a 2xx
must be dominated by a reachable durability barrier — the group-commit
``writer.sync`` tier (``JobStore._barrier`` / ``_GroupCommitBarrier.
sync``) or the ingest batcher's blocking ``submit_and_wait`` (whose 201
is resolved only after its batch's barrier). The same dominance check
runs over the store's own public transaction functions (the launch-txn
tier): a public ``JobStore`` method that appends to the event log must
reach its ``_barrier()`` before returning.

Mechanics, all on the interprocedural model:

* a handler is **state-mutating** iff its call closure reaches a log
  append chokepoint (``_append_raw`` / ``_append_raw_many`` /
  ``_append_segments``). Routes that mutate only in-memory state (the
  share/quota tables — a documented divergence from the reference's
  Datomic-backed limits) are therefore out of scope by construction,
  not by exemption list.
* a call is **barrier-reaching** iff its resolved closure contains a
  barrier seed (``JobStore._barrier``, ``_GroupCommitBarrier.sync``,
  ``IngestBatcher.submit_and_wait``, a writer ``sync``).
* **dominance** is statement-level: the barrier call dominates a
  ``return`` when it appears in the return's own expression, or in an
  earlier sibling statement on the return's ancestor chain that always
  executes (a plain statement; an ``if`` only when both branches
  barrier; ``try`` when the barrier is in the body or ``finally`` —
  loops never dominate, their bodies may run zero times).

The rule deliberately checks *acks*, not writes: an error return (4xx/
5xx/non-literal status) needs no barrier, and a 2xx on a read-only
route is ignored because the handler reaches no append."""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from cook_tpu_torch.analysis.core import Finding
from cook_tpu_torch.analysis.interproc import PackageModel

# log-append chokepoints: reaching one of these makes a path mutating
_APPEND_NAMES = frozenset(("_append_raw", "_append_raw_many",
                           "_append_segments"))
# durability barrier seeds: reaching one of these makes a call an ack
# barrier. (class, name) with None = any class.
_BARRIER_SEEDS = (
    ("JobStore", "_barrier"),
    ("_GroupCommitBarrier", "sync"),
    ("IngestBatcher", "submit_and_wait"),
    ("_PyLogWriter", "sync"),
)


def _seed_keys(model: PackageModel,
               pairs: Iterable[tuple]) -> set:
    out = set()
    for cls, name in pairs:
        for key in model.by_name.get(name, ()):
            fi = model.functions[key]
            if cls is None or fi.cls == cls:
                out.add(key)
    return out


def _append_keys(model: PackageModel) -> set:
    return {k for name in _APPEND_NAMES
            for k in model.by_name.get(name, ())}


def _reaching_set(model: PackageModel, targets: set) -> set:
    """All function keys whose call closure intersects `targets`
    (reverse reachability over DIRECT call edges — listener dispatch is
    asynchronous from the handler's point of view and cannot carry its
    durability obligation)."""
    rev: dict[str, set] = {}
    for key, fi in model.functions.items():
        for cs in fi.calls:
            for t in cs.targets:
                if t.startswith("<escaped"):
                    continue
                rev.setdefault(t, set()).add(key)
    out = set(targets)
    work = list(targets)
    while work:
        k = work.pop()
        for caller in rev.get(k, ()):
            if caller not in out:
                out.add(caller)
                work.append(caller)
    return out


def check(model: PackageModel) -> list[Finding]:
    appends = _append_keys(model)
    if not appends:
        return []
    barriers = _seed_keys(model, _BARRIER_SEEDS)
    mutating = _reaching_set(model, appends)
    barrier_reaching = _reaching_set(model, barriers)

    findings: list[Finding] = []
    findings += _check_rest_handlers(model, mutating, barrier_reaching)
    findings += _check_store_txns(model, barriers, barrier_reaching)
    return findings


# ----------------------------------------------------------------------
# REST handlers

def _router_handlers(model: PackageModel) -> list:
    """(method, pattern, handler func key) rows parsed out of the
    router-construction method(s) (`r.add("POST", "/jobs", self.h)`)."""
    rows = []
    for key, fi in model.functions.items():
        if fi.name != "_build_router" or fi.node is None:
            continue
        cls = model.classes.get(fi.cls) if fi.cls else None
        if cls is None:
            continue
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add"
                    and len(node.args) >= 3):
                continue
            m, pat, h = node.args[:3]
            if not (isinstance(m, ast.Constant)
                    and isinstance(pat, ast.Constant)):
                continue
            if isinstance(h, ast.Attribute) \
                    and isinstance(h.value, ast.Name) \
                    and h.value.id == "self" \
                    and h.attr in cls.methods:
                rows.append((m.value, pat.value, cls.methods[h.attr]))
    return rows


def _check_rest_handlers(model: PackageModel, mutating: set,
                         barrier_reaching: set) -> list:
    findings: list[Finding] = []
    checked: set = set()
    for method, pattern, hkey in _router_handlers(model):
        if method == "GET" or hkey not in mutating:
            continue
        # the handler plus every mutating helper it delegates 2xx
        # production to in the same module (create_jobs ->
        # _create_jobs_impl) — direct call edges only
        for key in _direct_reachable(model, hkey):
            fi = model.functions.get(key)
            if fi is None or fi.path != model.functions[hkey].path:
                continue
            if key in checked or key not in mutating:
                continue
            checked.add(key)
            if _all_mutations_self_barrier(model, key, mutating,
                                           barrier_reaching):
                # every call that can append is itself barrier-reaching
                # (store txns barrier internally, checked by the
                # launch-txn tier below): no un-fsynced bytes can exist
                # at any return, loop or not
                continue
            findings += _check_returns(
                model, key, barrier_reaching,
                is_ack=_returns_2xx_response,
                what=f"{method} {pattern}")
    return findings


def _all_mutations_self_barrier(model: PackageModel, key: str,
                                mutating: set,
                                barrier_reaching: set) -> bool:
    fi = model.functions[key]
    saw_mutation = False
    for cs in fi.calls:
        for t in cs.targets:
            if t.startswith("<escaped") or t not in mutating:
                continue
            saw_mutation = True
            if t not in barrier_reaching:
                return False
    return saw_mutation


def _direct_reachable(model: PackageModel, start: str) -> set:
    seen: set = set()
    work = [start]
    while work:
        k = work.pop()
        if k in seen:
            continue
        seen.add(k)
        fi = model.functions.get(k)
        if fi is None:
            continue
        for cs in fi.calls:
            for t in cs.targets:
                if not t.startswith("<escaped") and t not in seen:
                    work.append(t)
    return seen


def _returns_2xx_response(ret: ast.Return) -> Optional[int]:
    """Status code when the return is a literal 2xx Response(...)"""
    v = ret.value
    if not (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
            and v.func.id == "Response" and v.args):
        return None
    status = v.args[0]
    if isinstance(status, ast.Constant) and isinstance(status.value, int) \
            and 200 <= status.value < 300:
        return status.value
    return None


# ----------------------------------------------------------------------
# store transaction functions (the launch-txn tier)

def _check_store_txns(model: PackageModel, barriers: set,
                      barrier_reaching: set) -> list:
    findings: list[Finding] = []
    appends = _append_keys(model)
    for key, fi in model.functions.items():
        if fi.cls != "JobStore" or fi.name.startswith("_"):
            continue
        # direct appenders only: public txn functions that put bytes in
        # the log themselves must barrier before returning; helpers
        # and read paths are out of scope
        direct = any(t in appends or t in barriers
                     for cs in fi.calls for t in cs.targets)
        if not direct:
            continue
        append_lines = [cs.line for cs in fi.calls
                        if any(t in appends for t in cs.targets)]
        if not append_lines:
            continue
        first_append = min(append_lines)

        def ack_after_append(ret: ast.Return,
                             _first=first_append) -> Optional[int]:
            # a return before any append needs no barrier (validation
            # bail-outs); anything after an append is an ack
            return 200 if ret.lineno >= _first else None

        findings += _check_returns(model, key, barrier_reaching,
                                   is_ack=ack_after_append,
                                   what="store txn")
    return findings


# ----------------------------------------------------------------------
# dominance

def _check_returns(model: PackageModel, key: str, barrier_reaching: set,
                   is_ack, what: str) -> list:
    fi = model.functions[key]
    if fi.node is None:
        return []
    # lines containing a barrier-reaching call, from the already-
    # resolved callsites
    barrier_lines = {cs.line for cs in fi.calls
                     if any(t in barrier_reaching for t in cs.targets)}
    parents: dict = {}
    for parent in ast.walk(fi.node):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    out = []
    # implicit fall-off-the-end return of a contextless function is
    # not an ack; only explicit returns are checked
    for ret in fi.returns:
        status = is_ack(ret)
        if status is None:
            continue
        if _dominated(ret, parents, barrier_lines, fi.node):
            continue
        sym = key.split("::", 1)[1]
        out.append(Finding(
            "R12", fi.path, ret.lineno, sym,
            f"{what}: 2xx ack returned without a dominating durability "
            "barrier (writer.sync / group-commit / submit_and_wait) — "
            "a crash after this return loses an acked write"))
    return out


def _span(node: ast.AST) -> tuple:
    return (node.lineno, getattr(node, "end_lineno", node.lineno))


def _contains_barrier(node: ast.AST, barrier_lines: set) -> bool:
    lo, hi = _span(node)
    return any(lo <= ln <= hi for ln in barrier_lines)


def _stmt_dominates(stmt: ast.AST, barrier_lines: set) -> bool:
    """Does this earlier sibling statement ALWAYS execute a barrier
    call before falling through?"""
    if not _contains_barrier(stmt, barrier_lines):
        return False
    if isinstance(stmt, ast.If):
        # both branches must barrier (an else-less if never dominates)
        return (bool(stmt.orelse)
                and all(any(_stmt_dominates(s, barrier_lines)
                            or _contains_barrier(s, barrier_lines)
                            for s in branch)
                        for branch in (stmt.body, stmt.orelse)))
    if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
        return False          # zero-iteration loops don't dominate
    if isinstance(stmt, ast.Try):
        return any(_contains_barrier(s, barrier_lines)
                   for s in list(stmt.body) + list(stmt.finalbody))
    return True


def _dominated(ret: ast.Return, parents: dict, barrier_lines: set,
               root: ast.AST) -> bool:
    if not barrier_lines:
        return False
    # the return's own expression
    if ret.value is not None and _contains_barrier(ret.value,
                                                   barrier_lines):
        return True
    # earlier siblings on the ancestor chain
    node: ast.AST = ret
    while node is not root:
        parent = parents.get(node)
        if parent is None:
            break
        for field in ("body", "orelse", "finalbody"):
            seq = getattr(parent, field, None)
            if not isinstance(seq, list) or node not in seq:
                continue
            for sib in seq[:seq.index(node)]:
                if _stmt_dominates(sib, barrier_lines):
                    return True
        node = parent
    return False
