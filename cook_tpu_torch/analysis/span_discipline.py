"""R5: span discipline for the obs tracer.

Every ``<anything>.start_span(...)`` call must hand its span to one of
the shapes that guarantees ``finish()`` runs:

1. a context manager — ``with tracer.start_span(...) as sp:`` (the
   ``Span.__exit__`` finishes it, exceptions included);
2. an assignment to a name that has a *reachable* ``<name>.finish()``
   call in the same function scope;
3. an assignment whose name is returned from the function (ownership
   moves to the caller — the factory pattern).

Anything else — a bare expression statement, a span passed straight
into another call, an assignment that is never finished — leaks an
open span: it will never reach the flight recorder or the per-trace
index, and the trace tree silently loses a node.  ``record(...)``
(already-timed spans) is exempt by construction: it has no open state.
"""
from __future__ import annotations

import ast
from typing import Optional

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

_MSG = ("start_span(...) result must be used as a context manager or "
        "have a reachable .finish()")


def _chain(node: ast.AST) -> Optional[str]:
    """Dotted text of a Name/Attribute chain, no alias resolution
    (``self.sp`` stays ``self.sp``)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _enclosing(parents: dict, node: ast.AST) -> tuple[ast.AST, str]:
    """(function-or-module scope node, dotted Class.method symbol)."""
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
    if scope is None:
        scope = None   # module level
    return scope, ".".join(reversed(names))


def _finished_in(scope: ast.AST, var: str) -> bool:
    """Is there a ``var.finish()`` call, a ``with var:`` use, or a
    ``return var`` anywhere in the scope?  Deliberately flow-free:
    reachability here means "the source contains a finishing use", the
    same bar the other cookcheck rules apply."""
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "finish" \
                and _chain(node.func.value) == var:
            return True
        if isinstance(node, ast.withitem) \
                and _chain(node.context_expr) == var:
            return True
        if isinstance(node, ast.Return) and node.value is not None \
                and _chain(node.value) == var:
            return True
    return False


def check(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "start_span"):
            continue
        p = parents.get(node)
        if isinstance(p, ast.withitem) and p.context_expr is node:
            continue
        scope, symbol = _enclosing(parents, node)
        search_in = scope if scope is not None else mod.tree
        var = None
        if isinstance(p, ast.Assign) and len(p.targets) == 1:
            var = _chain(p.targets[0])
        elif isinstance(p, ast.AnnAssign) and p.value is node:
            var = _chain(p.target)
        if var is not None and _finished_in(search_in, var):
            continue
        findings.append(Finding("R5", mod.path, node.lineno, symbol,
                                _MSG))
    return findings
