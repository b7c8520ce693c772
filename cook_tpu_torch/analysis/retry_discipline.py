"""R6: retry discipline — no hand-rolled backoff loops.

`cook_tpu_torch.utils.retry.RetryPolicy` is the one retry loop in the port:
exponential backoff with full jitter, permanent-4xx classification
(via `HttpJsonError`), and an overall deadline. A hand-rolled loop
almost always misses at least one of those (the three it replaced in
`agent/daemon.py` each missed a different one: no jitter — a fleet
re-registers in lockstep; no 4xx cutoff — a malformed request is
retried forever; no deadline).

Flagged shape: a ``for``/``while`` loop that simultaneously

1. calls ``time.sleep(...)`` (``Event.wait``-paced loops are exempt:
   they are shutdown-aware by construction),
2. multiplies a backoff variable (``delay *= 2``, or
   ``delay = min(delay * 2, cap)`` — any assignment whose value
   multiplies the assigned name), and
3. has a broad handler (``except:``, ``except Exception``,
   ``except BaseException``, alone or in a tuple).

`cook_tpu_torch/utils/retry.py` itself is exempt by path — it is the
implementation the rule points at. Intentional loops elsewhere take a
``# cookcheck: disable=R6`` on the loop line.
"""
from __future__ import annotations

import ast

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

_MSG = ("hand-rolled retry loop (sleep + multiplicative backoff + "
        "broad except): use utils.retry.RetryPolicy")

_EXEMPT_SUFFIX = "utils/retry.py"


def _enclosing_symbol(parents: dict, node: ast.AST) -> str:
    names = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names))


def _calls_time_sleep(loop: ast.AST, mod: ModuleInfo) -> bool:
    for node in ast.walk(loop):
        if isinstance(node, ast.Call) \
                and mod.resolve(node.func) == "time.sleep":
            return True
    return False


def _multiplies(expr: ast.AST, name: str) -> bool:
    """Does `expr` contain a multiplication with `name` as a factor
    (covers the ``min(name * 2, cap)`` capped form)?"""
    for n in ast.walk(expr):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult):
            for side in (n.left, n.right):
                if isinstance(side, ast.Name) and side.id == name:
                    return True
    return False


def _has_mult_backoff(loop: ast.AST) -> bool:
    for node in ast.walk(loop):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.op, ast.Mult):
            return True
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _multiplies(node.value, node.targets[0].id):
            return True
    return False


def _broad_name(node: ast.AST, mod: ModuleInfo) -> bool:
    return (mod.resolve(node) or "") in ("Exception", "BaseException",
                                         "builtins.Exception",
                                         "builtins.BaseException")


def _has_broad_handler(loop: ast.AST, mod: ModuleInfo) -> bool:
    for node in ast.walk(loop):
        if not isinstance(node, ast.ExceptHandler):
            continue
        t = node.type
        if t is None:
            return True
        if isinstance(t, ast.Tuple):
            if any(_broad_name(el, mod) for el in t.elts):
                return True
        elif _broad_name(t, mod):
            return True
    return False


def check(mod: ModuleInfo) -> list[Finding]:
    if mod.path.replace("\\", "/").endswith(_EXEMPT_SUFFIX):
        return []
    findings: list[Finding] = []
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        if not (_calls_time_sleep(node, mod)
                and _has_mult_backoff(node)
                and _has_broad_handler(node, mod)):
            continue
        findings.append(Finding("R6", mod.path, node.lineno,
                                _enclosing_symbol(parents, node), _MSG))
    return findings
