"""R9: shard-lock discipline for the pool-sharded store.

The sharded store (state/store.py) replaces the single store mutex
with per-pool shard locks plus a thin global section, held together by
ONE fixed acquisition order: shard locks in ascending index order,
then ``self._lock``. Three blessed contextmanagers own that order —
``_pool_section`` (one shard), ``_pools_section`` (several shards,
sorted), ``_global_section`` (all shards, then the global lock). Any
other acquisition shape can deadlock against them.

R9 pins the discipline at the AST level, scoped to ``state/store.py``:

  - a shard section (``self._pool_section(...)`` /
    ``self._pools_section(...)``) entered inside a ``with self._lock``
    or ``with self._global_section()`` block inverts the pinned
    shard→global order;
  - a shard section nested inside another shard section acquires two
    shard locks outside the sorted-ascending helper —
    ``_pools_section`` is the only blessed multi-shard shape;
  - ``self._shard_locks`` touched anywhere outside the three blessed
    helpers (plus ``__init__``, which creates the list) bypasses the
    order entirely.

Like R8, the rule is receiver-name based and deliberately syntactic:
it cannot see a lock smuggled through an alias, but every such alias
would itself be a finding under the direct-access check at the point
it reads ``self._shard_locks``.
"""
from __future__ import annotations

import ast

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

# the only functions allowed to touch self._shard_locks — the three
# ordered section helpers, plus the constructor that builds the list
_BLESSED = frozenset(("_pool_section", "_pools_section",
                      "_global_section", "__init__"))

_SHARD_SECTIONS = frozenset(("_pool_section", "_pools_section"))
_GLOBAL_SECTIONS = frozenset(("_global_section",))

_MSG_ORDER = ("shard section entered while the global section is held "
              "— the pinned order is shard→global; acquire the shard "
              "section first or use _global_section")
_MSG_NESTED = ("nested shard sections acquire two shard locks outside "
               "the sorted-ascending helper — use _pools_section for "
               "multi-pool batches")
_MSG_DIRECT = ("direct self._shard_locks access outside "
               "_pool_section/_pools_section/_global_section bypasses "
               "the fixed acquisition order")


def _enclosing_function(parents: dict, node: ast.AST):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def _symbol(parents: dict, node: ast.AST) -> str:
    names = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names))


def _item_kind(expr: ast.AST) -> str:
    """Classify one with-item context expr: 'shard', 'global' or ''."""
    if isinstance(expr, ast.Attribute) and expr.attr == "_lock" \
            and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return "global"
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute):
        if expr.func.attr in _SHARD_SECTIONS:
            return "shard"
        if expr.func.attr in _GLOBAL_SECTIONS:
            return "global"
    return ""


def check(mod: ModuleInfo) -> list[Finding]:
    norm = mod.path.replace("\\", "/")
    if not norm.endswith("state/store.py"):
        return []
    findings: list[Finding] = []
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    for node in ast.walk(mod.tree):
        # direct self._shard_locks touch outside the blessed helpers
        if isinstance(node, ast.Attribute) \
                and node.attr == "_shard_locks" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            fn = _enclosing_function(parents, node)
            if fn is None or fn.name not in _BLESSED:
                findings.append(Finding("R9", mod.path, node.lineno,
                                        _symbol(parents, node),
                                        _MSG_DIRECT))
            continue

        if not isinstance(node, ast.With):
            continue
        kinds = [_item_kind(it.context_expr) for it in node.items]
        fn = _enclosing_function(parents, node)
        if fn is not None and fn.name in _BLESSED:
            continue   # the helpers themselves own the order

        # held kinds from ancestor With statements in the SAME function
        held: list[str] = []
        cur = parents.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.With):
                held.extend(_item_kind(it.context_expr)
                            for it in cur.items)
            cur = parents.get(cur)

        for pos, kind in enumerate(kinds):
            if kind != "shard":
                continue
            earlier = held + kinds[:pos]
            if "global" in earlier:
                findings.append(Finding("R9", mod.path, node.lineno,
                                        _symbol(parents, node),
                                        _MSG_ORDER))
            if "shard" in earlier:
                findings.append(Finding("R9", mod.path, node.lineno,
                                        _symbol(parents, node),
                                        _MSG_NESTED))
    return findings
