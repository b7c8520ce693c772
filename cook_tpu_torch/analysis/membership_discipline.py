"""R14: membership-table discipline for the live-reconfigurable fleet.

Live reconfiguration (docs/robustness.md) is safe only because the
federation's routing state — ``FederationHost.groups`` and the
``_pool_owner`` map — changes through exactly three blessed sites in
``scheduler/federation.py``:

  - ``__init__``          (boot-time construction from config),
  - ``reassign``          (the single-pool runtime migration flip,
                           under ``_owner_lock``),
  - ``_swap_membership``  (the atomic whole-view swap a committed
                           membership epoch applies).

Each of those holds ``_owner_lock`` (or runs before the host is
shared) and keeps the two tables mutually consistent; a mutation
anywhere else can tear routing from ownership mid-read, or apply a
view change that was never journaled to the membership ledger —
exactly the wedge the ledger's begin/commit protocol exists to
prevent.

R14 pins that funnel at the AST level, receiver-name based like R8:

  - in ``scheduler/federation.py``: any store into ``<recv>.groups``
    or ``<recv>._pool_owner`` (plain/aug/ann assignment, subscript
    store, ``del``, or a mutating method call such as ``.update`` /
    ``.pop`` / ``.clear``) outside the blessed functions;
  - in every other ``scheduler/`` or ``rest/`` module: ANY mutation
    of a ``._pool_owner`` attribute — other modules may read the
    routing view through ``_owner_of``/``owns``, never write it.

``groups`` is too common a name to chase outside federation.py;
``_pool_owner`` is unique to the federation host, so a write to it
from another module is a bypass by construction.
"""
from __future__ import annotations

import ast

from cook_tpu_torch.analysis.core import Finding, ModuleInfo
from cook_tpu_torch.analysis.epoch_discipline import (_enclosing_function,
                                                _symbol)

# the only functions allowed to store into groups/_pool_owner — all
# swap both tables consistently under _owner_lock (or pre-sharing)
_BLESSED = frozenset(("__init__", "reassign", "_swap_membership"))

# in-place mutators on the dict objects themselves
_MUTATORS = frozenset(("update", "pop", "clear", "setdefault",
                       "popitem", "__setitem__"))

_MSG = ("membership-table mutation outside the blessed swap — "
        "route through reassign()/_swap_membership() (they hold "
        "_owner_lock and keep groups/_pool_owner consistent with "
        "the journaled membership epoch)")


def _table_attr(node: ast.AST, names: frozenset) -> bool:
    """True when ``node`` is ``<recv>.<name>`` for a watched name."""
    return isinstance(node, ast.Attribute) and node.attr in names


def _stored_tables(target: ast.AST, names: frozenset) -> list[ast.AST]:
    """Watched-table attribute nodes a statement target stores into:
    ``x.groups = ...`` rebinds the table, ``x._pool_owner[p] = ...``
    mutates it in place — both are membership writes."""
    hits: list[ast.AST] = []
    stack = [target]
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, (ast.Subscript, ast.Starred)):
            stack.append(t.value)
        elif _table_attr(t, names):
            hits.append(t)
    return hits


def check(mod: ModuleInfo) -> list[Finding]:
    norm = mod.path.replace("\\", "/")
    in_fed = norm.endswith("scheduler/federation.py")
    if in_fed:
        names = frozenset(("groups", "_pool_owner"))
        allowed = _BLESSED
    else:
        names = frozenset(("_pool_owner",))
        allowed: frozenset = frozenset()

    findings: list[Finding] = []
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    def flag(node: ast.AST) -> None:
        if _enclosing_function(parents, node) in allowed:
            return
        findings.append(Finding("R14", mod.path, node.lineno,
                                _symbol(parents, node), _MSG))

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for hit in _stored_tables(t, names):
                    flag(hit)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                for hit in _stored_tables(t, names):
                    flag(hit)
        elif isinstance(node, ast.Call):
            func = node.func
            # <recv>._pool_owner.update(...) and friends
            if (isinstance(func, ast.Attribute)
                    and func.attr in _MUTATORS
                    and _table_attr(func.value, names)):
                flag(node)
    return findings
