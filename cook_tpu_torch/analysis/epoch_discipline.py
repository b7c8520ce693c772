"""R8: epoch-fence discipline for the durable event log.

The epoch-fenced failover design (docs/robustness.md) holds only if
every durable append is checked against the epoch ledger: a deposed
leader's write must raise ``StaleEpochError`` BEFORE the bytes reach
the shared log. ``state/store.py`` funnels that guarantee through
exactly three chokepoints — ``_append_raw``, ``_append_raw_many`` and
``_append_segments`` (the zero-copy preencoded path) — which run the
leadership gate and ``_fence_stale_epoch()`` ahead of the writer call.

R8 pins the funnel shape at the AST level: inside ``state/store.py``,
a call to ``<anything>._log.append(...)``, ``.append_many(...)`` or
``.append_segments(...)`` outside those functions is a fence bypass —
a code path that could commit a superseded leader's record.  (A writer aliased into a local first, ``w = self._log``, is
only reachable inside the chokepoints today; the rule is receiver-name
based and deliberately cheap, the same trade R7 makes.)

The same funnel argument covers the fsync'd sidecar ledgers (the
epoch ledger and the membership ledger for live reconfiguration):
their append protocol — record, fsync file, fsync directory, all
inside the global section — lives in exactly two writers,
``_mint_epoch_locked`` and ``_append_membership_locked``. R8 also
flags any other ``os.write`` in the store module: a raw write outside
those functions is a ledger append that skips the durability order
or the section lock.

The rule is scoped to the store module: ``_log`` attributes elsewhere
in the tree are unrelated.
"""
from __future__ import annotations

import ast

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

# the only functions allowed to touch the writer directly — all run
# the append gate + _fence_stale_epoch before the writer call
_CHOKEPOINTS = frozenset(("_append_raw", "_append_raw_many",
                          "_append_segments"))

_APPENDS = frozenset(("append", "append_many", "append_segments"))

# the only functions allowed to os.write a sidecar ledger — both run
# in the global section and fsync file-then-directory before returning
_LEDGER_WRITERS = frozenset(("_mint_epoch_locked",
                             "_append_membership_locked"))

_MSG = ("direct event-log append bypasses the epoch fence — route "
        "through _append_raw/_append_raw_many/_append_segments (they "
        "run the leadership gate and _fence_stale_epoch first)")

_LEDGER_MSG = ("raw os.write in the store bypasses the ledger append "
               "protocol — route through _mint_epoch_locked/"
               "_append_membership_locked (global section + fsync "
               "file then directory)")


def _enclosing_function(parents: dict, node: ast.AST) -> str:
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur.name
        cur = parents.get(cur)
    return ""


def _symbol(parents: dict, node: ast.AST) -> str:
    names = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names))


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
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        # raw ledger write: os.write(...) outside the blessed writers
        if mod.resolve(func) == "os.write":
            if _enclosing_function(parents, node) not in _LEDGER_WRITERS:
                findings.append(Finding("R8", mod.path, node.lineno,
                                        _symbol(parents, node),
                                        _LEDGER_MSG))
            continue
        # <recv>._log.append(...) / .append_many(...)
        if not (isinstance(func, ast.Attribute)
                and func.attr in _APPENDS
                and isinstance(func.value, ast.Attribute)
                and func.value.attr == "_log"):
            continue
        if _enclosing_function(parents, node) in _CHOKEPOINTS:
            continue
        findings.append(Finding("R8", mod.path, node.lineno,
                                _symbol(parents, node), _MSG))
    return findings
