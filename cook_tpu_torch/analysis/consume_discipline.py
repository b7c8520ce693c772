"""R10: consume-side fast-path discipline.

The native consume chokepoint (native/consumefold.py) exists so that
exactly ONE call site owns each hot fold — the differential oracle
pins native and Python paths together *at those sites*, and a second
caller would silently skip that guarantee (and, for the status lines,
could interleave writes outside the store's `_append_segments`
ordering). R10 pins the blessed homes at the AST level:

  - ``consumefold.fold_status_lines`` may only be called from
    ``state/store.py`` ``update_instances_bulk`` — everywhere else,
    status events must go through the store's public bulk API;
  - ``consumefold.frame_concat`` may only be called from
    ``backends/specwire.py`` ``frame_segments`` — CKS1 frames have one
    assembler, so the wire shape cannot fork;
  - ``consumefold.usage_totals`` may only be called from
    ``backends/agent.py`` ``_track_bulk_locked`` — the one batch
    writer of the per-host ``_used`` aggregate;
  - in ``state/store.py``, the precomputed ``_STATUS_FRAG`` /
    ``_STATUS_FRAG_B`` fragments may only be read inside
    ``update_instances_bulk`` (module level defines them): any other
    reader is hand-assembling status lines off the blessed path;
  - in ``backends/agent.py``, ``self._used`` may only be *mutated*
    (subscript/attribute assignment, ``del``, or a mutator-method
    call) inside ``__init__`` / ``_track_locked`` /
    ``_untrack_locked`` / ``_track_bulk_locked``; reads are free.

Like R8/R9 the rule is deliberately syntactic — an alias smuggling a
fold function or the ``_used`` dict past it is possible, but the
aliasing site itself reads the guarded name and is flagged there.
"""
from __future__ import annotations

import ast

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

# consumefold entry point -> (home module suffix, blessed functions)
_FOLD_HOMES = {
    "fold_status_lines": ("state/store.py",
                          frozenset(("update_instances_bulk",))),
    "frame_concat": ("backends/specwire.py",
                     frozenset(("frame_segments",))),
    "usage_totals": ("backends/agent.py",
                     frozenset(("_track_bulk_locked",))),
}

_FRAG_NAMES = frozenset(("_STATUS_FRAG", "_STATUS_FRAG_B"))
_FRAG_BLESSED = frozenset(("update_instances_bulk",))

_USED_BLESSED = frozenset(("__init__", "_track_locked",
                           "_untrack_locked", "_track_bulk_locked"))
_USED_MUTATORS = frozenset(("pop", "popitem", "setdefault", "update",
                            "clear"))

_MSG_FOLD = ("consumefold.{fn} called outside its blessed home "
             "({home}) — the native/Python byte-identity oracle only "
             "covers the chokepoint call site")
_MSG_FRAG = ("_STATUS_FRAG read outside update_instances_bulk "
             "hand-assembles status lines off the blessed "
             "consumefold + _append_segments path")
_MSG_USED = ("self._used mutated outside _track_locked/"
             "_untrack_locked/_track_bulk_locked — the offer "
             "aggregate has exactly three writers")


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


def _is_self_used(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "_used"
            and isinstance(node.value, ast.Name)
            and node.value.id == "self")


def check(mod: ModuleInfo) -> list[Finding]:
    norm = mod.path.replace("\\", "/")
    # the chokepoint module itself defines the folds (and native/
    # holds the C sources' bindings) — nothing to pin there
    if norm.endswith("native/consumefold.py"):
        return []
    findings: list[Finding] = []
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    in_store = norm.endswith("state/store.py")
    in_agent = norm.endswith("backends/agent.py")

    for node in ast.walk(mod.tree):
        # (a-c) consumefold entry points outside their blessed homes
        if isinstance(node, ast.Call):
            resolved = mod.resolve(node.func)
            if resolved:
                for fn_name, (home, blessed) in _FOLD_HOMES.items():
                    if not resolved.endswith("consumefold." + fn_name):
                        continue
                    fn = _enclosing_function(parents, node)
                    if not norm.endswith(home) or fn is None \
                            or fn.name not in blessed:
                        findings.append(Finding(
                            "R10", mod.path, node.lineno,
                            _symbol(parents, node),
                            _MSG_FOLD.format(fn=fn_name, home=home)))
            # mutator-method calls on self._used
            if in_agent and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _USED_MUTATORS \
                    and _is_self_used(node.func.value):
                fn = _enclosing_function(parents, node)
                if fn is None or fn.name not in _USED_BLESSED:
                    findings.append(Finding("R10", mod.path,
                                            node.lineno,
                                            _symbol(parents, node),
                                            _MSG_USED))

        # (d) status-fragment reads outside the blessed store fold
        if in_store and isinstance(node, ast.Name) \
                and node.id in _FRAG_NAMES \
                and isinstance(node.ctx, ast.Load):
            fn = _enclosing_function(parents, node)
            if fn is not None and fn.name not in _FRAG_BLESSED:
                findings.append(Finding("R10", mod.path, node.lineno,
                                        _symbol(parents, node),
                                        _MSG_FRAG))

        # (e) self._used mutated via assignment / del
        if in_agent and isinstance(node, (ast.Assign, ast.AugAssign,
                                          ast.Delete)):
            targets = node.targets if isinstance(
                node, (ast.Assign, ast.Delete)) else [node.target]
            hit = False
            for t in targets:
                if _is_self_used(t):
                    hit = True
                elif isinstance(t, ast.Subscript) \
                        and _is_self_used(t.value):
                    hit = True
            if hit:
                fn = _enclosing_function(parents, node)
                if fn is None or fn.name not in _USED_BLESSED:
                    findings.append(Finding("R10", mod.path,
                                            node.lineno,
                                            _symbol(parents, node),
                                            _MSG_USED))
    return findings
