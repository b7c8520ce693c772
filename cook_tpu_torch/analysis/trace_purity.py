"""R1: host syncs in the port's device code.

The port's device entry points run eagerly: each op is queued on the
card's stream and the host runs ahead of it, until something needs a
device value on the host. That read blocks the host until the queue
drains — a sync — and the syncs of a cycle are what its device idle
share is made of (PERF.md §5). A sync hides easily: ``bool(t.any())``
reads a flag, ``torch.tensor(n, device=dev)`` copies a Python int from
pageable memory and waits for the copy. R1 finds them statically, and
``chip_smoke.py`` holds it against the syncs PyTorch's sync debug mode
traces on the card: every traced site in ``ops/``, ``parallel/`` and
``scheduler/resident.py`` must be an R1 finding.

Roots, the port's device entry points (by name, in any file R1 runs
on; their homes):

  ops/cycle.py              rank_and_match
  ops/match.py              match_scan, match_rounds,
                            _scan_assign_candidates (the candidate
                            walk: no path calls it, as in the
                            reference, but it runs on the device
                            when called)
  ops/rebalance.py          rebalance
  ops/dru.py                dru_rank, gpu_dru_rank (the rankers)
  parallel/pools.py         pool_sharded_cycle
  parallel/federation.py    federated_cycle
  parallel/sharded_match.py sharded_match_scan
  scheduler/resident.py     device_cycle, read_outputs

Reachability: a function is checked when it is a root, is called by
name from a checked function, or is passed by name as an argument
inside one — as in the reference — or is a nested def a checked
function returns (``sharded_match_scan`` builds and returns its
matcher), and also across the port's own
imports: ``match_ops.match_scan(...)`` after ``from cook_tpu_torch.ops
import match as match_ops``, or ``cumsum0(...)`` after ``from
cook_tpu_torch.ops.segments import cumsum0``. The cross-module part
needs the whole scanned file set, so :func:`reach` computes it once
over the files R1 runs on (``core.analyze_paths`` does); a single
source text (``core.analyze_source``) sees only its own module.

Flagged, each at the line Python reports for it (a method call's at
the line of its attribute name):

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``;
* ``bool()``, ``int()``, ``float()`` of an expression not known on the
  host (literals, ``.shape`` / ``.ndim`` / ``.size`` chains, ``len()``
  and arithmetic over those are);
* a ``numpy`` call with a non-static argument (``np.*`` of a tensor);
* ``torch.cuda.synchronize()`` and ``.synchronize()`` of any object
  (an event, a stream);
* ``torch.tensor(...)`` / ``torch.as_tensor(...)`` with ``device=``:
  host values copied from pageable memory, then a stream sync;
* ``.to(...)`` to a device (any first argument but a ``torch.<dtype>``,
  or ``device=``) and ``.cuda()`` without ``non_blocking=True``;
* ``.nonzero()``, ``torch.nonzero``, ``torch.unique``,
  ``torch.masked_select`` (output sizes read back);
* ``repeat_interleave`` without ``output_size=``.

Left alone: the plain versions' CPU branches, told apart by their
device guard. The body of ``if <x>.type == "cpu":`` or ``if <x>.type
!= "cuda":``, or the ``else`` of the converse, is neither checked nor
followed: each kernel wrapper sends a
CPU tensor to its plain version there, and on the CPU a read is no
sync. A plain version reached some other way is checked.

Dropped from the reference's R1 (``jax.jit`` trace purity), since each
matters only under tracing and is no sync in eager PyTorch: ``global``
statements, attribute mutation, host clocks (``time.*``,
``datetime.now``) and ``print()``. ``jax.jit`` roots are gone with
them: the port has none.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from cook_tpu_torch.analysis.core import (Finding, ModuleInfo,
                                          _collect_aliases)

ROOTS = frozenset({
    "rank_and_match", "match_scan", "match_rounds", "rebalance",
    "dru_rank", "gpu_dru_rank", "pool_sharded_cycle", "federated_cycle",
    "sharded_match_scan", "device_cycle", "read_outputs",
    "_scan_assign_candidates"})

# methods that read a device value on the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_NUMPY_MODULES = {"numpy", "onp"}
_CASTS = {"float", "int", "bool"}
# torch functions whose output size is read back from the device
_SIZE_READS = {"torch.nonzero", "torch.unique", "torch.masked_select"}
_UPLOADS = {"torch.tensor", "torch.as_tensor"}
# the package the modules are named from (the anchor of `_dotted`)
_PACKAGE = "cook_tpu_torch"


def _static_safe(node: ast.AST) -> bool:
    """Expressions whose value is known on the host — casting these
    with int()/float() is the static-shape idiom, not a host sync:
    literals, .shape/.ndim/.size chains, len(), arithmetic over
    those."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in ("shape", "ndim", "size")
    if isinstance(node, ast.Subscript):
        return _static_safe(node.value)
    if isinstance(node, ast.Call):
        return isinstance(node.func, ast.Name) and node.func.id == "len"
    if isinstance(node, ast.BinOp):
        return _static_safe(node.left) and _static_safe(node.right)
    if isinstance(node, ast.UnaryOp):
        return _static_safe(node.operand)
    return False


def _function_defs(tree: ast.Module) -> dict[str, ast.AST]:
    """Every (possibly nested) def in the module, by name. Later
    definitions shadow earlier ones of the same name."""
    defs: dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
    return defs


def _cpu_branch(test: ast.AST) -> Optional[str]:
    """"body" or "orelse": the branch of an `if` that runs only for a
    CPU device, by its guard; None for any other test."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.left, ast.Attribute)
            and test.left.attr == "type"
            and isinstance(test.comparators[0], ast.Constant)):
        return None
    kind, op = test.comparators[0].value, test.ops[0]
    if (kind, type(op)) in (("cpu", ast.Eq), ("cuda", ast.NotEq)):
        return "body"
    if (kind, type(op)) in (("cpu", ast.NotEq), ("cuda", ast.Eq)):
        return "orelse"
    return None


def _iter_body(fn: ast.AST):
    """Walk a function body without descending into nested defs (those
    are visited on their own when reachable) or into CPU branches."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.If):
            skip = _cpu_branch(node.test)
            if skip is not None:
                stack.append(node.test)
                stack.extend(node.orelse if skip == "body" else node.body)
                continue
        stack.extend(ast.iter_child_nodes(node))


def _dotted(path: str) -> str:
    """The module name of a repo-relative path, anchored at the
    package."""
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if _PACKAGE in parts:
        parts = parts[parts.index(_PACKAGE):]
    return ".".join(parts)


class _Module:
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.defs = _function_defs(mod.tree)


def _callees(m: _Module, fn: ast.AST):
    """(dotted or local) names a function calls, passes by name, or
    returns (a factory's closure: the matcher it builds)."""
    for node in _iter_body(fn):
        if isinstance(node, ast.Return) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in m.defs:
            yield None, node.value.id
        if not isinstance(node, ast.Call):
            continue
        for ref in [node.func] + list(node.args) + \
                [k.value for k in node.keywords]:
            if isinstance(ref, ast.Name) and ref.id in m.defs:
                yield None, ref.id
            elif isinstance(ref, (ast.Name, ast.Attribute)):
                dotted = m.mod.resolve(ref)
                if dotted and "." in dotted:
                    mod_name, _, name = dotted.rpartition(".")
                    yield mod_name, name


def _walk(modules: dict[str, _Module]) -> dict[str, set]:
    """{path: names reachable from the roots} over `modules` (dotted
    module name -> module)."""
    seen: dict[str, set] = {m.mod.path: set() for m in modules.values()}
    work = [(name, fn_name) for name, m in modules.items()
            for fn_name in m.defs if fn_name in ROOTS]
    while work:
        name, fn_name = work.pop()
        m = modules.get(name)
        if m is None or fn_name not in m.defs or \
                fn_name in seen[m.mod.path]:
            continue
        seen[m.mod.path].add(fn_name)
        for target, callee in _callees(m, m.defs[fn_name]):
            work.append((name if target is None else target, callee))
    return seen


def reach(files: Iterable[tuple]) -> dict[str, set]:
    """{path: reachable function names} over (repo-relative path,
    source) pairs, across their imports of one another."""
    modules: dict[str, _Module] = {}
    for path, source in files:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            continue
        modules[_dotted(path)] = _Module(ModuleInfo(
            tree=tree, source=source, path=path,
            aliases=_collect_aliases(tree)))
    return _walk(modules)


def _line(node: ast.Call) -> int:
    """The line Python reports for a call: a method call's is the line
    of its attribute name."""
    if isinstance(node.func, ast.Attribute):
        return node.func.end_lineno or node.lineno
    return node.lineno


def _kw(node: ast.Call, name: str) -> Optional[ast.AST]:
    for k in node.keywords:
        if k.arg == name:
            return k.value
    return None


def _true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


class _Scope:
    """What a function's own assignments show to be host values:
    names every assignment of which is host-evident (numpy results,
    Python containers, shapes, dtypes), and names holding a dtype."""

    # builtins whose result is a host value
    _HOST_CALLS = {"len", "range", "list", "tuple"}

    def __init__(self, mod: ModuleInfo, fn: Optional[ast.AST] = None):
        self.mod = mod
        self.host: set = set()
        self.dtypes: set = set()
        if fn is None:
            return
        # name -> the values bound to it; None for a binding other than
        # `name = value` (a loop target, an unpacking, `+=`, `with as`)
        values: dict[str, list] = {}
        for node in _iter_body(fn):
            if isinstance(node, ast.Assign):
                simple = len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name)
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                                   ast.AsyncFor, ast.NamedExpr)):
                simple, targets = False, [node.target]
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                simple = False
                targets = [i.optional_vars for i in node.items
                           if i.optional_vars is not None]
            else:
                continue
            for tgt in targets:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name):
                        values.setdefault(n.id, []).append(
                            node.value if simple else None)
        # to a fixed point: a name built from host names is one too
        for known, test in ((self.dtypes, self.is_dtype),
                            (self.host, self.is_host)):
            grew = True
            while grew:
                grew = False
                for name, vs in values.items():
                    if name not in known and None not in vs and \
                            all(test(v) for v in vs):
                        known.add(name)
                        grew = True

    def is_dtype(self, node: ast.AST) -> bool:
        """`torch.float32`, `x.dtype`, a dtype name: `.to()` of a dtype
        stays on the tensor's device."""
        if isinstance(node, ast.Name):
            return node.id == "dtype" or node.id in self.dtypes
        if isinstance(node, ast.Attribute) and node.attr == "dtype":
            return True
        dotted = self.mod.resolve(node)
        return bool(dotted) and dotted.startswith("torch.") and \
            dotted != "torch.device"

    def is_host(self, node: ast.AST) -> bool:
        """An expression whose value is known to live on the host."""
        if _static_safe(node) or self.is_dtype(node):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.host
        if isinstance(node, (ast.List, ast.Tuple, ast.Set, ast.Dict,
                             ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp, ast.JoinedStr)):
            return True
        if isinstance(node, ast.Compare):
            return all(self.is_host(x)
                       for x in [node.left] + node.comparators)
        if isinstance(node, (ast.Attribute, ast.Subscript)):
            return self.is_host(node.value)
        if isinstance(node, ast.Call):
            dotted = self.mod.resolve(node.func)
            if dotted and dotted.split(".")[0] in _NUMPY_MODULES:
                return True
            if isinstance(node.func, ast.Name):
                return node.func.id in self._HOST_CALLS
            if isinstance(node.func, ast.Attribute):
                return self.is_host(node.func.value)
        return False


def _violation(scope: _Scope, node: ast.AST) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    mod = scope.mod
    fn = node.func
    dotted = mod.resolve(fn)
    if isinstance(fn, ast.Attribute):
        if fn.attr in _SYNC_METHODS and not scope.is_host(fn.value):
            return (f"host sync: .{fn.attr}() reads a device value on the "
                    "host")
        if fn.attr == "synchronize":
            return (f"host sync: {dotted or '.synchronize'}() waits for "
                    "the device")
        if fn.attr == "nonzero" and not scope.is_host(fn.value):
            return ("host sync: .nonzero() reads its output size back "
                    "from the device")
        if fn.attr == "repeat_interleave" and \
                _kw(node, "output_size") is None:
            return ("host sync: repeat_interleave without output_size "
                    "reads its output size back from the device")
        if fn.attr in ("to", "cuda") and \
                not _true(_kw(node, "non_blocking")):
            to_device = (fn.attr == "cuda"
                         or _kw(node, "device") is not None
                         or bool(node.args)
                         and not scope.is_dtype(node.args[0]))
            if to_device:
                return (f".{fn.attr}() to a device without "
                        "non_blocking=True: a copy from pageable memory "
                        "and a host sync")
    if dotted in _SIZE_READS:
        return (f"host sync: {dotted}() reads its output size back from "
                "the device")
    if dotted in _UPLOADS and _kw(node, "device") is not None:
        return (f"{dotted}(..., device=) of host values: a copy from "
                "pageable memory and a host sync")
    if dotted and "." in dotted and \
            dotted.split(".")[0] in _NUMPY_MODULES and \
            any(not scope.is_host(a) for a in node.args):
        return (f"host numpy call {dotted}() of a possible tensor reads "
                "it on the host")
    if isinstance(fn, ast.Name) and fn.id in _CASTS and node.args:
        if not scope.is_host(node.args[0]):
            return (f"{fn.id}() of a possible device value is a host "
                    "sync")
    return None


def check(mod: ModuleInfo, reachable: Optional[set] = None
          ) -> list[Finding]:
    """R1 over one module: the functions `reachable` names (from
    :func:`reach` over the scanned files), or, without it, those the
    module's own roots reach."""
    m = _Module(mod)
    if reachable is None:
        reachable = _walk({_dotted(mod.path): m})[mod.path]
    findings: list[Finding] = []
    for name in sorted(reachable):
        fn = m.defs.get(name)
        if fn is None:
            continue
        scope = _Scope(mod, fn)
        for node in _iter_body(fn):
            msg = _violation(scope, node)
            if msg is not None:
                findings.append(Finding("R1", mod.path, _line(node),
                                        name, msg))
    return findings
