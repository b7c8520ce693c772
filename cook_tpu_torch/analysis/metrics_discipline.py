"""R7: metrics discipline for the process-wide registry.

The labeled-family registry (obs/metrics.py) is only as useful as the
names and labels fed into it.  Prometheus exposition degrades in two
well-known ways — name churn (f-string names mint a new family per
format value) and label-cardinality blowups (a per-job uuid label turns
one family into millions of children).  R7 pins the discipline at the
call sites:

1. metric value classes (``Counter``, ``Gauge``, ``Meter``,
   ``Histogram``, ``Timer``) are instantiated by the registry, never
   directly — a free-floating metric object can never reach
   ``/metrics`` and silently drops data;
2. the ``name`` handed to ``registry.counter(...)`` (and gauge / meter
   / timer / histogram) is a string **literal** — a computed name is an
   unbounded family generator;
3. literal names are prometheus-idiomatic snake_case
   (``[a-z][a-z0-9_]*``) — dotted codahale names fork the exposition
   into sanitize-time collisions;
4. label keys stay off the identity axes that are unbounded per
   cluster: job / task / instance uuids.  Labels like ``pool``,
   ``user``, ``state``, ``reason`` are bounded by configuration;
   ``job="…uuid…"`` is bounded by nothing.  A ``**splat`` of labels
   hides the keys from review and is flagged for the same reason.

Violations that predate the rule live in the cookcheck baseline, so
the rule gates *new* call sites without forcing a flag-day rename.
"""
from __future__ import annotations

import ast
import re

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

# registry factory methods whose first argument is a metric name
_FACTORIES = ("counter", "gauge", "meter", "timer", "histogram")

# metric value classes that must come from a registry; matched on the
# resolved dotted import (both the labeled registry and the legacy
# utils.metrics classes)
_METRIC_CLASSES = frozenset(
    f"{mod}.{cls}"
    for mod in ("cook_tpu_torch.obs.metrics", "cook_tpu_torch.utils.metrics")
    for cls in ("Counter", "Gauge", "Meter", "Histogram", "Timer"))

# label keys that carry per-job/per-task identity — unbounded
_BANNED_LABELS = frozenset((
    "uuid", "job", "job_uuid", "jobuuid", "task", "task_id",
    "instance", "instance_id"))

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# registry factories also take real kwargs; don't mistake them for
# label keys
_FACTORY_KWARGS = frozenset(("buckets", "window_s", "reservoir"))

_MSG_DIRECT = ("instantiate metrics through a registry "
               "(registry.%s(...)), not %s directly")
_MSG_DYNAMIC = ("metric name must be a string literal — computed "
                "names mint unbounded metric families")
_MSG_CASE = ("metric name %r is not snake_case "
             "([a-z][a-z0-9_]*) — dotted/camel names collide after "
             "prometheus sanitation")
_MSG_LABEL = ("label %r keys metrics on per-job/task identity — "
              "unbounded cardinality; aggregate or drop the label")
_MSG_SPLAT = ("**-splatted labels hide the label keys — pass labels "
              "as explicit keyword arguments")


def _symbol(parents: dict, node: ast.AST) -> str:
    names = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names))


def _is_registry_factory(mod: ModuleInfo, call: ast.Call) -> bool:
    """``<chain>.counter(...)`` where the receiver chain ends in a
    registry — ``registry``, ``metrics_registry``, ``self.registry``,
    or anything else whose trailing component mentions "registry".
    Receiver-name based on purpose: the rule must catch call sites no
    matter which alias a module imports the process registry under."""
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr in _FACTORIES):
        return False
    recv = mod.resolve(call.func.value)
    return recv is not None and "registry" in recv.lower()


def check(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    parents: dict[ast.AST, ast.AST] = {}
    for parent in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(parent):
            parents[child] = parent

    # registry modules themselves construct the value classes
    norm = mod.path.replace("\\", "/")
    is_registry_module = norm.endswith(
        ("obs/metrics.py", "utils/metrics.py"))

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue

        # -- 1. direct metric-class instantiation ----------------------
        if not is_registry_module:
            resolved = mod.resolve(node.func)
            if resolved in _METRIC_CLASSES:
                cls = resolved.rsplit(".", 1)[-1]
                findings.append(Finding(
                    "R7", mod.path, node.lineno,
                    _symbol(parents, node),
                    _MSG_DIRECT % (cls.lower(), cls)))
                continue

        if not _is_registry_factory(mod, node):
            continue
        symbol = _symbol(parents, node)

        # -- 2./3. literal snake_case name -----------------------------
        name_arg = node.args[0] if node.args else None
        if name_arg is None:
            for kw in node.keywords:
                if kw.arg == "name":
                    name_arg = kw.value
                    break
        if not (isinstance(name_arg, ast.Constant)
                and isinstance(name_arg.value, str)):
            findings.append(Finding("R7", mod.path, node.lineno,
                                    symbol, _MSG_DYNAMIC))
        elif not _NAME_RE.match(name_arg.value):
            findings.append(Finding("R7", mod.path, node.lineno,
                                    symbol,
                                    _MSG_CASE % name_arg.value))

        # -- 4. bounded, reviewable label keys -------------------------
        for kw in node.keywords:
            if kw.arg is None:            # **splat
                findings.append(Finding("R7", mod.path, node.lineno,
                                        symbol, _MSG_SPLAT))
            elif kw.arg != "name" and kw.arg not in _FACTORY_KWARGS \
                    and kw.arg.lower() in _BANNED_LABELS:
                findings.append(Finding("R7", mod.path, node.lineno,
                                        symbol, _MSG_LABEL % kw.arg))
    return findings
