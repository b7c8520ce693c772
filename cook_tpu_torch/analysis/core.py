"""cookcheck plumbing: findings, suppressions, baseline, file walking.

A Finding's identity (``fingerprint``) deliberately omits the line
number so the baseline survives unrelated edits above a finding; it is
``rule|path|symbol|message``, counted — two identical violations in one
function occupy two baseline slots, so fixing one of them shrinks the
baseline instead of hiding behind the other.

Per-line suppression: a ``# cookcheck: disable=R1,R2`` (or a bare
``# cookcheck: disable`` for every rule) comment on the flagged line.
Comments are read with :mod:`tokenize` so a ``# cookcheck`` inside a
string literal never suppresses anything.
"""
from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, Optional

ALL_RULES = ("R1", "R2", "R3", "R4", "R5", "R6", "R7", "R8", "R9",
             "R10", "R11", "R12", "R13", "R14")

# rules that run over the whole scanned file set at once (the
# interprocedural model), not per-module
PACKAGE_RULES = ("R11", "R12")

# which rule families run over which package subdirectories when
# scanning a tree (explicit file arguments get every AST rule)
RULE_DIRS = {
    "R1": ("ops", "parallel", "resident.py"),
    "R2": ("scheduler", "agent"),
    "R3": ("rest", "backends", "scheduler", "integrations"),
    "R5": ("obs", "scheduler", "rest", "backends", "agent", "state",
           "utils"),
    "R6": ("agent", "backends", "scheduler", "rest", "state", "utils",
           "integrations", "plugins", "obs"),
    "R7": ("scheduler", "rest", "backends", "agent", "plugins", "obs",
           "state", "utils", "integrations"),
    "R8": ("state",),
    "R9": ("state",),
    "R10": ("state", "backends", "scheduler", "native", "agent"),
    "R13": ("scheduler", "obs"),
    "R14": ("scheduler", "rest"),
}

_SUPPRESS_RE = re.compile(
    r"#\s*cookcheck:\s*disable(?:=(?P<rules>[A-Za-z0-9,\s]+))?")


@dataclass(frozen=True)
class Finding:
    rule: str          # "R1".."R4"
    path: str          # repo-relative path
    line: int
    symbol: str        # enclosing Class.method / function ("" for R4)
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}|{self.path}|{self.symbol}|{self.message}"

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"


@dataclass
class ModuleInfo:
    """Shared per-module context handed to every rule."""

    tree: ast.Module
    source: str
    path: str                       # repo-relative
    # import alias -> dotted module ("np" -> "numpy",
    # "rq" -> "requests"); from-imports map name -> "module.name"
    aliases: dict = field(default_factory=dict)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a Name/Attribute chain with import aliases
        applied, e.g. ``np.sum`` -> ``numpy.sum``; None for anything
        that isn't a plain dotted chain."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.aliases.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))


def _collect_aliases(tree: ast.Module) -> dict:
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def collect_suppressions(source: str) -> dict[int, Optional[frozenset]]:
    """line -> suppressed rule set (None = every rule)."""
    out: dict[int, Optional[frozenset]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = m.group("rules")
            out[tok.start[0]] = None if rules is None else frozenset(
                r.strip().upper() for r in rules.split(",") if r.strip())
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def suppressed(finding: Finding,
               suppressions: dict[int, Optional[frozenset]]) -> bool:
    rules = suppressions.get(finding.line, frozenset())
    if rules is None:       # bare "# cookcheck: disable"
        return True
    return finding.rule in rules


# ----------------------------------------------------------------------
# baseline

def load_baseline(path: str) -> dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
    with open(path, "w") as fh:
        json.dump({"version": 1,
                   "findings": dict(sorted(counts.items()))}, fh, indent=1)
        fh.write("\n")


def diff_baseline(findings: list[Finding], baseline: dict[str, int]
                  ) -> tuple[list[Finding], dict[str, int]]:
    """(new findings not covered by the baseline, stale baseline
    entries whose violations no longer exist)."""
    counts: dict[str, int] = {}
    new: list[Finding] = []
    for f in findings:
        counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
        if counts[f.fingerprint] > baseline.get(f.fingerprint, 0):
            new.append(f)
    stale = {fp: n - counts.get(fp, 0) for fp, n in baseline.items()
             if counts.get(fp, 0) < n}
    return new, stale


# ----------------------------------------------------------------------
# analysis drivers

def analyze_source(source: str, path: str,
                   rules: Iterable[str] = ("R1", "R2", "R3", "R5", "R6",
                                           "R7", "R8", "R9", "R10",
                                           "R13", "R14"),
                   apply_suppressions: bool = True,
                   r1_reach: Optional[dict] = None) -> list[Finding]:
    """Run the per-module AST rules over one source text. `r1_reach`
    ({path: function names}, from trace_purity.reach over the scanned
    files) lets R1 follow calls into other modules."""
    from cook_tpu_torch.analysis import (async_hygiene, consume_discipline,
                                   epoch_discipline, lock_discipline,
                                   membership_discipline,
                                   metrics_discipline,
                                   profiler_discipline,
                                   retry_discipline, shard_discipline,
                                   span_discipline, trace_purity)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("R0", path, e.lineno or 0, "",
                        f"syntax error: {e.msg}")]
    mod = ModuleInfo(tree=tree, source=source, path=path,
                     aliases=_collect_aliases(tree))
    findings: list[Finding] = []
    if "R1" in rules:
        findings += trace_purity.check(
            mod, None if r1_reach is None else r1_reach.get(path, set()))
    if "R2" in rules:
        findings += lock_discipline.check(mod)
    if "R3" in rules:
        findings += async_hygiene.check(mod)
    if "R5" in rules:
        findings += span_discipline.check(mod)
    if "R6" in rules:
        findings += retry_discipline.check(mod)
    if "R7" in rules:
        findings += metrics_discipline.check(mod)
    if "R8" in rules:
        findings += epoch_discipline.check(mod)
    if "R9" in rules:
        findings += shard_discipline.check(mod)
    if "R10" in rules:
        findings += consume_discipline.check(mod)
    if "R13" in rules:
        findings += profiler_discipline.check(mod)
    if "R14" in rules:
        findings += membership_discipline.check(mod)
    if apply_suppressions:
        sup = collect_suppressions(source)
        findings = [f for f in findings if not suppressed(f, sup)]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def analyze_package(files: list, rules: Iterable[str],
                    apply_suppressions: bool = True) -> list[Finding]:
    """Run the interprocedural package rules (R11/R12) over the whole
    scanned file set. `files` is a list of (repo-relative path, source)
    pairs — the same shape :func:`interproc.build_model` takes."""
    from cook_tpu_torch.analysis import durability, lock_order
    from cook_tpu_torch.analysis.interproc import build_model
    model = build_model(files)
    findings: list[Finding] = []
    if "R11" in rules:
        findings += lock_order.check(model)
    if "R12" in rules:
        findings += durability.check(model)
    if apply_suppressions:
        sup_by_path = {rel: collect_suppressions(src)
                       for rel, src in files}
        findings = [f for f in findings
                    if not suppressed(f, sup_by_path.get(f.path, {}))]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _rules_for(relpath: str, selected: Iterable[str]) -> list[str]:
    parts = relpath.replace(os.sep, "/").split("/")
    out = []
    for rule, dirs in RULE_DIRS.items():
        if rule in selected and any(d in parts for d in dirs):
            out.append(rule)
    return out


def iter_py_files(path: str) -> Iterable[str]:
    if os.path.isfile(path):
        yield path
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".git")]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def analyze_paths(paths: list[str], root: str,
                  rules: Iterable[str] = ALL_RULES,
                  apply_suppressions: bool = True) -> list[Finding]:
    """Analyze files/trees. `root` anchors repo-relative paths and the
    R4 pair lookup. Directory scans scope rules by RULE_DIRS; files
    named explicitly get every per-module rule."""
    from cook_tpu_torch.analysis import rest_drift, trace_purity
    findings: list[Finding] = []
    # R1 follows calls across modules: its reach over every file it
    # runs on, before the per-module pass
    r1_files = []
    if "R1" in rules:
        for path in paths:
            explicit_file = os.path.isfile(path)
            for fp in iter_py_files(path):
                rel = os.path.relpath(fp, root)
                if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                    continue
                if explicit_file or "R1" in _rules_for(rel, rules):
                    with open(fp, encoding="utf-8") as f:
                        r1_files.append((rel, f.read()))
    r1_reach = trace_purity.reach(r1_files) if r1_files else None
    api_path = openapi_path = None
    pkg_files: list[tuple] = []     # (rel, source) for R11/R12
    want_pkg = any(r in rules for r in PACKAGE_RULES)
    for path in paths:
        explicit_file = os.path.isfile(path)
        for fp in iter_py_files(path):
            rel = os.path.relpath(fp, root)
            if rel.replace(os.sep, "/").endswith("rest/api.py"):
                api_path = fp
            if rel.replace(os.sep, "/").endswith("rest/openapi.py"):
                openapi_path = fp
            # the analyzer does not analyze itself: its rule modules
            # are full of violation-shaped pattern literals
            if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                continue
            active = (list(r for r in rules if r != "R4")
                      if explicit_file else _rules_for(rel, rules))
            src = None
            if active:
                with open(fp, encoding="utf-8") as f:
                    src = f.read()
                findings += analyze_source(src, rel, active,
                                           apply_suppressions, r1_reach)
            if want_pkg:
                if src is None:
                    with open(fp, encoding="utf-8") as f:
                        src = f.read()
                pkg_files.append((rel, src))
    if want_pkg and pkg_files:
        findings += analyze_package(pkg_files,
                                    [r for r in rules
                                     if r in PACKAGE_RULES],
                                    apply_suppressions)
    if "R4" in rules and api_path and openapi_path:
        with open(api_path, encoding="utf-8") as f:
            api_src = f.read()
        with open(openapi_path, encoding="utf-8") as f:
            openapi_src = f.read()
        api_rel = os.path.relpath(api_path, root)
        openapi_rel = os.path.relpath(openapi_path, root)
        r4 = rest_drift.check_pair(api_src, api_rel,
                                   openapi_src, openapi_rel)
        sup_by_path = {api_rel: collect_suppressions(api_src),
                       openapi_rel: collect_suppressions(openapi_src)}
        if apply_suppressions:
            r4 = [f for f in r4
                  if not suppressed(f, sup_by_path.get(f.path, {}))]
        findings += r4
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
