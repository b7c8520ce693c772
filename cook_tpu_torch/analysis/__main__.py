"""cookcheck CLI.

    python -m cook_tpu_torch.analysis [paths...] [--strict] [--rules R1,R2]
                                [--baseline FILE] [--write-baseline]
                                [--json] [--format sarif] [--output F]
                                [--witness PATH] [--warn-unused-suppressions]

With no paths, scans the cook_tpu_torch package of the repo the
module was imported from, against the package's own baseline
(cook_tpu_torch/analysis/baseline.json). Exit status: 0 when every finding is suppressed or
baselined; 1 in --strict mode when non-baselined findings exist (this
is the CI gate); 2 on usage errors.

``--witness PATH`` switches to witness-diff mode: the interprocedural
lock model is built over the scanned paths and diffed against the
runtime lock-witness JSONL at PATH (a file, or a directory of
``witness-*.jsonl``; repeatable). Any unexplained observed edge —
a real acquisition the static graph missed — exits 1. Static edges
never observed are reported as coverage gaps but do not fail.

``--format sarif`` emits SARIF 2.1.0 (non-baselined findings) so CI
can annotate the diff; ``--output`` redirects it to a file.

Stale baseline entries (violations that were fixed) are reported as a
reminder to re-run --write-baseline so the baseline only ever shrinks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from cook_tpu_torch.analysis.core import (ALL_RULES, analyze_paths,
                                    collect_suppressions, diff_baseline,
                                    iter_py_files, load_baseline,
                                    save_baseline)

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)


def _package_files(paths: list[str]) -> list[tuple]:
    """(repo-relative path, source) pairs for the interprocedural
    model, skipping the analyzer's own subtree like analyze_paths."""
    files: list[tuple] = []
    seen: set = set()
    for path in paths:
        for fp in iter_py_files(path):
            rel = os.path.relpath(fp, _REPO_ROOT)
            if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                continue
            if rel in seen:
                continue
            seen.add(rel)
            with open(fp, encoding="utf-8") as f:
                files.append((rel, f.read()))
    return files


def _witness_mode(paths: list[str], witness_paths: list[str]) -> int:
    from cook_tpu_torch.analysis.interproc import build_model
    from cook_tpu_torch.analysis.witness import (diff_witness, load_witness,
                                           render_diff)
    model = build_model(_package_files(paths))
    observed = load_witness(witness_paths)
    diff = diff_witness(model, observed)
    print(render_diff(diff))
    return 1 if diff["unexplained"] else 0


def _unused_suppressions(paths: list[str], raw_findings: list) -> list:
    """Suppression comments whose rules no longer fire on that line.

    ``raw_findings`` must come from an apply_suppressions=False run so
    a suppression that IS doing its job still sees its finding."""
    fired: dict[tuple, set] = {}
    for f in raw_findings:
        fired.setdefault((f.path, f.line), set()).add(f.rule)
    out: list[tuple] = []
    seen: set = set()
    for path in paths:
        for fp in iter_py_files(path):
            rel = os.path.relpath(fp, _REPO_ROOT)
            if "cook_tpu_torch/analysis" in rel.replace(os.sep, "/"):
                continue
            if rel in seen:
                continue
            seen.add(rel)
            with open(fp, encoding="utf-8") as fh:
                src = fh.read()
            for line, rules in sorted(collect_suppressions(src).items()):
                hit = fired.get((rel, line), set())
                if rules is None:
                    if not hit:
                        out.append((rel, line, "disable"))
                else:
                    stale = sorted(r for r in rules if r not in hit)
                    if stale:
                        out.append((rel, line,
                                    "disable=" + ",".join(stale)))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cook_tpu_torch.analysis",
        description="cookcheck: host syncs (R1), lock discipline (R2), "
                    "async hygiene (R3), REST/OpenAPI drift (R4), "
                    "span discipline (R5), retry discipline (R6), "
                    "metrics discipline (R7), epoch discipline (R8), "
                    "shard-lock discipline (R9), consume discipline "
                    "(R10), whole-program lock order (R11), "
                    "durability-ack dominance (R12), profiler "
                    "discipline (R13), membership discipline (R14)")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the "
                         "cook_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any finding is not in the baseline")
    ap.add_argument("--rules", default=",".join(ALL_RULES),
                    help="comma-separated subset of rules to run")
    ap.add_argument("--baseline",
                    default=os.path.join(_PKG_ROOT, "analysis",
                                         "baseline.json"),
                    help="baseline file (default: the package's "
                         "analysis/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report everything")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--format", choices=("text", "sarif"),
                    default="text",
                    help="output format for findings (sarif emits "
                         "SARIF 2.1.0 of non-baselined findings)")
    ap.add_argument("--output", default=None, metavar="FILE",
                    help="write --format output to FILE instead of "
                         "stdout")
    ap.add_argument("--witness", action="append", default=None,
                    metavar="PATH",
                    help="witness-diff mode: compare runtime lock-"
                         "witness JSONL (file or directory; repeatable) "
                         "against the static lock graph; exit 1 on any "
                         "unexplained observed edge")
    ap.add_argument("--warn-unused-suppressions", action="store_true",
                    help="report '# cookcheck: disable' comments whose "
                         "rules no longer fire on that line")
    args = ap.parse_args(argv)

    rules = tuple(r.strip().upper() for r in args.rules.split(",")
                  if r.strip())
    bad = [r for r in rules if r not in ALL_RULES]
    if bad:
        ap.exit(2, f"unknown rule(s): {', '.join(bad)} "
                   f"(have {', '.join(ALL_RULES)})\n")
    paths = args.paths or [_PKG_ROOT]

    if args.witness:
        return _witness_mode(paths, args.witness)

    findings = analyze_paths(paths, _REPO_ROOT, rules)

    unused: list[tuple] = []
    if args.warn_unused_suppressions:
        raw = analyze_paths(paths, _REPO_ROOT, rules,
                            apply_suppressions=False)
        unused = _unused_suppressions(paths, raw)

    baseline = {} if (args.no_baseline or args.write_baseline) \
        else load_baseline(args.baseline)
    new, stale = diff_baseline(findings, baseline)

    if args.write_baseline:
        save_baseline(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    if args.format == "sarif":
        from cook_tpu_torch.analysis.sarif import to_sarif
        text = json.dumps(to_sarif(new), indent=1)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as fh:
                fh.write(text + "\n")
        else:
            print(text)
    elif args.as_json:
        text = json.dumps({
            "findings": [vars(f) for f in findings],
            "new": [vars(f) for f in new],
            "stale_baseline": stale,
            "unused_suppressions": [
                {"path": p, "line": l, "comment": c}
                for p, l, c in unused],
        }, indent=1)
        if args.output:
            with open(args.output, "w", encoding="utf-8") as fh:
                fh.write(text + "\n")
        else:
            print(text)
    else:
        for f in new:
            print(f.render())
        n_baselined = len(findings) - len(new)
        summary = f"{len(new)} finding(s)"
        if n_baselined:
            summary += f", {n_baselined} baselined"
        print(summary)
        if stale:
            print(f"note: {sum(stale.values())} baseline entr(ies) are "
                  "stale (violations fixed) — re-run --write-baseline "
                  "to shrink the baseline:", file=sys.stderr)
            for fp, n in sorted(stale.items()):
                print(f"  stale x{n}: {fp}", file=sys.stderr)

    if unused:
        print(f"note: {len(unused)} unused suppression comment(s) — "
              "delete them:", file=sys.stderr)
        for p, l, c in unused:
            print(f"  {p}:{l}: # cookcheck: {c}", file=sys.stderr)

    if args.strict and new:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
