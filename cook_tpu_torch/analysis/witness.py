"""Witness-vs-static diff: does the model cover what really ran?

The runtime lock-witness (:mod:`cook_tpu_torch.utils.lockwitness`) writes one
JSONL line per distinct observed acquisition edge; this module merges
those files and diffs them against the static lock-order graph:

* **unexplained** — an observed edge the static graph lacks (or an
  observed UNORDERED family acquisition where the graph only blesses
  the ordered walk). The model missed a call path; CI fails, because a
  missed path is where the next soak-only deadlock hides.
* **coverage gaps** — static edges between witnessed locks that never
  fired. Non-fatal: the static side over-approximates on purpose, and
  a gap is also honest news about what the test tier never exercised.

Only edges whose BOTH endpoints are witnessed locks participate: the
witness cannot see plain ``threading`` locks, so static edges touching
them are outside the contract.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

from cook_tpu_torch.analysis.interproc import PackageModel


def load_witness(paths: Iterable[str]) -> dict:
    """Merge witness JSONL files into {(src, dst, ordered): count}.

    Each path may be a file or a directory (every ``witness-*.jsonl``
    inside is merged — the soak jobs write one file per PID)."""
    out: dict = {}
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(
                os.path.join(p, n) for n in os.listdir(p)
                if n.startswith("witness-") and n.endswith(".jsonl"))
        else:
            files.append(p)
    for fp in files:
        try:
            with open(fp, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue   # torn tail line from a killed proc
                    key = (str(rec.get("from")), str(rec.get("to")),
                           bool(rec.get("ordered")))
                    out[key] = out.get(key, 0) + int(rec.get("n", 1))
        except OSError:
            continue
    return out


def diff_witness(model: PackageModel, observed: dict) -> dict:
    """{"unexplained": [...], "gaps": [...], "matched": n,
    "observed": n} — see the module docstring for semantics."""
    witnessed = {n for n, l in model.locks.items() if l.witnessed}
    static = {(e.src, e.dst): e for e in model.edges}

    unexplained = []
    matched = 0
    seen_pairs: set = set()
    for (src, dst, ordered), n in sorted(observed.items()):
        if src not in witnessed or dst not in witnessed:
            # a lock name the model doesn't know is itself unexplained:
            # the witness vocabulary is the model's vocabulary
            unexplained.append({
                "from": src, "to": dst, "ordered": ordered, "n": n,
                "why": "lock name missing from the static model"})
            continue
        seen_pairs.add((src, dst))
        e = static.get((src, dst))
        if e is None:
            unexplained.append({
                "from": src, "to": dst, "ordered": ordered, "n": n,
                "why": "no static edge — the model missed a call path"})
        elif e.ordered and not ordered:
            unexplained.append({
                "from": src, "to": dst, "ordered": ordered, "n": n,
                "why": "observed UNORDERED acquisition of a "
                       "statically ordered (blessed ascending) edge"})
        else:
            matched += 1

    gaps = []
    for (src, dst), e in sorted(static.items()):
        if src in witnessed and dst in witnessed \
                and (src, dst) not in seen_pairs:
            gaps.append({
                "from": src, "to": dst, "ordered": e.ordered,
                "site": f"{e.path}:{e.line}", "func": e.func})

    return {"unexplained": unexplained, "gaps": gaps,
            "matched": matched, "observed": len(observed)}


def render_diff(diff: dict) -> str:
    lines = []
    lines.append(f"witness: {diff['observed']} observed edge(s), "
                 f"{diff['matched']} explained, "
                 f"{len(diff['unexplained'])} unexplained, "
                 f"{len(diff['gaps'])} static edge(s) never observed")
    for u in diff["unexplained"]:
        o = " (ordered)" if u["ordered"] else ""
        lines.append(f"  UNEXPLAINED {u['from']} -> {u['to']}{o} "
                     f"x{u['n']}: {u['why']}")
    for g in diff["gaps"]:
        lines.append(f"  gap {g['from']} -> {g['to']} "
                     f"(static at {g['site']} [{g['func']}])")
    return "\n".join(lines)
