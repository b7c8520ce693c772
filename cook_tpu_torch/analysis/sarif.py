"""SARIF 2.1.0 output for cookcheck, so CI can annotate PR diffs.

One run, one ``cookcheck`` driver, one rule entry per R-rule, one
result per finding. The finding's counted-baseline fingerprint is
carried in ``partialFingerprints`` under ``cookcheck/v1`` — the same
line-independent key ``analysis_baseline.json`` uses, so a SARIF
consumer dedupes across rebases exactly like the baseline does.
"""
from __future__ import annotations

from typing import Iterable

from cook_tpu_torch.analysis.core import Finding

_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
           "master/Schemata/sarif-schema-2.1.0.json")

RULE_DESCRIPTIONS = {
    "R0": "file fails to parse",
    "R1": "trace purity: no host callbacks inside traced/jitted code",
    "R2": "lock discipline: no I/O or callbacks under a scheduler lock",
    "R3": "async hygiene: futures must be awaited or explicitly owned",
    "R4": "REST drift: api.py handlers and openapi.py must agree",
    "R5": "span discipline: spans closed on every path",
    "R6": "retry discipline: no bare retry loops without backoff/cap",
    "R7": "metrics discipline: registered metrics, no ad-hoc counters",
    "R8": "epoch discipline: epoch-fenced writes in federated paths",
    "R9": "shard discipline: shard sections only through the blessed "
          "helpers",
    "R10": "consume discipline: single-leader consume loop invariants",
    "R11": "lock order: no cycles, shard-after-global, nested shard "
           "sections, or non-reentrant re-entry in the whole-program "
           "lock graph",
    "R12": "durability-ack dominance: a 2xx ack on a state-mutating "
           "route must be dominated by a reachable fsync barrier",
}


def to_sarif(findings: Iterable[Finding]) -> dict:
    findings = list(findings)
    used_rules = sorted({f.rule for f in findings},
                        key=lambda r: (len(r), r))
    rules = [{
        "id": rid,
        "shortDescription": {
            "text": RULE_DESCRIPTIONS.get(rid, rid)},
    } for rid in used_rules]
    rule_index = {rid: i for i, rid in enumerate(used_rules)}
    results = [{
        "ruleId": f.rule,
        "ruleIndex": rule_index[f.rule],
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": f.path.replace("\\", "/"),
                    "uriBaseId": "SRCROOT"},
                "region": {"startLine": max(1, f.line)},
            },
            **({"logicalLocations": [{"fullyQualifiedName": f.symbol}]}
               if f.symbol else {}),
        }],
        "partialFingerprints": {"cookcheck/v1": f.fingerprint},
    } for f in findings]
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "cookcheck",
                "rules": rules,
            }},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }
