"""Decision provenance: why each considered job did (not) launch.

The device cycle (`ops/cycle.py rank_and_match`) already decides every
job's fate — ranked out, quota-gated, unplaceable, matched — and this
makes it say so: a compact per-queue-position reason-code triple
(``why_idx``/``why_code``/``why_amt``) packed into the compaction
epilogue rides the existing prefix readback.  This module is the host
side: reason-code constants shared with the kernel, and the
``DecisionBook`` ring that joins decoded codes with the cycle number
(the flight-recorder ring keys its ``cycle.match`` entries by the same
``{pool, cycle}`` attrs) and per-job history, serving
``GET /unscheduled?job=`` and ``GET /debug/decisions``.

Stdlib only; imports nothing from cook_tpu (obs is a leaf package).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

# Reason codes — MUST mirror the jnp.where ladder in ops/cycle.py.
# 0 is the pad value for queue positions past the valid prefix.
PAD = 0
MATCHED = 1          # amt = host id it matched
NO_HOST_FIT = 2      # considerable, but no host had room / constraints
RANK_CUTOFF = 3      # amt = DRU-rank ordinal vs the considerable cap
QUOTA_MEM = 4        # amt = mem overage (requested cum - quota)
QUOTA_CPUS = 5       # amt = cpus overage
QUOTA_COUNT = 6      # amt = job-count overage
INVALID = 7          # queue slot held no valid pending job

CODE_NAMES = {
    PAD: "pad", MATCHED: "matched", NO_HOST_FIT: "no_host_fit",
    RANK_CUTOFF: "rank_cutoff", QUOTA_MEM: "quota_mem",
    QUOTA_CPUS: "quota_cpus", QUOTA_COUNT: "quota_count",
    INVALID: "invalid",
}

# Cook-parity human strings (unscheduled.clj wording) per code; the
# structured ``data`` dict carries the numbers.
COOK_REASONS = {
    MATCHED: "The job is now under consideration for launch.",
    NO_HOST_FIT: "The job couldn't be placed on any available hosts.",
    RANK_CUTOFF: "The job is ranked too low to be considered this "
                 "cycle.",
    QUOTA_MEM: "The job would cause you to exceed resource quotas.",
    QUOTA_CPUS: "The job would cause you to exceed resource quotas.",
    QUOTA_COUNT: "You have reached the limit of concurrent jobs.",
    INVALID: "The job was not in the pending queue this cycle.",
}


class Decision:
    """One (job, cycle) outcome."""

    __slots__ = ("uuid", "pool", "cycle", "ts_ms", "code", "amount",
                 "position")

    def __init__(self, uuid, pool, cycle, ts_ms, code, amount,
                 position):
        self.uuid = uuid
        self.pool = pool
        self.cycle = cycle
        self.ts_ms = ts_ms
        self.code = int(code)
        self.amount = float(amount)
        self.position = int(position)

    def to_dict(self) -> dict:
        return {"uuid": self.uuid, "pool": self.pool,
                "cycle": self.cycle, "ts_ms": self.ts_ms,
                "code": self.code,
                "reason": CODE_NAMES.get(self.code, "unknown"),
                "amount": self.amount, "position": self.position}


class DecisionBook:
    """Bounded ring of per-cycle decisions + per-job last-K history.

    ``record_cycle`` is called once per consumed cycle from the
    coordinator with already-decoded host rows (uuid, code, amt,
    queue position); readers (`/unscheduled`, `/debug/decisions`) get
    copies.  Per-job history is an LRU capped at ``max_jobs`` so a
    long-running scheduler can't grow without bound; per-cycle
    summaries live in a ``maxlen`` deque like the flight ring."""

    def __init__(self, max_cycles: int = 512, max_jobs: int = 8192,
                 per_job: int = 4):
        self.per_job = per_job
        self._cycles: collections.deque = collections.deque(
            maxlen=max_cycles)
        self._jobs: collections.OrderedDict = collections.OrderedDict()
        self.max_jobs = max_jobs
        self._lock = threading.Lock()
        self._recorded = 0

    def record_cycle(self, pool: str, cycle: int, decisions,
                     considered: int = 0, matched: int = 0,
                     ts_ms: Optional[float] = None) -> None:
        """``decisions`` is an iterable of (uuid, code, amount,
        position) for every valid queue slot in the cycle window."""
        ts = time.time() * 1e3 if ts_ms is None else ts_ms
        counts: dict = {}
        entries = []
        for uuid, code, amount, position in decisions:
            code = int(code)
            counts[code] = counts.get(code, 0) + 1
            entries.append(
                Decision(uuid, pool, cycle, ts, code, amount,
                         position))
        with self._lock:
            self._recorded += 1
            self._cycles.append({
                "pool": pool, "cycle": cycle, "ts_ms": round(ts, 3),
                "window": len(entries), "considered": int(considered),
                "matched": int(matched),
                "outcomes": {CODE_NAMES.get(c, str(c)): n
                             for c, n in sorted(counts.items())},
            })
            for d in entries:
                hist = self._jobs.get(d.uuid)
                if hist is None:
                    hist = self._jobs[d.uuid] = collections.deque(
                        maxlen=self.per_job)
                    if len(self._jobs) > self.max_jobs:
                        self._jobs.popitem(last=False)
                else:
                    self._jobs.move_to_end(d.uuid)
                hist.append(d)

    # -- reads -----------------------------------------------------

    def job_decisions(self, uuid) -> list:
        """Newest-first decisions recorded for ``uuid`` (may be [])."""
        with self._lock:
            hist = self._jobs.get(uuid)
            return [d.to_dict() for d in reversed(hist)] if hist else []

    def last_decision(self, uuid) -> Optional[dict]:
        with self._lock:
            hist = self._jobs.get(uuid)
            return hist[-1].to_dict() if hist else None

    def cycles(self, limit: int = 64, pool: Optional[str] = None):
        """Newest-first per-cycle outcome summaries."""
        with self._lock:
            entries = list(self._cycles)
        if pool is not None:
            entries = [e for e in entries if e["pool"] == pool]
        return list(reversed(entries[-limit:] if limit else entries))

    def stats(self) -> dict:
        with self._lock:
            return {"cycles_recorded": self._recorded,
                    "cycles_retained": len(self._cycles),
                    "jobs_tracked": len(self._jobs)}


def explain(decision: dict, num_considerable: int = 0) -> dict:
    """Cook-parity [reason, data] pair for one recorded decision."""
    code = decision["code"]
    data = {"pool": decision["pool"], "cycle": decision["cycle"]}
    if code == RANK_CUTOFF:
        data["rank"] = int(decision["amount"])
        data["cutoff"] = int(num_considerable)
    elif code in (QUOTA_MEM, QUOTA_CPUS, QUOTA_COUNT):
        data["quota"] = {QUOTA_MEM: "mem", QUOTA_CPUS: "cpus",
                         QUOTA_COUNT: "count"}[code]
        data["exceeded_by"] = decision["amount"]
    elif code == MATCHED:
        data["host"] = int(decision["amount"])
    return {"reason": COOK_REASONS.get(code, CODE_NAMES.get(
        code, "unknown")), "code": CODE_NAMES.get(code, "unknown"),
        "data": data}
