"""Instance runtime statistics (/stats/instances).

Equivalent of cook.task-stats (task_stats.clj:117): over a time window,
bucket completed instances by status (success/failed), failure reason,
and user; report counts, total runtimes, and runtime percentiles.
"""
from __future__ import annotations

import numpy as np

from cook_tpu_torch.state.model import InstanceStatus, REASON_BY_CODE
from cook_tpu_torch.state.store import JobStore

PERCENTILES = (50, 75, 95, 99, 100)


def _percentiles(runtimes_ms: list[float]) -> dict:
    if not runtimes_ms:
        return {}
    arr = np.asarray(runtimes_ms, dtype=np.float64)
    return {str(p): float(np.percentile(arr, p)) for p in PERCENTILES}


def _leaf(entries: list[dict]) -> dict:
    runtimes = [e["runtime"] for e in entries]
    return {
        "count": len(entries),
        "total_runtime": float(sum(runtimes)),
        "percentiles": _percentiles(runtimes),
    }


def get_stats(store: JobStore, status: str, start_ms: int,
              end_ms: int, name_filter: str | None = None) -> dict:
    """Stats for instances of `status` ("success"|"failed") that ended in
    [start_ms, end_ms), grouped overall / by-reason / by-user
    (task_stats.clj:74-122)."""
    want = InstanceStatus(status)
    entries = []
    for job in store.jobs.values():
        if name_filter and name_filter not in job.name:
            continue
        for inst in job.instances:
            if inst.status != want or not inst.end_time_ms:
                continue
            if not (start_ms <= inst.end_time_ms < end_ms):
                continue
            reason = REASON_BY_CODE.get(inst.reason_code or -1)
            entries.append({
                "runtime": inst.end_time_ms - inst.start_time_ms,
                "user": job.user,
                "reason": reason.string if reason else "unknown",
            })
    by_reason = {}
    by_user = {}
    for e in entries:
        by_reason.setdefault(e["reason"], []).append(e)
        by_user.setdefault(e["user"], []).append(e)
    return {
        "overall": _leaf(entries) if entries else {"count": 0},
        "by-reason": {r: _leaf(v) for r, v in by_reason.items()},
        "by-user": {u: _leaf(v) for u, v in by_user.items()},
    }
