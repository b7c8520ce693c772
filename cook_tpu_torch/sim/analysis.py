"""Run-trace analysis: the reference's analysis notebook as a module.

The reference ships `scheduler/simulator_files/analysis/analysis.ipynb`
+ helpers to chart wait/turnaround/overhead distributions and compare
scheduler runs (simulator reporting.clj:156-325 produces the same
aggregates server-side). This module reads one or more run-trace CSVs
(written by `Simulator.write_run_trace` / `python -m cook_tpu_torch.sim
--out-trace-file`) and produces the same cuts:

    python -m cook_tpu_torch.sim.analysis run1.csv [run2.csv ...] \
        [--charts out_dir] [--by-user]

Text report always; charts (wait-time CDF, per-user mean wait bars,
hourly throughput) when --charts is given and matplotlib is available.
"""
from __future__ import annotations

import argparse
import csv
import json
import sys
from collections import defaultdict
from typing import Optional

import numpy as np


def load_run_trace(path: str) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def _f(row: dict, key: str) -> Optional[float]:
    v = row.get(key)
    if v in (None, ""):
        return None
    return float(v)


def analyze(rows: list[dict]) -> dict:
    """Wait/turnaround/overhead stats per run (reporting.clj:156-325)."""
    waits, turnarounds, overheads, runtimes = [], [], [], []
    per_user: dict[str, list[float]] = defaultdict(list)
    preemptions = 0
    by_status = defaultdict(int)
    first_start_of_job: dict[str, float] = {}
    end_of_job: dict[str, float] = {}
    submit_of_job: dict[str, float] = {}
    user_of_job: dict[str, str] = {}
    run_of_job: dict[str, float] = defaultdict(float)

    for row in rows:
        jid = row["job_id"]
        user_of_job[jid] = row.get("user", "")
        submit = _f(row, "submit_time_ms")
        start = _f(row, "start_time_ms")
        end = _f(row, "end_time_ms")
        by_status[row.get("status", "")] += 1
        if row.get("preempted") in ("1", "True", "true"):
            preemptions += 1
        if submit is not None:
            submit_of_job[jid] = submit
        if start is not None:
            cur = first_start_of_job.get(jid)
            first_start_of_job[jid] = start if cur is None \
                else min(cur, start)
        if end is not None:
            end_of_job[jid] = max(end_of_job.get(jid, 0.0), end)
        if start is not None and end is not None:
            runtimes.append(end - start)
            run_of_job[jid] += end - start

    for jid, submit in submit_of_job.items():
        start = first_start_of_job.get(jid)
        if start is None:
            continue
        wait = start - submit
        waits.append(wait)
        per_user[user_of_job.get(jid, "")].append(wait)
        end = end_of_job.get(jid)
        if end is not None:
            turnarounds.append(end - submit)
            # overhead = turnaround minus time actually spent running
            # across all attempts (reporting.clj's overhead cut)
            overheads.append((end - submit) - run_of_job[jid])

    def stats(xs):
        if not xs:
            return {}
        a = np.asarray(xs, float)
        return {"n": len(xs), "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "max_ms": float(a.max())}

    return {
        "tasks": len(rows),
        "jobs": len(submit_of_job),
        "status_counts": dict(by_status),
        "preemptions": preemptions,
        "wait": stats(waits),
        "turnaround": stats(turnarounds),
        "overhead": stats(overheads),
        "runtime": stats(runtimes),
        "per_user_mean_wait_ms": {
            u: float(np.mean(w)) for u, w in sorted(per_user.items())},
        "_waits": waits,     # stripped before printing; used by charts
    }


def charts(results: dict[str, dict], out_dir: str) -> list[str]:
    """Wait-time CDFs + per-user mean wait bars, one figure each
    (analysis.ipynb's comparison charts)."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    fig, ax = plt.subplots(figsize=(7, 4.5))
    for name, res in results.items():
        w = np.sort(np.asarray(res["_waits"], float)) / 1000.0
        if not len(w):
            continue
        ax.plot(w, np.arange(1, len(w) + 1) / len(w), label=name)
    ax.set_xlabel("job wait time (s)")
    ax.set_ylabel("fraction of jobs")
    ax.set_title("Wait-time CDF")
    ax.legend()
    p = os.path.join(out_dir, "wait_cdf.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)

    fig, ax = plt.subplots(figsize=(7, 4.5))
    width = 0.8 / max(len(results), 1)
    users = sorted({u for res in results.values()
                    for u in res["per_user_mean_wait_ms"]})
    x = np.arange(len(users))
    for i, (name, res) in enumerate(results.items()):
        vals = [res["per_user_mean_wait_ms"].get(u, 0.0) / 1000.0
                for u in users]
        ax.bar(x + i * width, vals, width, label=name)
    ax.set_xticks(x + width * (len(results) - 1) / 2)
    ax.set_xticklabels(users, rotation=45, ha="right")
    ax.set_ylabel("mean wait (s)")
    ax.set_title("Per-user mean wait")
    ax.legend()
    p = os.path.join(out_dir, "per_user_wait.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    written.append(p)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cook_tpu_torch.sim.analysis")
    p.add_argument("traces", nargs="+", help="run-trace CSV files")
    p.add_argument("--charts", help="directory for chart PNGs")
    p.add_argument("--by-user", action="store_true",
                   help="include the per-user wait table")
    a = p.parse_args(argv)

    results = {}
    for path in a.traces:
        results[path] = analyze(load_run_trace(path))
    if a.charts:
        for f in charts(results, a.charts):
            print(f"wrote {f}", file=sys.stderr)
    for name, res in results.items():
        out = {k: v for k, v in res.items() if not k.startswith("_")}
        if not a.by_user:
            out.pop("per_user_mean_wait_ms", None)
        print(json.dumps({name: out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
