"""Faster-than-real-time scheduler simulator.

Equivalent of the reference's zz_simulator
(scheduler/test/cook/test/zz_simulator.clj + scheduler/docs/simulator.md):
a JSON trace of jobs (reference trace-file format, simulator.md "Inputs")
and a hosts file are replayed through the REAL coordinator — rank/match
kernels, rebalancer, watchdogs — against the mock backend on a virtual
clock. Time is frozen during each cycle (simulator.md "time is
effectively frozen while each operation is happening"), so two runs with
the same inputs compare *scheduling decisions*, not wall-clock speed.

Output is a run-trace CSV, one row per task, with the reference's
columns (zz_simulator.clj:42-43 field list, dump-jobs-to-csv :223), plus
a JSON summary of wait/turnaround/preemption statistics in the spirit of
the system simulator's reports (simulator/src/main/cook/sim/
reporting.clj:156-325).

CLI: python -m cook_tpu_torch.sim --trace-file T --host-file H \
         --out-trace-file OUT.csv [--cycle-step-ms N] [--config-file C]
         [--device cuda|cpu]

A port of cook_tpu/sim: the simulator is the reference's, and its
coordinator runs the match and rebalance cycles on `device` ("cuda"
unless asked for the CPU; it raises without a card).
"""
from __future__ import annotations

import csv
import json
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cook_tpu_torch.backends.base import ClusterRegistry
from cook_tpu_torch.backends.mock import MockCluster, MockHost
from cook_tpu_torch.scheduler.coordinator import (Coordinator, RebalancerParams,
                                            SchedulerConfig)
from cook_tpu_torch.state import model
from cook_tpu_torch.state.limits import QuotaStore, ShareStore
from cook_tpu_torch.state.model import (REASON_BY_CODE, InstanceStatus, Job,
                                  JobState)
from cook_tpu_torch.state.store import JobStore

# trace "status" values (simulator.md) -> (success, failure reason code)
STATUS_MAP = {
    "finished": (True, None),
    "failed": (False, 1003),    # command-executor-failed
    "killed": (False, 1004),    # task-killed-by-user
    "lost": (False, 5000),      # host-lost (mea culpa)
    "error": (False, 6000),     # unknown
}


@dataclass
class TraceJob:
    job: Job
    submit_time_ms: int
    run_time_ms: int
    success: bool
    reason: Optional[int]


def load_trace(path: str) -> list[TraceJob]:
    """Parse the reference trace-file format (simulator.md trace keys;
    example simulator_files/example-trace.json)."""
    with open(path) as f:
        raw = json.load(f)
    return parse_trace(raw)


def parse_trace(raw: list[dict]) -> list[TraceJob]:
    out = []
    for r in raw:
        res = {d["resource/type"].split("/")[-1]: float(d["resource/amount"])
               for d in r.get("job/resource", [])}
        status = r.get("status", "finished")
        if status not in STATUS_MAP:
            raise ValueError(
                f"job {r.get('job/uuid')}: unknown status {status!r} "
                f"(expected one of {sorted(STATUS_MAP)})")
        success, reason = STATUS_MAP[status]
        job = Job(
            uuid=r["job/uuid"], user=r["job/user"],
            command=r.get("job/command", "sim"),
            mem=res.get("mem", 0.0), cpus=res.get("cpus", 0.0),
            gpus=res.get("gpus", 0.0),
            name=r.get("job/name", "simjob"),
            priority=int(r.get("job/priority", 50)),
            max_retries=int(r.get("job/max-retries", 1)),
            max_runtime_ms=int(r.get("job/max-runtime", 2 ** 53)),
            expected_runtime_ms=r.get("job/expected-runtime"),
            group=r.get("job/group"),
            disable_mea_culpa_retries=bool(
                r.get("job/disable-mea-culpa-retries", False)),
            labels={"JOB-RUNTIME": str(r["run-time-ms"]),
                    "JOB-STATUS": r.get("status", "finished")},
        )
        out.append(TraceJob(job=job,
                            submit_time_ms=int(r["submit-time-ms"]),
                            run_time_ms=int(r["run-time-ms"]),
                            success=success, reason=reason))
    # normalize: shift so the earliest submit lands at t=0 (simulator.md:
    # "shifting all the jobs submit times ... will not affect the sim")
    if out:
        t0 = min(t.submit_time_ms for t in out)
        for t in out:
            t.submit_time_ms -= t0
    return sorted(out, key=lambda t: t.submit_time_ms)


def load_hosts(path: str) -> list[MockHost]:
    """Parse the reference host-file format (simulator.md host keys;
    example simulator_files/example-hosts.json)."""
    with open(path) as f:
        raw = json.load(f)
    return parse_hosts(raw)


def parse_hosts(raw: list[dict]) -> list[MockHost]:
    hosts = []
    for r in raw:
        res = r.get("resources", {})

        def scalar(key):
            v = res.get(key, {})
            return float(sum(x for x in v.values()
                             if isinstance(x, (int, float))))
        hosts.append(MockHost(
            hostname=str(r["hostname"]),
            mem=scalar("mem"), cpus=scalar("cpus"), gpus=scalar("gpus"),
            pool=r.get("pool", "default"),
            attributes={k: str(v)
                        for k, v in r.get("attributes", {}).items()}))
    return hosts


@dataclass
class SimConfig:
    cycle_step_ms: int = 30_000
    rebalance_interval_ms: int = 300_000
    max_sim_time_ms: int = 2 ** 53
    shares: list = field(default_factory=list)   # [{user, mem, cpus, gpus}]
    quotas: list = field(default_factory=list)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    @classmethod
    def from_file(cls, path: str) -> "SimConfig":
        with open(path) as f:
            raw = json.load(f)
        cfg = cls()
        cfg.cycle_step_ms = int(raw.get("cycle-step-ms", cfg.cycle_step_ms))
        cfg.rebalance_interval_ms = int(
            raw.get("rebalance-interval-ms", cfg.rebalance_interval_ms))
        cfg.max_sim_time_ms = int(
            raw.get("max-sim-time-ms", cfg.max_sim_time_ms))
        cfg.shares = raw.get("shares", [])
        cfg.quotas = raw.get("quotas", [])
        sched = raw.get("scheduler-config", {})
        for k, v in sched.items():
            key = k.replace("-", "_")
            if key == "rebalancer":
                cfg.scheduler.rebalancer = RebalancerParams(
                    **{rk.replace("-", "_"): rv for rk, rv in v.items()})
            elif hasattr(cfg.scheduler, key):
                setattr(cfg.scheduler, key, v)
        return cfg


class Simulator:
    """Drives the full leader path on a virtual clock (zz_simulator
    simulate :350): per cycle — submit due jobs, deliver completions,
    rank+match, periodically rebalance, run watchdogs."""

    def __init__(self, trace: list[TraceJob], hosts: list[MockHost],
                 config: Optional[SimConfig] = None, device="cuda"):
        self.trace = trace
        self.config = config or SimConfig()
        self.now_ms = 0

        fates = {t.job.uuid: t for t in trace}

        def runtime_fn(spec):
            t = fates[spec.job_uuid]
            return (t.run_time_ms / 1000.0, t.success, t.reason)

        self.store = JobStore()
        self.cluster = MockCluster(hosts, runtime_fn=runtime_fn)
        reg = ClusterRegistry()
        reg.register(self.cluster)
        shares = ShareStore()
        for s in self.config.shares:
            shares.set(s["user"], s.get("pool", "default"),
                       **{k: v for k, v in s.items()
                          if k in ("mem", "cpus", "gpus")})
        quotas = QuotaStore()
        for q in self.config.quotas:
            quotas.set(q["user"], q.get("pool", "default"),
                       **{k: v for k, v in q.items()
                          if k in ("mem", "cpus", "gpus", "count")})
        self.coord = Coordinator(self.store, reg, shares=shares,
                                 quotas=quotas, config=self.config.scheduler,
                                 device=device)
        self.cycles = 0
        self.preemptions = 0

    def run(self, progress_every: int = 0) -> dict:
        """Run the trace to completion (or max-sim-time). Returns the
        summary dict."""
        try:
            # virtual clock is installed only for the duration of the
            # run so a constructed-but-unrun Simulator can't freeze the
            # process-global time source
            model.set_clock(lambda: self.now_ms / 1000.0)
            return self._run(progress_every)
        finally:
            model.reset_clock()

    def _run(self, progress_every: int) -> dict:
        cfg = self.config
        step = cfg.cycle_step_ms
        next_rebalance = cfg.rebalance_interval_ms
        i = 0   # next trace job to submit
        idle_cycles = 0   # stall detection: unplaceable leftovers
        while True:
            # 1. submit jobs that are due (runner.clj-style trace feed)
            due = []
            while i < len(self.trace) and \
                    self.trace[i].submit_time_ms <= self.now_ms:
                tj = self.trace[i]
                tj.job.submit_time_ms = tj.submit_time_ms
                due.append(tj.job)
                i += 1
            if due:
                self.store.create_jobs(due)
            # 2. deliver completions due by now (mock virtual clock)
            self.cluster.advance(self.now_ms / 1000.0 - self.cluster.clock)
            # 3. schedule (rank is fused into the match kernel)
            self.coord.match_cycle()
            # 4. rebalance on its own cadence (config.clj:386)
            if self.now_ms >= next_rebalance:
                res = self.coord.rebalance_cycle()
                self.preemptions += res.get("preempted", 0)
                next_rebalance += cfg.rebalance_interval_ms
            # 5. watchdogs on virtual time (lingering/straggler killers)
            self.coord.watchdog_cycle(wall_ms=self.now_ms)
            self.cycles += 1
            if progress_every and self.cycles % progress_every == 0:
                done = sum(1 for t in self.trace
                           if t.job.state == JobState.COMPLETED)
                print(f"t={self.now_ms / 1000.0:.0f}s cycle={self.cycles} "
                      f"submitted={i}/{len(self.trace)} done={done}")
            if i >= len(self.trace) and self._all_done():
                break
            if self.now_ms >= cfg.max_sim_time_ms:
                break
            # stall: trace exhausted, nothing running, nothing matching
            # (leftover jobs don't fit any host) — no future event can
            # change the outcome, so stop rather than spin to max-time.
            if i >= len(self.trace) and not self.cluster.tasks \
                    and self.cluster.next_completion_time() is None:
                idle_cycles += 1
                if idle_cycles >= 3:
                    break
            else:
                idle_cycles = 0
            self.now_ms += step
        return self.summary()

    def _all_done(self) -> bool:
        return all(t.job.state == JobState.COMPLETED for t in self.trace)

    # -- outputs -------------------------------------------------------
    RUN_TRACE_COLUMNS = [
        "job_id", "instance_id", "group_id", "submit_time_ms",
        "start_time_ms", "end_time_ms", "hostname", "backend", "status",
        "reason", "user", "mem", "cpus", "job_name", "requested_run_time",
        "expected_run_time", "requested_status", "preempted",
    ]

    def run_trace_rows(self) -> list[dict]:
        """One row per task, reference column set (zz_simulator.clj:42,
        generate-task-trace-map :190-223)."""
        rows = []
        for t in self.trace:
            job = t.job
            for inst in job.instances:
                reason = ""
                if inst.status == InstanceStatus.FAILED and \
                        inst.reason_code is not None:
                    r = REASON_BY_CODE.get(inst.reason_code)
                    reason = r.string if r else str(inst.reason_code)
                rows.append({
                    "job_id": job.uuid, "instance_id": inst.task_id,
                    "group_id": job.group or "",
                    "submit_time_ms": job.submit_time_ms,
                    "start_time_ms": inst.start_time_ms,
                    "end_time_ms": inst.end_time_ms
                    if inst.end_time_ms is not None else self.now_ms,
                    "hostname": inst.hostname, "backend": inst.backend,
                    "status": inst.status.value, "reason": reason,
                    "user": job.user, "mem": job.mem, "cpus": job.cpus,
                    "job_name": job.name,
                    "requested_run_time": job.labels.get("JOB-RUNTIME", ""),
                    "expected_run_time": job.expected_runtime_ms or "",
                    "requested_status": job.labels.get("JOB-STATUS", ""),
                    "preempted": int(inst.preempted),
                })
        return rows

    def write_run_trace(self, path: str) -> int:
        rows = self.run_trace_rows()
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.RUN_TRACE_COLUMNS)
            w.writeheader()
            w.writerows(rows)
        return len(rows)

    def summary(self) -> dict:
        """Wait/turnaround/preemption statistics (reporting.clj:156-325
        analysis set)."""
        waits, turnarounds, overheads = [], [], []
        completed = succeeded = 0
        per_user: dict[str, dict] = {}
        for t in self.trace:
            job = t.job
            started = [i for i in job.instances if i.start_time_ms
                       is not None]
            if job.state == JobState.COMPLETED:
                completed += 1
                if job.success:
                    succeeded += 1
            if not started:
                continue
            first = min(i.start_time_ms for i in started)
            wait = first - job.submit_time_ms
            waits.append(wait)
            u = per_user.setdefault(job.user, {"jobs": 0, "waits": []})
            u["jobs"] += 1
            u["waits"].append(wait)
            ends = [i.end_time_ms for i in job.instances
                    if i.end_time_ms is not None]
            if ends and job.state == JobState.COMPLETED:
                ta = max(ends) - job.submit_time_ms
                turnarounds.append(ta)
                overheads.append(ta - t.run_time_ms)

        def stats(xs):
            if not xs:
                return {}
            a = np.asarray(xs, np.float64)
            return {"mean": float(a.mean()), "p50": float(np.median(a)),
                    "p95": float(np.quantile(a, 0.95)),
                    "max": float(a.max())}
        return {
            "jobs": len(self.trace), "completed": completed,
            "succeeded": succeeded, "cycles": self.cycles,
            "sim_time_ms": self.now_ms, "preemptions": self.preemptions,
            "wait_ms": stats(waits), "turnaround_ms": stats(turnarounds),
            "overhead_ms": stats(overheads),
            "per_user": {u: {"jobs": d["jobs"],
                             "mean_wait_ms": float(np.mean(d["waits"]))}
                         for u, d in sorted(per_user.items())},
        }
