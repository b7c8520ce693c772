"""Randomized trace generation, the analog of the system simulator's
schedule generator (simulator/src/main/cook/sim/schedule.clj:134
generate-job-schedule!): N users submitting jobs over a window with
log-normal-ish runtimes and mixed resource shapes. Deterministic by
seed so two framework versions can replay identical traces
(simulator.md "two simulations should only be compared if all inputs
were the same")."""
from __future__ import annotations

import json
import uuid

import numpy as np


def generate_trace(n_jobs: int = 1000, n_users: int = 10,
                   submit_window_ms: int = 3_600_000,
                   mean_runtime_ms: int = 600_000,
                   fail_fraction: float = 0.05,
                   seed: int = 0, diurnal: bool = False) -> list[dict]:
    """diurnal=True replaces the uniform arrival process with a
    production-day shape: two workday bursts (morning and
    mid-afternoon peaks) over a background floor — the arrival pattern
    the crash soak replays at compressed timescale."""
    rng = np.random.default_rng(seed)
    users = [chr(ord("a") + i % 26) + (str(i // 26) if i >= 26 else "")
             for i in range(n_users)]

    def submit_time() -> int:
        if not diurnal:
            return int(rng.integers(submit_window_ms))
        r = rng.random()
        if r < 0.45:            # morning burst
            t = rng.normal(0.33 * submit_window_ms,
                           0.07 * submit_window_ms)
        elif r < 0.90:          # afternoon burst
            t = rng.normal(0.68 * submit_window_ms,
                           0.07 * submit_window_ms)
        else:                   # overnight/background floor
            t = rng.uniform(0, submit_window_ms)
        return int(min(max(t, 0), submit_window_ms - 1))

    jobs = []
    for _ in range(n_jobs):
        runtime = int(rng.lognormal(np.log(mean_runtime_ms), 0.8))
        status = "failed" if rng.random() < fail_fraction else "finished"
        jobs.append({
            "job/uuid": str(uuid.UUID(bytes=rng.bytes(16), version=4)),
            "job/user": users[int(rng.integers(n_users))],
            "job/name": "simjob",
            "job/command": "sleep 10",
            "job/priority": int(rng.choice([25, 50, 75])),
            "job/max-retries": 3,
            "job/max-runtime": 86_400_000,
            "job/disable-mea-culpa-retries": False,
            "submit-time-ms": submit_time(),
            "run-time-ms": max(runtime, 1000),
            "status": status,
            "job/resource": [
                {"resource/type": "resource.type/cpus",
                 "resource/amount": float(rng.choice([1.0, 2.0, 4.0]))},
                {"resource/type": "resource.type/mem",
                 "resource/amount": float(rng.choice([512.0, 2048.0,
                                                      4096.0]))},
            ],
        })
    return jobs


def generate_hosts(n_hosts: int = 20, cpus: float = 20.0,
                   mem: float = 20_000.0) -> list[dict]:
    """Uniform fleet like example-hosts.json (20-cpu/20 GB hosts)."""
    return [{"hostname": str(i), "attributes": {},
             "resources": {"cpus": {"*": cpus}, "mem": {"*": mem}}}
            for i in range(n_hosts)]


def generate_churn_schedule(seed: int, hostnames: list,
                            duration_s: float, **kw):
    """Agent-churn schedule for a generated fleet: a thin re-export of
    :func:`cook_tpu.chaos.churn.generate_churn` so a soak's three
    deterministic inputs — trace, fleet, churn — all come from this
    module with one seed. Keyword args pass through (events_per_agent,
    kill_fraction, per-action down windows)."""
    from cook_tpu_torch.chaos.churn import generate_churn
    return generate_churn(seed, hostnames, duration_s, **kw)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="generate a simulator trace")
    p.add_argument("--jobs", type=int, default=1000)
    p.add_argument("--users", type=int, default=10)
    p.add_argument("--hosts", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace-out", required=True)
    p.add_argument("--hosts-out", required=True)
    p.add_argument("--churn-out", default=None,
                   help="also write an agent-churn JSONL schedule "
                        "for the generated fleet")
    p.add_argument("--churn-duration-s", type=float, default=60.0)
    a = p.parse_args(argv)
    with open(a.trace_out, "w") as f:
        json.dump(generate_trace(a.jobs, a.users, seed=a.seed), f, indent=1)
    with open(a.hosts_out, "w") as f:
        json.dump(generate_hosts(a.hosts), f, indent=1)
    print(f"wrote {a.jobs} jobs -> {a.trace_out}, "
          f"{a.hosts} hosts -> {a.hosts_out}")
    if a.churn_out:
        sched = generate_churn_schedule(
            a.seed, [str(i) for i in range(a.hosts)], a.churn_duration_s)
        n = sched.save(a.churn_out)
        print(f"wrote {n} churn events -> {a.churn_out}")


if __name__ == "__main__":
    main()
