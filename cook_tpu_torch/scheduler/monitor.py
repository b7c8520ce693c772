"""User/pool fairness gauges: running, waiting, starved, hungry,
satisfied.

Equivalent of cook.monitor (monitor.clj:60-176):
  - per (state, user, resource, pool) counters for running/waiting/
    starved resource totals, with stale-user clearing;
  - a user is STARVED when they have waiting jobs and their running
    usage is strictly below their promised share in EVERY resource
    (get-starved-job-stats :60-79); starvation amount =
    min(waiting demand, share - running);
  - HUNGRY = waiting but not starved; SATISFIED = running and nothing
    waiting.
"""
from __future__ import annotations

from typing import Optional

from cook_tpu_torch.state.limits import ShareStore, UNLIMITED
from cook_tpu_torch.state.store import JobStore
from cook_tpu_torch.utils.metrics import MetricRegistry

RESOURCES = ("mem", "cpus")


def _job_stats(jobs) -> dict[str, dict[str, float]]:
    out: dict[str, dict[str, float]] = {}
    for j in jobs:
        u = out.setdefault(j.user, {"mem": 0.0, "cpus": 0.0, "jobs": 0})
        u["mem"] += j.mem
        u["cpus"] += j.cpus
        u["jobs"] += 1
    return out


def starved_stats(running: dict, waiting: dict,
                  shares: ShareStore, pool: str) -> dict:
    out = {}
    for user, wstats in waiting.items():
        share = shares.get(user, pool)
        promised = {r: share.get(r, UNLIMITED) for r in RESOURCES}
        used = running.get(user, {})
        if all(used.get(r, 0.0) < promised[r] for r in RESOURCES):
            out[user] = {
                r: min(wstats.get(r, 0.0),
                       (promised[r] - used.get(r, 0.0))
                       if promised[r] != UNLIMITED else wstats.get(r, 0.0))
                for r in RESOURCES}
    return out


class StatsMonitor:
    """set-stats-counters! (monitor.clj:125-176) with stale clearing."""

    def __init__(self, store: JobStore, shares: ShareStore,
                 registry: MetricRegistry):
        self.store = store
        self.shares = shares
        self.registry = registry
        self._previous: dict[tuple, set] = {}

    def collect(self, pool: str = "default") -> dict:
        running_jobs = self.store.running_jobs(pool)
        waiting_jobs = self.store.pending_jobs(pool)
        running = _job_stats(running_jobs)
        waiting = _job_stats(waiting_jobs)
        starved = starved_stats(running, waiting, self.shares, pool)

        running_users = set(running)
        waiting_users = set(waiting)
        starved_users = set(starved)
        hungry_users = waiting_users - starved_users
        satisfied_users = running_users - waiting_users

        for state, stats in (("running", running), ("waiting", waiting),
                             ("starved", starved)):
            self._set_user_counters(state, stats, pool)
        for state, count in (("total", len(running_users | waiting_users)),
                             ("starved", len(starved_users)),
                             ("hungry", len(hungry_users)),
                             ("satisfied", len(satisfied_users))):
            self.registry.counter(
                f"{state}.users.pool-{pool}").set(count)
        return {"total": len(running_users | waiting_users),
                "starved": sorted(starved_users),
                "hungry": sorted(hungry_users),
                "satisfied": sorted(satisfied_users)}

    def _set_user_counters(self, state: str, stats: dict,
                           pool: str) -> None:
        """Set counters; zero out users present last round but gone now
        (clear-old-counters! monitor.clj:88-103)."""
        key = (pool, state)
        previous = self._previous.get(key, set())
        for user in previous - set(stats):
            for r in (*RESOURCES, "jobs"):
                self.registry.counter(
                    f"{state}.{user}.{r}.pool-{pool}").set(0)
        for user, ustats in stats.items():
            for r, amount in ustats.items():
                self.registry.counter(
                    f"{state}.{user}.{r}.pool-{pool}").set(amount)
        self._previous[key] = set(stats)
