"""Pluggable optimizer hook.

Equivalent of cook.scheduler.optimizer (optimizer.clj): a periodic
cycle that feeds (queue, running, offers, purchasable-host catalog) to
a pluggable Optimizer and records the suggested Schedule.  The default
implementations are no-ops, as in the reference (dummy impls
optimizer.clj:44-66); the coordinator consumes the step-0 suggestions
as scheduling hints and the autoscaler may consume host purchases.
Docs: reference scheduler/docs/optimizer.md.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger(__name__)


@dataclass
class HostType:
    """A purchasable host shape (HostFeed, optimizer.clj:33-42)."""

    name: str
    mem: float
    cpus: float
    gpus: float = 0.0
    count: int = 0


class HostFeed:
    """get-available-host-info (optimizer.clj:33)."""

    def available_hosts(self) -> list[HostType]:
        return []


class Optimizer:
    """produce-schedule (optimizer.clj:57-66): returns
    {step-seconds: {"suggested-matches": {host-type: [job uuids]},
                    "suggested-purchases": {host-type: count}}}."""

    def produce_schedule(self, queue, running, offers,
                         host_types: list[HostType]) -> dict:
        return {0: {"suggested-matches": {}, "suggested-purchases": {}}}


@dataclass
class StaticHostFeed(HostFeed):
    """A fixed purchasable-host catalog (the file/config-backed feed the
    reference leaves to operators, optimizer.clj:44-50)."""

    hosts: list = field(default_factory=list)

    def available_hosts(self) -> list[HostType]:
        return list(self.hosts)


class CapacityPlanningOptimizer(Optimizer):
    """A WORKING optimizer (the reference ships only dummies): cover the
    pending queue's unmet resource demand with purchases from the host
    catalog.

    Unmet demand = what the queue needs beyond current offers. Coverage
    is greedy by "fit density": for each host type, how many queued jobs'
    dominant demand it covers per host, preferring types that waste the
    least. Suggested purchases respect each type's available count.
    Everything stays host-side numpy-free Python — OptimizerCycle bounds
    the queue to its max_queue horizon and this runs once per 30 s.
    """

    def __init__(self, headroom: float = 1.0, max_hosts_per_cycle: int = 64):
        self.headroom = headroom          # scale demand (e.g. 1.2 = +20%)
        self.max_hosts = max_hosts_per_cycle

    def produce_schedule(self, queue, running, offers,
                         host_types: list[HostType]) -> dict:
        need_mem = sum(j.mem for j in queue)
        need_cpus = sum(j.cpus for j in queue)
        need_gpus = sum(getattr(j, "gpus", 0.0) for j in queue)
        have_mem = sum(o.mem for o in offers)
        have_cpus = sum(o.cpus for o in offers)
        have_gpus = sum(getattr(o, "gpus", 0.0) for o in offers)
        unmet = [max(0.0, need_mem * self.headroom - have_mem),
                 max(0.0, need_cpus * self.headroom - have_cpus),
                 max(0.0, need_gpus * self.headroom - have_gpus)]
        purchases: dict[str, int] = {}
        budget = self.max_hosts
        # gpu demand first (only gpu hosts can serve it), then the rest
        for want_gpu in (True, False):
            if budget <= 0 or sum(unmet) <= 0:
                break
            types = [t for t in host_types
                     if (t.gpus > 0) == want_gpu and t.count > 0
                     and (t.mem > 0 or t.cpus > 0)]
            # prefer the type covering the most unmet demand per host
            types.sort(key=lambda t: -(min(t.mem, unmet[0])
                                       + 4 * min(t.cpus, unmet[1])
                                       + 1000 * min(t.gpus, unmet[2])))
            for t in types:
                if budget <= 0:
                    break
                n = 0
                while (n < t.count and budget > 0
                       and ((want_gpu and unmet[2] > 0)
                            or (not want_gpu
                                and (unmet[0] > 0 or unmet[1] > 0)))):
                    unmet[0] = max(0.0, unmet[0] - t.mem)
                    unmet[1] = max(0.0, unmet[1] - t.cpus)
                    unmet[2] = max(0.0, unmet[2] - t.gpus)
                    n += 1
                    budget -= 1
                if n:
                    purchases[t.name] = n
        return {0: {"suggested-matches": {},
                    "suggested-purchases": purchases}}


@dataclass
class OptimizerCycle:
    """optimizer-cycle! / start-optimizer-cycles! (optimizer.clj:90-134)."""

    store: object
    clusters: object
    optimizer: Optimizer = field(default_factory=Optimizer)
    host_feed: HostFeed = field(default_factory=HostFeed)
    interval_s: float = 30.0
    # the optimizer plans for the next scheduling horizon, not the whole
    # backlog: an unbounded queue would make purchase suggestions size
    # the entire backlog (massive over-provisioning) and scan it in
    # Python every cycle
    max_queue: int = 4096
    # per-pool: one shared cycle is driven for every active pool, so a
    # single slot would leak one pool's suggestions into another's
    last_schedules: dict = field(default_factory=dict)

    def cycle(self, pool: Optional[str] = None) -> dict:
        key = pool or "default"
        queue = self.store.pending_jobs(pool)[:self.max_queue]
        running = self.store.running_jobs(pool)
        offers = []
        for cluster in self.clusters.all():
            offers.extend(cluster.pending_offers(key))
        try:
            schedule = self.optimizer.produce_schedule(
                queue, running, offers, self.host_feed.available_hosts())
        except Exception:
            log.exception("optimizer cycle failed")
            return self.last_schedules.get(key, {})
        self.last_schedules[key] = schedule
        return schedule

    def step_zero_matches(self, pool: Optional[str] = None) -> dict:
        return self.last_schedules.get(pool or "default", {}) \
            .get(0, {}).get("suggested-matches", {})
