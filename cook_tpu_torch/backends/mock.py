"""Mock compute cluster: hosts, offers, simulated task lifetimes.

Equivalent of the reference's mock Mesos driver (mesos/mesos_mock.clj):
keeps per-host resource state, synthesizes offers from spare capacity
(make-offer mesos_mock.clj:33), "runs" launched tasks for a
caller-specified duration on a virtual clock and emits completion
statuses (complete-tasks! :229, default-task->runtime-ms :320). Powers
the unit tests and the faster-than-real-time simulator
(cook_tpu/sim), like zz_simulator.clj does.
"""
from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from cook_tpu_torch.backends.base import ComputeCluster, LaunchSpec, Offer
from cook_tpu_torch.state.model import InstanceStatus


@dataclass
class MockHost:
    hostname: str
    mem: float
    cpus: float
    gpus: float = 0.0
    pool: str = "default"
    attributes: dict[str, str] = field(default_factory=dict)
    # advertised host port range, inclusive
    port_range: tuple[int, int] = (31000, 31099)


@dataclass
class _RunningTask:
    spec: LaunchSpec
    end_time: float
    success: bool = True
    reason: Optional[int] = None


class MockCluster(ComputeCluster):
    """Virtual-clock cluster. `runtime_fn(spec) -> (runtime_s, success,
    reason_code)` decides each task's fate (default: 60 s success)."""

    def __init__(self, hosts: list[MockHost], name: str = "mock",
                 runtime_fn: Optional[Callable] = None,
                 bulk_status: bool = False):
        # bulk_status: deliver clock-tick completions through the
        # batched status channel (one store txn per tick) — the
        # at-scale path; per-item default preserves the completion-
        # plugin / reservation side effects unit tests rely on
        self.bulk_status = bulk_status
        self.name = name
        self.hosts = {h.hostname: h for h in hosts}
        self.used: dict[str, list[float]] = {
            h.hostname: [0.0, 0.0, 0.0] for h in hosts}
        self.used_ports: dict[str, set[int]] = {
            h.hostname: set() for h in hosts}
        self.tasks: dict[str, _RunningTask] = {}
        self._heap: list[tuple[float, str]] = []
        self.clock = 0.0
        self.runtime_fn = runtime_fn or (lambda spec: (60.0, True, None))
        self._lock = threading.RLock()

    # -- protocol ------------------------------------------------------
    def pending_offers(self, pool: str) -> list[Offer]:
        with self._lock:
            offers = []
            for h in self.hosts.values():
                if h.pool != pool:
                    continue
                um, uc, ug = self.used[h.hostname]
                if h.mem - um <= 0 and h.cpus - uc <= 0:
                    continue
                offers.append(Offer(
                    hostname=h.hostname, pool=pool,
                    mem=h.mem - um, cpus=h.cpus - uc, gpus=h.gpus - ug,
                    attributes=dict(h.attributes),
                    cap_mem=h.mem, cap_cpus=h.cpus, cap_gpus=h.gpus,
                    ports=self._free_port_ranges(h)))
            return offers

    def _free_port_ranges(self, h: MockHost) -> list[tuple[int, int]]:
        """Advertised range minus ports held by running tasks, as
        inclusive ranges (the mesos ranges resource shape)."""
        used = self.used_ports.get(h.hostname, set())
        lo, hi = h.port_range
        ranges: list[tuple[int, int]] = []
        start = None
        for p in range(lo, hi + 2):
            if p <= hi and p not in used:
                if start is None:
                    start = p
            elif start is not None:
                ranges.append((start, p - 1))
                start = None
        return ranges

    def launch_tasks(self, pool: str, specs: list[LaunchSpec]) -> None:
        batch = []
        with self._lock:
            for spec in specs:
                host = self.hosts.get(spec.hostname)
                if host is None:
                    # ports reserved via allocate_ports for a host that
                    # vanished between match and launch must come back
                    # (symmetric with the oversubscription branch)
                    self.used_ports.get(spec.hostname,
                                        set()).difference_update(spec.ports)
                    batch.append((spec.task_id, InstanceStatus.FAILED, 5000))
                    continue
                um, uc, ug = self.used[spec.hostname]
                if (um + spec.mem > host.mem + 1e-6
                        or uc + spec.cpus > host.cpus + 1e-6
                        or ug + spec.gpus > host.gpus + 1e-6):
                    # oversubscription = launch failure; any ports
                    # reserved for this task must come back (only a
                    # STARTED task's _release returns them otherwise)
                    self.used_ports.get(spec.hostname,
                                        set()).difference_update(spec.ports)
                    batch.append((spec.task_id, InstanceStatus.FAILED,
                                  99000))
                    continue
                self.used[spec.hostname] = [um + spec.mem, uc + spec.cpus,
                                            ug + spec.gpus]
                self.used_ports[spec.hostname] |= set(spec.ports)
                runtime, success, reason = self.runtime_fn(spec)
                t = _RunningTask(spec, self.clock + runtime, success, reason)
                self.tasks[spec.task_id] = t
                heapq.heappush(self._heap, (t.end_time, spec.task_id))
                batch.append((spec.task_id, InstanceStatus.RUNNING, None))
        # one store transaction for the whole launch batch in bulk mode
        # (a per-task emit costs a durability barrier per status)
        if self.bulk_status:
            self.emit_status_bulk(batch)
        else:
            for task_id, status, reason in batch:
                self.emit_status(task_id, status, reason)

    def kill_task(self, task_id: str) -> None:
        with self._lock:
            t = self.tasks.pop(task_id, None)
            if t is None:
                return
            self._release(t.spec)
            self.emit_status(task_id, InstanceStatus.FAILED, 1004)

    def preempt_task(self, task_id: str) -> None:
        """Kill with the preemption reason (rebalancer path)."""
        with self._lock:
            t = self.tasks.pop(task_id, None)
            if t is None:
                return
            self._release(t.spec)
            self.emit_status(task_id, InstanceStatus.FAILED, 2000)

    def known_task_ids(self) -> set[str]:
        with self._lock:
            return set(self.tasks)

    def allocate_ports(self, hostname: str, n: int):
        """Reserve n free host ports for a launch (the resident match
        path assigns ports at writeback instead of carrying per-offer
        range lists). Returns the ports or None when exhausted; the
        reservation is released by _release via the launched spec."""
        with self._lock:
            h = self.hosts.get(hostname)
            if h is None:
                return None
            used = self.used_ports.setdefault(hostname, set())
            lo, hi = h.port_range
            free = [p for p in range(lo, hi + 1) if p not in used]
            if len(free) < n:
                return None
            got = free[:n]
            used.update(got)   # reserved NOW; launch_tasks re-adds them
            return got

    def release_ports(self, hostname: str, ports) -> None:
        with self._lock:
            self.used_ports.get(hostname, set()).difference_update(ports)

    def host_attributes(self) -> dict[str, dict[str, str]]:
        with self._lock:
            return {h.hostname: dict(h.attributes)
                    for h in self.hosts.values()}

    # -- virtual clock -------------------------------------------------
    def advance(self, dt: float) -> int:
        """Advance the virtual clock, completing due tasks. Returns the
        number of completions emitted."""
        with self._lock:
            self.clock += dt
            batch = []
            while self._heap and self._heap[0][0] <= self.clock:
                _, task_id = heapq.heappop(self._heap)
                t = self.tasks.pop(task_id, None)
                if t is None:
                    continue  # killed earlier
                self._release(t.spec)
                status = (InstanceStatus.SUCCESS if t.success
                          else InstanceStatus.FAILED)
                batch.append((task_id, status,
                              t.reason if not t.success else None))
        if self.bulk_status:
            self.emit_status_bulk(batch)
        else:
            for task_id, status, reason in batch:
                self.emit_status(task_id, status, reason)
        return len(batch)

    def next_completion_time(self) -> Optional[float]:
        with self._lock:
            while self._heap and self._heap[0][1] not in self.tasks:
                heapq.heappop(self._heap)
            return self._heap[0][0] if self._heap else None

    def _release(self, spec: LaunchSpec) -> None:
        if spec.hostname in self.used:
            um, uc, ug = self.used[spec.hostname]
            self.used[spec.hostname] = [um - spec.mem, uc - spec.cpus,
                                        ug - spec.gpus]
            self.used_ports[spec.hostname] -= set(spec.ports)

    # -- test helpers --------------------------------------------------
    def fail_task(self, task_id: str, reason: int = 6000) -> None:
        with self._lock:
            t = self.tasks.pop(task_id, None)
            if t is None:
                return
            self._release(t.spec)
            self.emit_status(task_id, InstanceStatus.FAILED, reason)

    def remove_host(self, hostname: str) -> list[str]:
        """Simulate host loss: running tasks there fail with host-lost."""
        with self._lock:
            dead = [tid for tid, t in self.tasks.items()
                    if t.spec.hostname == hostname]
            for tid in dead:
                t = self.tasks.pop(tid)
                self.emit_status(tid, InstanceStatus.FAILED, 5000)
            self.hosts.pop(hostname, None)
            self.used.pop(hostname, None)
            self.bump_offer_generation()
            return dead

    def add_host(self, host: MockHost) -> None:
        with self._lock:
            self.hosts[host.hostname] = host
            self.used[host.hostname] = [0.0, 0.0, 0.0]
            self.used_ports[host.hostname] = set()
            self.bump_offer_generation()
