"""Host-side tensorization: JobStore state -> padded device arrays.

The reference walks Datomic entities each cycle (tools.clj:298-582);
we intern users to dense ids and pack SoA arrays padded to bucketed
sizes so the jitted kernels compile once per bucket, not per cycle
(the "dynamic shapes" hard part, SURVEY.md §7).
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cook_tpu_torch.state.limits import QuotaStore, ShareStore, UNLIMITED
from cook_tpu_torch.state.model import Job
from cook_tpu_torch.state.pools import DruMode

F32_MAX = np.float32(3.4e38)
MIN_BUCKET = 64


def bucket(n: int) -> int:
    """Next power-of-two >= n (>= MIN_BUCKET) so jit shapes are stable."""
    return max(MIN_BUCKET, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


class UserInterner:
    """Stable user-name -> dense id mapping for one coordinator.
    Thread-safe: the background rebuild interns from its builder thread
    while the cycle thread fills rows (two racing first-sightings of a
    user must not mint two ids)."""

    def __init__(self):
        self.ids: dict[str, int] = {}
        self._lock = threading.Lock()

    def id(self, user: str) -> int:
        i = self.ids.get(user)
        if i is None:
            with self._lock:
                i = self.ids.get(user)
                if i is None:
                    i = self.ids[user] = len(self.ids)
        return i

    def items(self) -> list:
        """Snapshot for iteration: the builder thread may insert while
        the cycle thread walks the mapping (quota arrays, rate-limit
        lanes) — iterating the live dict would raise mid-insert."""
        with self._lock:
            return list(self.ids.items())

    def size_bucket(self) -> int:
        return bucket(len(self.ids) + 1)


@dataclass
class TaskBatch:
    """Running tasks of one pool, SoA, padded."""

    user: np.ndarray
    mem: np.ndarray
    cpus: np.ndarray
    gpus: np.ndarray
    priority: np.ndarray
    start_time: np.ndarray
    host: np.ndarray           # dense host id (see HostInterner)
    valid: np.ndarray
    mem_share: np.ndarray
    cpus_share: np.ndarray
    gpu_share: np.ndarray
    task_ids: list[str] = field(default_factory=list)  # row -> task id
    job_uuids: list[str] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.task_ids)


@dataclass
class JobBatch:
    """Pending jobs of one pool, SoA, padded."""

    user: np.ndarray
    mem: np.ndarray
    cpus: np.ndarray
    gpus: np.ndarray
    priority: np.ndarray
    start_time: np.ndarray
    valid: np.ndarray
    mem_share: np.ndarray
    cpus_share: np.ndarray
    gpu_share: np.ndarray
    group: np.ndarray
    unique_group: np.ndarray
    uuids: list[str] = field(default_factory=list)
    group_names: list[Optional[str]] = field(default_factory=list)
    num_groups: int = 1

    @property
    def n(self) -> int:
        return len(self.uuids)


def share_of(shares: ShareStore, user: str, pool: str) -> tuple[float, float, float]:
    s = shares.get(user, pool)
    def cap(v):
        return float(min(v, float(F32_MAX))) if v != UNLIMITED else float(F32_MAX)
    return cap(s["mem"]), cap(s["cpus"]), cap(s["gpus"])


def tensorize_tasks(instances, shares: ShareStore, pool: str,
                    interner: UserInterner, host_ids: dict[str, int],
                    pad_to: Optional[int] = None,
                    extra_slots: int = 0) -> TaskBatch:
    """instances: list[(Instance, Job)] running in this pool."""
    n = len(instances)
    size = pad_to or bucket(n + extra_slots)
    b = TaskBatch(
        user=np.zeros(size, np.int32), mem=np.zeros(size, np.float32),
        cpus=np.zeros(size, np.float32), gpus=np.zeros(size, np.float32),
        priority=np.zeros(size, np.int32),
        start_time=np.zeros(size, np.int32),
        host=np.full(size, -1, np.int32), valid=np.zeros(size, bool),
        mem_share=np.full(size, F32_MAX), cpus_share=np.full(size, F32_MAX),
        gpu_share=np.full(size, F32_MAX),
    )
    for i, (inst, job) in enumerate(instances):
        b.user[i] = interner.id(job.user)
        b.mem[i], b.cpus[i], b.gpus[i] = job.mem, job.cpus, job.gpus
        b.priority[i] = job.priority
        # absolute seconds (mod 2^30 to stay in int32) so running tasks
        # and pending jobs share one comparator timeline
        b.start_time[i] = (inst.start_time_ms // 1000) % (2 ** 30)
        b.host[i] = host_ids.get(inst.hostname, -1)
        b.valid[i] = True
        ms, cs, gs = share_of(shares, job.user, pool)
        b.mem_share[i], b.cpus_share[i], b.gpu_share[i] = ms, cs, gs
        b.task_ids.append(inst.task_id)
        b.job_uuids.append(job.uuid)
    return b


def tensorize_jobs(jobs: list[Job], shares: ShareStore, pool: str,
                   interner: UserInterner, groups=None,
                   pad_to: Optional[int] = None,
                   mem_fn=None) -> JobBatch:
    """mem_fn(job) -> effective MB overrides the matcher-visible memory
    (checkpoint memory-overhead, adjust-job-resources
    kubernetes/api.clj:573-589 — the reference also bin-packs with the
    adjusted resources, via make-task-request)."""
    n = len(jobs)
    size = pad_to or bucket(n)
    b = JobBatch(
        user=np.zeros(size, np.int32), mem=np.zeros(size, np.float32),
        cpus=np.zeros(size, np.float32), gpus=np.zeros(size, np.float32),
        priority=np.zeros(size, np.int32),
        start_time=np.zeros(size, np.int32),
        valid=np.zeros(size, bool),
        mem_share=np.full(size, F32_MAX), cpus_share=np.full(size, F32_MAX),
        gpu_share=np.full(size, F32_MAX),
        group=np.full(size, -1, np.int32), unique_group=np.zeros(size, bool),
    )
    groups = groups or {}
    group_ids: dict[str, int] = {}
    for i, job in enumerate(jobs):
        b.user[i] = interner.id(job.user)
        b.mem[i] = mem_fn(job) if mem_fn else job.mem
        b.cpus[i], b.gpus[i] = job.cpus, job.gpus
        b.priority[i] = job.priority
        # pending jobs sort after running tasks of equal priority: use
        # submit time in seconds relative to nothing (monotonic enough)
        b.start_time[i] = (job.submit_time_ms // 1000) % (2 ** 30)
        b.valid[i] = True
        ms, cs, gs = share_of(shares, job.user, pool)
        b.mem_share[i], b.cpus_share[i], b.gpu_share[i] = ms, cs, gs
        b.uuids.append(job.uuid)
        b.group_names.append(job.group)
        if job.group is not None:
            g = groups.get(job.group)
            gid = group_ids.setdefault(job.group, len(group_ids))
            b.group[i] = gid
            if g is not None and g.host_placement.get("type") == "unique":
                b.unique_group[i] = True
    b.num_groups = max(1, len(group_ids))
    return b


def quota_arrays(quotas: QuotaStore, interner: UserInterner, pool: str,
                 size: Optional[int] = None, resources=("mem", "cpus")):
    """Per-dense-user quota arrays for the kernels. `resources` names
    the two resource lanes (gpu-mode pools pass ("gpus",) and get an
    unlimited second lane)."""
    size = size or interner.size_bucket()
    qm = np.full(size, F32_MAX, np.float32)
    qc = np.full(size, F32_MAX, np.float32)
    qn = np.full(size, 1e9, np.float32)
    for user, uid in interner.items():
        if uid >= size:
            continue
        q = quotas.get(user, pool)
        qm[uid] = min(q[resources[0]], float(F32_MAX))
        if len(resources) > 1:
            qc[uid] = min(q[resources[1]], float(F32_MAX))
        qn[uid] = min(q.get("count", UNLIMITED), 1e9)
    return qm, qc, qn
