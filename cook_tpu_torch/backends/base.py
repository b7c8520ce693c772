"""ComputeCluster protocol: the backend abstraction.

Equivalent of cook.compute-cluster (compute_cluster.clj:44-92) — the
surface between the scheduling core and concrete cluster backends
(mock/simulator, k8s-style controller). The registry mirrors
register-compute-cluster! (compute_cluster.clj:127-156).

The launch/kill atomicity rule the reference documents at length
(compute_cluster.clj:21-42 "kill-lock"): the coordinator writes the
instance transaction BEFORE calling launch_tasks, and kill_task is
always safe to call for unknown tasks (idempotent).
"""
from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from cook_tpu_torch.state.model import InstanceStatus


@dataclass
class Offer:
    """Spare capacity on one host, one pool (VirtualMachineLease
    equivalent, scheduler.clj:442-468)."""

    hostname: str
    pool: str
    mem: float
    cpus: float
    gpus: float = 0.0
    attributes: dict[str, str] = field(default_factory=dict)
    # total capacity for bin-packing fitness
    cap_mem: float = 0.0
    cap_cpus: float = 0.0
    cap_gpus: float = 0.0
    # available port ranges, inclusive (mesos-style ranges resource)
    ports: list[tuple[int, int]] = field(default_factory=list)


@dataclass
class LaunchSpec:
    """One matched task to launch."""

    task_id: str
    job_uuid: str
    hostname: str
    command: str
    mem: float
    cpus: float
    gpus: float = 0.0
    env: dict[str, str] = field(default_factory=dict)
    container: Optional[dict] = None
    progress_regex: str = ""
    progress_output_file: str = ""
    # job-level checkpointing (:job/checkpoint schema.clj:84): raw job
    # config + this job's prior failure reason names, so the backend can
    # apply the max-checkpoint-attempts cutoff (kubernetes/api.clj:642)
    checkpoint: Optional[dict] = None
    prior_failure_reasons: list[str] = field(default_factory=list)
    # host ports assigned by the matcher (also exported as PORT0..N-1
    # env, the mesos task port assignment task.clj:254-280)
    ports: list[int] = field(default_factory=list)
    # FetchableURIs to stage into the sandbox before the command runs
    uris: list[dict] = field(default_factory=list)
    # trace context for this launch ("00-<trace>-<launch span>-01");
    # agents parent their launch/run spans into it and echo it back on
    # status posts.  Empty = untraced.
    traceparent: str = ""
    # pre-encoded CKS1 wire segment (backends/specwire.py), attached by
    # the consume lane so the agent POST splices the bytes encoded once
    # at match time instead of re-encoding per host. Empty = encode on
    # demand; excluded from equality (it is a cache, not identity).
    wire_segment: bytes = field(default=b"", compare=False, repr=False)


StatusCallback = Callable[..., None]
# (task_id, status, reason_code, **extra) — extra may carry exit_code,
# sandbox (the sandbox/exit-code publisher data, mesos/sandbox.clj)


class ComputeCluster(abc.ABC):
    """Backend protocol (compute_cluster.clj:44-92)."""

    name: str = "cluster"

    @abc.abstractmethod
    def pending_offers(self, pool: str) -> list[Offer]:
        """Current spare capacity per host for `pool`."""

    @abc.abstractmethod
    def launch_tasks(self, pool: str, specs: list[LaunchSpec]) -> None:
        """Start matched tasks. Must not raise for individual task
        failures — report them through the status callback instead."""

    @abc.abstractmethod
    def kill_task(self, task_id: str) -> None:
        """Idempotent kill; unknown task ids are a no-op (safe-kill-task,
        compute_cluster.clj:94)."""

    def set_status_callback(self, cb: StatusCallback) -> None:
        self._status_cb = cb

    def set_bulk_status_callback(self, cb) -> None:
        """Optional batched channel: cb([(task_id, status, reason), ...]).
        Backends that complete many tasks at once (mock clock ticks,
        kube relists) should prefer emit_status_bulk.

        ASYNC CONTRACT: when the coordinator runs sharded status
        executors (the production server config), cb returns BEFORE the
        statuses reach the store — the batch is partitioned onto the
        same hash shards the per-item channel uses (per-task ordering
        holds across both channels) and applied as one store
        transaction per shard sub-batch, so cross-task atomicity within
        one batch is NOT guaranteed. Backends must not read store state
        right after cb and assume the batch applied; anything needing
        the applied state should go through the store's own listeners.
        Coordinator.stop() drains the shards before the store closes;
        external callers flushing mid-run must drain status_shards
        themselves."""
        self._bulk_status_cb = cb

    def emit_status(self, task_id: str, status: InstanceStatus,
                    reason: Optional[int] = None, **extra) -> None:
        cb = getattr(self, "_status_cb", None)
        if cb:
            cb(task_id, status, reason, **extra)

    def emit_status_bulk(self, updates) -> None:
        """updates: (task_id, status, reason) or (task_id, status,
        reason, extras_dict) tuples — the 4-tuple form carries the
        per-item kwargs (exit_code/sandbox/output_url) the singular
        channel passes as **extra."""
        cb = getattr(self, "_bulk_status_cb", None)
        if cb is not None:
            cb(updates)
        else:
            for upd in updates:
                extra = upd[3] if len(upd) > 3 and upd[3] else {}
                self.emit_status(upd[0], upd[1], upd[2], **extra)

    # lifecycle / recovery ------------------------------------------------
    def initialize(self) -> None:
        """Connect, start watches, reconcile state (initialize-cluster)."""

    def shutdown(self) -> None:
        pass

    def known_task_ids(self) -> set[str]:
        """For reconciliation (reconcile-tasks scheduler.clj:1041-1104)."""
        return set()

    def host_attributes(self) -> dict[str, dict[str, str]]:
        """hostname -> attribute map, for constraint evaluation off the
        offer path (the agent-attributes-cache, scheduler.clj:986-993)."""
        return {}

    def offer_generation(self, pool: str) -> int:
        """Monotonic counter the backend bumps on any host add/remove.
        The device-resident match path (scheduler/resident.py) polls it
        each cycle and rebuilds its host universe when it moved — a
        backend that never bumps would leave a resident pool matching
        onto a stale host set for up to resync_interval cycles."""
        return getattr(self, "_offer_gen", 0)

    def bump_offer_generation(self) -> None:
        self._offer_gen = getattr(self, "_offer_gen", 0) + 1

    def autoscale(self, pool: str, queue_depth: int,
                  pending_sizes: Optional[list] = None) -> None:
        """Hook for synthetic-pod style autoscaling (autoscale!,
        kubernetes/compute_cluster.clj:339-409). pending_sizes carries
        (mem, cpus) of the unmatched queue head so scale-up requests are
        representative."""


class ClusterRegistry:
    """register-compute-cluster! / compute-cluster-name->ComputeCluster
    (compute_cluster.clj:127-156)."""

    def __init__(self):
        self._clusters: dict[str, ComputeCluster] = {}
        self._lock = threading.Lock()

    def register(self, cluster: ComputeCluster) -> None:
        with self._lock:
            if cluster.name in self._clusters:
                raise ValueError(f"cluster {cluster.name} already registered")
            self._clusters[cluster.name] = cluster

    def get(self, name: str) -> ComputeCluster:
        return self._clusters[name]

    def all(self) -> list[ComputeCluster]:
        with self._lock:
            return list(self._clusters.values())
