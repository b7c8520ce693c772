"""Kubernetes API model + client protocol + in-memory fake.

Equivalent of the reference's kubernetes/api.clj (1,135 LoC): pod and
node representations, watch streams with callbacks, pod CRUD, and state
synthesis (pod->synthesized-pod-state api.clj:942).  The real apiserver
client would implement KubeApi over HTTP watches; FakeKube implements
it in-memory with the same watch semantics (plus a toy cluster
autoscaler reacting to unschedulable synthetic pods, which is how the
reference's synthetic-pod autoscaling is exercised in its tests).

Synthetic pods carry the label cook-synthetic=true
(kubernetes/api.clj:29-40 cook-synthetic-pod-job-uuid-label).
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

SYNTHETIC_LABEL = "cook-synthetic"
POOL_LABEL = "cook-pool"


class PodPhase(str, enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"


@dataclass
class Pod:
    name: str
    mem: float                      # MB requested
    cpus: float
    gpus: float = 0.0
    node: str = ""                  # scheduled node ("" = unscheduled)
    phase: PodPhase = PodPhase.PENDING
    labels: dict = field(default_factory=dict)
    env: dict = field(default_factory=dict)
    command: str = ""
    exit_code: Optional[int] = None
    deleting: bool = False
    preempted: bool = False         # node-preemption mark
    pool: str = "default"
    # injected volumes/mounts (checkpointing tools volume etc.,
    # task-metadata->pod kubernetes/api.clj:598-611)
    volumes: list = field(default_factory=list)
    # FetchableURIs staged by the pod's init-container (the reference
    # renders these into the init-container spec, api.clj:661-882)
    init_uris: list = field(default_factory=list)
    # job container config: {"type": "docker", "docker": {"image": ...,
    # "network": "HOST"|..., "port-mapping": [{"host-port": ..,
    # "container-port": .., "protocol": ..}]}, "volumes": [{"host-path":
    # .., "container-path": .., "mode": "RO"|"RW"}]} — the docker
    # translation of task.clj:338-405 / pod image selection
    # api.clj:661-882; materialized onto the pod spec by pod_to_json
    container: Optional[dict] = None
    # scheduling placement depth (task-metadata->pod api.clj:661-882):
    # tolerations the cluster stamps on every job pod, the pool node
    # selector, and the pod priority class (synthetic pods get the
    # cluster's preemptible class so a REAL cluster autoscaler keys on
    # it, api.clj:29-40,:339-409)
    tolerations: list = field(default_factory=list)
    node_selector: dict = field(default_factory=dict)
    priority_class: str = ""
    # sidecar file-server spec ({"image": .., "port": ..}): the
    # reference runs its file server inside every pod
    # (sidecar/cook/sidecar/file_server.py:45, api.clj sidecar wiring)
    # so `cs ls/cat/tail` work for kube-launched tasks
    sidecar: Optional[dict] = None

    @property
    def synthetic(self) -> bool:
        return self.labels.get(SYNTHETIC_LABEL) == "true"

    @property
    def terminal(self) -> bool:
        return self.phase in (PodPhase.SUCCEEDED, PodPhase.FAILED)


@dataclass
class Node:
    name: str
    mem: float
    cpus: float
    gpus: float = 0.0
    pool: str = "default"
    labels: dict = field(default_factory=dict)
    schedulable: bool = True


# watch callback: (kind, obj) with kind in {"added","modified","deleted"}
WatchCallback = Callable[[str, object], None]


class KubeApi:
    """Client protocol (the WatchHelper + CoreV1Api surface)."""

    def list_pods(self) -> list[Pod]:
        raise NotImplementedError

    def list_nodes(self) -> list[Node]:
        raise NotImplementedError

    def create_pod(self, pod: Pod) -> None:
        raise NotImplementedError

    def delete_pod(self, name: str) -> None:
        raise NotImplementedError

    def watch_pods(self, cb: WatchCallback) -> None:
        raise NotImplementedError

    def watch_nodes(self, cb: WatchCallback) -> None:
        raise NotImplementedError


class FakeKube(KubeApi):
    """In-memory apiserver with watches and a toy autoscaler.

    Test/simulation helpers drive pod lifecycles the way kubelet would:
    schedule_pending(), start_pod(), succeed_pod(), fail_pod(),
    preempt_node(), autoscale_step().
    """

    def __init__(self, nodes: Optional[list[Node]] = None,
                 autoscaler_max_nodes: int = 0,
                 autoscaler_node_template: Optional[Node] = None):
        self.pods: dict[str, Pod] = {}
        self.nodes: dict[str, Node] = {n.name: n for n in (nodes or [])}
        self._pod_watchers: list[WatchCallback] = []
        self._node_watchers: list[WatchCallback] = []
        self._lock = threading.RLock()
        self.autoscaler_max_nodes = autoscaler_max_nodes
        self.autoscaler_node_template = autoscaler_node_template
        self._scale_count = 0

    # -- protocol ------------------------------------------------------
    def list_pods(self) -> list[Pod]:
        with self._lock:
            return list(self.pods.values())

    def list_nodes(self) -> list[Node]:
        with self._lock:
            return list(self.nodes.values())

    def create_pod(self, pod: Pod) -> None:
        with self._lock:
            if pod.name in self.pods:
                return
            self.pods[pod.name] = pod
        self._emit_pod("added", pod)

    def delete_pod(self, name: str) -> None:
        with self._lock:
            pod = self.pods.get(name)
            if pod is None:
                return
            if pod.terminal or pod.phase == PodPhase.UNKNOWN:
                del self.pods[name]
                self._emit_pod("deleted", pod)
                return
            # graceful deletion: pod enters deleting, then goes away
            pod.deleting = True
            pod.phase = PodPhase.FAILED
            pod.exit_code = pod.exit_code if pod.exit_code is not None \
                else 137
            del self.pods[name]
        self._emit_pod("deleted", pod)

    def watch_pods(self, cb: WatchCallback) -> None:
        self._pod_watchers.append(cb)

    def watch_nodes(self, cb: WatchCallback) -> None:
        self._node_watchers.append(cb)

    # -- kubelet/scheduler simulation ---------------------------------
    def _fits(self, pod: Pod, node: Node) -> bool:
        with self._lock:
            used_mem = sum(p.mem for p in self.pods.values()
                           if p.node == node.name and not p.terminal)
            used_cpus = sum(p.cpus for p in self.pods.values()
                            if p.node == node.name and not p.terminal)
        return (node.schedulable and pod.mem <= node.mem - used_mem + 1e-9
                and pod.cpus <= node.cpus - used_cpus + 1e-9
                and pod.pool == node.pool)

    def schedule_pending(self) -> int:
        """Bind unscheduled pods to nodes with room (kube-scheduler)."""
        bound = []
        with self._lock:
            pending = [p for p in self.pods.values()
                       if p.phase == PodPhase.PENDING and not p.node]
            for pod in pending:
                for node in self.nodes.values():
                    if self._fits(pod, node):
                        pod.node = node.name
                        bound.append(pod)
                        break
        # emit outside the lock: watch callbacks may take their own
        # locks (e.g. the HTTP stand-in's), and holding ours here would
        # invert the order a concurrent list request uses
        for pod in bound:
            self._emit_pod("modified", pod)
        return len(bound)

    def start_pod(self, name: str) -> None:
        """kubelet starts a scheduled pod."""
        with self._lock:
            pod = self.pods[name]
            assert pod.node, f"pod {name} is not scheduled"
            pod.phase = PodPhase.RUNNING
        self._emit_pod("modified", pod)

    def succeed_pod(self, name: str, exit_code: int = 0) -> None:
        with self._lock:
            pod = self.pods[name]
            pod.phase = PodPhase.SUCCEEDED
            pod.exit_code = exit_code
        self._emit_pod("modified", pod)

    def fail_pod(self, name: str, exit_code: int = 1) -> None:
        with self._lock:
            pod = self.pods[name]
            pod.phase = PodPhase.FAILED
            pod.exit_code = exit_code
        self._emit_pod("modified", pod)

    def mark_unknown(self, name: str) -> None:
        with self._lock:
            pod = self.pods[name]
            pod.phase = PodPhase.UNKNOWN
        self._emit_pod("modified", pod)

    def vanish_pod(self, name: str) -> None:
        """Pod disappears without a terminal phase (external deletion)."""
        with self._lock:
            pod = self.pods.pop(name, None)
        if pod is not None:
            self._emit_pod("deleted", pod)

    def preempt_node(self, node_name: str) -> list[str]:
        """Cloud preemption: node vanishes; its pods go with it, marked
        preempted."""
        with self._lock:
            node = self.nodes.pop(node_name, None)
            victims = [p for p in self.pods.values()
                       if p.node == node_name and not p.terminal]
            for pod in victims:
                pod.preempted = True
                del self.pods[pod.name]
        if node is not None:
            self._emit_node("deleted", node)
        for pod in victims:
            self._emit_pod("deleted", pod)
        return [p.name for p in victims]

    def autoscale_step(self) -> int:
        """Toy cluster autoscaler: if unschedulable pods exist and we're
        under the node cap, add a node from the template.  This is what
        the synthetic pods are designed to trigger
        (kubernetes/compute_cluster.clj:339-409)."""
        if not self.autoscaler_node_template:
            return 0
        new_nodes = []
        with self._lock:
            unschedulable = [p for p in self.pods.values()
                             if p.phase == PodPhase.PENDING and not p.node
                             and not any(self._fits(p, n)
                                         for n in self.nodes.values())]
            while unschedulable and \
                    len(self.nodes) < self.autoscaler_max_nodes:
                t = self.autoscaler_node_template
                self._scale_count += 1
                node = Node(name=f"{t.name}-as-{self._scale_count}",
                            mem=t.mem, cpus=t.cpus, gpus=t.gpus,
                            pool=t.pool)
                self.nodes[node.name] = node
                new_nodes.append(node)
                unschedulable = unschedulable[1:]
        for node in new_nodes:   # emit outside the lock (see above)
            self._emit_node("added", node)
        return len(new_nodes)

    # ------------------------------------------------------------------
    def _emit_pod(self, kind: str, pod: Pod) -> None:
        for cb in list(self._pod_watchers):
            cb(kind, pod)

    def _emit_node(self, kind: str, node: Node) -> None:
        for cb in list(self._node_watchers):
            cb(kind, node)
