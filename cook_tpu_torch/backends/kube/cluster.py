"""KubeCluster: the ComputeCluster over the kube controller.

Equivalent of kubernetes/compute_cluster.clj (574 LoC):
  - offers synthesized per pool from node capacity minus non-terminal
    pod requests (generate-offers :48-88);
  - launch: write the instance's expected state = STARTING with the
    built pod spec; the controller creates the pod (launch-task! :213);
  - kill: expected state = KILLED (safe for unknown tasks);
  - autoscaling via synthetic pods: unmatched pending jobs materialize
    as cheap placeholder pods that make the cluster autoscaler add
    nodes; synthetic pods never write back to the store
    (:339-409);
  - startup reconstruction: seed expected state from the store's view
    of live instances, then scan (:155-190);
  - task-id == pod-name throughout (like the reference).
"""
from __future__ import annotations

import threading
from typing import Optional

from cook_tpu_torch.backends.base import ComputeCluster, LaunchSpec, Offer
from cook_tpu_torch.backends.kube import checkpoint as cp
from cook_tpu_torch.backends.kube.api import (KubeApi, Pod, PodPhase, POOL_LABEL,
                                        SYNTHETIC_LABEL)
from cook_tpu_torch.backends.kube.controller import (ExpectedState, KubeController,
                                               PodState)
from cook_tpu_torch.state.model import InstanceStatus

MAX_SYNTHETIC_PODS = 30


class KubeCluster(ComputeCluster):
    def __init__(self, api: KubeApi, name: str = "kube",
                 max_synthetic_pods: int = MAX_SYNTHETIC_PODS,
                 synthetic_pods: bool = True,
                 default_checkpoint_config: Optional[dict] = None,
                 tolerations: Optional[list] = None,
                 priority_class: str = "",
                 synthetic_priority_class: str = "cook-synthetic-preemptible",
                 sidecar: Optional[dict] = None,
                 pool_node_selector: bool = True):
        self.name = name
        self.api = api
        self.max_synthetic = max_synthetic_pods
        self.synthetic_enabled = synthetic_pods
        # cluster-wide defaults merged under each job's checkpoint
        # config (config/kubernetes :default-checkpoint-config)
        self.default_checkpoint_config = default_checkpoint_config or {}
        # placement depth stamped on every job pod (task-metadata->pod
        # api.clj:661-882): cluster tolerations, a pool node selector,
        # and the job priority class. Synthetic autoscaling pods carry
        # their own PREEMPTIBLE priority class so a real cluster
        # autoscaler scales up for them but any real workload evicts
        # them (api.clj:29-40, :339-409).
        self.tolerations = tolerations or []
        self.priority_class = priority_class
        self.synthetic_priority_class = synthetic_priority_class
        # sidecar file-server config {"image":..., "port":...} injected
        # into every job pod so cs ls/cat/tail reach kube tasks
        self.sidecar = sidecar
        self.pool_node_selector = pool_node_selector
        self._synthetic_seq = 0
        self._lock = threading.Lock()
        self.controller = KubeController(api, self._writeback, name=name)

    # -- lifecycle -----------------------------------------------------
    def initialize(self, running_task_ids=frozenset()) -> None:
        """Startup reconstruction then watches (initialize-cluster;
        compute_cluster.clj:155-190): (1) load the live pod list into
        the actual-state map without processing, (2) seed expected
        RUNNING for every instance the store believes is live, (3) one
        reconciling scan — store-vs-pod disagreements resolve here
        (live pod → keep; missing pod → externally-deleted failure;
        orphan pod → weird-state kill), (4) subscribe to watches."""
        from cook_tpu_torch.backends.kube.controller import ExpectedDict
        with self.controller._maps_lock:
            for pod in self.api.list_pods():
                if not pod.synthetic:
                    self.controller.actual[pod.name] = pod
            for task_id in running_task_ids:
                self.controller.expected[task_id] = ExpectedDict(
                    ExpectedState.RUNNING)
        self.controller.scan()
        self.api.watch_pods(self._on_pod_event)
        self.api.watch_nodes(self._on_node_event)

    def _on_node_event(self, kind: str, node) -> None:
        # host-SET changes (adds/removals) bump the offer generation so
        # the device-resident match state rebuilds its host universe
        if kind in ("added", "deleted"):
            with self._lock:
                self.bump_offer_generation()

    def _on_pod_event(self, kind: str, pod: Pod) -> None:
        if pod.synthetic:
            self._on_synthetic_event(kind, pod)
            return
        if kind == "deleted":
            self.controller.pod_deleted(pod)
        else:
            self.controller.pod_update(pod)

    # -- protocol ------------------------------------------------------
    def pending_offers(self, pool: str) -> list[Offer]:
        """generate-offers (:48-88): capacity minus consumption per
        node; synthetic pods count as consumption so the matcher and the
        autoscaler don't double-claim the same room."""
        pods = self.api.list_pods()
        offers = []
        for node in self.api.list_nodes():
            if node.pool != pool or not node.schedulable:
                continue
            used_mem = used_cpus = used_gpus = 0.0
            for p in pods:
                if p.node == node.name and not p.terminal:
                    used_mem += p.mem
                    used_cpus += p.cpus
                    used_gpus += p.gpus
            mem = node.mem - used_mem
            cpus = node.cpus - used_cpus
            if mem <= 0 and cpus <= 0:
                continue
            offers.append(Offer(
                hostname=node.name, pool=pool, mem=mem, cpus=cpus,
                gpus=node.gpus - used_gpus,
                attributes={POOL_LABEL: node.pool, **node.labels},
                cap_mem=node.mem, cap_cpus=node.cpus, cap_gpus=node.gpus))
        return offers

    def launch_tasks(self, pool: str, specs: list[LaunchSpec]) -> None:
        for spec in specs:
            # checkpointing: env/volumes/memory-overhead materialized on
            # the pod (task-metadata->pod api.clj:598-660,:689,:724)
            ckpt = cp.effective_checkpoint_config(
                spec.checkpoint, spec.prior_failure_reasons,
                self.default_checkpoint_config)
            pod = Pod(name=spec.task_id,
                      mem=cp.adjusted_mem(spec.mem, ckpt), cpus=spec.cpus,
                      gpus=spec.gpus, node=spec.hostname, pool=pool,
                      env={**spec.env, **cp.checkpoint_env(ckpt)},
                      command=spec.command,
                      # trace context rides as a pod label through the
                      # stand-in apiserver, the k8s equivalent of the
                      # agent wire's traceparent field
                      labels={"cook-job": spec.job_uuid,
                              **({"cook-traceparent": spec.traceparent}
                                 if spec.traceparent else {})},
                      volumes=cp.checkpoint_volumes(ckpt),
                      init_uris=list(spec.uris),
                      container=spec.container,
                      tolerations=list(self.tolerations),
                      node_selector=({POOL_LABEL: pool}
                                     if self.pool_node_selector else {}),
                      priority_class=self.priority_class,
                      sidecar=dict(self.sidecar) if self.sidecar else None)
            self.controller.set_expected(spec.task_id,
                                         ExpectedState.STARTING,
                                         launch_pod=pod)

    def kill_task(self, task_id: str) -> None:
        # only flip tasks we actually track; an unconditional KILLED
        # write would resurrect completed entries (safe-kill-task)
        if task_id in self.controller.known_task_ids():
            self.controller.set_expected(task_id, ExpectedState.KILLED)

    def preempt_task(self, task_id: str) -> None:
        self.kill_task(task_id)

    def known_task_ids(self) -> set[str]:
        return self.controller.known_task_ids()

    def host_attributes(self) -> dict[str, dict[str, str]]:
        return {n.name: {POOL_LABEL: n.pool, **n.labels}
                for n in self.api.list_nodes()}

    # -- autoscaling (synthetic pods, :339-409) ------------------------
    def autoscale(self, pool: str, queue_depth: int,
                  pending_sizes: Optional[list] = None) -> None:
        """Materialize up to max_synthetic placeholder pods for
        unmatched demand.  Outstanding synthetic pods count against the
        cap; they are deleted as soon as they schedule+run (their whole
        purpose is to be unschedulable and trigger scale-up)."""
        if not self.synthetic_enabled or queue_depth <= 0:
            return
        outstanding = [p for p in self.api.list_pods()
                       if p.synthetic and p.pool == pool]
        budget = self.max_synthetic - len(outstanding)
        sizes = (pending_sizes or [(1024.0, 1.0)] * queue_depth)[:budget]
        with self._lock:
            for mem, cpus in sizes:
                self._synthetic_seq += 1
                self.api.create_pod(Pod(
                    name=f"synthetic-{self.name}-{self._synthetic_seq}",
                    mem=float(mem), cpus=float(cpus), pool=pool,
                    labels={SYNTHETIC_LABEL: "true"},
                    tolerations=list(self.tolerations),
                    node_selector=({POOL_LABEL: pool}
                                   if self.pool_node_selector else {}),
                    priority_class=self.synthetic_priority_class))

    def _on_synthetic_event(self, kind: str, pod: Pod) -> None:
        """Synthetic pods that ever start running are useless (they hold
        real capacity): delete immediately (synthetic-pod GC)."""
        if kind != "deleted" and pod.phase in (PodPhase.RUNNING,
                                               PodPhase.SUCCEEDED,
                                               PodPhase.FAILED):
            self.api.delete_pod(pod.name)

    def gc_synthetic(self, max_age_pods: int = 0) -> int:
        """Drop scheduled-but-idle synthetic pods so real workloads can
        claim the room (the reference ages them out via
        synthetic-pod-recency tracking)."""
        n = 0
        for p in self.api.list_pods():
            if p.synthetic and p.node:
                self.api.delete_pod(p.name)
                n += 1
        return n

    # -- controller writeback -----------------------------------------
    def _writeback(self, task_id: str, event: str, info: dict) -> None:
        if event == "running":
            output_url = None
            if self.sidecar:
                # the in-pod file server address: cs ls/cat/tail resolve
                # the instance's output_url to the /files API
                pod = self.controller.actual.get(task_id)
                node = getattr(pod, "node", "") if pod else ""
                if node:
                    port = int(self.sidecar.get("port", 28501))
                    output_url = f"http://{node}:{port}"
            self.emit_status(task_id, InstanceStatus.RUNNING, None,
                             output_url=output_url,
                             sandbox="/cook-sandbox" if self.sidecar
                             else None)
        elif event == "succeeded":
            self.emit_status(task_id, InstanceStatus.SUCCESS, None,
                             exit_code=info.get("exit_code", 0))
        elif event == "failed":
            self.emit_status(task_id, InstanceStatus.FAILED,
                             info.get("reason"),
                             exit_code=info.get("exit_code"))
