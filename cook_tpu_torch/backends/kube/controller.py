"""The (cook-expected-state × k8s-actual-state) controller.

Equivalent of kubernetes/controller.clj (670 LoC): an explicit state
machine over the cross product of

  expected: STARTING | RUNNING | COMPLETED | KILLED | MISSING
            (controller.clj:371-430 comment block)
  actual:   WAITING | RUNNING | SUCCEEDED | FAILED | UNKNOWN | MISSING
            (pod->synthesized-pod-state api.clj:942)

with the reference's invariants preserved:
  - terminal expected states: COMPLETED, MISSING; terminal pod states:
    SUCCEEDED, FAILED, MISSING (UNKNOWN treated as terminal);
  - status writeback happens BEFORE kubernetes mutation so restarts
    recover (controller.clj "We always update datomic first");
  - pods are deleted iff they are in a terminal/unknown state;
  - a kill racing ahead of the watch ((KILLED, MISSING) with a saved
    launch pod) opportunistically deletes the pod (controller.clj
    :456-474);
  - weird states (resurrections, rollbacks) kill the pod and log;
  - pod-name operations serialize through sharded locks
    (controller.clj:18-41, default 32 shards).

Writeback reasons: pod failed → 1003; killed → 1004; node preempted →
2003 (container-preempted, mea culpa); externally deleted/unknown →
5002 (killed-externally, mea culpa).
"""
from __future__ import annotations

import enum
import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from cook_tpu_torch.backends.kube.api import KubeApi, Pod, PodPhase

log = logging.getLogger(__name__)

NUM_LOCK_SHARDS = 32

REASON_FAILED = 1003
REASON_KILLED = 1004
REASON_PREEMPTED = 2003
REASON_EXTERNAL = 5002


class ExpectedState(str, enum.Enum):
    STARTING = "starting"
    RUNNING = "running"
    COMPLETED = "completed"
    KILLED = "killed"
    MISSING = "missing"


class PodState(str, enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    UNKNOWN = "unknown"
    MISSING = "missing"


def synthesize_pod_state(pod: Optional[Pod]) -> PodState:
    """pod->synthesized-pod-state (api.clj:942)."""
    if pod is None:
        return PodState.MISSING
    if pod.deleting:
        return PodState.MISSING
    return {
        PodPhase.PENDING: PodState.WAITING,
        PodPhase.RUNNING: PodState.RUNNING,
        PodPhase.SUCCEEDED: PodState.SUCCEEDED,
        PodPhase.FAILED: PodState.FAILED,
        PodPhase.UNKNOWN: PodState.UNKNOWN,
    }[pod.phase]


@dataclass
class ExpectedDict:
    """cook-expected-state-dict: state + the pod spec to launch."""

    state: ExpectedState
    launch_pod: Optional[Pod] = None


# writeback: (task_id, event, info) with event in
# {"running", "succeeded", "failed"}; info: reason/exit_code/preempted
StatusWriteback = Callable[[str, str, dict], None]


class KubeController:
    def __init__(self, api: KubeApi, writeback: StatusWriteback,
                 name: str = "kube", num_shards: int = NUM_LOCK_SHARDS):
        self.api = api
        self.writeback = writeback
        self.name = name
        self.expected: dict[str, ExpectedDict] = {}
        self.actual: dict[str, Optional[Pod]] = {}
        self._locks = [threading.RLock() for _ in range(num_shards)]
        self._maps_lock = threading.RLock()
        self.weird_states = 0

    def _lock_for(self, pod_name: str) -> threading.RLock:
        return self._locks[hash(pod_name) % len(self._locks)]

    # -- entry points (all take the sharded lock) ----------------------
    def set_expected(self, pod_name: str, state: ExpectedState,
                     launch_pod: Optional[Pod] = None) -> None:
        """update-cook-expected-state (controller.clj:630): scheduler
        writes intent (starting/killed), then the machine runs."""
        with self._lock_for(pod_name):
            with self._maps_lock:
                cur = self.expected.get(pod_name)
                self.expected[pod_name] = ExpectedDict(
                    state=state,
                    launch_pod=launch_pod or (cur.launch_pod if cur
                                              else None))
            self._process(pod_name)

    def pod_update(self, pod: Pod) -> None:
        """Watch callback for added/modified (pod-update :603)."""
        with self._lock_for(pod.name):
            with self._maps_lock:
                self.actual[pod.name] = pod
            self._process(pod.name)

    def pod_deleted(self, pod: Pod) -> None:
        """Watch callback for deletions (pod-deleted :614)."""
        with self._lock_for(pod.name):
            with self._maps_lock:
                self.actual[pod.name] = None
            # remember preemption marks: the vanished pod object carries it
            self._process(pod.name, vanished_pod=pod)

    def scan(self) -> None:
        """Periodic full pass over every tracked pod (scan-tasks,
        kubernetes/compute_cluster.clj:97-124)."""
        with self._maps_lock:
            names = set(self.expected) | set(self.actual)
        for name in names:
            with self._lock_for(name):
                self._process(name)

    def known_task_ids(self) -> set[str]:
        with self._maps_lock:
            return {n for n, d in self.expected.items()
                    if d.state in (ExpectedState.STARTING,
                                   ExpectedState.RUNNING)}

    # -- the machine ---------------------------------------------------
    def _process(self, pod_name: str,
                 vanished_pod: Optional[Pod] = None) -> None:
        """process (controller.clj:371-581). Must hold the shard lock."""
        while True:
            with self._maps_lock:
                exp = self.expected.get(pod_name)
                pod = self.actual.get(pod_name)
            estate = exp.state if exp else ExpectedState.MISSING
            pstate = synthesize_pod_state(pod)

            new_exp = self._step(pod_name, exp, estate, pod, pstate,
                                 vanished_pod)

            with self._maps_lock:
                if new_exp is None:
                    self.expected.pop(pod_name, None)
                    if self.actual.get(pod_name) is None:
                        self.actual.pop(pod_name, None)
                else:
                    self.expected[pod_name] = new_exp
            if new_exp is None or new_exp.state == estate:
                return
            vanished_pod = None  # only relevant on the first iteration

    def _step(self, pod_name: str, exp: Optional[ExpectedDict],
              estate: ExpectedState, pod: Optional[Pod],
              pstate: PodState,
              vanished_pod: Optional[Pod]) -> Optional[ExpectedDict]:
        E, P = ExpectedState, PodState

        if estate == E.COMPLETED:
            if pstate == P.MISSING:
                return None                      # (missing, missing) → gone
            if pstate in (P.SUCCEEDED, P.FAILED):
                self.api.delete_pod(pod_name)    # writeback already done
                return exp
            if pstate == P.UNKNOWN:
                self._weird(pod_name, estate, pstate)
                self.api.delete_pod(pod_name)
                return exp
            # running/waiting: resurrected pod — kill it
            self._weird(pod_name, estate, pstate)
            self.api.delete_pod(pod_name)
            return exp

        if estate == E.KILLED:
            if pstate == P.MISSING:
                # kill raced ahead of the watch: opportunistically delete
                # the saved launch pod (controller.clj:456-474)
                if exp and exp.launch_pod is not None:
                    self.api.delete_pod(pod_name)
                self._handle_killed(pod_name, vanished_pod)
                return ExpectedDict(E.COMPLETED)
            if pstate in (P.SUCCEEDED, P.FAILED):
                # race: completed before the kill landed
                self._handle_completed(pod_name, pod)
                return ExpectedDict(E.COMPLETED)
            if pstate == P.UNKNOWN:
                self._handle_completed(pod_name, pod, force_external=True)
                self.api.delete_pod(pod_name)
                return ExpectedDict(E.COMPLETED)
            # running/waiting: delete and wait for the watch
            self.api.delete_pod(pod_name)
            return exp

        if estate == E.RUNNING:
            if pstate == P.MISSING:
                if (pod and pod.preempted) or \
                        (vanished_pod and vanished_pod.preempted):
                    self._handle_preemption(pod_name)
                else:
                    self._handle_external_delete(pod_name)
                return ExpectedDict(E.COMPLETED)
            if pstate in (P.SUCCEEDED, P.FAILED):
                self._handle_completed(pod_name, pod)
                return ExpectedDict(E.COMPLETED)
            if pstate == P.RUNNING:
                return exp
            if pstate == P.UNKNOWN:
                self._handle_completed(pod_name, pod, force_external=True)
                self.api.delete_pod(pod_name)
                return ExpectedDict(E.COMPLETED)
            # waiting while expected running: pod rescheduled after node
            # preemption (GKE preemptible-VM pattern) — kill + preempt
            self.api.delete_pod(pod_name)
            self._handle_preemption(pod_name)
            return ExpectedDict(E.COMPLETED)

        if estate == E.STARTING:
            if pstate == P.MISSING:
                if vanished_pod is not None:
                    # deleted while starting → treat as killed
                    self._handle_killed(pod_name, vanished_pod)
                    return ExpectedDict(E.COMPLETED)
                if exp and exp.launch_pod is not None:
                    self.api.create_pod(exp.launch_pod)   # launch-pod
                    return exp
                self._weird(pod_name, estate, pstate)
                self._handle_killed(pod_name, None)
                return ExpectedDict(E.COMPLETED)
            if pstate in (P.SUCCEEDED, P.FAILED):
                self._handle_completed(pod_name, pod)     # finished fast
                return ExpectedDict(E.COMPLETED)
            if pstate == P.RUNNING:
                self._handle_started(pod_name)
                return ExpectedDict(E.RUNNING,
                                    launch_pod=exp.launch_pod if exp
                                    else None)
            if pstate == P.UNKNOWN:
                self._handle_completed(pod_name, pod, force_external=True)
                self.api.delete_pod(pod_name)
                return ExpectedDict(E.COMPLETED)
            return exp                                    # waiting: wait

        # estate == MISSING
        if pstate == P.MISSING:
            return None
        # orphan pod with no expected state (rollback / cross-instance):
        # kill it; no store writeback (nothing owns it)
        self._weird(pod_name, estate, pstate)
        self.api.delete_pod(pod_name)
        return None

    # -- writeback handlers (handle-pod-* controller.clj:283-369) ------
    def _handle_started(self, pod_name: str) -> None:
        self.writeback(pod_name, "running", {})

    def _handle_completed(self, pod_name: str, pod: Optional[Pod],
                          force_external: bool = False) -> None:
        """calculate-pod-status + write (controller.clj:247-283)."""
        if force_external or pod is None:
            self.writeback(pod_name, "failed",
                           {"reason": REASON_EXTERNAL})
            return
        if pod.phase == PodPhase.SUCCEEDED:
            self.writeback(pod_name, "succeeded",
                           {"exit_code": pod.exit_code or 0})
        else:
            self.writeback(pod_name, "failed",
                           {"reason": REASON_FAILED,
                            "exit_code": pod.exit_code})

    def _handle_killed(self, pod_name: str,
                       vanished_pod: Optional[Pod]) -> None:
        info = {"reason": REASON_KILLED}
        if vanished_pod is not None and vanished_pod.exit_code is not None:
            info["exit_code"] = vanished_pod.exit_code
        self.writeback(pod_name, "failed", info)

    def _handle_preemption(self, pod_name: str) -> None:
        """handle-pod-preemption (controller.clj:152): mea-culpa."""
        self.writeback(pod_name, "failed",
                       {"reason": REASON_PREEMPTED, "preempted": True})

    def _handle_external_delete(self, pod_name: str) -> None:
        self.writeback(pod_name, "failed", {"reason": REASON_EXTERNAL})

    def _weird(self, pod_name: str, estate, pstate) -> None:
        self.weird_states += 1
        log.warning("cluster %s: pod %s in weird state (expected=%s, "
                    "actual=%s)", self.name, pod_name, estate, pstate)
