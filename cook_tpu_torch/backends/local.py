"""Local-execution backend: actually runs job commands on this host.

The single-node equivalent of the reference's executor-under-Mesos-agent
path (executor/cook/executor.py wired through
mesos_compute_cluster.clj): a ComputeCluster whose launch_tasks hands
specs to an in-process agent Executor, with

  - real subprocesses in sandboxes (stdout/stderr files),
  - exit-code → status mapping (0 → success; non-zero → failed 1003;
    killed → 1004) like executor status reporting,
  - progress-regex updates flowing into the ProgressAggregator,
  - heartbeats into the HeartbeatWatcher,
  - a sidecar FileServer exposing /files/* over the sandbox root.

Capacity is declared, not enforced: offers advertise (mem, cpus) minus
what launched tasks claim, like a Mesos agent's resource accounting.
"""
from __future__ import annotations

import socket
import threading
from typing import Optional

from cook_tpu_torch.agent.executor import Executor
from cook_tpu_torch.agent.file_server import FileServer
from cook_tpu_torch.backends.base import ComputeCluster, LaunchSpec, Offer
from cook_tpu_torch.state.model import InstanceStatus


class LocalCluster(ComputeCluster):
    def __init__(self, sandbox_root: str, name: str = "local",
                 mem: float = 8192.0, cpus: float = 8.0,
                 pool: str = "default", hostname: Optional[str] = None,
                 file_server_port: int = 0,
                 progress_aggregator=None, heartbeats=None,
                 heartbeat_interval_s: float = 15.0):
        self.name = name
        self.hostname = hostname or socket.gethostname()
        self.pool = pool
        self.mem = mem
        self.cpus = cpus
        self.progress = progress_aggregator
        self.heartbeats = heartbeats
        self._specs: dict[str, LaunchSpec] = {}
        self._lock = threading.Lock()
        self.executor = Executor(
            sandbox_root,
            on_status=self._on_exec_status,
            on_progress=self._on_progress,
            on_heartbeat=self._on_heartbeat,
            heartbeat_interval_s=heartbeat_interval_s)
        self.file_server = FileServer(sandbox_root, port=file_server_port)
        # :instance/output-url equivalent: where this host's sandboxes
        # are served (port is bound at construction)
        self._output_url = f"http://{self.hostname}:{self.file_server.port}"

    # -- protocol ------------------------------------------------------
    def initialize(self) -> None:
        self.file_server.start()

    def shutdown(self) -> None:
        for tid in list(self.executor.alive_task_ids()):
            self.executor.kill(tid)
        self.file_server.stop()

    def pending_offers(self, pool: str) -> list[Offer]:
        if pool != self.pool:
            return []
        with self._lock:
            used_mem = sum(s.mem for s in self._specs.values())
            used_cpus = sum(s.cpus for s in self._specs.values())
        mem = self.mem - used_mem
        cpus = self.cpus - used_cpus
        if mem <= 0 and cpus <= 0:
            return []
        return [Offer(hostname=self.hostname, pool=pool, mem=mem, cpus=cpus,
                      cap_mem=self.mem, cap_cpus=self.cpus)]

    def launch_tasks(self, pool: str, specs: list[LaunchSpec]) -> None:
        for spec in specs:
            with self._lock:
                self._specs[spec.task_id] = spec
            try:
                self.executor.launch(
                    spec.task_id, spec.command, env=spec.env,
                    progress_regex=spec.progress_regex,
                    progress_output_file=spec.progress_output_file,
                    uris=spec.uris)
            except OSError:
                with self._lock:
                    self._specs.pop(spec.task_id, None)
                self.emit_status(spec.task_id, InstanceStatus.FAILED, 99003)

    def kill_task(self, task_id: str) -> None:
        self.executor.kill(task_id)

    def known_task_ids(self) -> set[str]:
        with self._lock:
            return set(self._specs)

    def host_attributes(self) -> dict[str, dict[str, str]]:
        return {self.hostname: {"backend": "local"}}

    # -- agent callbacks ----------------------------------------------
    def _on_exec_status(self, task_id: str, event: str, info: dict) -> None:
        sandbox = info.get("sandbox", "")
        if event == "running":
            self.emit_status(task_id, InstanceStatus.RUNNING, None,
                             sandbox=sandbox,
                             output_url=self._output_url)
            return
        if event == "fetch_failed":
            with self._lock:
                self._specs.pop(task_id, None)
            if self.heartbeats is not None:
                self.heartbeats.untrack(task_id)
            self.emit_status(task_id, InstanceStatus.FAILED, 99003,
                             sandbox=sandbox,
                             output_url=self._output_url)
            return
        with self._lock:
            self._specs.pop(task_id, None)
        if self.heartbeats is not None:
            self.heartbeats.untrack(task_id)
        exit_code = info.get("exit_code")
        if event == "killed":
            self.emit_status(task_id, InstanceStatus.FAILED, 1004,
                             exit_code=exit_code, sandbox=sandbox,
                             output_url=self._output_url)
        elif exit_code == 0:
            self.emit_status(task_id, InstanceStatus.SUCCESS, None,
                             exit_code=0, sandbox=sandbox,
                             output_url=self._output_url)
        else:
            self.emit_status(task_id, InstanceStatus.FAILED, 1003,
                             exit_code=exit_code, sandbox=sandbox,
                             output_url=self._output_url)

    def _on_progress(self, task_id: str, sequence: int, percent: int,
                     message: str) -> None:
        if self.progress is not None:
            self.progress.handle(task_id, sequence, percent, message)

    def _on_heartbeat(self, task_id: str) -> None:
        if self.heartbeats is not None:
            self.heartbeats.notify(task_id)
