"""Dask cluster backend over the cook_tpu scheduler.

Implements the reference's Dask design (dask/docs/design.md — the
reference ships only the doc): a `CookCluster` that launches dask
workers as scheduler jobs, with `scale(n)` / `adapt(min, max)` /
context-manager lifecycle, and a `CookJob` process handle per worker.

Layering:
  - The core (WorkerSpec, CookJob, CookCluster) speaks ONLY to the
    cook_tpu REST API through JobClient — fully testable against the
    in-process server + mock backend with no dask installed.
  - When `distributed` IS importable, `spec_cluster(...)` returns a
    dask `SpecCluster` wired with CookJob-backed workers, giving the
    design doc's plug-and-play flow:

        from cook_tpu_torch.integrations.dask_cook import CookCluster
        with CookCluster("http://cook:12321",
                         scheduler_addr="tcp://10.0.0.1:8786") as c:
            c.scale(20)
"""
from __future__ import annotations

import threading
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Optional

from cook_tpu_torch.client import JobClient

try:  # optional dependency
    from distributed.deploy.spec import ProcessInterface  # type: ignore
    HAVE_DISTRIBUTED = True
except Exception:  # pragma: no cover - gated on env
    ProcessInterface = object
    HAVE_DISTRIBUTED = False


@dataclass
class WorkerSpec:
    """How to run one dask worker as a cook job (design.md 'CookJob')."""

    scheduler_addr: str                 # tcp://host:port of dask scheduler
    mem: float = 4096.0
    cpus: float = 2.0
    gpus: float = 0.0
    pool: Optional[str] = None
    name: str = "dask-worker"
    worker_cmd: str = "dask-worker"
    nthreads: Optional[int] = None
    extra_args: list = field(default_factory=list)
    env: dict = field(default_factory=dict)

    def command(self) -> str:
        parts = [self.worker_cmd, self.scheduler_addr,
                 "--memory-limit", f"{int(self.mem)}MB"]
        parts += ["--nthreads", str(self.nthreads or max(int(self.cpus), 1))]
        parts += list(self.extra_args)
        return " ".join(parts)

    def job_spec(self) -> dict:
        return {"uuid": str(uuid_mod.uuid4()), "command": self.command(),
                "mem": self.mem, "cpus": self.cpus, "gpus": self.gpus,
                "name": self.name, "max_retries": 1,
                "env": dict(self.env),
                "labels": {"cook-dask-worker": "true"}}


class CookJob:
    """One dask worker's lifecycle as a cook job (the design doc's
    ProcessInterface extension)."""

    def __init__(self, client: JobClient, spec: WorkerSpec):
        self.client = client
        self.spec = spec
        self.uuid: Optional[str] = None

    def start(self) -> str:
        self.uuid = self.client.submit_jobs([self.spec.job_spec()],
                                            pool=self.spec.pool)[0]
        return self.uuid

    def status(self) -> str:
        if self.uuid is None:
            return "unstarted"
        return self.client.query(self.uuid).status

    def running(self) -> bool:
        return self.status() == "running"

    def close(self) -> None:
        if self.uuid is not None:
            try:
                self.client.kill(self.uuid)
            except Exception:
                pass


class CookCluster:
    """Manage a fleet of dask-worker jobs on a cook_tpu scheduler
    (design.md 'CookCluster'; scale/adapt mirror SpecCluster
    semantics)."""

    def __init__(self, url: str, scheduler_addr: str = "",
                 worker_spec: Optional[WorkerSpec] = None,
                 user: Optional[str] = None,
                 client: Optional[JobClient] = None):
        self.client = client or JobClient(url, user=user)
        self.spec = worker_spec or WorkerSpec(scheduler_addr=scheduler_addr)
        if scheduler_addr:
            self.spec.scheduler_addr = scheduler_addr
        self.workers: list[CookJob] = []
        self._lock = threading.Lock()

    # -- scaling -------------------------------------------------------
    def scale(self, n: int) -> None:
        """Reconcile the worker fleet to exactly n jobs: submit the
        difference or kill the newest surplus (SpecCluster.scale)."""
        with self._lock:
            # one batched status query for the whole fleet; job status is
            # waiting|running|completed (completed covers every terminal
            # job regardless of success)
            started = [w for w in self.workers if w.uuid]
            statuses = {}
            if started:
                statuses = {j.uuid: j.status for j in
                            self.client.query_jobs(w.uuid for w in started)}
            alive = [w for w in self.workers
                     if statuses.get(w.uuid) != "completed"]
            self.workers = list(alive)
            while len(alive) < n:
                job = CookJob(self.client, self.spec)
                job.start()
                self.workers.append(job)
                alive.append(job)
            surplus = alive[n:]
            if surplus:
                try:
                    self.client.kill(*[w.uuid for w in surplus if w.uuid])
                except Exception:
                    # kill failed: keep them tracked so the next
                    # scale()/close() retries instead of leaking the
                    # still-running jobs
                    return
                for w in surplus:
                    self.workers.remove(w)

    def adapt(self, minimum: int = 0, maximum: int = 10,
              queued_tasks: Optional[int] = None) -> int:
        """Dead-simple adaptive policy: one worker per queued task,
        clamped to [minimum, maximum]. dask's Adaptive drives the real
        signal when running under distributed; this keeps the same
        contract for the core. Returns the new target."""
        demand = queued_tasks if queued_tasks is not None else minimum
        target = max(minimum, min(maximum, demand))
        self.scale(target)
        return target

    def worker_uuids(self) -> list[str]:
        return [w.uuid for w in self.workers if w.uuid]

    def close(self) -> None:
        with self._lock:
            uuids = [w.uuid for w in self.workers if w.uuid]
            if uuids:
                try:
                    self.client.kill(*uuids)   # one batched kill
                except Exception:
                    pass
            self.workers.clear()

    def __enter__(self) -> "CookCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- distributed-native wrapper ---------------------------------------
def spec_cluster(url: str, scheduler_addr: str = "",
                 worker_spec: Optional[WorkerSpec] = None, n_workers: int = 0,
                 **kw):
    """A dask SpecCluster whose workers are CookJob-backed jobs.

    SpecCluster always manages its own in-process dask scheduler (that is
    its contract: scheduler=None makes it start a default `Scheduler`);
    each worker start receives that scheduler's address as the first
    positional argument and the CookJob dials it — unless
    `scheduler_addr` is given, which overrides the dial address (for
    NAT/advertised-address setups where workers must use a different
    route than the in-process listen address). For a dask scheduler run
    entirely outside this process, use `CookCluster` +
    `distributed.Client(addr)` directly.

    Requires `distributed`; raises ImportError otherwise. The `worker`
    template makes `.scale(n)` mint new CookJob workers. Cannot be
    exercised in this image (no dask); the tested core is CookCluster.
    """
    if not HAVE_DISTRIBUTED:
        raise ImportError(
            "distributed is not installed; use CookCluster directly or "
            "install dask[distributed]")
    from distributed import SpecCluster  # type: ignore

    spec = worker_spec or WorkerSpec(scheduler_addr=scheduler_addr)
    spec.scheduler_addr = scheduler_addr or spec.scheduler_addr
    client = JobClient(url)

    class _AsyncCookJob(ProcessInterface):  # pragma: no cover - needs dask
        def __init__(self, scheduler_address=None, **k):
            super().__init__()
            if not spec.scheduler_addr and scheduler_address:
                spec.scheduler_addr = scheduler_address
            self._job = CookJob(client, spec)

        async def start(self):
            self._job.start()
            await super().start()

        async def close(self):
            self._job.close()
            await super().close()

    template = {"cls": _AsyncCookJob, "options": {}}
    return SpecCluster(
        workers={i: template for i in range(n_workers)},
        worker=template,           # scale() template for new workers
        **kw)
