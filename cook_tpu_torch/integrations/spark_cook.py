"""Spark-on-Cook executor provisioning.

The reference ships this as patches to Spark 1.5/1.6 adding a
`CoarseCookSchedulerBackend` inside Spark itself
(/root/reference/spark/0001-Add-cook-support-for-spark-v1.6.1.patch):
the Spark driver asks Cook for executors by submitting one Cook job per
chunk of `spark.cook.cores.per.job.max` cores; each job runs Spark's
CoarseGrainedExecutorBackend, which phones back to the driver's RPC
endpoint; failed jobs are replaced up to a failure budget; dynamic
allocation caps the job count; killing an executor aborts its job.

Patching an EOL Spark fork is not reproducible here, so this module
implements the same provisioning state machine as a standalone driver-
side component over the Python JobClient. A real Spark deployment uses
it from the driver process (spark-submit --master spark://... with a
thin ExternalClusterManager shim, or standalone via
`CookSparkBackend.start()` before creating the SparkContext against the
returned executor set). Everything below the RPC hand-shake — chunking,
replacement, dynamic allocation, abort bookkeeping — is the patch's
logic, testable against the mock backend.
"""
from __future__ import annotations

import logging
import shlex
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger(__name__)


@dataclass
class SparkConf:
    """The spark.cook.* / spark.executor.* knobs the patch reads."""

    driver_url: str                     # spark://CoarseGrainedScheduler@host:port
    app_id: str = "spark-cook"
    max_cores: int = 0                  # spark.cores.max (0 = no executors)
    cores_per_job: int = 5              # spark.cook.cores.per.job.max
    executor_memory_mb: float = 1024.0  # spark.executor.memory (+overhead)
    memory_overhead_mb: float = 384.0   # mesos MEMORY_OVERHEAD_MINIMUM
    priority: int = 75                  # spark.cook.priority
    max_failures: int = 5               # spark.executor.failures
    spark_home: str = "spark"           # unpacked distribution dir on the host
    executor_env: dict[str, str] = field(default_factory=dict)
    uris: list[dict] = field(default_factory=list)  # spark dist + conf fetches
    pool: Optional[str] = None
    keep_local_dirs: bool = False

    @property
    def total_memory_mb(self) -> float:
        """calculateTotalMemory: executor memory + overhead floor."""
        return self.executor_memory_mb + max(
            self.memory_overhead_mb, 0.10 * self.executor_memory_mb)


def executor_command(conf: SparkConf, executor_id: str, cores: int) -> str:
    """The command a Cook job runs to become a Spark executor — the
    mesosBackend.createCommand + env-export + cleanup sequence the patch
    assembles (patch lines: `val cmds = remoteConfFetch ++ environment
    ++ Seq(commandString, cleanup)`)."""
    env = {
        "SPARK_LOCAL_DIRS": "spark-temp",
        "SPARK_EXECUTOR_MEMORY": f"{int(conf.executor_memory_mb)}m",
        **conf.executor_env,
    }
    exports = [f"export {k}={shlex.quote(v)}" for k, v in sorted(env.items())]
    run = (
        f"cd {shlex.quote(conf.spark_home)} && "
        "./bin/spark-class org.apache.spark.executor.CoarseGrainedExecutorBackend"
        f" --driver-url {shlex.quote(conf.driver_url)}"
        f" --executor-id {executor_id}"
        " --hostname $(hostname)"
        f" --cores {cores}"
        f" --app-id {conf.app_id}"
    )
    # runtime opt-out via env (the reference patch honors
    # KEEP_SPARK_LOCAL_DIRS at executor exit; settable per run through
    # executor_env), on top of the submit-time keep_local_dirs switch
    cleanup = ('if [ -z "$KEEP_SPARK_LOCAL_DIRS" ]; then rm -rf '
               '$SPARK_LOCAL_DIRS; echo deleted $SPARK_LOCAL_DIRS; fi')
    cmds = exports + [run] + ([] if conf.keep_local_dirs else [cleanup])
    return "; ".join(cmds)


def core_chunks(total: int, per_job: int) -> list[int]:
    """Split a core budget into per-job chunks (createRemainingJobs's
    tail-recursive loop: full chunks, then one remainder chunk)."""
    if per_job <= 0:
        raise ValueError("cores_per_job must be positive")
    out = []
    remaining = total
    while remaining > 0:
        take = min(per_job, remaining)
        out.append(take)
        remaining -= take
    return out


@dataclass
class _ExecutorJob:
    uuid: str
    executor_id: str   # the --executor-id the process registered with
    cores: int
    aborted: bool = False


class CookSparkBackend:
    """Driver-side executor provisioner (CoarseCookSchedulerBackend).

    `client` is any object with the JobClient surface used here:
    submit_jobs(specs, pool=...) -> [uuid], query_jobs(uuids) ->
    [JobInfo], kill(*uuids). Call `poll()` periodically (or
    `start_polling()`)
    to drive completion/replacement — the role of the reference
    JobClient's 1 s status-update listener thread.
    """

    def __init__(self, client, conf: SparkConf,
                 on_executor_lost: Optional[Callable[[str], None]] = None):
        self.client = client
        self.conf = conf
        self.on_executor_lost = on_executor_lost
        self.jobs: dict[str, _ExecutorJob] = {}   # uuid -> live executor job
        self._executor_seq = 0    # monotonic: replacement ids never collide
        self.total_cores_requested = 0
        self.total_failures = 0
        # dynamic allocation: doRequestTotalExecutors caps the job count
        self.job_limit: Optional[int] = None
        self.group = None
        self._lock = threading.RLock()
        self._poller: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- provisioning --------------------------------------------------
    def current_cores_limit(self) -> int:
        """currentCoresLimit: the budget still to request, from either
        the dynamic-allocation job cap or spark.cores.max."""
        with self._lock:
            if self.job_limit is not None:
                budget = self.job_limit * self.conf.cores_per_job
            else:
                budget = self.conf.max_cores
            return budget - self.total_cores_requested

    def request_remaining_cores(self) -> list[str]:
        """Submit executor jobs until the core budget is met
        (requestRemainingCores), in ONE batched submission. Returns new
        job uuids."""
        with self._lock:
            if self.total_failures >= self.conf.max_failures:
                log.error("exceeded %d executor failures; not relaunching",
                          self.conf.max_failures)
                return []
            chunks = core_chunks(self.current_cores_limit(),
                                 self.conf.cores_per_job)
            if self.job_limit is not None:
                # the dynamic-allocation cap is an executor COUNT: never
                # exceed it even when remainder-sized live jobs leave
                # leftover core budget
                chunks = chunks[:max(0, self.job_limit - len(self.jobs))]
            if not chunks:
                return []
            specs, exec_ids = [], []
            for cores in chunks:
                self._executor_seq += 1
                exec_id = f"cook-{self._executor_seq}"
                exec_ids.append(exec_id)
                spec = {
                    "command": executor_command(self.conf, exec_id, cores),
                    "mem": self.conf.total_memory_mb, "cpus": float(cores),
                    "priority": self.conf.priority,
                    "name": f"{self.conf.app_id}-executor",
                    "env": dict(self.conf.executor_env),
                    "max_retries": 1,
                }
                if self.conf.uris:
                    spec["uris"] = self.conf.uris
                specs.append(spec)
            new = self.client.submit_jobs(specs, pool=self.conf.pool)
            for uuid, exec_id, cores in zip(new, exec_ids, chunks):
                self.jobs[uuid] = _ExecutorJob(uuid, exec_id, cores)
                self.total_cores_requested += cores
            log.info("requested %d executor jobs (%d cores total)",
                     len(new), sum(chunks))
            return new

    # -- status (CJobListener.onStatusUpdate) --------------------------
    def poll(self) -> None:
        """Query live jobs; completed ones free budget, unexpected
        failures count against the budget and trigger replacement."""
        with self._lock:
            live = list(self.jobs)
        if not live:
            return
        lost = []
        for info in self.client.query_jobs(live):
            if info.status != "completed":
                continue
            with self._lock:
                job = self.jobs.pop(info.uuid, None)
                if job is None:
                    continue
                self.total_cores_requested -= job.cores
                if job.aborted:
                    log.info("executor job %s aborted cleanly", info.uuid)
                    continue
                self.total_failures += 1
                failures = self.total_failures
            lost.append(job.executor_id)
            log.warning("executor %s (job %s) died (failure %d/%d)",
                        job.executor_id, info.uuid, failures,
                        self.conf.max_failures)
        for exec_id in lost:
            if self.on_executor_lost:
                # reported by Spark executor id so a driver shim can call
                # removeExecutor() with it
                self.on_executor_lost(exec_id)
        if lost:
            self.request_remaining_cores()

    def start_polling(self, interval_s: float = 1.0) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception:
                    log.exception("spark backend poll failed")
        self._poller = threading.Thread(target=loop, daemon=True,
                                        name="spark-cook-poll")
        self._poller.start()

    # -- dynamic allocation --------------------------------------------
    def request_total_executors(self, requested_total: int) -> bool:
        """doRequestTotalExecutors: cap the executor-job count, then
        top up to the (possibly raised) budget."""
        with self._lock:
            self.job_limit = requested_total
        self.request_remaining_cores()
        return True

    def kill_executors(self, ids: list[str]) -> bool:
        """doKillExecutors: abort the executor's job; its cores are
        released when the completed status arrives (abortJobs). Accepts
        Cook job uuids or Spark executor ids (cook-N)."""
        with self._lock:
            by_exec = {j.executor_id: u for u, j in self.jobs.items()}
            known = [by_exec.get(i, i) for i in ids
                     if i in by_exec or i in self.jobs]
            for u in known:
                self.jobs[u].aborted = True
        if known:
            self.client.kill(*known)
        return bool(known)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> list[str]:
        return self.request_remaining_cores()

    def stop(self) -> None:
        self._stop.set()
        if self._poller:
            self._poller.join(timeout=5)
        with self._lock:
            live = [u for u in self.jobs if not self.jobs[u].aborted]
            for u in live:
                self.jobs[u].aborted = True
        if live:
            self.client.kill(*live)

    def sufficient_resources_registered(self, registered_cores: int) -> bool:
        """sufficientResourcesRegistered: ready once the minimum
        registered-resources ratio of the requested cores is up. With
        nothing requested (dynamic allocation from zero) the app is
        trivially ready."""
        with self._lock:
            if self.total_cores_requested <= 0:
                return True
            return registered_cores >= 0.8 * self.total_cores_requested
