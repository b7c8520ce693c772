"""Core data model: jobs, instances, groups, reasons.

Host-side equivalent of the reference's Datomic schema (schema.clj):
  job attributes          schema.clj:23-203
  instance attributes     schema.clj:585-708
  group attributes        schema.clj:205-234
  failure reasons         schema.clj:762-790 + seed data :1237+

State machines (enforced by state.store transaction functions, the
analog of Datomic transaction functions :instance/update-state
schema.clj:1103 and :job/update-state :1065):

  instance: unknown -> running -> {success, failed}
            unknown -> {success, failed}         (terminal is immutable)
  job:      waiting <-> running -> completed

Failures carry a reason code; mea-culpa reasons (system's fault:
preemption, host lost, ...) do not consume user retries up to a
per-reason limit (schema.clj:1018-1062).
"""
from __future__ import annotations

import enum
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Any, Optional


class JobState(str, enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    COMPLETED = "completed"


class InstanceStatus(str, enum.Enum):
    UNKNOWN = "unknown"
    RUNNING = "running"
    SUCCESS = "success"
    FAILED = "failed"


# legal instance transitions (schema.clj:1119-1124 equivalent)
VALID_INSTANCE_TRANSITIONS = {
    InstanceStatus.UNKNOWN: {InstanceStatus.RUNNING, InstanceStatus.SUCCESS,
                             InstanceStatus.FAILED},
    InstanceStatus.RUNNING: {InstanceStatus.SUCCESS, InstanceStatus.FAILED},
    InstanceStatus.SUCCESS: set(),
    InstanceStatus.FAILED: set(),
}


@dataclass
class Reason:
    """A failure reason (reason entity, schema.clj:762-790)."""

    code: int
    name: str
    string: str
    mea_culpa: bool = False
    # default per-job free retries for this mea-culpa reason; None =
    # unlimited free retries (failure-limit, schema.clj:1018-1062)
    failure_limit: Optional[int] = None


# Seeded reason table (subset of the reference's seed data with the same
# codes/meanings, schema.clj:1237+ / reason entities).
REASONS = [
    Reason(1000, "normal-exit", "Normal exit"),
    Reason(1003, "command-executor-failed", "Command exited non-zero"),
    Reason(1004, "task-killed-by-user", "Task killed by user"),
    Reason(2000, "preempted-by-rebalancer", "Preempted to rebalance cluster",
           mea_culpa=True, failure_limit=None),
    Reason(2001, "preempted-by-user", "Preempted by user"),
    Reason(2002, "killed-during-launch", "Killed during launch",
           mea_culpa=True, failure_limit=None),
    Reason(2003, "container-preempted", "Container preempted",
           mea_culpa=True, failure_limit=None),
    Reason(3000, "heartbeat-lost", "Heartbeat lost", mea_culpa=True,
           failure_limit=3),
    Reason(4000, "max-runtime-exceeded", "Max runtime exceeded"),
    Reason(4001, "straggler", "Killed as straggler", mea_culpa=True,
           failure_limit=None),
    Reason(5000, "host-lost", "Host lost", mea_culpa=True, failure_limit=3),
    Reason(5001, "executor-unregistered", "Executor unregistered",
           mea_culpa=True, failure_limit=3),
    Reason(5002, "killed-externally", "Container killed externally",
           mea_culpa=True, failure_limit=3),
    # cook_tpu extension (no reference equivalent; PARITY.md §5): the
    # coordinator's launch-ack watchdog fails an instance that was
    # launched but never acknowledged RUNNING within
    # launch_ack_timeout_s — the backend swallowed the task. Mea-culpa:
    # the user's command never ran, so the retry must be free (bounded,
    # like host-lost, so a systematically black-holing cluster cannot
    # retry forever).
    Reason(5003, "launch-ack-timeout", "Launch not acknowledged in time",
           mea_culpa=True, failure_limit=3),
    Reason(6000, "unknown", "Unknown failure"),
    Reason(99000, "scheduling-failed", "Could not launch task",
           mea_culpa=True, failure_limit=None),
    Reason(99003, "container-launch-failed", "Container launch failed",
           mea_culpa=True, failure_limit=3),
]
REASON_BY_CODE = {r.code: r for r in REASONS}
REASON_BY_NAME = {r.name: r for r in REASONS}
REASON_UNKNOWN = REASON_BY_CODE[6000]


# Swappable clock so the faster-than-real-time simulator (cook_tpu.sim)
# can freeze/set time, the way the reference pins joda DateTimeUtils
# (zz_simulator.clj "Setting time" developer notes). Production leaves
# the wall clock in place.
_clock = time.time


def set_clock(fn) -> None:
    """Install `fn() -> seconds` as the time source for all timestamps."""
    global _clock
    _clock = fn


def reset_clock() -> None:
    global _clock
    _clock = time.time


def now_ms() -> int:
    return int(_clock() * 1000)


def new_uuid() -> str:
    return str(uuid_mod.uuid4())


@dataclass
class Instance:
    """One attempt at running a job (instance entity schema.clj:585-708)."""

    task_id: str
    job_uuid: str
    status: InstanceStatus = InstanceStatus.UNKNOWN
    hostname: str = ""
    backend: str = ""                 # compute cluster name
    start_time_ms: int = 0
    end_time_ms: Optional[int] = None
    reason_code: Optional[int] = None
    preempted: bool = False
    progress: int = 0                 # percent
    progress_message: str = ""
    exit_code: Optional[int] = None
    sandbox_directory: str = ""
    # base URL of the file server holding this sandbox (the reference's
    # :instance/output-url); lets ls/cat/tail reach a remote agent whose
    # file server sits on a dynamic port
    output_url: str = ""
    ports: list[int] = field(default_factory=list)

    @property
    def active(self) -> bool:
        return self.status in (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING)

    @property
    def mea_culpa(self) -> bool:
        r = REASON_BY_CODE.get(self.reason_code or -1)
        return bool(r and r.mea_culpa)

    @property
    def counts_for_novel_host(self) -> bool:
        """Whether this attempt contributes its host to the job's
        novel-host exclusion set (constraints.clj:73-100). A 5003
        launch-ack-timeout is excluded: the launch was never
        acknowledged — the command provably never ran there, so there
        is no evidence against the host, and counting it deadlocks a
        small cluster (a job whose launches were twice interrupted by
        coordinator crashes would exhaust every host and wait forever).
        Genuine host failures (host-lost, heartbeat-lost, user exits)
        still count."""
        return bool(self.hostname) and self.reason_code != 5003


@dataclass
class Job:
    """A job (job entity schema.clj:23-203)."""

    uuid: str
    user: str
    command: str
    mem: float                        # MB
    cpus: float
    gpus: float = 0.0
    name: str = "cookjob"
    priority: int = 50
    max_retries: int = 1
    max_runtime_ms: int = 2 ** 53
    expected_runtime_ms: Optional[int] = None
    ports: int = 0                    # number of ports requested
    #                                   (:job/ports, resource type ports)
    state: JobState = JobState.WAITING
    pool: str = "default"
    group: Optional[str] = None       # group uuid
    submit_time_ms: int = 0
    env: dict[str, str] = field(default_factory=dict)
    labels: dict[str, str] = field(default_factory=dict)
    constraints: list[tuple[str, str, str]] = field(default_factory=list)
    # [(attribute, operator, pattern)] — user-defined host constraints
    # (rest/api.clj job schema; constraints.clj:171)
    uris: list[dict[str, Any]] = field(default_factory=list)
    container: Optional[dict[str, Any]] = None
    application: Optional[dict[str, str]] = None
    progress_output_file: str = ""
    progress_regex_string: str = ""
    checkpoint: Optional[dict[str, Any]] = None
    disable_mea_culpa_retries: bool = False
    committed: bool = True            # commit-latch (rest/api.clj:659)
    instances: list[Instance] = field(default_factory=list)
    # user-facing success/failure of the terminal state
    success: Optional[bool] = None
    # when the job reached COMPLETED (retention GC measures its window
    # from here; kill-while-waiting leaves no instance end time)
    end_time_ms: Optional[int] = None
    # why the job can't be scheduled right now (for /unscheduled_jobs)
    last_placement_failure: Optional[dict[str, Any]] = None
    datasets: list[dict[str, Any]] = field(default_factory=list)
    # W3C-style trace context stamped at REST submit ("00-<trace>-
    # <root span>-01"); every downstream span of this job's lifecycle
    # parents into it.  Empty = job not traced.
    traceparent: str = ""

    @property
    def active_instances(self) -> list[Instance]:
        return [i for i in self.instances if i.active]

    def attempts_consumed(self) -> int:
        """Failed attempts that count against max_retries: mea-culpa
        failures are free up to the reason's failure_limit
        (schema.clj:1018-1062 :job/reasons->attempts-consumed)."""
        per_reason: dict[int, int] = {}
        consumed = 0
        for inst in self.instances:
            if inst.status != InstanceStatus.FAILED:
                continue
            if inst.preempted and not self.disable_mea_culpa_retries:
                continue
            reason = REASON_BY_CODE.get(inst.reason_code or -1, REASON_UNKNOWN)
            if reason.mea_culpa and not self.disable_mea_culpa_retries:
                per_reason[reason.code] = per_reason.get(reason.code, 0) + 1
                if (reason.failure_limit is not None
                        and per_reason[reason.code] > reason.failure_limit):
                    consumed += 1
            else:
                consumed += 1
        return consumed

    def retries_remaining(self) -> int:
        return max(self.max_retries - self.attempts_consumed(), 0)


@dataclass
class Group:
    """Job group (group entity schema.clj:205-234; docs/groups.md)."""

    uuid: str
    name: str = "defaultgroup"
    user: str = ""
    # host-placement: type in {all, balanced, unique, attribute-equals}
    host_placement: dict[str, Any] = field(
        default_factory=lambda: {"type": "all"})
    # straggler-handling: type in {none, quantile-deviation}
    straggler_handling: dict[str, Any] = field(
        default_factory=lambda: {"type": "none"})
    jobs: list[str] = field(default_factory=list)
