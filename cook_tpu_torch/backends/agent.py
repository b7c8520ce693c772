"""Network-agent backend: remote execution over an HTTP control plane.

The libmesos/executor communication role (SURVEY §7.8): the reference's
executor is a *network* participant that registers with its agent and
streams status/progress/heartbeats as framework messages
(/root/reference/executor/cook/executor.py:421,
mesos_compute_cluster.clj:94-195). Here:

  coordinator side (this module)     agent side (cook_tpu.agent.daemon)
  ------------------------------     ----------------------------------
  AgentCluster (ComputeCluster)      AgentDaemon process
    offers = registered agents'        registers over POST /agents/register
      capacity minus assigned work     heartbeats POST /agents/heartbeat
    launch -> POST {agent}/launch      runs tasks via agent.executor
    kill   -> POST {agent}/kill        status  -> POST /agents/status
    agent-lost watchdog: heartbeat     progress-> POST /agents/progress
      timeout fails tasks 5000         serves sandboxes via FileServer

Exactly-once discipline matches the other backends: the store txn
happens before launch; agent death surfaces as mea-culpa host-lost so
retries don't burn user attempts (schema.clj:1018-1062 semantics).
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

from cook_tpu_torch import obs
from cook_tpu_torch.utils.lockwitness import witness_lock
from cook_tpu_torch.backends import specwire
from cook_tpu_torch.backends.base import ComputeCluster, LaunchSpec, Offer
from cook_tpu_torch.native import consumefold
from cook_tpu_torch.scheduler.liveness import DEAD, RESURRECTED
from cook_tpu_torch.state.model import InstanceStatus, now_ms
from cook_tpu_torch.utils.breaker import (
    BreakerOpenError, CircuitBreaker, CLOSED, OPEN)
from cook_tpu_torch.utils.httpjson import json_request, raw_request
from cook_tpu_torch.utils.metrics import registry as metrics_registry

logger = logging.getLogger(__name__)

REASON_HOST_LOST = 5000           # mea-culpa (model.py REASONS)
REASON_LAUNCH_FAILED = 99003


@dataclass
class AgentInfo:
    hostname: str
    url: str                      # the agent's own control server
    mem: float
    cpus: float
    gpus: float = 0.0
    pool: str = "default"
    attributes: dict = field(default_factory=dict)
    file_server_url: str = ""
    last_heartbeat_ms: int = 0
    alive: bool = True
    # the daemon's lifetime count of terminal statuses its bounded
    # outbox overflowed and dropped (reported on register/heartbeat);
    # surfaced in /debug + Prometheus so silent status loss is visible
    outbox_dropped: int = 0
    # binary launch framings the daemon advertised at registration
    # (e.g. ("cks1",)); empty for old daemons -> JSON launch body
    spec_wire: tuple = ()


class AgentCluster(ComputeCluster):
    """ComputeCluster over registered network agents."""

    # consume lanes pre-encode each spec's CKS1 segment at match time
    # (LaunchSpec.wire_segment) so the launch POST splices bytes
    # instead of re-encoding; backends without a binary wire leave
    # this False and skip that work entirely
    spec_wire_eager = True

    def __init__(self, name: str = "agents",
                 heartbeat_timeout_s: float = 30.0,
                 progress_aggregator=None, heartbeats=None,
                 request_timeout_s: float = 10.0,
                 lost_task_grace_s: float = 5.0,
                 agent_token: str = "",
                 task_lookup=None,
                 breaker_failures: int = 3,
                 breaker_reset_s: float = 30.0,
                 fanout_workers: int = 8,
                 liveness=None):
        self.name = name
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.request_timeout_s = request_timeout_s
        self.lost_task_grace_s = lost_task_grace_s
        self.agent_token = agent_token
        self.breaker_failures = breaker_failures
        self.breaker_reset_s = breaker_reset_s
        # parallel launch fan-out width: one worker posts to one host;
        # <=1 keeps the serial loop (Settings.scheduler
        # launch_fanout_workers). The executor is lazy so clusters
        # that never launch (read replicas) start no threads.
        self.fanout_workers = max(1, int(fanout_workers))
        self._fanout: Optional[ThreadPoolExecutor] = None
        # hostname -> CircuitBreaker over coordinator->agent RPCs: a
        # host that black-holes requests stops receiving offers (OPEN)
        # instead of costing a request_timeout_s stall per launch cycle
        self._breakers: dict[str, CircuitBreaker] = {}
        self.progress = progress_aggregator
        self.heartbeats = heartbeats
        # task_id -> (Job, Instance) or None, consulted before declaring
        # a reported task an orphan: a new leader's cluster starts with
        # empty _specs, but the durable store (shared event log) may
        # know the task as a live instance — ADOPT it instead of
        # killing it (the startup-reconstruction role,
        # kubernetes/compute_cluster.clj:155-190 / reconcile-tasks
        # scheduler.clj:1041-1104)
        self.task_lookup = task_lookup
        # lease-based agent lifecycle (scheduler/liveness.py): when
        # present it replaces the raw heartbeat-cutoff death model —
        # alive -> suspect -> dead with a grace window before tasks are
        # requeued, and dead -> resurrected with census + adoption
        # instead of the re-register round trip. None keeps the legacy
        # single-cutoff behavior.
        self.liveness = liveness
        self.agents: dict[str, AgentInfo] = {}
        # task -> (spec, host, launched_ms)
        self._specs: dict[str, tuple[LaunchSpec, str, int]] = {}
        # hostname -> [mem, cpus, gpus, task_count] consumed by tracked
        # specs, maintained incrementally by _track/_untrack so
        # pending_offers is O(agents), not O(tracked specs × agents)
        self._used: dict[str, list] = {}
        # heartbeat-diff strike counts: a task is only failed lost after
        # missing from TWO consecutive heartbeats, so an in-flight
        # terminal status post (executor pops the task before POSTing)
        # has a window to land
        self._missing: dict[str, int] = {}
        # bounded breaker state-transition log for /debug: each entry
        # {hostname, from, to, t_ms} (appends are GIL-atomic; /debug
        # copies before serializing)
        import collections
        self.breaker_transitions: "collections.deque[dict]" = \
            collections.deque(maxlen=256)
        self._lock = witness_lock("AgentCluster._lock", reentrant=True)

    # -- agent control-plane entry points (wired to REST routes) -------
    def register_agent(self, payload: dict) -> dict:
        """POST /agents/register. Re-registration after an agent restart
        reconciles: any task we believed was running there that the
        fresh agent does not report is failed host-lost (the
        reconciliation role of re-registration,
        mesos_compute_cluster.clj:119-133)."""
        hostname = payload["hostname"]
        info = AgentInfo(
            hostname=hostname,
            url=payload["url"].rstrip("/"),
            mem=float(payload.get("mem", 0.0)),
            cpus=float(payload.get("cpus", 0.0)),
            gpus=float(payload.get("gpus", 0.0)),
            pool=payload.get("pool", "default"),
            attributes=dict(payload.get("attributes", {})),
            file_server_url=payload.get("file_server_url", ""),
            last_heartbeat_ms=now_ms(),
            spec_wire=tuple(payload.get("spec_wire", ())))
        reported = set(payload.get("tasks", []))
        grace_cutoff = now_ms() - int(self.lost_task_grace_s * 1000)
        info.outbox_dropped = int(payload.get("outbox_dropped", 0))
        if self.liveness is not None:
            # registration IS the census (the payload carries the task
            # list and this handler reconciles it), so no extra
            # resurrection round trip is needed here
            self.liveness.observe(hostname)
        with self._lock:
            prev = self.agents.get(hostname)
            self._account_outbox_dropped(prev, info.outbox_dropped)
            if prev is None or not prev.alive:
                # new host (or resurrection): the resident match path
                # polls offer_generation to learn the host set changed
                self.bump_offer_generation()
            self.agents[hostname] = info
            # a (re)registered agent gets a clean breaker: registration
            # proves the process is back even if its old URL was
            # black-holing, and a stale-open breaker would starve the
            # fresh agent of offers for a full reset timeout
            if hostname in self._breakers:
                self._breakers[hostname].record_success()
            lost = [tid for tid, (_, h, t0) in self._specs.items()
                    if h == hostname and tid not in reported
                    and t0 < grace_cutoff]
            unknown = [tid for tid in reported if tid not in self._specs]
        for tid in lost:
            self._fail_lost(tid, "agent re-registered without task")
        # reported-but-untracked tasks the durable store knows as live
        # instances are ADOPTED, not killed: this cluster object may be
        # a fresh leader's (leader failover / coordinator restart)
        adopted = sum(self._try_adopt(tid, hostname) for tid in unknown)
        logger.info("agent %s registered (%s); %d tasks lost, %d adopted",
                    hostname, info.url, len(lost), adopted)
        return {"ok": True, "hostname": hostname}

    def _resolve_active(self, task_id: str):
        """(job, instance) from the durable store, if the instance is
        still live; None otherwise."""
        if self.task_lookup is None:
            return None
        try:
            res = self.task_lookup(task_id)
        except Exception:
            return None
        if res is None:
            return None
        job, inst = res
        return (job, inst) if inst.active else None

    def _try_adopt(self, task_id: str, hostname: str,
                   resolved=None) -> bool:
        """Adopt a reported task if the store knows it as a live
        instance on this host (startup reconstruction,
        kubernetes/compute_cluster.clj:155-190 / reconcile-tasks
        scheduler.clj:1041-1104). Returns True if adopted. `resolved`
        passes an already-fetched (job, instance) pair."""
        res = resolved if resolved is not None \
            else self._resolve_active(task_id)
        if res is None or res[1].hostname != hostname:
            return False
        job = res[0]
        spec = LaunchSpec(task_id=task_id, job_uuid=job.uuid,
                          hostname=hostname, command=job.command,
                          mem=job.mem, cpus=job.cpus, gpus=job.gpus)
        with self._lock:
            if task_id not in self._specs:
                self._track_locked(spec, hostname, now_ms())
        logger.info("adopted running task %s on %s", task_id, hostname)
        return True

    def _track_locked(self, spec: LaunchSpec, hostname: str,
                      t0: int) -> None:
        """Record a tracked spec + fold its resources into the per-host
        used aggregate (caller holds the lock; the ONLY writer of
        _specs additions, so _used can never drift from _specs)."""
        self._specs[spec.task_id] = (spec, hostname, t0)
        u = self._used.get(hostname)
        if u is None:
            u = self._used[hostname] = [0.0, 0.0, 0.0, 0]
        u[0] += spec.mem
        u[1] += spec.cpus
        u[2] += spec.gpus
        u[3] += 1

    def _track_bulk_locked(self, specs: list, hostname: str,
                           t0: int) -> None:
        """Batch twin of _track_locked for one host's launch batch:
        the per-host used aggregate is folded ONCE from the batch's
        resource totals (native consume chokepoint) instead of four
        float adds per spec on the launch path. Adding the subtotal
        can differ from per-spec accumulation in the last ulp; that is
        exactly the float residue _untrack_locked's drop-at-zero rule
        already clears (un-counting is per-spec and exact either
        way)."""
        for s in specs:
            self._specs[s.task_id] = (s, hostname, t0)
        mem, cpus, gpus = consumefold.usage_totals(
            [(s.mem, s.cpus, s.gpus) for s in specs])
        u = self._used.get(hostname)
        if u is None:
            u = self._used[hostname] = [0.0, 0.0, 0.0, 0]
        u[0] += mem
        u[1] += cpus
        u[2] += gpus
        u[3] += len(specs)

    def _untrack_locked(self, task_id: str):
        """Inverse of _track_locked; returns the popped entry (or
        None). Un-counts the exact resources counted in, and drops the
        host row at zero tasks so _used stays O(hosts with work) — a
        float-drift residue cannot accumulate across task churn."""
        entry = self._specs.pop(task_id, None)
        if entry is not None:
            spec, h, _ = entry
            u = self._used.get(h)
            if u is not None:
                u[0] -= spec.mem
                u[1] -= spec.cpus
                u[2] -= spec.gpus
                u[3] -= 1
                if u[3] <= 0:
                    self._used.pop(h, None)
        return entry

    def agent_heartbeat(self, payload: dict) -> dict:
        """POST /agents/heartbeat: {hostname, tasks: [alive ids]}.
        Tasks we track on that agent but absent from the report are
        failed host-lost (safety net under executor status reports).
        Unknown hostnames get told to re-register (a restarted
        coordinator has an empty registry)."""
        hostname = payload.get("hostname", "")
        reported = set(payload.get("tasks", []))
        grace_cutoff = now_ms() - int(self.lost_task_grace_s * 1000)
        self._liveness_traffic(hostname)
        lost = []
        with self._lock:
            info = self.agents.get(hostname)
            if info is None or not info.alive:
                return {"ok": False, "reregister": True}
            info.last_heartbeat_ms = now_ms()
            dropped = int(payload.get("outbox_dropped", 0))
            self._account_outbox_dropped(info, dropped)
            info.outbox_dropped = dropped
            known_here = set()
            for tid, (_, h, t0) in self._specs.items():
                if h != hostname:
                    continue
                known_here.add(tid)
                if tid in reported or t0 >= grace_cutoff:
                    # present, or launched after the heartbeat's task
                    # list could have been snapshotted: not lost
                    self._missing.pop(tid, None)
                    continue
                strikes = self._missing.get(tid, 0) + 1
                self._missing[tid] = strikes
                if strikes >= 2:
                    lost.append(tid)
            # reported-but-unknown: try adoption (durable store may know
            # it — new leader / restarted coordinator); what remains is
            # an orphan from a failed launch POST, killed so it stops
            # consuming real capacity
            candidates = sorted(reported - known_here)
        orphans = [tid for tid in candidates
                   if not self._try_adopt(tid, hostname)]
        for tid in lost:
            self._fail_lost(tid, "missing from two consecutive heartbeats")
        # a live agent task keeps the per-task heartbeat fresh: the
        # HeartbeatWatcher must not fire 3000 while the agent reports it
        if self.heartbeats is not None:
            for tid in reported:
                self.heartbeats.notify(tid)
        return {"ok": True, "kill": orphans}

    @staticmethod
    def _record_remote_spans(payload: dict) -> None:
        """Fold agent-side spans into the coordinator's tracer: the
        daemon echoes the launch spec's traceparent plus its locally
        timed spans on each status post, so the job's /trace tree
        crosses the process (and clock) boundary.  Malformed trace
        payloads are ignored — tracing must never fail a status."""
        if not obs.tracer.enabled:
            return
        ctx = obs.parse_traceparent(payload.get("traceparent"))
        if ctx is None:
            return
        spans = payload.get("spans")
        if not isinstance(spans, list):
            return
        for sp in spans:
            try:
                obs.tracer.record(
                    f"agent.{sp['name']}", trace_id=ctx[0],
                    parent_id=ctx[1], start_ms=float(sp["t0"]),
                    end_ms=float(sp["t1"]),
                    attrs={"hostname": payload.get("hostname", ""),
                           "task": payload.get("task_id", "")})
            except (KeyError, TypeError, ValueError):
                continue

    def _status_update(self, payload: dict):
        """Map one executor status payload to its (task_id, status,
        reason, extras) emit tuple, performing the non-emit side
        effects (liveness, spans, adoption, _forget). Returns None for
        payloads this cluster cannot vouch for. Shared by the singular
        and bulk ingestion paths so the event -> instance-status
        mapping cannot drift between them."""
        task_id = payload["task_id"]
        event = payload.get("event", "")
        exit_code = payload.get("exit_code")
        sandbox = payload.get("sandbox", "")
        self._liveness_traffic(payload.get("hostname", ""))
        self._record_remote_spans(payload)
        with self._lock:
            entry = self._specs.get(task_id)
        if entry is None:
            # Not a task THIS cluster object launched — but the durable
            # store may know it as a live instance (leader failover: the
            # agent retried a terminal status that first landed in the
            # leaderless window). Accept it iff the store vouches for
            # the task on EXACTLY that agent; a payload without a
            # hostname (no legitimate daemon omits it) or with the
            # wrong one can't flip instance state.
            res = self._resolve_active(task_id)
            hostname = payload.get("hostname", "")
            if res is None or not hostname or \
                    res[1].hostname != hostname:
                return None
            self._try_adopt(task_id, hostname, resolved=res)
            with self._lock:
                entry = self._specs.get(task_id)
            if entry is None:
                return None
        with self._lock:
            info = self.agents.get(entry[1])
            output_url = info.file_server_url if info else ""
        if event == "running":
            return (task_id, InstanceStatus.RUNNING, None,
                    {"sandbox": sandbox, "output_url": output_url})
        if event == "fetch_failed":
            self._forget(task_id)
            return (task_id, InstanceStatus.FAILED,
                    REASON_LAUNCH_FAILED,
                    {"sandbox": sandbox, "output_url": output_url})
        self._forget(task_id)
        if event == "killed":
            return (task_id, InstanceStatus.FAILED, 1004,
                    {"exit_code": exit_code, "sandbox": sandbox,
                     "output_url": output_url})
        if exit_code == 0:
            return (task_id, InstanceStatus.SUCCESS, None,
                    {"exit_code": 0, "sandbox": sandbox,
                     "output_url": output_url})
        return (task_id, InstanceStatus.FAILED, 1003,
                {"exit_code": exit_code, "sandbox": sandbox,
                 "output_url": output_url})

    def status_report(self, payload: dict) -> dict:
        """POST /agents/status: executor events relayed over the wire.
        Same event -> instance-status mapping as the in-process local
        backend (executor exit-code reporting)."""
        upd = self._status_update(payload)
        if upd is None:
            return {"ok": False, "unknown": True}
        self.emit_status(upd[0], upd[1], upd[2], **upd[3])
        return {"ok": True}

    def status_report_bulk(self, payloads: list) -> dict:
        """POST /agents/status/bulk: a daemon's coalesced status batch,
        folded through ONE emit_status_bulk call — at bench scale the
        per-item HTTP round trip (and per-item shard submit on the
        coordinator side) dominates status ingestion. Per-item results
        mirror the singular endpoint's bodies, positionally."""
        updates = []
        results = []
        for payload in payloads:
            upd = self._status_update(payload)
            if upd is None:
                results.append({"ok": False, "unknown": True})
            else:
                updates.append(upd)
                results.append({"ok": True})
        if updates:
            self.emit_status_bulk(updates)
        return {"ok": True, "results": results, "applied": len(updates)}

    def progress_report(self, payload: dict) -> dict:
        """POST /agents/progress (the framework-message progress path,
        progress.clj:102)."""
        if self.progress is not None:
            self.progress.handle(
                payload["task_id"], int(payload.get("sequence", 0)),
                int(payload.get("percent", 0)),
                str(payload.get("message", "")))
        if self.heartbeats is not None:
            self.heartbeats.notify(payload["task_id"])
        return {"ok": True}

    # -- ComputeCluster protocol ---------------------------------------
    def pending_offers(self, pool: str) -> list[Offer]:
        offers = []
        with self._lock:
            for info in self.agents.values():
                if not info.alive or info.pool != pool:
                    continue
                br = self._breakers.get(info.hostname)
                if br is not None and br.state == OPEN:
                    # black-holing host: no offers until the reset
                    # timeout elapses. HALF_OPEN hosts DO get offers —
                    # the next launch there is the probe (nothing else
                    # posts to an idle agent, so withholding offers
                    # would leave the breaker half-open forever)
                    continue
                # incremental per-host aggregate (maintained by
                # _track/_untrack) — the old per-agent rescan of every
                # tracked spec made offer generation O(specs × agents)
                used = self._used.get(info.hostname)
                used_mem, used_cpus, used_gpus = \
                    (used[0], used[1], used[2]) if used \
                    else (0.0, 0.0, 0.0)
                mem = info.mem - used_mem
                cpus = info.cpus - used_cpus
                if mem <= 0 and cpus <= 0:
                    continue
                offers.append(Offer(
                    hostname=info.hostname, pool=pool, mem=mem, cpus=cpus,
                    gpus=info.gpus - used_gpus,
                    attributes={"backend": "agent", **info.attributes},
                    cap_mem=info.mem, cap_cpus=info.cpus,
                    cap_gpus=info.gpus))
        return offers

    def launch_tasks(self, pool: str, specs: list[LaunchSpec]) -> None:
        """One POST per host per call (per-host ordering), fanned out
        across a bounded executor when several hosts are addressed —
        the serial per-host loop made backend_launch scale with host
        count × RTT on the cycle thread. Every per-host outcome is
        folded back before returning (futures joined), so the
        at-most-once contract is unchanged: by the time this returns,
        every spec is either tracked on its agent or already failed
        through the status callback (REASON_HOST_LOST /
        REASON_LAUNCH_FAILED with best-effort kill), exactly as the
        serial loop left it."""
        by_host: dict[str, list[LaunchSpec]] = {}
        for spec in specs:
            by_host.setdefault(spec.hostname, []).append(spec)
        if not by_host:
            return
        t0 = time.perf_counter()
        if len(by_host) == 1 or self.fanout_workers <= 1:
            for hostname, host_specs in by_host.items():
                self._launch_host(hostname, host_specs)
        else:
            futs = [self._fanout_pool().submit(
                        self._launch_host, hostname, host_specs)
                    for hostname, host_specs in by_host.items()]
            err = None
            for f in futs:
                try:
                    f.result()
                except BaseException as e:   # noqa: BLE001
                    # per-task launch failures are handled INSIDE
                    # _launch_host; anything escaping it is a
                    # programming error — join every host first, then
                    # surface it like the serial loop would have
                    err = err or e
            if err is not None:
                raise err
        metrics_registry.histogram("launch_fanout_ms", pool=pool) \
            .observe((time.perf_counter() - t0) * 1000.0)

    def _fanout_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._fanout is None:
                self._fanout = ThreadPoolExecutor(
                    max_workers=self.fanout_workers,
                    thread_name_prefix="agent-fanout")
            return self._fanout

    def _launch_host(self, hostname: str,
                     host_specs: list[LaunchSpec]) -> None:
        """Launch one host's specs: track, POST once, and on failure
        best-effort-kill + FAILED each spec (breaker/chaos semantics
        identical to the old serial loop — the executor only changes
        WHERE this runs, not what it does)."""
        with self._lock:
            info = self.agents.get(hostname)
            if info is None or not info.alive:
                info = None
            else:
                self._track_bulk_locked(host_specs, hostname, now_ms())
        if info is None:
            for s in host_specs:
                self.emit_status(s.task_id, InstanceStatus.FAILED,
                                 REASON_HOST_LOST)
            return
        try:
            # agents that advertised the binary framing get the compact
            # frame, spliced from the segments the consume lane encoded
            # at match time (encode once, ship the same bytes);
            # everyone else the legacy JSON body
            if specwire.WIRE_FORMAT in info.spec_wire:
                frame = specwire.frame_segments(
                    [s.wire_segment or specwire.encode_spec_segment(s)
                     for s in host_specs])
                self._post(info.url + "/launch", None,
                           hostname=hostname,
                           chaos_site="backend.launch",
                           raw=frame,
                           content_type=specwire.CONTENT_TYPE)
            else:
                self._post(info.url + "/launch",
                           {"specs": [_spec_wire(s) for s in host_specs]},
                           hostname=hostname,
                           chaos_site="backend.launch")
        except Exception as e:
            logger.warning("launch to agent %s failed: %s", hostname, e)
            for s in host_specs:
                # the POST may have half-landed (e.g. timed out after
                # delivery): best-effort kill so no orphan runs on;
                # the heartbeat orphan reconciliation is the backstop
                try:
                    self._post(info.url + "/kill",
                               {"task_id": s.task_id},
                               hostname=hostname,
                               chaos_site="backend.kill")
                except Exception:
                    pass
                self._forget(s.task_id)
                self.emit_status(s.task_id, InstanceStatus.FAILED,
                                 REASON_LAUNCH_FAILED)

    def kill_task(self, task_id: str) -> None:
        with self._lock:
            entry = self._specs.get(task_id)
        if entry is None:
            return
        _, hostname, _ = entry
        with self._lock:
            info = self.agents.get(hostname)
        if info is None:
            return
        try:
            self._post(info.url + "/kill", {"task_id": task_id},
                       hostname=hostname, chaos_site="backend.kill")
        except Exception as e:
            # the agent is unreachable: the watchdog will fail the task
            # host-lost when the heartbeat lapses
            logger.warning("kill of %s on %s failed: %s",
                           task_id, hostname, e)

    def known_task_ids(self) -> set[str]:
        with self._lock:
            return set(self._specs)

    def _account_outbox_dropped(self, prev: Optional[AgentInfo],
                                new_count: int) -> None:
        """Fold the positive delta of a daemon's lifetime outbox-drop
        count into the coordinator-side Prometheus counter (a daemon
        restart resets its count to 0 — never subtract)."""
        old = prev.outbox_dropped if prev is not None else 0
        if new_count > old:
            metrics_registry.counter(
                "agent_outbox_dropped_reported_total").inc(new_count - old)

    def query_agent_tasks(self, timeout_s: Optional[float] = None,
                          hosts: Optional[set] = None,
                          include_dead: bool = False):
        """GET every alive agent's /state for its live task_ids — the
        restart-reconciliation census. Returns (tasks_by_host,
        responded, undelivered): a host appears in `responded` only
        when it actually answered, so the caller can distinguish
        "agent says the task is not running" (requeue it, no attempt
        burned) from "agent unreachable" (decide nothing — leave it to
        the heartbeat/ack watchdogs). `undelivered` carries terminal
        status payloads still sitting in agent outboxes — tasks that
        finished while the coordinator was down; the caller folds them
        in before classifying anything as never-launched. Goes around
        the circuit breakers on purpose: this runs once at boot, when
        breakers carry no history yet, and a wrong OPEN here would
        mis-classify every task on the host. ``hosts``/``include_dead``
        narrow the census to specific (possibly not-alive) agents —
        the resurrection path censuses exactly the returning host."""
        with self._lock:
            targets = [(h, i.url) for h, i in self.agents.items()
                       if (i.alive or include_dead)
                       and (hosts is None or h in hosts)]
        headers = {}
        if self.agent_token:
            headers["X-Cook-Agent-Token"] = self.agent_token
        tasks: dict[str, set[str]] = {}
        responded: set[str] = set()
        undelivered: list[dict] = []
        for hostname, url in targets:
            try:
                resp = json_request(
                    "GET", url + "/state", None, headers=headers,
                    timeout=timeout_s or self.request_timeout_s)
            except Exception as e:
                logger.warning("reconcile: state query to agent %s "
                               "failed: %s", hostname, e)
                continue
            responded.add(hostname)
            tasks[hostname] = set(resp.get("tasks", []))
            undelivered.extend(resp.get("undelivered", []) or [])
        return tasks, responded, undelivered

    def host_attributes(self) -> dict[str, dict[str, str]]:
        with self._lock:
            return {h: {"backend": "agent", **i.attributes}
                    for h, i in self.agents.items() if i.alive}

    # -- agent liveness (lease machine -> offers/grace/resurrection) ---
    def _liveness_traffic(self, hostname: str) -> None:
        """Feed agent traffic into the lease machine; a dead host's
        returning traffic triggers the resurrection census."""
        if self.liveness is None or not hostname:
            return
        if self.liveness.observe(hostname) == (DEAD, RESURRECTED):
            self._resurrect(hostname)

    def _resurrect(self, hostname: str) -> None:
        """A dead agent's traffic returned: census it over the existing
        query_agent_tasks path and ADOPT still-running tasks instead of
        double-launching (the restart-reconciliation fold, scoped to
        one host). Tasks the agent no longer reports are requeued
        host-lost (mea-culpa); tasks it does report that we still track
        were never failed — nothing relaunches, at-most-once holds."""
        with self._lock:
            info = self.agents.get(hostname)
        if info is None:
            return  # never registered with this coordinator life; the
            # heartbeat handler's reregister answer covers it
        tasks, responded, undelivered = self.query_agent_tasks(
            hosts={hostname}, include_dead=True)
        if hostname not in responded:
            # reachable enough to send traffic but /state failed: stay
            # in resurrected limbo (not offerable until census lands);
            # the next traffic retries, the watchdogs keep protecting
            logger.warning("resurrection census of %s failed", hostname)
            return
        # terminal statuses that finished while the agent was dead are
        # folded FIRST so they can't be requeued as lost
        for payload in undelivered:
            try:
                self.status_report(payload)
            except Exception:
                logger.exception("folding undelivered status from %s",
                                 hostname)
        reported = tasks.get(hostname, set())
        with self._lock:
            known_here = {tid for tid, (_, h, _) in self._specs.items()
                          if h == hostname}
        adopted = sum(self._try_adopt(tid, hostname)
                      for tid in sorted(reported - known_here))
        folded = {p.get("task_id") for p in undelivered}
        gone = known_here - reported - folded
        for tid in sorted(gone):
            self._fail_lost(tid, "not reported by resurrected agent")
        with self._lock:
            info = self.agents.get(hostname)
            if info is not None:
                info.last_heartbeat_ms = now_ms()
                if not info.alive:
                    info.alive = True
                    self.bump_offer_generation()
        metrics_registry.counter("agent_resurrections_total").inc()
        logger.info("agent %s resurrected: %d adopted, %d requeued, "
                    "%d undelivered folded", hostname, adopted,
                    len(gone), len(undelivered))

    def _check_agents_liveness(self) -> list[str]:
        """Lease-machine replacement for the raw-cutoff watchdog: on
        dead, withdraw offers but leave tasks in GRACE; only when the
        grace lapses are they failed mea-culpa (5000) and requeued."""
        out = self.liveness.tick()
        dead = []
        with self._lock:
            for hostname, _old, new in out["transitions"]:
                info = self.agents.get(hostname)
                if info is not None and new == DEAD and info.alive:
                    info.alive = False
                    dead.append(hostname)
            if dead:
                self.bump_offer_generation()
            lapsed = set(out["lapsed"])
            lost = [tid for tid, (_, h, _) in self._specs.items()
                    if h in lapsed]
        for hostname in dead:
            logger.warning("agent %s dead (lease expired); %0.1fs task "
                           "grace", hostname, self.liveness.grace_s)
        for tid in lost:
            self._fail_lost(tid, "agent lease fully lapsed")
        return dead

    # -- agent-lost watchdog (heartbeat timeout -> host lost) ----------
    def check_agents(self, wall_ms: Optional[int] = None) -> list[str]:
        """Fail tasks of agents whose heartbeat lapsed; mark the agent
        dead until it re-registers (slave-removed semantics; reason 5000
        is mea-culpa so the retry doesn't burn a user attempt). With a
        liveness tracker installed, the lease machine decides instead."""
        if self.liveness is not None:
            return self._check_agents_liveness()
        wall_ms = wall_ms or now_ms()
        cutoff = wall_ms - int(self.heartbeat_timeout_s * 1000)
        dead = []
        with self._lock:
            for hostname, info in self.agents.items():
                if info.alive and info.last_heartbeat_ms < cutoff:
                    info.alive = False
                    dead.append(hostname)
            if dead:
                self.bump_offer_generation()
            lost = [tid for tid, (_, h, _) in self._specs.items()
                    if h in dead]
        for hostname in dead:
            logger.warning("agent %s lost (heartbeat timeout)", hostname)
        for tid in lost:
            self._fail_lost(tid, "agent heartbeat timeout")
        return dead

    def advance(self, dt: float) -> None:
        """Real-time tick hook (the server's tick loop calls advance on
        clusters that have one)."""
        self.check_agents()

    def shutdown(self) -> None:
        with self._lock:
            ex, self._fanout = self._fanout, None
        if ex is not None:
            ex.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _fail_lost(self, task_id: str, why: str) -> None:
        logger.warning("task %s lost: %s", task_id, why)
        self._forget(task_id)
        self.emit_status(task_id, InstanceStatus.FAILED, REASON_HOST_LOST)

    def _forget(self, task_id: str) -> None:
        with self._lock:
            self._untrack_locked(task_id)
            self._missing.pop(task_id, None)
        if self.heartbeats is not None:
            self.heartbeats.untrack(task_id)

    def describe_agents(self) -> list[dict]:
        with self._lock:
            return [{
                "hostname": a.hostname, "url": a.url, "pool": a.pool,
                "mem": a.mem, "cpus": a.cpus, "gpus": a.gpus,
                "alive": a.alive,
                "last_heartbeat_ms": a.last_heartbeat_ms,
                "outbox_dropped": a.outbox_dropped,
                "liveness": self.liveness.state(a.hostname)
                if self.liveness is not None else None,
                "breaker": self._breakers[a.hostname].snapshot()
                if a.hostname in self._breakers
                else {"state": CLOSED, "consecutive_failures": 0,
                      "trips": 0},
            } for a in self.agents.values()]

    def breaker_snapshots(self) -> dict[str, dict]:
        """hostname -> breaker state, for /debug."""
        with self._lock:
            return {h: b.snapshot() for h, b in self._breakers.items()}

    def _record_breaker_transition(self, hostname: str,
                                   old: str, new: str) -> None:
        # invoked by the breaker OUTSIDE its lock; deque append is
        # GIL-atomic so no extra lock is needed here
        self.breaker_transitions.append(
            {"hostname": hostname, "from": old, "to": new,
             "t_ms": now_ms()})
        metrics_registry.counter(
            "agent_breaker_transitions_total", state=new).inc()

    def _breaker(self, hostname: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(hostname)
            if br is None:
                br = CircuitBreaker(
                    failure_threshold=self.breaker_failures,
                    reset_timeout_s=self.breaker_reset_s,
                    on_transition=lambda old, new, h=hostname:
                        self._record_breaker_transition(h, old, new))
                self._breakers[hostname] = br
            return br

    def _post(self, url: str, payload: Optional[dict],
              hostname: str = "", chaos_site: str = "",
              raw: Optional[bytes] = None,
              content_type: str = "") -> dict:
        br = self._breaker(hostname) if hostname else None
        if br is not None and not br.allow():
            raise BreakerOpenError(f"agent {hostname}: circuit open")
        headers = {}
        if self.agent_token:
            headers["X-Cook-Agent-Token"] = self.agent_token
        try:
            if raw is not None:
                # pre-encoded body (binary spec frame); same breaker +
                # chaos semantics as the JSON path
                resp = raw_request("POST", url, raw, content_type,
                                   headers=headers,
                                   timeout=self.request_timeout_s,
                                   chaos_site=chaos_site)
            else:
                resp = json_request("POST", url, payload,
                                    headers=headers,
                                    timeout=self.request_timeout_s,
                                    chaos_site=chaos_site)
        except Exception:
            if br is not None:
                before = br.trips
                br.record_failure()
                if br.trips > before:
                    metrics_registry.counter(
                        "agent_breaker_trips_total").inc()
                    logger.warning("circuit breaker OPEN for agent %s",
                                   hostname)
            raise
        if br is not None:
            br.record_success()
        return resp


def _spec_wire(s: LaunchSpec) -> dict:
    return {
        "task_id": s.task_id, "job_uuid": s.job_uuid,
        "hostname": s.hostname, "command": s.command,
        "mem": s.mem, "cpus": s.cpus, "gpus": s.gpus,
        "env": s.env, "container": s.container,
        "progress_regex": s.progress_regex,
        "progress_output_file": s.progress_output_file,
        "ports": s.ports, "uris": s.uris,
        "traceparent": s.traceparent,
    }
