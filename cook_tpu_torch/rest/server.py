"""HTTP server mounting the CookApi on a stdlib ThreadingHTTPServer.

The reference embeds Jetty with a middleware stack
(components.clj:239-275); here a threaded stdlib server carries the same
surface: JSON in/out, CORS preflight, NCSA-style access log.

Run a full single-process scheduler (REST + coordinator + mock backend):

    python -m cook_tpu_torch.rest.server --port 12321 [--config cfg.json]
        [--device cuda|cpu]

A port of cook_tpu/rest/server.py: the handler, the embedded server and
the scheduler graph are the reference's; the coordinator runs its
device paths on `--device` ("cuda" unless asked for the CPU, and boot
raises without a card), with no lowering to choose (`use_pallas` is
accepted in the config and has no effect) and no boot-time probe.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from cook_tpu_torch.rest.api import CookApi, Response
from cook_tpu_torch.rest.auth import cors_headers

log = logging.getLogger("cook_tpu.rest.access")


def make_handler(api: CookApi):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _dispatch(self, method: str) -> None:
            t0 = time.perf_counter()
            parts = urlsplit(self.path)
            query = parse_qs(parts.query)
            body = None
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                try:
                    body = json.loads(raw)
                except ValueError:
                    self._reply(Response(400, {"error": "malformed JSON"}))
                    return
            headers = {k.lower(): v for k, v in self.headers.items()}
            if method == "OPTIONS":
                resp = Response(200, None,
                                cors_headers(api.auth,
                                             headers.get("origin")))
            else:
                resp = api.handle(method, parts.path, query, body, headers)
                resp.headers.update(
                    cors_headers(api.auth, headers.get("origin")))
            self._reply(resp)
            # NCSA-ish access log (components.clj:188-201)
            log.info('%s "%s %s" %d %.1fms', self.client_address[0],
                     method, self.path, resp.status,
                     (time.perf_counter() - t0) * 1e3)

        def _reply(self, resp: Response) -> None:
            # a handler-supplied Content-Type means the body is already
            # a rendered string (e.g. the Prometheus text exposition)
            ctype = resp.headers.pop("Content-Type", None)
            payload = b""
            if resp.body is not None:
                payload = resp.body.encode() if ctype else \
                    json.dumps(resp.body).encode()
            self.send_response(resp.status)
            self.send_header("Content-Type", ctype or "application/json")
            self.send_header("Content-Length", str(len(payload)))
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.end_headers()
            if payload:
                self.wfile.write(payload)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def do_OPTIONS(self):
            self._dispatch("OPTIONS")

        def log_message(self, *args):  # silenced; we log above
            pass

    return Handler


class ApiServer:
    """Embedded server (run-test-server-in-thread, testutil.clj:126)."""

    def __init__(self, api: CookApi, port: int = 0, host: str = "127.0.0.1"):
        self.httpd = ThreadingHTTPServer((host, port), make_handler(api))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "ApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def install_artifact_flush() -> None:
    """When $CHAOS_ARTIFACTS_DIR is set, flush the chaos event ring and
    the flight-recorder trace to JSONL artifacts on SIGTERM/atexit — a
    soak run killed by its harness (or a CI timeout) still uploads its
    evidence. SIGKILL cannot be caught by design: the procfault budget
    file records the kill schedule durably BEFORE the signal, and the
    respawned incarnation flushes what the dead one could not."""
    out = os.environ.get("CHAOS_ARTIFACTS_DIR")
    if not out:
        return
    import atexit
    import signal
    from cook_tpu_torch import chaos, obs
    flushed = threading.Event()

    def flush():
        if flushed.is_set():
            return
        flushed.set()
        try:
            os.makedirs(out, exist_ok=True)
            tag = f"server-{os.getpid()}"
            chaos.controller.save_events(
                os.path.join(out, f"chaos-events-{tag}.jsonl"))
            with open(os.path.join(out, f"trace-{tag}.json"), "w") as f:
                json.dump(obs.to_chrome_trace(obs.tracer.recent(4096)), f)
        except Exception:
            log.exception("chaos artifact flush failed")

    atexit.register(flush)

    def on_term(signum, frame):
        flush()
        raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):
        pass  # not on the main thread (embedded use); atexit still runs


# the prefix of the two lines an incarnation of the server writes to
# stderr, each followed by a JSON object: at boot its pid and device,
# and on SIGTERM also its kernel launches (a supervisor reads them from
# the server's log: tests/torch_livestack.py `incarnations`)
INCARNATION = "cook_tpu_torch.rest.server incarnation "


def report_incarnation(device) -> None:
    """Write the boot line, and install a SIGTERM handler that writes
    the launch line, then hands the signal on to the handler installed
    before it (a function, or the default or ignoring disposition, put
    back and the signal sent again)."""
    import signal

    def line(**extra):
        sys.stderr.write(INCARNATION + json.dumps(
            {"pid": os.getpid(), "device": str(device), **extra}) + "\n")
        sys.stderr.flush()

    line()
    prev = signal.getsignal(signal.SIGTERM)

    def on_term(signum, frame):
        from cook_tpu_torch.ops import fused_match as fm
        line(kernel_launches=dict(fm.LAUNCHES))
        if callable(prev):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, prev)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        signal.signal(signal.SIGTERM, on_term)
    except (ValueError, OSError):
        pass   # not on the main thread (embedded use)


def apply_gc_discipline() -> None:
    """Move the store's long-lived object graph out of the cyclic
    collector's reach. At 100k jobs the store holds ~10^6 live objects
    and every CPython gen-2 sweep walks them all — multi-hundred-ms
    pauses landing in the match cycle's p99 (measured, docs/
    benchmarks.md round 3). Called at leadership takeover, after the
    replay materializes the store. This is the ARMING half of a
    two-part discipline: once armed (gc.get_freeze_count() > 0), the
    coordinator re-collects + re-freezes BETWEEN match cycles on a
    cadence (Coordinator._maybe_refreeze) — round 4's tail attribution
    measured 0.9-1.9 s gen-2 sweeps landing inside drain/launch phases
    as post-takeover churn regrew the tracked population, so the sweep
    is paid at a controlled point instead. The cyclic transients
    leaked per re-freeze are a handful of in-flight request frames;
    store state dies by refcount regardless. Native handles use
    weakref.finalize, which freeze does not break (a __del__-based
    finalizer would never run — see native/eventlog.py)."""
    import gc
    gc.collect()
    gc.freeze()


_use_pallas_noted = False


def _note_use_pallas(setting) -> None:
    """`scheduler.use_pallas` chooses between the reference's two
    lowerings of the match. The port has one on each device: a CUDA
    tensor runs the hand-written kernels, a CPU tensor their plain
    versions, so the key is validated (one config file boots both
    servers) and otherwise ignored; logged once per process."""
    global _use_pallas_noted
    if _use_pallas_noted:
        return
    _use_pallas_noted = True
    log.info("scheduler.use_pallas=%r has no effect here: the device "
             "picks the kernels (cuda) or their plain versions (cpu)",
             setting)


def _devices(device, n: int) -> list:
    """The first `n` CUDA devices visible, as torch.device values, or
    fewer when fewer are visible (none on a CPU coordinator)."""
    import torch
    if device.type != "cuda":
        return []
    return [torch.device("cuda", i)
            for i in range(min(n, torch.cuda.device_count()))]


def build_scheduler(config, read_only=False, device="cuda"):
    """Assemble a full single-process scheduler from a Settings tree or
    raw config dict (the components.clj scheduler-server graph
    equivalent). read_only: an api-only read replica — never opens a
    log writer and never trims the shared log. device: where the
    coordinator's device paths run ("cuda", the default, raises
    without a card; "cpu" runs the plain PyTorch versions)."""
    from cook_tpu_torch.backends.base import ClusterRegistry
    from cook_tpu_torch.backends.mock import MockCluster, MockHost
    from cook_tpu_torch.config import Settings
    from cook_tpu_torch.device import resolve_device
    from cook_tpu_torch.plugins import PluginRegistry, registry_from_config
    from cook_tpu_torch.rest.auth import AuthConfig
    from cook_tpu_torch.rest.api import TaskConstraints
    from cook_tpu_torch.scheduler.coordinator import (Coordinator,
                                                RebalancerParams,
                                                SchedulerConfig)
    from cook_tpu_torch.scheduler.data_locality import DataLocalityCosts
    from cook_tpu_torch.scheduler.heartbeat import HeartbeatWatcher
    from cook_tpu_torch.scheduler.monitor import StatsMonitor
    from cook_tpu_torch.scheduler.progress import ProgressAggregator
    from cook_tpu_torch.state.limits import RateLimiter, ShareStore
    from cook_tpu_torch.state.pools import DruMode, Pool, PoolRegistry
    from cook_tpu_torch.state.store import JobStore
    from cook_tpu_torch.utils import metrics as metrics_mod

    if isinstance(config, dict):
        config = Settings.from_dict(config)
    # before the store restores: no card and no "cpu" fails the boot
    device = resolve_device(device)

    # fault injection (cook_tpu.chaos): armed BEFORE the store restores
    # so even boot-time appends run under the schedule. Env overrides
    # the settings section (the chaos-soak CI job uses the env path);
    # the production default leaves the controller disabled and every
    # site check on its zero-overhead path.
    from cook_tpu_torch import chaos
    if not chaos.controller.configure_from_env() and config.chaos.enabled:
        chaos.controller.configure(seed=config.chaos.seed,
                                   sites=config.chaos.sites)
    if chaos.controller.enabled:
        log.warning("CHAOS ENABLED: %s", chaos.controller.stats())
    # process-level kill points (SIGKILL chaos): env-only by design —
    # the schedule crosses the exec boundary from the supervisor
    # (procfault.ServerSupervisor), never from a config file a
    # production deployment could ship by accident
    from cook_tpu_torch.chaos import procfault
    if procfault.controller.configure_from_env():
        log.warning("PROCFAULT ARMED: seed=%d incarnation=%d",
                    procfault.controller.seed,
                    procfault.controller.incarnation)

    # In an HA deployment the log is shared and a live leader may be
    # mid-append while this (standby) process boots: trimming a torn
    # tail would truncate under its writer. A standby replays up to the
    # last complete line instead; the takeover reload_from (old leader
    # dead) does the repair trim. Single-node keeps boot-time repair.
    ha = bool(config.leader_lease_url or config.leader_lock_path)
    store = JobStore.restore(config.snapshot_path,
                             log_path=config.log_path,
                             trim_tail=not ha and not read_only,
                             open_writer=not read_only,
                             store_shards=config.store_shards)
    store.group_commit = bool(config.launch_group_commit)
    store.native_encoder = bool(config.store_native_encoder)
    pools = PoolRegistry(config.default_pool)
    for p in config.pools:
        pools.add(Pool(name=p.name, purpose=p.purpose,
                       dru_mode=DruMode(p.dru_mode)))
    progress = ProgressAggregator(store)
    heartbeats = HeartbeatWatcher(
        store, timeout_s=config.scheduler.heartbeat_timeout_s)
    # boot-time sync: a restart restores RUNNING instances whose agent
    # may be gone for good (it will never re-register, so neither the
    # census nor the liveness lease machine will ever hear from it) —
    # tracking them NOW means the heartbeat watchdog settles them with
    # 3000 (mea-culpa) after one timeout instead of waiting for the
    # 300 s periodic sync to even start the clock
    heartbeats.sync()
    clusters = ClusterRegistry()
    for c in config.clusters:
        if c.kind == "local":
            from cook_tpu_torch.backends.local import LocalCluster
            clusters.register(LocalCluster(
                sandbox_root=c.sandbox_root, name=c.name,
                mem=c.host_mem, cpus=c.host_cpus, pool=c.pool,
                file_server_port=c.file_server_port,
                progress_aggregator=progress, heartbeats=heartbeats))
        elif c.kind == "kube":
            from cook_tpu_torch.backends.kube import FakeKube, KubeCluster, Node
            if c.kube_url:
                # real apiserver over HTTP (kubernetes/api.clj role)
                from cook_tpu_torch.backends.kube.http_api import HttpKube
                kube = HttpKube(
                    c.kube_url, namespace=c.kube_namespace,
                    token_path=c.kube_token_path or None,
                    ca_path=c.kube_ca_path or None,
                    insecure=c.kube_insecure)
            else:
                kube = FakeKube([Node(f"{c.name}-n{i}", mem=c.host_mem,
                                      cpus=c.host_cpus, gpus=c.host_gpus,
                                      pool=c.pool)
                                 for i in range(c.hosts)])
            clusters.register(KubeCluster(
                kube, name=c.name, max_synthetic_pods=c.max_synthetic_pods,
                default_checkpoint_config=config.checkpoint or None))
        elif c.kind == "agent":
            from cook_tpu_torch.backends.agent import AgentCluster
            def _resolve_task(task_id, _store=store):
                uuid = _store.task_to_job.get(task_id)
                job = _store.get_job(uuid) if uuid else None
                inst = _store.get_instance(task_id)
                return (job, inst) if job and inst else None
            liveness = None
            if c.liveness_enabled:
                # lease-based alive/suspect/dead/resurrected hysteresis
                # (scheduler/liveness.py); the legacy raw-cutoff sweep
                # remains for liveness_enabled: false
                from cook_tpu_torch.scheduler.liveness import AgentLivenessTracker
                liveness = AgentLivenessTracker(
                    lease_s=c.agent_heartbeat_timeout_s,
                    suspect_after_s=c.liveness_suspect_after_s or None,
                    grace_s=c.liveness_grace_s)
            clusters.register(AgentCluster(
                name=c.name,
                heartbeat_timeout_s=c.agent_heartbeat_timeout_s,
                progress_aggregator=progress, heartbeats=heartbeats,
                agent_token=config.auth.agent_token,
                task_lookup=_resolve_task,
                fanout_workers=config.scheduler.launch_fanout_workers,
                liveness=liveness))
        else:
            hosts = [MockHost(hostname=f"{c.name}-host-{i}",
                              mem=c.host_mem, cpus=c.host_cpus,
                              gpus=c.host_gpus, pool=c.pool)
                     for i in range(c.hosts)]
            clusters.register(MockCluster(hosts, name=c.name))

    def make_rl(key):
        rl = config.rate_limits.get(key)
        if rl is None:
            return RateLimiter(enforce=False)
        return RateLimiter(tokens_per_sec=rl.tokens_per_sec,
                           max_tokens=rl.max_tokens, enforce=rl.enforce)

    plugins = registry_from_config(config.plugins) if config.plugins \
        else PluginRegistry()
    data_locality = None
    if config.data_locality.get("fetcher"):
        from cook_tpu_torch.plugins import resolve_plugin
        data_locality = DataLocalityCosts(
            fetcher=resolve_plugin(config.data_locality["fetcher"]),
            weight=float(config.data_locality.get("weight", 0.25)),
            batch_size=int(config.data_locality.get("batch_size", 500)))
    elif config.data_locality.get("cost_endpoint"):
        # the reference's batched HTTP cost client
        # (fetch-data-local-costs data_locality.clj:141)
        from cook_tpu_torch.scheduler.data_locality import http_cost_fetcher
        data_locality = DataLocalityCosts(
            fetcher=http_cost_fetcher(
                config.data_locality["cost_endpoint"]),
            weight=float(config.data_locality.get("weight", 0.25)),
            batch_size=int(config.data_locality.get("batch_size", 500)))

    # federated per-pool control plane (scheduler/federation.py): with
    # explicit groups, this process serves ONE group's pools and routes
    # the rest to peers; without, the degenerate single-group host
    # still carries the /debug federation block and fencing evidence.
    from cook_tpu_torch.scheduler.federation import (FederatedQuotaView,
                                               FederationHost)
    fcfg = config.federation or {}
    if fcfg.get("groups"):
        fed = FederationHost(
            group=fcfg.get("group", ""),
            groups=fcfg["groups"],
            store=store, url=config.url,
            exchange_interval_s=float(
                fcfg.get("exchange_interval_s", 2.0)),
            global_quota=bool(fcfg.get("global_quota", False)),
            global_quota_staleness_s=float(
                fcfg.get("global_quota_staleness_s", 10.0)))
    else:
        fed = FederationHost.single(store=store, url=config.url)
    quotas = FederatedQuotaView(fed)

    s = config.scheduler
    # native consume fast path: a process-wide switch, latched here so
    # every consumer (store status folds, CKS1 framing, agent _used
    # bookkeeping) honors the operator's setting
    from cook_tpu_torch.native import consumefold
    consumefold.set_enabled(s.native_consume)
    # always-on cycle profiler: another process-wide switch — size the
    # ring here so /debug/profile serves the configured window from
    # the first cycle
    from cook_tpu_torch import obs
    obs.profiler.configure(ring=config.profile_ring)
    overload = None
    if s.overload_enabled:
        # coordinator-owned shed ladder (scheduler/overload.py); signal
        # sources are registered below once the ingest batcher exists
        from cook_tpu_torch.scheduler.overload import OverloadController
        overload = OverloadController(
            cycle_p99_ms=s.overload_cycle_p99_ms,
            launch_txn_p99_ms=s.overload_launch_txn_p99_ms,
            escalate_after=s.overload_escalate_after,
            relax_after=s.overload_relax_after)
    coord = Coordinator(
        store, clusters,
        shares=ShareStore(), quotas=quotas, pools=pools,
        config=SchedulerConfig(
            max_jobs_considered=s.max_jobs_considered,
            scaleback=s.scaleback,
            match_interval_s=s.match_interval_s,
            rank_interval_s=s.rank_interval_s,
            rebalancer_interval_s=s.rebalancer_interval_s,
            rebalancer=RebalancerParams(
                safe_dru_threshold=s.rebalancer_safe_dru_threshold,
                min_dru_diff=s.rebalancer_min_dru_diff,
                max_preemption=s.rebalancer_max_preemption,
                candidate_cap=s.rebalancer_candidate_cap),
            sequential_match_threshold=s.sequential_match_threshold,
            launch_ack_timeout_s=s.launch_ack_timeout_s,
            consume_workers=s.consume_workers,
            pipeline_depth=s.pipeline_depth,
            decision_provenance=s.decision_provenance,
            heartbeat_timeout_s=s.heartbeat_timeout_s),
        launch_rate_limiter=make_rl("global_launch"),
        user_launch_rate_limiter=make_rl("user_launch"),
        progress_aggregator=progress, heartbeats=heartbeats,
        plugins=plugins, data_locality=data_locality,
        checkpoint_defaults=config.checkpoint or None,
        status_shards=s.status_shards,
        overload=overload, device=device)
    _note_use_pallas(s.use_pallas)
    coord.federation = fed
    if fcfg.get("groups"):
        # only this group's pools get cycle threads; a peer's pools
        # would be double-scheduled against its shard otherwise. The
        # single-group host leaves the filter off (exact legacy path).
        coord.pool_filter = fed.owns

    # device-resident match path (scheduler/resident.py): the
    # production DEFAULT, with full feature parity — plugins, data
    # locality and estimated completion all run on the resident path
    # (launch filters + adjusters against the compact readback, bonus
    # rows, the est-completion device lane). resident_match: false
    # falls back to the legacy host-side cycle.
    if s.resident_match:
        shard_n = getattr(s, "resident_shard_devices", 0)
        shard_devs = None
        if shard_n and shard_n > 1:
            # with enough cards each pool shards its host axis over
            # them (ResidentPool(devices=...), the host-sharded scan)
            devs = _devices(device, shard_n)
            if len(devs) >= shard_n:
                shard_devs = devs[:shard_n]
            else:
                log.warning(
                    "resident_shard_devices=%d but only %d devices "
                    "visible; running single-device", shard_n, len(devs))
        # pool -> device placement (fleet federation): when this
        # group's spec claims devices, each owned pool's resident
        # cycle pins to its placed chip — two groups on one host never
        # contend for the same device. An index beyond the visible
        # device count falls back to the default device (a 4-chip
        # claim still boots on a 1-chip dev box).
        placement = fed.placement() if fcfg.get("groups") else {}
        place_devs = {}
        if placement:
            devs = _devices(device, max(placement.values()) + 1)
            for pname, idx in placement.items():
                if idx < len(devs):
                    place_devs[pname] = devs[idx]
                else:
                    log.warning(
                        "pool %r placed on device %d but only %d "
                        "visible; using default device", pname, idx,
                        len(devs))
        for p in coord.active_pools():
            kw = {}
            # sharded pools (one pool over many chips) and placed
            # pools (one chip per pool) are mutually exclusive per
            # ResidentPool's contract; the explicit shard claim wins
            if shard_devs is None and p.name in place_devs:
                kw["device"] = place_devs[p.name]
            coord.enable_resident(p.name, synchronous=False,
                                  devices=shard_devs, **kw)

    # optimizer cycle (start-optimizer-cycles! mesos.clj:216,
    # optimizer.clj:115): config {"optimizer": {"optimizer": "pkg:fn",
    # "host_feed": "pkg:fn", "interval_s": 30}} — or the built-in
    # capacity planner with "optimizer": "capacity-planning"
    coord.optimizer_cycle = None
    opt_cfg = getattr(config, "optimizer", None) or {}
    if opt_cfg.get("optimizer"):
        from cook_tpu_torch.plugins import resolve_plugin
        from cook_tpu_torch.scheduler.optimizer import (
            CapacityPlanningOptimizer, HostFeed, OptimizerCycle)
        spec = opt_cfg["optimizer"]
        opt = CapacityPlanningOptimizer() if spec == "capacity-planning" \
            else resolve_plugin(spec)
        feed = resolve_plugin(opt_cfg["host_feed"]) \
            if opt_cfg.get("host_feed") else HostFeed()
        coord.optimizer_cycle = OptimizerCycle(
            store=store, clusters=coord.clusters, optimizer=opt,
            host_feed=feed,
            interval_s=float(opt_cfg.get("interval_s", 30.0)))

    monitor = StatsMonitor(store, coord.shares, metrics_mod.registry)
    # coalescing ingest between the REST handlers and the store: one
    # group-commit fdatasync per drained batch of submissions, bounded
    # queue -> 429 + Retry-After when the front door saturates. A
    # read-only replica never commits, so it gets no batcher.
    ingest = None
    if config.ingest_workers > 0 and not read_only:
        from cook_tpu_torch.rest.ingest import IngestBatcher
        ingest = IngestBatcher(
            store,
            workers=config.ingest_workers,
            queue_depth=config.ingest_queue_depth,
            max_batch=config.ingest_max_batch,
            pressure=overload.ingest_tightened if overload else None)
    if overload is not None:
        # pressure signals beyond the two latency feeds the coordinator
        # pushes: admission-queue depth and resident-structure sizes
        if ingest is not None:
            overload.add_source(
                "ingest_queue_depth", ingest.queue_depth,
                high=0.8 * config.ingest_queue_depth)
        overload.add_source(
            "pending_jobs", store.pending_count,
            high=float(4 * s.max_jobs_considered))
        overload.add_source(
            "decision_jobs_tracked",
            lambda: coord.decisions.stats().get("jobs_tracked", 0),
            high=float(max(4096, 8 * s.max_jobs_considered)))
    api = CookApi(
        store, coordinator=coord,
        auth=AuthConfig(scheme=config.auth.scheme,
                        one_user=config.auth.one_user,
                        admins=set(config.auth.admins),
                        imposters=set(config.auth.imposters),
                        authorization=config.auth.authorization,
                        cors_origins=list(config.auth.cors_origins),
                        agent_token=config.auth.agent_token,
                        agent_token_previous=
                        config.auth.agent_token_previous),
        task_constraints=TaskConstraints(
            max_mem_mb=config.task_constraints.max_mem_mb,
            max_cpus=config.task_constraints.max_cpus,
            max_gpus=config.task_constraints.max_gpus,
            max_retries=config.task_constraints.max_retries),
        submission_rate_limiter=make_rl("user_submit"),
        settings=config.public(), leader_url=config.url,
        ingest=ingest)
    api.federation = fed
    # membership ledger replay (live reconfiguration): after a reload,
    # the <log>.membership ledger is newer truth than the config file
    # a restarted process just read — apply the last committed view
    # over the boot view, and park any dangling "begin" record on
    # fed.pending_reload for the post-takeover resume.
    fed.bootstrap_membership()
    # policy rebalancer (default off): folds the fleet health rollup
    # into hot/cold scores and pulls pools off hot groups through the
    # ordinary migrate protocol. Built here, started on leadership.
    fed.configure_rebalance(fcfg.get("rebalance") or {},
                            health_fn=api.fleet_health_snapshot,
                            migrate_fn=api.policy_migrate)
    coord.monitor = monitor
    return store, coord, api


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="cook_tpu_torch scheduler")
    parser.add_argument("--port", type=int, default=12321)
    parser.add_argument("--config", default=None,
                        help="JSON config file (pools, clusters, limits)")
    parser.add_argument("--no-cycles", action="store_true",
                        help="API only; don't start scheduling loops")
    parser.add_argument("--device", default="cuda",
                        help="where the match and rebalance cycles run: "
                             "cuda (the default; boot fails without a "
                             "card) or cpu (the plain PyTorch versions)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    install_artifact_flush()
    from cook_tpu_torch.config import Settings
    from cook_tpu_torch.scheduler.leader import (FileLeaderElector,
                                           StandaloneElector)
    from cook_tpu_torch.utils.metrics import JsonlReporter, registry

    settings = Settings.from_file(args.config) if args.config else Settings()
    if args.port != 12321:
        settings.port = args.port
    settings.url = settings.url or f"http://127.0.0.1:{settings.port}"
    store, coord, api = build_scheduler(settings,
                                        read_only=args.no_cycles,
                                        device=args.device)
    # the hint non-leaders hand to clients: for api-only replicas this
    # must be the real leader's (or the HA service's) address, not our
    # own — a self-hint is a dead end for a rejected write
    api.leader_url = settings.leader_hint_url or settings.url

    api.leader_ready = threading.Event()

    # SIGHUP = live membership reload: re-read the config file's
    # federation block and apply it through the same path as POST
    # /federation/reload. The apply runs off the signal frame — drains
    # POST to peers and must never run inside a signal handler.
    def _sighup_reload(signum=None, frame=None):
        del signum, frame

        def apply():
            if not args.config:
                log.warning("SIGHUP reload: no --config file to re-read")
                return
            try:
                fresh = Settings.from_file(args.config)
                if not fresh.federation:
                    log.warning(
                        "SIGHUP reload: config has no federation block")
                    return
                mep, result = api.apply_membership_reload(
                    fresh.federation, by="sighup", propagate=True)
                log.info("SIGHUP membership reload %d: %s", mep, result)
            except Exception:
                log.exception("SIGHUP membership reload failed")

        threading.Thread(target=apply, daemon=True).start()

    import signal
    try:
        signal.signal(signal.SIGHUP, _sighup_reload)
    except (ValueError, OSError, AttributeError):
        pass   # non-main thread (embedded) or no SIGHUP on platform
    report_incarnation(coord.device)

    def _still_leader():
        elector = getattr(api, "leader_elector", None)
        return elector.is_leader() if elector is not None else True

    def on_leadership():
        """The takeLeadership path (mesos.clj:153-223): start backends,
        scheduling cycles, monitors. Re-checks leadership around each
        step: a stalled init thread must never trim/write the shared
        log after a successor acquired the lease."""
        if not _still_leader():
            raise RuntimeError("leadership lost before takeover init")
        t_takeover = time.monotonic()
        # re-replay the shared snapshot+log: the previous leader kept
        # appending after this standby's boot-time restore
        store.reload_from(settings.snapshot_path)
        # the replay swaps the store's contents without events, so each
        # resident pool still mirrors the boot-time store: rebuild them
        # all from the replayed one at their next cycle (else the jobs
        # the old leader left waiting wait for the periodic resync)
        for rp in getattr(coord, "_resident", {}).values():
            rp.request_resync()
        # durable epoch fence: MINT a monotone fencing epoch in the
        # <log>.epoch ledger before any post-takeover write. Every log
        # entry is stamped with it ("ep"), replay drops older-epoch
        # stragglers, and — the log-level guarantee the in-memory
        # append_gate cannot give — a deposed leader's next append
        # stat()s the ledger and rejects with StaleEpochError
        # (state/store.py _fence_stale_epoch). The elector's lease
        # transition count, when it has one, floors the mint.
        elector = getattr(api, "leader_elector", None)
        lease_epoch = getattr(elector, "epoch", 0)
        epoch = store.mint_epoch(owner=settings.url, floor=lease_epoch)
        if not _still_leader():
            raise RuntimeError("leadership lost during takeover replay")
        for cluster in coord.clusters.all():
            cluster.initialize()
        # every write path is fenced: cycles + status entry early-out,
        # and the store's append gate is the chokepoint for anything
        # already in flight when the fence closes
        store.append_gate = _still_leader
        # restart reconciliation: with agent-backed clusters, gate the
        # first match cycle until the live-agent census resolves the
        # UNKNOWN (launched-but-unacked) instances the previous
        # incarnation left behind — or the grace window expires
        agentish = [c for c in coord.clusters.all()
                    if hasattr(c, "query_agent_tasks")]
        reconcile_s = settings.restart_reconcile_timeout_s
        if agentish and reconcile_s > 0:
            coord.arm_restart_reconcile(reconcile_s)
        coord.run(leadership_check=_still_leader)
        # only now may writes land: the replayed store can vouch for
        # live tasks the agents report
        if not _still_leader():
            raise RuntimeError("leadership lost during takeover init")
        # the replayed store is long-lived by definition: freeze it out
        # of the cyclic collector so gen-2 sweeps can't spike the match
        # cycle (the same tuning the e2e bench measures with)
        apply_gc_discipline()
        api.leader_ready.set()
        # takeover evidence + the cross-shard usage exchange: the gates
        # are open, so the failover clock stops here (kill -> first
        # acceptable write is what the soak and bench.py failover
        # actually measure end to end; this is the in-process share)
        fed = getattr(api, "federation", None)
        if fed is not None:
            fed.record_takeover(
                epoch, (time.monotonic() - t_takeover) * 1e3)
            fed.start_exchange()

            def finish_reconfig():
                # a membership reload the previous incarnation
                # journaled but never committed is re-driven now that
                # this leader's gates are open. Deferred until OUR
                # listener answers: a resumed leave-drain can route an
                # adopt payload right back at this group, and the
                # HTTP server only starts serving after this callback
                # returns (same ordering note as reconcile_thread).
                import urllib.request
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline:
                    try:
                        with urllib.request.urlopen(
                                f"{settings.url}/info", timeout=1.0):
                            break
                    except Exception:
                        time.sleep(0.1)
                try:
                    api.resume_membership_reload()
                except Exception:
                    log.exception("membership reload resume failed")
                fed.start_rebalancer()

            threading.Thread(target=finish_reconfig,
                             daemon=True).start()

        if agentish and reconcile_s > 0:
            def reconcile_thread():
                # agents can only register once the HTTP server
                # listens (which happens after this callback returns),
                # so the census waits for the hosts that actually hold
                # UNKNOWN instances to call home — or the deadline
                from cook_tpu_torch.state.model import (InstanceStatus,
                                                  JobState)
                deadline = time.monotonic() + reconcile_s
                want = {i.hostname for j in list(store.jobs.values())
                        if j.state == JobState.RUNNING
                        for i in j.active_instances
                        if i.status == InstanceStatus.UNKNOWN
                        and i.hostname}
                while want and time.monotonic() < deadline:
                    have = set()
                    for c in agentish:
                        try:
                            have |= {h for h, i in
                                     list(getattr(c, "agents",
                                                  {}).items())
                                     if i.alive}
                        except RuntimeError:
                            continue  # registry mutated mid-copy
                    if want <= have:
                        break
                    time.sleep(0.05)
                try:
                    coord.reconcile_restart()
                except Exception:
                    log.exception("restart reconciliation failed")

            threading.Thread(target=reconcile_thread,
                             daemon=True).start()

        def tick():  # real-time driver for mock virtual clocks + monitor
            while True:
                time.sleep(1.0)
                for cluster in coord.clusters.all():
                    if hasattr(cluster, "advance"):
                        cluster.advance(1.0)

        threading.Thread(target=tick, daemon=True).start()

        def monitor_loop():
            while True:
                time.sleep(settings.metrics_interval_s)
                try:
                    for p in coord.pools.active():
                        coord.monitor.collect(p.name)
                except Exception:
                    log.exception("stats monitor failed")

        threading.Thread(target=monitor_loop, daemon=True).start()

        if settings.snapshot_path and settings.log_path \
                and settings.snapshot_interval_s > 0:
            # periodic checkpoint + log compaction (the role Datomic's
            # indexing/gc plays for the reference): snapshot on a
            # cadence, rotate the log once it outgrows the threshold.
            # Leader-only — every write inside is append-gate fenced,
            # and followers absorb a rotation via their shrink-resync.
            def snapshot_loop():
                # checkpoints ride the store's dedicated snapshot
                # thread (snapshot_async / rotate_log(wait=False)):
                # this loop only pays the O(ms) rotation swap, and the
                # launch-txn group-commit path never queues behind the
                # chunked snapshot flush. One ticket at a time — if the
                # previous checkpoint is still in flight at the next
                # tick, skip the tick rather than queue a pile-up.
                ticket = None
                while True:
                    time.sleep(settings.snapshot_interval_s)
                    if not _still_leader():
                        continue
                    if ticket is not None and not ticket.done():
                        continue
                    ticket = None
                    try:
                        lines = store.log_lines()
                        if lines >= settings.log_rotate_lines > 0:
                            ticket = store.rotate_log(
                                settings.snapshot_path, wait=False)
                            log.info("rotated event log at %d lines",
                                     lines)
                        elif settings.snapshot_delta_chain > 0 and \
                                store.delta_chain_length() < \
                                settings.snapshot_delta_chain:
                            # delta chain: checkpoint only the jobs
                            # dirtied since the last one; a full
                            # snapshot re-bases the chain once it
                            # reaches the configured length
                            ticket = store.snapshot_delta_async(
                                settings.snapshot_path)
                        else:
                            ticket = store.snapshot_async(
                                settings.snapshot_path)
                    except Exception:
                        log.exception("snapshot/rotate failed")

            threading.Thread(target=snapshot_loop, daemon=True).start()

        if settings.completed_gc_interval_s > 0 \
                and settings.completed_retention_hours > 0:
            # retention GC for COMPLETED jobs (the role Datomic
            # excision plays for the reference, run out-of-process
            # there): without it, store memory and checkpoint size
            # grow with total jobs ever processed. Leader-only; writes
            # are append-gate fenced. Uncommitted-job GC is NOT here —
            # the coordinator watchdog already owns it
            # (uncommitted_gc_age_ms, clear-uncommitted-jobs
            # tools.clj:757); one knob, one mechanism.
            def retention_loop():
                while True:
                    time.sleep(settings.completed_gc_interval_s)
                    if not _still_leader():
                        continue
                    try:
                        n = store.gc_completed(int(
                            settings.completed_retention_hours
                            * 3_600_000))
                        if n:
                            log.info("retention: retired %d completed "
                                     "jobs", n)
                    except Exception:
                        log.exception("retention gc failed")

            threading.Thread(target=retention_loop, daemon=True).start()

    if args.no_cycles:
        # API-only read replica (the reference's api-only config role,
        # minus live writes: the reference's api-only nodes share
        # Datomic so the leader sees their writes immediately; our
        # leader only replays the shared log at takeover, so accepting
        # a write here would ack a job nothing ever schedules). All
        # writes 503 with the configured leader hint; reads serve from
        # the boot-time restore of the shared snapshot/log.
        elector = None
        api.api_only = True
        if settings.log_path:
            # keep reads fresh: incrementally apply the leader's new
            # log events (read replica; never writes)
            store.follow_log(interval_s=2.0)
    elif settings.leader_lease_url:
        from cook_tpu_torch.scheduler.leader import LeaseElector
        token = settings.leader_lease_token
        if not token and settings.leader_lease_token_path:
            with open(settings.leader_lease_token_path) as f:
                token = f.read().strip()
        elector = LeaseElector(
            settings.leader_lease_url, settings.url,
            name=settings.leader_lease_name,
            namespace=settings.leader_lease_namespace,
            lease_duration_s=settings.leader_lease_duration_s,
            token=token or None)
        elector.start(on_leadership)
    elif settings.leader_lock_path:
        elector = FileLeaderElector(settings.leader_lock_path, settings.url)
        elector.start(on_leadership)
    else:
        elector = StandaloneElector(settings.url)
        elector.start(on_leadership)
    if elector is not None:
        api.leader_elector = elector

    if settings.metrics_jsonl:
        JsonlReporter(registry, settings.metrics_jsonl,
                      interval_s=settings.metrics_interval_s).start()
    if settings.spans_jsonl:
        from cook_tpu_torch import obs
        obs.tracer.add_listener(obs.SpanJsonlExporter(
            settings.spans_jsonl, max_mb=settings.spans_jsonl_max_mb))
    if settings.profile_jsonl:
        from cook_tpu_torch import obs
        # profiler entries are plain dicts — the span exporter's
        # line-per-record JSONL (and its size bound) fits unchanged
        obs.profiler.add_listener(obs.SpanJsonlExporter(
            settings.profile_jsonl,
            max_mb=settings.spans_jsonl_max_mb))
    server = ApiServer(api, port=settings.port).start()
    log.info("cook_tpu_torch scheduler listening on %s (leader=%s)",
             server.url,
             elector.is_leader() if elector is not None else "api-only")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
        if api.ingest is not None:
            api.ingest.stop()
        coord.stop()
        if elector is not None:
            elector.stop()


if __name__ == "__main__":
    main()
