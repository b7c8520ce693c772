"""Configuration system: one file → validated settings tree.

Equivalent of cook.config (config.clj:134-469 config-settings plumbing
graph): every knob has a default, validation happens up front with
actionable errors, and the assembled server consumes only this tree.
JSON instead of EDN; the same keys drive `python -m
cook_tpu.rest.server --config`.

Runtime-tunable knobs (rebalancer params, mea-culpa limits) follow the
reference's pattern of living in the durable store rather than here
(rebalancer.clj:520-542) — SchedulerConfig.rebalancer holds the boot
defaults.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Optional


class ConfigError(Exception):
    pass


@dataclass
class ClusterSettings:
    kind: str = "mock"            # mock | local | kube | agent
    name: str = "mock"
    pool: str = "default"
    hosts: int = 4                # mock: number of hosts
    host_mem: float = 32_768.0
    host_cpus: float = 16.0
    host_gpus: float = 0.0
    sandbox_root: str = "/tmp/cook_tpu_sandboxes"   # local
    file_server_port: int = 12322                   # local
    max_synthetic_pods: int = 30                    # kube
    # kube with a real apiserver: base URL + auth (HttpKube); when
    # kube_url is empty a kube cluster runs against the in-memory fake
    # (dev mode, like the reference's minimesos/testutil setups)
    kube_url: str = ""
    kube_namespace: str = "cook"
    kube_token_path: str = ""
    kube_ca_path: str = ""
    kube_insecure: bool = False
    # agent: network agents register themselves; timeout fails their
    # tasks host-lost
    agent_heartbeat_timeout_s: float = 30.0
    # lease-based liveness machine (scheduler/liveness.py) over the
    # raw heartbeat cutoff: alive -> suspect -> dead -> resurrected.
    # liveness_grace_s is the window between an agent going dead
    # (offers withdrawn) and its tasks being failed mea-culpa —
    # 0 keeps the legacy fail-immediately-on-dead timing while still
    # getting suspect/resurrect semantics; liveness_suspect_after_s
    # 0 = half the heartbeat timeout.
    liveness_enabled: bool = True
    liveness_grace_s: float = 0.0
    liveness_suspect_after_s: float = 0.0

    def validate(self) -> None:
        if self.kind not in ("mock", "local", "kube", "agent"):
            raise ConfigError(f"unknown cluster kind {self.kind!r}")
        if self.hosts < 0 or self.host_mem <= 0 or self.host_cpus <= 0:
            raise ConfigError(f"cluster {self.name}: invalid host shape")
        if self.liveness_grace_s < 0 or self.liveness_suspect_after_s < 0:
            raise ConfigError(f"cluster {self.name}: liveness windows "
                              "must be >= 0")


@dataclass
class PoolSettings:
    name: str
    purpose: str = ""
    dru_mode: str = "default"     # default | gpu

    def validate(self) -> None:
        if self.dru_mode not in ("default", "gpu"):
            raise ConfigError(f"pool {self.name}: dru_mode must be "
                              "default|gpu")


@dataclass
class RateLimitSettings:
    tokens_per_sec: float = float("inf")
    max_tokens: float = float("inf")
    enforce: bool = False


@dataclass
class AuthSettings:
    scheme: str = "one-user"      # one-user | basic | header
    one_user: str = "root"
    admins: list = field(default_factory=list)
    imposters: list = field(default_factory=list)
    authorization: str = "configfile-admins-auth"
    cors_origins: list = field(default_factory=list)
    # shared secret for the /agents machine channel; REQUIRED whenever
    # an agent cluster is configured unless dev_mode is set (see
    # Settings.validate). agent_token_previous is accepted during a
    # rotation window.
    agent_token: str = ""
    agent_token_previous: str = ""

    def validate(self) -> None:
        if self.scheme not in ("one-user", "basic", "header"):
            raise ConfigError(f"unknown auth scheme {self.scheme!r}")
        if self.agent_token_previous and not self.agent_token:
            raise ConfigError("agent_token_previous without agent_token")


@dataclass
class SchedulerSettings:
    max_jobs_considered: int = 1024     # fenzo-max-jobs-considered
    scaleback: float = 0.95
    match_interval_s: float = 1.0
    rank_interval_s: float = 5.0
    rebalancer_interval_s: float = 300.0
    rebalancer_safe_dru_threshold: float = 1.0
    rebalancer_min_dru_diff: float = 0.5
    rebalancer_max_preemption: int = 64
    rebalancer_candidate_cap: int = 0   # 0 = exact; >0 = top-K victims
    sequential_match_threshold: int = 2048
    # fused Pallas TPU matcher kernels: true | false | "auto".
    # "auto" races BOTH lowerings on the actual device at startup and
    # takes the winner (ops/pallas_probe — rounds 2-4 measured parity
    # on a v5e, and the winner can differ by device generation, so the
    # empirical probe replaces a hardcoded guess). Non-TPU platforms
    # resolve "auto" to false.
    use_pallas: object = False
    # device-resident match path (scheduler/resident.py): tensors stay
    # on device, the host ships store-event deltas. THE production
    # default — full feature parity with the legacy cycle (plugins,
    # data locality, estimated completion all supported); set false to
    # force the legacy per-cycle re-tensorize path.
    resident_match: bool = True
    # shard ONE pool's resident host tensors over this many devices
    # (0/1 = single device). Opt in when a pool's host count or HBM
    # footprint exceeds one chip: the match runs the distributed scan
    # (parallel/sharded_match — shard-local scoring, pmax/pmin argmax
    # over ICI), unique host-placement groups included. Applies to
    # every resident pool the server enables.
    resident_shard_devices: int = 0
    # hash-sharded in-order status executors (scheduler.clj:1524-1546);
    # 0 = inline on the backend callback thread
    status_shards: int = 19
    # launch-ack watchdog (coordinator): instance launched but never
    # acknowledged RUNNING within this window fails 5003 (mea-culpa)
    # and requeues; must exceed the worst honest fetch+start time
    launch_ack_timeout_s: float = 300.0
    # async consume executor: how many keyed in-order workers drain
    # matched prefixes (cycle consume/launch). Each pool's work stays
    # on one worker (per-pool ordering preserved); multiple pools
    # drain concurrently. 1 = the old single shared consumer thread.
    consume_workers: int = 4
    # parallel agent fan-out (backends/agent.py): a launch batch that
    # spans K hosts ships as K concurrent POSTs on a bounded executor
    # instead of a serial per-host loop; per-host ordering holds (one
    # POST per host per batch). 1 = the old serial loop.
    launch_fanout_workers: int = 8
    # per-job decision provenance: read back the device cycle's
    # reason-code tensor and record it in the DecisionBook that backs
    # GET /unscheduled and /debug/decisions. The codes are computed on
    # device either way (pure epilogue arithmetic); this gates only the
    # extra host readback + bookkeeping — disable to shave the last
    # percent off cycle latency on hot clusters.
    decision_provenance: bool = True
    # per-task executor heartbeat timeout (HeartbeatWatcher): a RUNNING
    # task whose executor goes silent this long fails 3000 mea-culpa.
    # Replaces the old hard-coded HEARTBEAT_TIMEOUT_S module constant.
    heartbeat_timeout_s: float = 15 * 60.0
    # adaptive overload controller (scheduler/overload.py): watermarks
    # for the pressure signals and the hysteresis dwell counts of the
    # shed ladder (docs/robustness.md "Agent liveness & overload
    # shedding"). overload_enabled=false removes the controller — no
    # shedding, zero hot-path reads.
    overload_enabled: bool = True
    overload_cycle_p99_ms: float = 1000.0
    # consume pipeline depth (resident match path): how many matched
    # cycles may be in flight between the device match and the host
    # consume/launch fold. 0 = strictly synchronous (each cycle's
    # consume completes before the next dispatch); N>0 lets the device
    # run N cycles ahead while the host folds earlier results —
    # overlapping readback with status/launch work is where the
    # single-leader dispatch rate comes from. Async pools size their
    # consume backpressure from the same knob (min 2).
    pipeline_depth: int = 2
    # native consume fast path (cook_tpu/native/consumefold): C folds
    # for status-line assembly, CKS1 frame splicing and _used
    # bookkeeping. Byte-identical Python fallback; false forces the
    # Python path process-wide (operational escape hatch — the
    # differential oracle pins both paths together).
    native_consume: bool = True
    overload_launch_txn_p99_ms: float = 500.0
    overload_escalate_after: int = 3
    overload_relax_after: int = 10

    def validate(self) -> None:
        if self.max_jobs_considered < 1:
            raise ConfigError("max_jobs_considered must be >= 1")
        if self.launch_ack_timeout_s <= 0:
            raise ConfigError("launch_ack_timeout_s must be > 0")
        if self.consume_workers < 1:
            raise ConfigError("consume_workers must be >= 1")
        if self.launch_fanout_workers < 1:
            raise ConfigError("launch_fanout_workers must be >= 1 "
                              "(1 = serial per-host launch)")
        if not 0 < self.scaleback <= 1:
            raise ConfigError("scaleback must be in (0, 1]")
        if self.heartbeat_timeout_s <= 0:
            raise ConfigError("heartbeat_timeout_s must be > 0")
        if self.overload_escalate_after < 1 or self.overload_relax_after < 1:
            raise ConfigError("overload dwell counts must be >= 1")
        if self.rebalancer_candidate_cap < 0:
            raise ConfigError("rebalancer_candidate_cap must be >= 0 "
                              "(0 = exact sweep)")
        if not 0 <= self.pipeline_depth <= 8:
            raise ConfigError("pipeline_depth must be in [0, 8] "
                              "(0 = synchronous consume)")
        if not isinstance(self.use_pallas, bool) \
                and str(self.use_pallas).lower() != "auto":
            raise ConfigError(
                f"use_pallas must be true, false or 'auto'; "
                f"got {self.use_pallas!r}")


@dataclass
class ChaosSettings:
    """Deterministic fault injection (cook_tpu.chaos). Disabled unless
    both `enabled` and at least one site are set; COOK_CHAOS_SITES /
    COOK_CHAOS_SEED env vars override this section at server start
    (the chaos-soak CI job uses the env path)."""
    enabled: bool = False
    seed: int = 0
    # site name -> {drop/delay/error/duplicate/torn: prob,
    #               delay_ms, error_status} (see cook_tpu/chaos)
    sites: dict = field(default_factory=dict)

    def validate(self) -> None:
        from cook_tpu_torch import chaos as _chaos
        for name, spec in self.sites.items():
            try:
                _chaos._Site(dict(spec or {}), self.seed, name)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"chaos.sites[{name!r}]: {e}")


def validate_federation(fed: dict) -> None:
    """Validate a ``federation`` config block. Factored out of
    Settings.validate so POST /federation/reload (and the SIGHUP
    reload path) can vet a PROPOSED block with exactly the boot-time
    rules before journaling a membership change — an invalid target
    view must be rejected before the ledger ever records intent."""
    if not isinstance(fed, dict):
        raise ConfigError("federation must be a mapping")
    groups = fed.get("groups") or {}
    if not isinstance(groups, dict):
        raise ConfigError("federation.groups must be a mapping "
                          "of group name -> spec")
    group = fed.get("group", "")
    if groups and (not group or group not in groups):
        raise ConfigError(
            f"federation.group {group!r} must name an entry in "
            "federation.groups")
    for name, spec in groups.items():
        if not isinstance(spec, dict):
            raise ConfigError(
                f"federation.groups[{name!r}] must be a mapping")
        unknown = set(spec) - {"pools", "url", "devices"}
        if unknown:
            raise ConfigError(
                f"federation.groups[{name!r}]: unknown keys "
                f"{sorted(unknown)}")
        devs = spec.get("devices", [])
        if not all(isinstance(d, int) and d >= 0 for d in devs):
            raise ConfigError(
                f"federation.groups[{name!r}].devices must be "
                "non-negative device indices")
    owners: dict = {}
    for name, spec in groups.items():
        for p in spec.get("pools", []):
            if p in owners:
                raise ConfigError(
                    f"pool {p!r} claimed by both "
                    f"{owners[p]!r} and {name!r}")
            owners[p] = name
    if float(fed.get("exchange_interval_s", 2.0)) <= 0:
        raise ConfigError(
            "federation.exchange_interval_s must be > 0")
    if float(fed.get("global_quota_staleness_s", 10.0)) < 0:
        raise ConfigError(
            "federation.global_quota_staleness_s must be >= 0 "
            "(0 = never flag folds stale)")
    rebalance = fed.get("rebalance")
    if rebalance is not None:
        if not isinstance(rebalance, dict):
            raise ConfigError("federation.rebalance must be a mapping")
        from cook_tpu_torch.scheduler.federation import REBALANCE_DEFAULTS
        unknown = set(rebalance) - set(REBALANCE_DEFAULTS)
        if unknown:
            raise ConfigError(
                f"federation.rebalance: unknown keys {sorted(unknown)}")
        for key in ("interval_s", "cooldown_s"):
            if float(rebalance.get(key,
                                   REBALANCE_DEFAULTS[key])) <= 0:
                raise ConfigError(
                    f"federation.rebalance.{key} must be > 0")
        if int(rebalance.get("hysteresis_rounds",
                             REBALANCE_DEFAULTS["hysteresis_rounds"])) \
                < 1:
            raise ConfigError(
                "federation.rebalance.hysteresis_rounds must be >= 1")


@dataclass
class TaskConstraintSettings:
    max_mem_mb: float = 256 * 1024
    max_cpus: float = 128
    max_gpus: float = 8
    max_retries: int = 1000


@dataclass
class Settings:
    port: int = 12321
    # dev_mode relaxes production-safety validation (open agent
    # channel); never set it in a real deployment
    dev_mode: bool = False
    default_pool: str = "default"
    pools: list = field(default_factory=list)          # [PoolSettings]
    clusters: list = field(default_factory=lambda: [ClusterSettings()])
    scheduler: SchedulerSettings = field(default_factory=SchedulerSettings)
    auth: AuthSettings = field(default_factory=AuthSettings)
    task_constraints: TaskConstraintSettings = field(
        default_factory=TaskConstraintSettings)
    chaos: ChaosSettings = field(default_factory=ChaosSettings)
    rate_limits: dict = field(default_factory=dict)
    # {user_submit|user_launch|global_launch: RateLimitSettings}
    log_path: Optional[str] = None
    snapshot_path: Optional[str] = None
    # periodic checkpoint + log compaction (leader-only; 0 disables).
    # When the event log exceeds log_rotate_lines, snapshot + rotate
    # (JobStore.rotate_log) instead of snapshotting alongside.
    snapshot_interval_s: float = 300.0
    log_rotate_lines: int = 1_000_000
    # delta-snapshot chain (JobStore.snapshot_delta): between full
    # snapshots the periodic checkpoint writes only the jobs dirtied
    # since the last one, so checkpoint cost tracks churn instead of
    # store size and restore replays snapshot -> deltas -> log tail.
    # Value = max chain length before the next checkpoint is forced
    # full again; 0 disables (every checkpoint is a full snapshot).
    snapshot_delta_chain: int = 16
    # restart reconciliation (Coordinator.reconcile_restart): how long
    # the first post-restore match cycle may wait for the live-agent
    # census before matching resumes anyway; 0 disables the gate
    restart_reconcile_timeout_s: float = 30.0
    # retention GC for completed jobs (leader-only; the role Datomic
    # excision plays for the reference — without it completed jobs
    # live forever in memory and in every checkpoint). OPT-IN: the
    # default 0 disables it, because expiring completed jobs makes
    # them 404 from the API — a user-visible divergence from the
    # reference, where in-repo Cook only GCs uncommitted jobs and
    # history excision is an explicit out-of-process deployment action
    # (see PARITY.md). Deployments that need bounded store memory set
    # an interval explicitly. Uncommitted-job GC is separate: the
    # coordinator watchdog's uncommitted_gc_age_ms owns that.
    completed_gc_interval_s: float = 0.0
    completed_retention_hours: float = 72.0
    leader_lock_path: Optional[str] = None   # None = standalone leader
    # distributed HA via Kubernetes Lease objects (no shared FS): point
    # at an apiserver and every candidate races for the named lease
    leader_lease_url: str = ""
    leader_lease_name: str = "cook-leader"
    leader_lease_namespace: str = "cook"
    leader_lease_duration_s: float = 10.0
    leader_lease_token: str = ""
    leader_lease_token_path: str = ""   # e.g. the in-cluster SA token
    url: str = ""                             # published leader URL
    # address handed to clients by non-leaders/replicas refusing a
    # write (e.g. the HA service/virtual-IP); defaults to `url`
    leader_hint_url: str = ""
    metrics_jsonl: Optional[str] = None
    metrics_interval_s: float = 60.0
    # event-driven span export (obs tracer): one JSON line per
    # finished span, alongside the interval-driven metric reporters.
    # spans_jsonl_max_mb > 0 bounds the file: at the bound it rotates
    # to <path>.1 (one old generation kept), so a long-lived server
    # holds at most ~2x the bound on disk. 0 = unbounded (legacy).
    spans_jsonl: Optional[str] = None
    spans_jsonl_max_mb: float = 0.0
    # always-on cycle profiler (obs/profiler.py): ring of per-cycle
    # phase ledgers behind /debug/profile. profile_ring sizes the
    # bounded ring (entries, not bytes); profile_jsonl streams one
    # JSON line per committed cycle record for offline analysis.
    profile_ring: int = 2048
    profile_jsonl: Optional[str] = None
    plugins: dict = field(default_factory=dict)
    # {"optimizer": "pkg.mod:factory" | "capacity-planning",
    #  "host_feed": "pkg.mod:factory", "interval_s": 30}
    optimizer: dict = field(default_factory=dict)
    data_locality: dict = field(default_factory=dict)
    # {fetcher: "pkg.mod:factory", weight: 0.25, batch_size: 500}
    # federated per-pool control plane (scheduler/federation.py):
    # {"group": "blue",
    #  "groups": {"blue": {"pools": [...], "url": "http://...",
    #                      "devices": [0, 1]}, ...},
    #  "exchange_interval_s": 2.0, "global_quota": false,
    #  "global_quota_staleness_s": 10.0}
    # Empty = single-group federation owning every pool. "devices" is
    # a group's device-placement claim: indices into jax.devices()
    # over which its pools' resident cycles are spread
    # (parallel/federation.place_pools).
    federation: dict = field(default_factory=dict)
    # cluster-wide default-checkpoint-config (config/kubernetes
    # :default-checkpoint-config): merged under each job's checkpoint
    # config by the matcher and the kube backend
    checkpoint: dict = field(default_factory=dict)
    # coalescing ingest (rest/ingest.py): submissions commit through a
    # bounded queue drained by N workers, one group-commit fdatasync
    # per drained batch; a full queue answers 429 + Retry-After.
    # ingest_workers: 0 disables the layer (one txn per request).
    ingest_workers: int = 2
    ingest_queue_depth: int = 512
    ingest_max_batch: int = 512
    # cross-lane launch group-commit (JobStore group_commit): every
    # lane's launch txn joins a shared fsync barrier, so N concurrent
    # consume lanes pay ~1 fsync per drain instead of N. Durability is
    # unchanged — the launch ack still waits for ITS round's fsync.
    launch_group_commit: bool = True
    # pool-sharded store locks (JobStore store_shards): transactions
    # take only their pool's shard lock, so per-pool consume lanes and
    # status folds stop serializing on one mutex. 1 = the old single-
    # lock behavior (the differential-oracle A/B arm).
    store_shards: int = 4
    # zero-copy event encoding (JobStore native_encoder): hot txn
    # records are appended as preencoded byte segments through the
    # native writer's scatter-gather entry point; off = the legacy
    # dict→json.dumps→str path (byte-identical logs either way).
    store_native_encoder: bool = True

    @classmethod
    def from_dict(cls, raw: dict) -> "Settings":
        known = set(cls.__dataclass_fields__)
        unknown = set(raw) - known
        if unknown:
            raise ConfigError(f"unknown config keys: {sorted(unknown)}")
        s = cls(**{k: v for k, v in raw.items()
                   if k not in ("pools", "clusters", "scheduler", "auth",
                                "task_constraints", "rate_limits",
                                "chaos")})
        s.pools = [PoolSettings(**p) for p in raw.get("pools", [])]
        s.clusters = [ClusterSettings(**c) for c in
                      raw.get("clusters", [asdict(ClusterSettings())])]
        s.scheduler = SchedulerSettings(**raw.get("scheduler", {}))
        s.auth = AuthSettings(**raw.get("auth", {}))
        s.task_constraints = TaskConstraintSettings(
            **raw.get("task_constraints", {}))
        s.chaos = ChaosSettings(**raw.get("chaos", {}))
        s.rate_limits = {k: RateLimitSettings(**v)
                         for k, v in raw.get("rate_limits", {}).items()}
        s.validate()
        return s

    @classmethod
    def from_file(cls, path: str) -> "Settings":
        with open(path) as f:
            try:
                raw = json.load(f)
            except ValueError as e:
                raise ConfigError(f"malformed config {path}: {e}")
        return cls.from_dict(raw)

    def validate(self) -> None:
        if not 0 < self.port < 65536:
            raise ConfigError(f"invalid port {self.port}")
        for p in self.pools:
            p.validate()
        names = [c.name for c in self.clusters]
        if len(names) != len(set(names)):
            raise ConfigError("duplicate cluster names")
        for c in self.clusters:
            c.validate()
        self.scheduler.validate()
        self.auth.validate()
        self.chaos.validate()
        if self.snapshot_delta_chain < 0:
            raise ConfigError("snapshot_delta_chain must be >= 0 "
                              "(0 = full snapshots only)")
        if self.store_shards < 1:
            raise ConfigError("store_shards must be >= 1")
        if self.restart_reconcile_timeout_s < 0:
            raise ConfigError("restart_reconcile_timeout_s must be "
                              ">= 0 (0 = no match-cycle gate)")
        if self.ingest_workers < 0:
            raise ConfigError("ingest_workers must be >= 0 "
                              "(0 = no ingest batching)")
        if self.ingest_workers and (self.ingest_queue_depth < 1
                                    or self.ingest_max_batch < 1):
            raise ConfigError("ingest_queue_depth and ingest_max_batch "
                              "must be >= 1 when ingest_workers > 0")
        if self.federation:
            validate_federation(self.federation)
        # a write-capable machine channel must not default open: an
        # agent cluster without an agent token is only a dev setup
        if any(c.kind == "agent" for c in self.clusters) \
                and not self.auth.agent_token and not self.dev_mode:
            raise ConfigError(
                "an 'agent' cluster requires auth.agent_token (or an "
                "explicit dev_mode: true for local development) — an "
                "open agent registration channel accepts task statuses "
                "from anyone")
        for key in self.rate_limits:
            if key not in ("user_submit", "user_launch", "global_launch"):
                raise ConfigError(f"unknown rate limit {key!r}")

    def public(self) -> dict:
        """Sanitized view for GET /settings (no secrets)."""
        d = asdict(self)
        d.pop("plugins", None)
        d["auth"] = {"scheme": self.auth.scheme}
        return d
