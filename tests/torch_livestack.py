"""Shared live-server harness for integration-tier tests.

Two tiers:

- ``Stack``: one embedded HTTP server + coordinator + mock
  virtual-clock cluster, in-process — the testutil.clj
  run-test-server-in-thread role for suites that drive the stack over
  the wire.
- ``LiveServer``: the port's server (``python -m
  cook_tpu_torch.rest.server --device <device>``) as a supervised
  SUBPROCESS over a durable store directory, with procfault kill points
  armable — the crash-soak harness. Each incarnation writes its pid and
  device to the server log at boot, and its kernel launches on SIGTERM
  (``incarnations``). A SIGKILL
  takes the whole process (no atexit, no flushes), exactly like an OOM
  kill; the supervisor restarts it against the same store dir and the
  test asserts recovery invariants from outside.
"""
import json
import os
import socket

from cook_tpu_torch.chaos import procfault
from cook_tpu_torch.backends.base import ClusterRegistry
from cook_tpu_torch.backends.mock import MockCluster
from cook_tpu_torch.client import JobClient
from cook_tpu_torch.rest.api import CookApi
from cook_tpu_torch.rest.auth import AuthConfig
from cook_tpu_torch.rest.server import INCARNATION, ApiServer
from cook_tpu_torch.scheduler.coordinator import Coordinator, SchedulerConfig
from cook_tpu_torch.scheduler.federation import FederationHost
from cook_tpu_torch.state.limits import QuotaStore, RateLimiter, ShareStore
from cook_tpu_torch.state.store import JobStore


class Stack:
    """One live server + coordinator + mock cluster, REST-addressable."""

    def __init__(self, hosts, config=None, pools=None,
                 submission_rate=None, user_launch_rate=None):
        self.store = JobStore()
        self.cluster = MockCluster(hosts)
        reg = ClusterRegistry()
        reg.register(self.cluster)
        self.shares = ShareStore()
        self.quotas = QuotaStore()
        kw = {}
        if user_launch_rate is not None:
            kw["user_launch_rate_limiter"] = RateLimiter(
                tokens_per_sec=user_launch_rate[0],
                max_tokens=user_launch_rate[1])
        self.coord = Coordinator(
            self.store, reg, shares=self.shares, quotas=self.quotas,
            pools=pools, config=config or SchedulerConfig(), **kw)
        sub_rl = None
        if submission_rate is not None:
            sub_rl = RateLimiter(tokens_per_sec=submission_rate[0],
                                 max_tokens=submission_rate[1])
        self.api = CookApi(
            self.store, coordinator=self.coord,
            auth=AuthConfig(scheme="header", admins={"admin"}),
            submission_rate_limiter=sub_rl)
        self.server = ApiServer(self.api).start()
        # mirror the real server's wiring (build_scheduler + the
        # on_leadership epilogue): every deployment runs the degenerate
        # single-group federation, mints an epoch, and records the
        # initial takeover — so /debug carries a federation block and
        # /metrics the failover families
        self.federation = FederationHost.single(store=self.store,
                                                url=self.server.url)
        self.coord.federation = self.federation
        self.api.federation = self.federation
        self.federation.record_takeover(self.store.mint_epoch(
            owner=self.server.url), 0.0)
        self.admin = JobClient(self.server.url, user="admin")

    def client(self, user):
        return JobClient(self.server.url, user=user)

    def set_share(self, user, **share):
        self.admin._request("POST", "/share",
                            body={"user": user, "share": share})

    def set_quota(self, user, **quota):
        self.admin._request("POST", "/quota",
                            body={"user": user, "quota": quota})

    def stop(self):
        self.server.stop()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def incarnations(log_path) -> list:
    """The server incarnations a log holds, in boot order: each a dict
    of its pid and device, and `kernel_launches` (None until it wrote
    them on SIGTERM; a SIGKILLed incarnation never does)."""
    out: dict = {}
    try:
        with open(log_path, errors="replace") as f:
            for line in f:
                i = line.find(INCARNATION)
                if i < 0:
                    continue
                try:
                    rec = json.loads(line[i + len(INCARNATION):])
                except ValueError:
                    continue
                got = out.setdefault(rec["pid"], {
                    "pid": rec["pid"], "device": rec["device"],
                    "kernel_launches": None})
                if "kernel_launches" in rec:
                    got["kernel_launches"] = rec["kernel_launches"]
    except OSError:
        pass
    return list(out.values())


def _merge(base: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


class LiveServer:
    """Supervised out-of-process server over a durable store dir.

    Agents are expected to run in the TEST process (so launch-count
    evidence survives server kills); the server subprocess owns the
    store, the coordinator, and the armed kill points. Small intervals
    compress a production day's checkpoint/rotation cadence into the
    soak's seconds.
    """

    AGENT_TOKEN = "livestack-secret"

    def __init__(self, store_dir, sites=None, seed=0, max_kills=2,
                 overrides=None, name=None, port=None, device="cuda"):
        """``name`` suffixes the per-process files (config, kill
        budget, server log) so an HA PAIR can share one store_dir —
        the durable snapshot+log stay shared (that's the point of the
        pair) while each member keeps its own supervisor evidence.
        ``port`` pins the listen port: a FLEET topology must know every
        member's URL before any member's config is written (each
        group's federation block names all peers), so the fleet soak
        pre-allocates ports and passes them in. ``device`` is the
        server's ``--device`` ("cuda" unless the caller asks for
        "cpu")."""
        self.store_dir = str(store_dir)
        self.name = name
        os.makedirs(self.store_dir, exist_ok=True)
        self.port = port if port is not None else free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        cfg = {
            "port": self.port,
            "url": self.url,
            "dev_mode": True,
            "log_path": os.path.join(self.store_dir, "events.log"),
            "snapshot_path": os.path.join(self.store_dir,
                                          "snapshot.json"),
            "snapshot_interval_s": 0.5,
            "snapshot_delta_chain": 6,
            "log_rotate_lines": 10_000,
            "restart_reconcile_timeout_s": 5.0,
            "auth": {"scheme": "header",
                     "agent_token": self.AGENT_TOKEN},
            "clusters": [{"kind": "agent", "name": "agents",
                          "agent_heartbeat_timeout_s": 3.0}],
            "scheduler": {"match_interval_s": 0.1,
                          "launch_ack_timeout_s": 3.0,
                          "resident_match": False,
                          "use_pallas": False,
                          "status_shards": 0},
        }
        _merge(cfg, overrides or {})
        sfx = f"-{name}" if name else ""
        self.config_path = os.path.join(self.store_dir,
                                        f"config{sfx}.json")
        with open(self.config_path, "w") as f:
            json.dump(cfg, f, indent=1)
        self.budget_file = os.path.join(self.store_dir,
                                        f"kills{sfx}.jsonl")
        self.server_log = os.path.join(self.store_dir,
                                       f"server{sfx}.log")
        self.sup = procfault.ServerSupervisor(
            self.config_path, self.url, sites=sites, seed=seed,
            max_kills=max_kills, budget_file=self.budget_file,
            log_path=self.server_log, device=device)

    def start(self, ready_timeout_s: float = 120.0) -> "LiveServer":
        self.sup.start(ready_timeout_s)
        return self

    def ensure_alive(self, ready_timeout_s: float = 120.0) -> bool:
        return self.sup.ensure_alive(ready_timeout_s)

    def client(self, user: str) -> JobClient:
        return JobClient(self.url, user=user, timeout=5.0)

    def debug(self) -> dict:
        import urllib.request
        with urllib.request.urlopen(self.url + "/debug",
                                    timeout=5.0) as r:
            return json.loads(r.read())

    def kills(self) -> list:
        try:
            with open(self.budget_file) as f:
                return [json.loads(l) for l in f if l.strip()]
        except OSError:
            return []

    def incarnations(self) -> list:
        """This member's server incarnations (``incarnations``)."""
        return incarnations(self.server_log)

    def stop(self) -> None:
        self.sup.stop()
