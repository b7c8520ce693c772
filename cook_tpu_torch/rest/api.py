"""The REST API: every user-facing endpoint of the framework.

Equivalent of cook.rest.api (rest/api.clj, 3343 LoC; route table
:3058-3340).  Framework-free: a small Router dispatches (method, path)
to handler methods on CookApi; cook_tpu.rest.server mounts it on a
stdlib ThreadingHTTPServer.  Endpoint parity:

  POST/GET/DELETE /jobs (+ /jobs/:uuid)      submission/query/kill
  POST/GET/DELETE /rawscheduler              deprecated alias
  GET /instances/:uuid, DELETE /instances    instance query/kill
  GET/POST/DELETE /share /quota              fair-share & quota admin
  GET /usage                                 per-user running usage
  POST/GET /retry                            retry management
  GET /group                                 group status
  GET /failure_reasons /settings /pools /info
  GET /unscheduled_jobs                      why-pending explainer
  GET /stats/instances                       runtime percentiles
  POST /progress/:uuid                       sidecar progress intake
  GET /queue /running /list                  scheduler introspection

Submission semantics (create-jobs! rest/api.clj:1805): validate every
job, write the batch uncommitted, then flip the commit latch — the
store's create_jobs/commit_jobs reproduce make-commit-latch
(rest/api.clj:659).  Per-user submission rate limiting returns 429
(rate_limit.clj:28).
"""
from __future__ import annotations

import json
import logging
import re
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from cook_tpu_torch import __version__ as VERSION
from cook_tpu_torch import obs
from cook_tpu_torch.chaos import procfault
from cook_tpu_torch.rest.auth import (AuthConfig, AuthError, authenticate,
                                require_authorized)
from cook_tpu_torch.rest.ingest import IngestQueueFull
from cook_tpu_torch.scheduler import unscheduled
from cook_tpu_torch.state import task_stats
from cook_tpu_torch.state.limits import UNLIMITED
from cook_tpu_torch.state.model import (Group, Instance, InstanceStatus, Job,
                                  JobState, REASONS,
                                  REASON_BY_CODE as _REASON_BY_CODE,
                                  new_uuid, now_ms)
from cook_tpu_torch.state.store import (NotLeaderError, PoolBusyError,
                                  TransactionError)

log = logging.getLogger(__name__)

_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$", re.I)
_NAME_RE = re.compile(r"^[\.a-zA-Z0-9_-]{0,128}$")


class ApiError(Exception):
    def __init__(self, status: int, message, data: Optional[dict] = None):
        super().__init__(str(message))
        self.status = status
        self.body = {"error": message, **(data or {})}


@dataclass
class Request:
    method: str
    path: str
    query: dict            # str -> list[str]
    body: Any              # parsed JSON or None
    headers: dict          # lower-cased keys
    user: str = ""

    def qp(self, key: str, default=None) -> Optional[str]:
        vals = self.query.get(key)
        return vals[0] if vals else default

    def qlist(self, *keys) -> list[str]:
        out = []
        for k in keys:
            out.extend(self.query.get(k, []))
        return out


@dataclass
class Response:
    status: int
    body: Any = None
    headers: dict = field(default_factory=dict)


@dataclass
class TaskConstraints:
    """Per-task resource ceilings enforced at submission
    (config :task-constraints, config.clj:232-247)."""

    max_mem_mb: float = 256 * 1024
    max_cpus: float = 128
    max_gpus: float = 8
    max_retries: int = 1000
    max_expected_runtime_ms: int = 10 * 24 * 3600 * 1000


class Router:
    def __init__(self):
        self._routes: list[tuple[str, re.Pattern, Callable]] = []
        # (method, pattern, handler) with the ORIGINAL ":name" pattern,
        # for the machine-readable API description (rest/openapi.py —
        # the compojure-api swagger role, rest/api.clj:3058-3340)
        self.route_table: list[tuple[str, str, Callable]] = []

    def add(self, method: str, pattern: str, handler: Callable) -> None:
        # pattern like "/jobs/:uuid" — ":name" captures a path segment
        regex = re.sub(r":(\w+)", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method, re.compile(f"^{regex}$"), handler))
        self.route_table.append((method, pattern, handler))

    def dispatch(self, req: Request) -> Response:
        path_matched = False
        for method, regex, handler in self._routes:
            m = regex.match(req.path)
            if not m:
                continue
            path_matched = True
            if method != req.method:
                continue
            return handler(req, **m.groupdict())
        if path_matched:
            return Response(405, {"error": "method not allowed"})
        return Response(404, {"error": f"unknown path {req.path}"})


class CookApi:
    """All endpoint handlers, bound to the live scheduler objects."""

    def __init__(self, store, coordinator=None, shares=None, quotas=None,
                 pools=None, auth: Optional[AuthConfig] = None,
                 task_constraints: Optional[TaskConstraints] = None,
                 submission_rate_limiter=None, settings: Optional[dict] = None,
                 leader_url: str = "", plugins=None, ingest=None):
        self.store = store
        # optional rest.ingest.IngestBatcher: when attached, submissions
        # commit through the coalescing ingest queue (one group-commit
        # fdatasync per drained batch) instead of one txn per request
        self.ingest = ingest
        self.coord = coordinator
        self.shares = shares if shares is not None else \
            getattr(coordinator, "shares", None)
        self.quotas = quotas if quotas is not None else \
            getattr(coordinator, "quotas", None)
        self.pools = pools if pools is not None else \
            getattr(coordinator, "pools", None)
        self.auth = auth or AuthConfig()
        self.tc = task_constraints or TaskConstraints()
        self.submit_rl = submission_rate_limiter
        self.plugins = plugins if plugins is not None else \
            getattr(coordinator, "plugins", None)
        self.settings = settings or {}
        self.leader_url = leader_url
        self.started_ms = now_ms()
        self.router = self._build_router()

    # ------------------------------------------------------------------
    def handle(self, method: str, path: str, query: dict, body: Any,
               headers: dict) -> Response:
        req = Request(method=method, path=path, query=query, body=body,
                      headers=headers)
        try:
            if path.startswith("/agents"):
                # machine channel: agents authenticate with the shared
                # token, not a user principal. With real user auth
                # configured, a token is REQUIRED — a write-capable
                # control plane must not be the open back door.
                if self.auth.agent_token:
                    if not self.auth.agent_token_ok(
                            headers.get("x-cook-agent-token", "")):
                        raise AuthError(401, "bad agent token")
                elif self.auth.scheme != "one-user":
                    raise AuthError(
                        401, "agent channel requires auth.agent_token "
                             "when user auth is enabled")
                # an API-only standby must not absorb agent writes into
                # its non-authoritative cluster state: refuse with the
                # leader's address so the daemon can fail over (the
                # Mesos-master-HA role of the reference's transport)
                blocked = self._leader_block(agent_channel=True)
                if blocked is not None:
                    return blocked
            elif path in ("/federation/adopt", "/federation/migrate",
                          "/federation/reload") \
                    and self.auth.agent_token \
                    and self.auth.agent_token_ok(
                        headers.get("x-cook-agent-token", "")):
                # leader-to-leader machine channel: migration peers,
                # the fleet rebalancer, and membership-reload
                # propagation authenticate with the shared fleet token
                # (same trust domain as the agent channel). An admin
                # user principal works too — the generic branch below.
                req.user = "federation-peer"
            elif path not in ("/info", "/debug", "/debug/flight",
                              "/debug/decisions", "/debug/profile",
                              "/metrics",
                              # peer-leader machine channel: read-only
                              # per-user aggregates for the cross-shard
                              # DRU exchange and the fleet health/trace
                              # rollup (same sensitivity class as the
                              # /metrics exposition)
                              "/federation/usage",
                              "/federation/health") \
                    and not path.startswith("/federation/trace/"):
                # conditional-auth-bypass
                req.user = authenticate(self.auth, headers)
            if method in ("POST", "PUT", "DELETE") \
                    and not path.startswith("/agents"):
                # a non-leader serves reads but must not accept writes
                # into a store where no scheduling cycles run (the
                # reference's API-only nodes route writes to the leader;
                # progress posts redirect, rest/api.clj:3298-3315).
                # Clients follow the hint.
                blocked = self._leader_block()
                if blocked is not None:
                    return blocked
            return self.router.dispatch(req)
        except NotLeaderError:
            # the store's write fence closed between the gate check and
            # the transaction (deposed mid-request): same answer as the
            # gate, so clients fail over instead of seeing a 409/500
            return self._not_leader()
        except AuthError as e:
            return Response(e.status, {"error": e.message})
        except ApiError as e:
            return Response(e.status, e.body)
        except Exception as e:  # logging-exception-handler equivalent
            return Response(500, {"error": f"internal error: {e!r}"})

    def _leader_block(self, agent_channel: bool = False) \
            -> Optional[Response]:
        """503 + leader hint when this node must not accept writes:
        not the leader, OR leader whose takeover (store replay, backend
        init) hasn't finished — the gate must not open before the
        replayed store can vouch for live tasks. An api-only node
        (--no-cycles) refuses BOTH channels: nothing schedules from its
        store (a leader never re-reads the shared log while leading, so
        an accepted submission would be acked yet never scheduled) and
        absorbing agent registrations would strand agents. Clients and
        daemons rotate away on the hint."""
        del agent_channel  # same policy both channels; kept for intent
        if getattr(self, "api_only", False):
            return self._not_leader()
        elector = getattr(self, "leader_elector", None)
        if elector is None:
            return None
        ready = getattr(self, "leader_ready", None)
        if elector.is_leader() and (ready is None or ready.is_set()):
            return None
        return self._not_leader()

    def _leader_hint(self) -> Optional[str]:
        """Best current-leader address for a rejected write, falling
        back through elector.current_leader() -> configured leader_url
        -> None. Mid-campaign the elector knows no leader yet and used
        to hand clients None (or this very node) as the hint — a dead
        end; the configured HA-service address at least resolves once
        the election settles."""
        elector = getattr(self, "leader_elector", None)
        hint = None
        if elector is not None:
            try:
                hint = elector.current_leader()
            except Exception:
                hint = None
        return hint or self.leader_url or None

    def _not_leader(self) -> Response:
        """The one not-leader answer, on BOTH the agent and client
        channels: 503 + best-effort leader hint + Retry-After so a
        client with no usable hint (mid-election) backs off instead of
        hammering."""
        return Response(503, {"error": "not leader",
                              "leader": self._leader_hint()},
                        headers={"Retry-After": "1"})

    def _build_router(self) -> Router:
        r = Router()
        r.add("POST", "/jobs", self.create_jobs)
        r.add("POST", "/jobs/bulk", self.create_jobs_bulk)
        r.add("GET", "/jobs", self.read_jobs)
        r.add("DELETE", "/jobs", self.destroy_jobs)
        r.add("GET", "/jobs/:uuid", self.read_job_single)
        r.add("POST", "/rawscheduler", self.create_jobs)
        r.add("GET", "/rawscheduler", self.read_jobs_deprecated)
        r.add("DELETE", "/rawscheduler", self.destroy_jobs)
        r.add("GET", "/instances/:uuid", self.read_instance)
        r.add("DELETE", "/instances", self.kill_instances)
        r.add("GET", "/share", self.get_share)
        r.add("POST", "/share", self.set_share)
        r.add("DELETE", "/share", self.retract_share)
        r.add("GET", "/quota", self.get_quota)
        r.add("POST", "/quota", self.set_quota)
        r.add("DELETE", "/quota", self.retract_quota)
        r.add("GET", "/usage", self.get_usage)
        r.add("GET", "/retry", self.get_retry)
        r.add("POST", "/retry", self.post_retry)
        r.add("PUT", "/retry", self.post_retry)
        r.add("GET", "/group", self.read_groups)
        r.add("GET", "/failure_reasons", self.failure_reasons)
        r.add("GET", "/settings", self.get_settings)
        r.add("GET", "/pools", self.get_pools)
        r.add("GET", "/unscheduled_jobs", self.unscheduled_jobs)
        # Cook-parity decision provenance: device-sourced reason codes
        # per (job, cycle) from the coordinator's DecisionBook
        r.add("GET", "/unscheduled", self.unscheduled)
        r.add("GET", "/debug/decisions", self.get_debug_decisions)
        r.add("GET", "/stats/instances", self.stats_instances)
        r.add("POST", "/progress/:uuid", self.post_progress)
        r.add("GET", "/queue", self.get_queue)
        r.add("GET", "/running", self.get_running)
        r.add("GET", "/list", self.list_jobs)
        r.add("GET", "/info", self.get_info)
        r.add("GET", "/debug", self.get_debug)
        # observability: assembled per-job span tree + the coordinator's
        # cycle flight recorder (obs/ tracer)
        r.add("GET", "/trace/:uuid", self.get_trace)
        r.add("GET", "/debug/flight", self.get_debug_flight)
        # always-on cycle profiler: phase stats + critical-path blame
        r.add("GET", "/debug/profile", self.get_debug_profile)
        r.add("GET", "/data-local", self.data_local_status)
        r.add("GET", "/data-local/:uuid", self.data_local_costs)
        r.add("GET", "/metrics", self.get_metrics)
        # federated control plane: peers poll each other's per-user
        # usage aggregates for the slow-cadence DRU exchange
        r.add("GET", "/federation/usage", self.federation_usage)
        # fleet-scale federation: live pool migration between leader
        # groups — admin kicks it off at the SOURCE, the source hands
        # the payload to the DESTINATION's adopt endpoint
        r.add("POST", "/federation/migrate", self.migrate_pool)
        r.add("POST", "/federation/adopt", self.adopt_pool)
        # live fleet reconfiguration: diff a new federation block
        # against the running view and apply it under a durable
        # membership epoch (joins announce, leaves drain-then-retire)
        r.add("POST", "/federation/reload", self.federation_reload)
        # fleet observability plane: health rollup across every leader
        # group + the peer-facing span reads get_trace merges from
        r.add("GET", "/federation/health", self.federation_health)
        r.add("GET", "/federation/trace/job/:uuid",
              self.federation_trace_job)
        r.add("GET", "/federation/trace/:trace_id",
              self.federation_trace)
        r.add("GET", "/rebalancer", self.get_rebalancer_params)
        r.add("POST", "/rebalancer", self.set_rebalancer_params)
        # network-agent control plane (the framework-message channel of
        # mesos_compute_cluster.clj:94-195, over HTTP)
        r.add("POST", "/agents/register", self.agent_register)
        r.add("POST", "/agents/heartbeat", self.agent_heartbeat)
        r.add("POST", "/agents/status", self.agent_status)
        r.add("POST", "/agents/status/bulk", self.agent_status_bulk)
        r.add("POST", "/agents/progress", self.agent_progress)
        r.add("GET", "/agents", self.agent_list)
        # machine-readable self-description (swagger role,
        # rest/api.clj:3058-3340): generated from this very table
        r.add("GET", "/openapi.json", self.get_openapi)
        r.add("GET", "/swagger-docs", self.get_openapi)
        return r

    def federation_usage(self, req: Request) -> Response:
        """Per-user running-usage aggregates for the pools THIS leader
        group owns (scheduler/federation.py ShareExchange polls peers
        here). 404 when no federation host is attached."""
        fed = getattr(self, "federation", None)
        if fed is None:
            raise ApiError(404, "federation not configured")
        return Response(200, fed.usage_snapshot())

    # -- fleet federation: live pool migration --------------------------
    def _fed_or_404(self):
        fed = getattr(self, "federation", None)
        if fed is None:
            raise ApiError(404, "federation not configured")
        return fed

    def migrate_pool(self, req: Request) -> Response:
        """Admin route (source side): hand one pool — jobs, routing,
        placement — to another leader group. The epoch-fenced handoff:
        drain (resident cycles consumed, backend launches handed off),
        atomic export + pool-scoped fence mint (store.migrate_pool_out
        — a submission racing the handoff lands after the fence and
        503s to the new owner), routing flip (fed.reassign), then the
        destination adopts via POST /federation/adopt. Any adoption
        failure rolls the whole thing back — fence lifted by a fresh
        unscoped mint, payload re-imported, routing restored — so the
        fleet never ends in a state where no group owns the pool."""
        fed = self._fed_or_404()
        if req.user != "federation-peer":
            require_authorized(self.auth, req.user, "update", None)
        body = req.body or {}
        pool = body.get("pool")
        dest = body.get("to")
        if not pool or not dest:
            raise ApiError(400, "pool and to are required")
        if dest != fed.group and dest not in fed.groups:
            raise ApiError(400, f"unknown leader group {dest!r}")
        if not fed.owns(pool):
            return Response(503, {
                "error": f"pool {pool} owned by another leader group",
                "leader": fed.owner_url(pool) or self._leader_hint()},
                headers={"Retry-After": "1"})
        if dest == fed.group:
            return Response(200, {"pool": pool, "from": fed.group,
                                  "to": dest, "moved": 0, "noop": True})
        if self.coord is not None:
            self.coord.retire_resident(pool)
        # one migration span id for the whole handoff (the launch-txn
        # precedent: the same id rides the durable "fedmove" record AND
        # appears as the fed.migrate span in every affected traced
        # job's tree, and the destination parents fed.adopt under it —
        # that link is what makes the cross-group tree ONE tree)
        migrate_sid = obs.new_span_id() if obs.tracer.enabled else ""
        t_mig0 = obs.now_ms()
        try:
            # at-most-once across the handoff: a RUNNING job's agent
            # still posts status to THIS group; adopting it elsewhere
            # would strand those reports (lost completion -> liveness
            # requeue -> double launch). The store refuses inside the
            # export's global section — atomic with the fence, so a
            # waiting job that launches a tick before the handoff
            # flips the verdict instead of slipping through.
            payload = self.store.migrate_pool_out(
                pool, fence_owner=f"fedmove:{fed.group}->{dest}",
                force=bool(body.get("force")), span_id=migrate_sid)
        except PoolBusyError as e:
            raise ApiError(
                409, f"pool {pool} has {len(e.running)} RUNNING jobs; "
                     "wait for drain or pass force:true",
                {"running": e.running[:16]})
        fed.reassign(pool, dest, note=f"migrate by {req.user or 'admin'}")
        url = (fed.groups.get(dest) or {}).get("url", "")
        err = None
        if url:
            import urllib.request
            data = json.dumps({"pool": pool, "from": fed.group,
                               "jobs": payload["jobs"],
                               "groups": payload["groups"],
                               # span context: the destination parents
                               # its fed.adopt span under this id
                               "span": migrate_sid}).encode()
            for attempt in range(3):
                try:
                    req2 = urllib.request.Request(
                        f"{url}/federation/adopt", data=data,
                        headers={"Content-Type": "application/json",
                                 "X-Cook-Agent-Token":
                                     self.auth.agent_token or ""},
                        method="POST")
                    with urllib.request.urlopen(req2,
                                                timeout=10.0) as resp:
                        json.loads(resp.read().decode())
                    err = None
                    break
                except Exception as e:   # adopt is idempotent per uuid
                    err = e
                    time.sleep(0.2 * (attempt + 1))
        elif payload["count"]:
            err = RuntimeError(f"no url configured for group {dest!r}")
        if err is not None:
            # rollback: a fresh UNSCOPED mint raises our epoch above
            # the pool fence (lifting it), then the export re-imports
            # locally and routing flips back. The pool resumes on the
            # legacy cycle path; the next enable_resident (or restart)
            # restores residency.
            self.store.mint_epoch(owner=f"fedmove-rollback:{pool}")
            self.store.import_pool(pool, payload["jobs"],
                                   payload["groups"])
            fed.reassign(pool, fed.group, note="rollback: adopt failed")
            return Response(502, {
                "error": f"adopt failed at {dest!r}: {err!r}",
                "pool": pool, "rolled_back": True})
        if migrate_sid:
            # per-traced-job migration span (same id across jobs, the
            # bulk-txn convention): parented on each job's root so the
            # source half of the tree stays connected
            end_ms = obs.now_ms()
            for jd in payload["jobs"]:
                ctx = obs.parse_traceparent(jd.get("traceparent") or "")
                if ctx is None:
                    continue
                obs.tracer.record(
                    "fed.migrate", trace_id=ctx[0], span_id=migrate_sid,
                    parent_id=ctx[1], start_ms=t_mig0, end_ms=end_ms,
                    attrs={"pool": pool, "from": fed.group, "to": dest})
        return Response(200, {"pool": pool, "from": fed.group,
                              "to": dest, "moved": payload["count"],
                              "fence_epoch": payload["fence_epoch"]})

    def adopt_pool(self, req: Request) -> Response:
        """Destination side of a live pool migration: import the
        payload (idempotent per uuid — a retried POST after a lost
        response inserts nothing twice), take routing ownership, and
        run a census-scoped takeover so any instance that was mid-
        launch at the source settles against cluster truth before this
        group's first cycle for the pool (at-most-once launch across
        the epoch handoff)."""
        fed = self._fed_or_404()
        if req.user != "federation-peer":
            require_authorized(self.auth, req.user, "update", None)
        body = req.body or {}
        pool = body.get("pool")
        if not pool:
            raise ApiError(400, "pool is required")
        # continue the migration's span context: the source shipped its
        # fed.migrate span id in the body; our fed.adopt parents under
        # it, and reconcile parents under adopt — migrate -> adopt ->
        # reconcile reads as one connected tree across both groups
        migrate_sid = body.get("span") or ""
        adopt_sid = obs.new_span_id() if obs.tracer.enabled else ""
        t_ad0 = obs.now_ms()
        jobs = body.get("jobs") or []
        adopted = self.store.import_pool(pool, jobs,
                                         body.get("groups") or [],
                                         span_id=adopt_sid)
        fed.reassign(pool, fed.group,
                     note=f"adopt from {body.get('from', '?')}")
        t_ad1 = obs.now_ms()
        if adopt_sid:
            adopted_set = set(adopted)
            for jd in jobs:
                if jd.get("uuid") not in adopted_set:
                    continue
                ctx = obs.parse_traceparent(jd.get("traceparent") or "")
                if ctx is None:
                    continue
                obs.tracer.record(
                    "fed.adopt", trace_id=ctx[0], span_id=adopt_sid,
                    parent_id=migrate_sid or ctx[1],
                    start_ms=t_ad0, end_ms=t_ad1,
                    attrs={"pool": pool, "group": fed.group,
                           "from": body.get("from", "?")})
        if self.coord is not None:
            try:
                self.coord.reconcile_restart(pools=[pool])
            except Exception:
                log.exception("post-adopt reconcile for %r failed", pool)
            finally:
                if adopt_sid:
                    rec_sid = obs.new_span_id()
                    t_rc1 = obs.now_ms()
                    for jd in jobs:
                        ctx = obs.parse_traceparent(
                            jd.get("traceparent") or "")
                        if ctx is None \
                                or jd.get("uuid") not in adopted_set:
                            continue
                        obs.tracer.record(
                            "fed.reconcile", trace_id=ctx[0],
                            span_id=rec_sid, parent_id=adopt_sid,
                            start_ms=t_ad1, end_ms=t_rc1,
                            attrs={"pool": pool, "group": fed.group})
        return Response(200, {"pool": pool, "group": fed.group,
                              "adopted": len(adopted)})

    # -- live fleet reconfiguration (tentpole: membership reload) ------
    #
    # POST /federation/reload (and SIGHUP, rest/server.py) diffs a new
    # `federation` block against the running view and applies it under
    # a MEMBERSHIP EPOCH journaled in the store's membership ledger:
    # "begin" (full target view — the crash-resume payload) before any
    # table is touched, "commit"/"abort" after. Joins only announce
    # (the new group's own boot claims its pools + devices;
    # place_pools adoption is derived). Leaves drain every owned pool
    # through the ordinary migrate protocol (409/retry, rollback on
    # adopt failure lives inside that protocol) and then retire. The
    # view swap itself is fed._swap_membership — atomic under the
    # owner lock, so in-flight requests see the old or the new view,
    # never half of each.

    _RELOAD_DRAIN_TIMEOUT_S = 30.0

    def federation_reload(self, req: Request) -> Response:
        """Apply a new federation membership view live. Body:
        ``{"federation": {"groups": {...}}, "propagate": true}`` —
        ``propagate`` (coordinator form) re-posts the target view to
        every peer in the old+new union so the whole fleet converges
        from one POST; propagated copies arrive with it false."""
        fed = self._fed_or_404()
        if req.user != "federation-peer":
            require_authorized(self.auth, req.user, "update", None)
        body = req.body or {}
        block = body.get("federation") or body
        if not isinstance(block, dict) or \
                not isinstance(block.get("groups"), dict):
            raise ApiError(400, "federation.groups mapping is required")
        mepoch, result = self.apply_membership_reload(
            block, by=req.user or "admin",
            propagate=bool(body.get("propagate", True)))
        return Response(200, {"membership_epoch": mepoch,
                              "group": fed.group, **result})

    def apply_membership_reload(self, block: dict, by: str = "",
                                propagate: bool = True,
                                resume_mepoch: int = 0) -> tuple:
        """The reload core, shared by the REST route, the SIGHUP
        handler, and crash resume. Returns (membership_epoch, result
        dict). ``resume_mepoch`` re-drives a journaled begin record
        instead of allocating a fresh epoch — drains are idempotent
        (an already-moved pool answers 503 with the new owner's hint,
        which resume treats as done)."""
        from cook_tpu_torch.config import ConfigError, validate_federation
        from cook_tpu_torch.utils.metrics import registry
        fed = self._fed_or_404()
        target = {name: dict(spec)
                  for name, spec in (block.get("groups") or {}).items()}
        probe = dict(block)
        probe["groups"] = target
        # validate the SPEC, not our seat in it: a departing group
        # receives a target view it is rightly absent from
        probe["group"] = fed.group if fed.group in target else \
            next(iter(sorted(target)), fed.group)
        try:
            validate_federation(probe)
        except ConfigError as e:
            registry.counter("federation_reloads_total",
                             outcome="invalid", group=fed.group).inc()
            raise ApiError(400, f"invalid federation block: {e}")
        joins, leaves = fed.diff_membership(target)
        changed = bool(joins or leaves) or target != fed.groups
        if not changed:
            if resume_mepoch:
                # crash landed after the swap's effects became moot
                # (view already matches): close the dangling record
                self.store.append_membership(
                    "commit", action="reload", mepoch=resume_mepoch,
                    owner=by)
                return resume_mepoch, {"changed": False,
                                       "resumed": True}
            registry.counter("federation_reloads_total",
                             outcome="noop", group=fed.group).inc()
            return fed.membership_epoch, {"changed": False}
        mepoch = resume_mepoch or self.store.append_membership(
            "begin", action="reload", target=target, owner=by)
        old_groups = {n: dict(s or {}) for n, s in fed.groups.items()}
        drained: dict = {}
        try:
            for g in leaves:
                if g != fed.group:
                    drained.update(
                        self._drain_departing(fed, g, target))
            if fed.group in leaves:
                drained.update(
                    self._drain_departing(fed, fed.group, target))
        except Exception as e:
            self.store.append_membership(
                "abort", action="reload", mepoch=mepoch,
                owner=by, detail=repr(e)[:512])
            registry.counter("federation_reloads_total",
                             outcome="drain_failed",
                             group=fed.group).inc()
            raise ApiError(502, f"membership reload {mepoch} aborted: "
                                f"drain failed: {e}",
                           {"membership_epoch": mepoch,
                            "drained": drained, "aborted": True})
        # a drained pool the target spec left unclaimed would default
        # back to "local" on every member — claim it for the actual
        # destination so the swapped view matches where the jobs went
        # (deterministic: resume recomputes the same destinations)
        for pool, dest in drained.items():
            if dest in target and not any(
                    pool in (s.get("pools") or ()) for s in
                    target.values()):
                target[dest].setdefault("pools", []).append(pool)
        fed._swap_membership(target, mepoch,
                             note=f"reload by {by or 'admin'}")
        self.store.append_membership("commit", action="reload",
                                     mepoch=mepoch, owner=by)
        registry.counter("federation_reloads_total", outcome="ok",
                         group=fed.group).inc()
        result: dict = {"changed": True, "joins": joins,
                        "leaves": leaves, "drained": drained}
        if propagate:
            result["propagated"] = self._propagate_reload(
                fed, target, old_groups)
        return mepoch, result

    def _drain_departing(self, fed, group: str, target: dict) -> dict:
        """Drain every pool a departing group owns through the
        ordinary migrate protocol, 409-retrying while jobs finish.
        Remote groups are driven at their own migrate route (the
        source side owns the drain); our own retirement goes through
        the local handler. Returns {pool: destination group}. A pool
        the source no longer owns (503 + owner hint — e.g. a resumed
        reload re-driving a finished drain) counts as done."""
        survivors = sorted(n for n in target if n != group)
        if not survivors:
            raise RuntimeError(
                f"cannot retire {group!r}: no surviving group")
        moved: dict = {}
        for pool in fed.pools_of(group):
            claimed = next(
                (n for n, spec in target.items()
                 if pool in (spec.get("pools") or ())), None)
            import zlib
            dest = claimed or survivors[
                zlib.crc32(pool.encode()) % len(survivors)]
            if dest == group:
                raise RuntimeError(
                    f"target still claims {pool!r} for departing "
                    f"group {group!r}")
            self._drain_one(fed, group, pool, dest)
            moved[pool] = dest
            procfault.kill_point("fed.reload_drain")
        return moved

    def _drain_one(self, fed, group: str, pool: str,
                   dest: str) -> None:
        """One pool's drain with the 409 retry loop (RUNNING jobs get
        their completion window before the export fences the pool)."""
        import urllib.error
        import urllib.request
        local = group == fed.group
        src_url = "" if local else \
            (fed.groups.get(group) or {}).get("url", "")
        if not local and not src_url:
            raise RuntimeError(f"no url for departing group {group!r}")
        deadline = time.monotonic() + self._RELOAD_DRAIN_TIMEOUT_S
        while True:
            status, out = 0, {}
            if local:
                resp = self.migrate_pool(Request(
                    method="POST", path="/federation/migrate",
                    query={}, body={"pool": pool, "to": dest},
                    headers={}, user="federation-peer"))
                status, out = resp.status, resp.body or {}
            else:
                data = json.dumps({"pool": pool, "to": dest}).encode()
                r = urllib.request.Request(
                    f"{src_url}/federation/migrate", data=data,
                    headers={"Content-Type": "application/json",
                             "X-Cook-Agent-Token":
                                 self.auth.agent_token or ""},
                    method="POST")
                try:
                    with urllib.request.urlopen(r, timeout=10.0) \
                            as resp:
                        status = resp.status
                        out = json.loads(resp.read().decode())
                except urllib.error.HTTPError as e:
                    status = e.code
                    try:
                        out = json.loads(e.read().decode())
                    except Exception:
                        out = {}
                except Exception as e:
                    raise RuntimeError(
                        f"drain of {pool!r} unreachable at "
                        f"{group!r}: {e}")
            if status == 200:
                return
            if status == 503:
                return   # already drained: owner hint names successor
            if status == 409 and time.monotonic() < deadline:
                time.sleep(0.5)
                continue
            raise RuntimeError(
                f"drain of {pool!r} from {group!r} failed: "
                f"{status} {out}")

    def _propagate_reload(self, fed, target: dict,
                          old_groups: dict) -> dict:
        """Re-post the committed target view to every peer in the
        old+new union (departing groups included — they must learn
        they retired) over the machine channel. ``old_groups`` is the
        PRE-swap view: by the time this runs ``fed.groups`` is already
        the target, so departing peers only appear in the old side.
        Best effort per peer: a dark peer is reported in the result,
        never fatal — the operator (or the soak) re-posts the reload
        to it once it returns; the apply is idempotent (a matching
        view no-ops)."""
        import urllib.request
        peers: dict = {}
        for name, spec in list(old_groups.items()) + \
                list(target.items()):
            url = (spec or {}).get("url")
            if name != fed.group and url:
                peers.setdefault(name, url)
        out: dict = {}
        body = json.dumps({"federation": {"groups": target},
                           "propagate": False}).encode()
        for name, url in sorted(peers.items()):
            try:
                r = urllib.request.Request(
                    f"{url}/federation/reload", data=body,
                    headers={"Content-Type": "application/json",
                             "X-Cook-Agent-Token":
                                 self.auth.agent_token or ""},
                    method="POST")
                with urllib.request.urlopen(r, timeout=10.0) as resp:
                    out[name] = resp.status
            except Exception as e:
                out[name] = f"unreachable: {type(e).__name__}"
        return out

    def resume_membership_reload(self) -> Optional[dict]:
        """Close out a dangling membership-ledger begin record found
        at boot (fed.bootstrap_membership): re-drive the journaled
        target view. Called by the server once the leadership gates
        open — a coordinator SIGKILLed mid-reload finishes the change
        (or aborts it durably) instead of wedging the fleet."""
        fed = getattr(self, "federation", None)
        if fed is None or not fed.pending_reload:
            return None
        rec, fed.pending_reload = fed.pending_reload, None
        mepoch = int(rec.get("mepoch", 0))
        target = rec.get("target")
        if not isinstance(target, dict):
            self.store.append_membership(
                "abort", action="reload", mepoch=mepoch,
                detail="begin record carries no target view")
            return {"aborted": mepoch}
        try:
            mep, result = self.apply_membership_reload(
                {"groups": target},
                by=f"resume:{rec.get('owner', '')}",
                propagate=True, resume_mepoch=mepoch)
            log.info("resumed membership reload %d: %s", mep, result)
            return {"resumed": mep, **result}
        except ApiError as e:     # abort journaled by the apply path
            log.warning("membership reload %d aborted on resume: %s",
                        mepoch, e.body)
            return {"aborted": mepoch}

    def policy_migrate(self, pool: str, src_group: str,
                       dst_group: str) -> bool:
        """The FleetRebalancer's migrate_fn: drive one migration at
        the SOURCE group's migrate route over the machine channel
        (dest is always this group — the rebalancer only pulls)."""
        import urllib.request
        fed = self._fed_or_404()
        url = (fed.groups.get(src_group) or {}).get("url", "")
        if not url:
            return False
        data = json.dumps({"pool": pool, "to": dst_group}).encode()
        r = urllib.request.Request(
            f"{url}/federation/migrate", data=data,
            headers={"Content-Type": "application/json",
                     "X-Cook-Agent-Token":
                         self.auth.agent_token or ""},
            method="POST")
        try:
            with urllib.request.urlopen(r, timeout=10.0) as resp:
                return resp.status == 200
        except Exception:
            return False

    def get_openapi(self, req: Request) -> Response:
        """OpenAPI 3.0 description of every served route."""
        from cook_tpu_torch.rest.openapi import build_spec
        if getattr(self, "_openapi_cache", None) is None:
            self._openapi_cache = build_spec(self.router)
        return Response(200, self._openapi_cache)

    def get_metrics(self, req: Request) -> Response:
        """Prometheus text exposition of the metric registry (the
        modern stand-in for the reference's Graphite/JMX reporters,
        reporter.clj:32-82). One code path: the process-wide obs
        registry renders every family — labeled histograms/counters
        and legacy dotted names alike."""
        from cook_tpu_torch.utils.metrics import registry
        return Response(200, registry.render(),
                        headers={"Content-Type":
                                 "text/plain; version=0.0.4"})

    # -- runtime-tunable rebalancer params (rebalancer.clj:520-542:
    # the reference stores these in Datomic, adjustable live) ----------
    def get_rebalancer_params(self, req: Request) -> Response:
        if self.coord is None:
            raise ApiError(404, "no scheduler attached")
        p = self.coord.live_rebalancer_params()
        return Response(200, {"safe-dru-threshold": p.safe_dru_threshold,
                              "min-dru-diff": p.min_dru_diff,
                              "max-preemption": p.max_preemption,
                              "candidate-cap": p.candidate_cap})

    def set_rebalancer_params(self, req: Request) -> Response:
        if self.coord is None:
            raise ApiError(404, "no scheduler attached")
        require_authorized(self.auth, req.user, "update", None)
        body = req.body or {}
        import math

        allowed = {"safe-dru-threshold": float, "min-dru-diff": float,
                   "max-preemption": int, "candidate-cap": int}
        updates = {}
        for key, value in body.items():
            conv = allowed.get(key)
            if conv is None:
                raise ApiError(400, f"unknown rebalancer param {key!r}")
            try:
                v = conv(value)
            except (TypeError, ValueError):
                raise ApiError(400, f"{key} must be a number")
            # NaN would silently disable every DRU comparison; negative
            # values make no sense for any of these knobs
            if not math.isfinite(v) or v < 0:
                raise ApiError(400, f"{key} must be finite and >= 0")
            updates[key] = v
        if not updates:
            raise ApiError(400, "no rebalancer params given")
        self.store.set_rebalancer_config(updates, merge=True)
        return self.get_rebalancer_params(req)

    # -- network-agent control plane -----------------------------------
    def _agent_cluster(self):
        from cook_tpu_torch.backends.agent import AgentCluster
        coord = self.coord
        if coord is not None:
            for cluster in coord.clusters.all():
                if isinstance(cluster, AgentCluster):
                    return cluster
        raise ApiError(404, "no agent backend configured")

    def agent_register(self, req: Request) -> Response:
        return Response(200, self._agent_cluster().register_agent(
            req.body or {}))

    def agent_heartbeat(self, req: Request) -> Response:
        return Response(200, self._agent_cluster().agent_heartbeat(
            req.body or {}))

    def agent_status(self, req: Request) -> Response:
        body = req.body or {}
        if "task_id" not in body:
            raise ApiError(400, "task_id is required")
        return Response(200, self._agent_cluster().status_report(body))

    def agent_status_bulk(self, req: Request) -> Response:
        """Coalesced executor statuses from one daemon: the whole
        batch rides one POST and one emit_status_bulk fold. Daemons
        fall back to the singular endpoint when this route 404s (old
        leaders keep working unmodified)."""
        body = req.body or {}
        updates = body.get("updates")
        if not isinstance(updates, list) or not updates:
            raise ApiError(400, "updates must be a non-empty list")
        for upd in updates:
            if not isinstance(upd, dict) or "task_id" not in upd:
                raise ApiError(400, "every update needs a task_id")
        return Response(
            200, self._agent_cluster().status_report_bulk(updates))

    def agent_progress(self, req: Request) -> Response:
        body = req.body or {}
        if "task_id" not in body:
            raise ApiError(400, "task_id is required")
        return Response(200, self._agent_cluster().progress_report(body))

    def agent_list(self, req: Request) -> Response:
        return Response(200, self._agent_cluster().describe_agents())

    # ------------------------------------------------------------------
    # submission (create-jobs! rest/api.clj:1805; validation :523+)
    def create_jobs(self, req: Request) -> Response:
        return self._create_jobs_impl(req, bulk=False)

    def create_jobs_bulk(self, req: Request) -> Response:
        """High-throughput bulk submission (same payload shape as POST
        /jobs). Differences from /jobs: the per-job failover-resubmit
        idempotency scan is skipped (duplicates answer 409 from the
        store's authoritative check), keeping the handler O(parse) for
        very large arrays. Validation and atomicity are unchanged: the
        whole array is one transaction — any invalid job rejects the
        request with nothing created."""
        return self._create_jobs_impl(req, bulk=True)

    def _create_jobs_impl(self, req: Request, bulk: bool) -> Response:
        t_submit0 = obs.now_ms()
        body = req.body
        if not isinstance(body, dict) or not isinstance(
                body.get("jobs"), list) or not body["jobs"]:
            raise ApiError(400, "malformed request: body must contain a "
                                "non-empty 'jobs' list")
        if self.submit_rl is not None and \
                not self.submit_rl.try_acquire(req.user, len(body["jobs"])):
            raise ApiError(429, "User submission rate limit exceeded")

        pool_name = body.get("pool")
        # submission-validator + pool-selector plugins
        # (plugins/submission.clj, plugins/pool.clj)
        if self.plugins is not None:
            for spec in body["jobs"]:
                status = self.plugins.submission.check_job_submission(
                    spec, req.user, pool_name)
                if status.status == "reject":
                    raise ApiError(400, f"submission rejected by plugin: "
                                        f"{status.message}")
            if pool_name is None and body["jobs"]:
                default = self.pools.default_pool if self.pools else "default"
                selected = {self.plugins.pool_selector.select_pool(s, default)
                            for s in body["jobs"]}
                if len(selected) == 1 and selected != {default}:
                    pool_name = selected.pop()
        if self.pools is not None:
            if pool_name and self.pools.get(pool_name).name != pool_name:
                raise ApiError(400, f"pool {pool_name} does not exist")
            if not self.pools.accepts_submissions(pool_name):
                raise ApiError(400, f"pool {pool_name} is not accepting "
                                    "job submissions")
            pool_name = self.pools.resolve(pool_name)
        # federated ingest routing: a submission for a pool another
        # leader group owns must land in THAT group's store (this
        # leader's cycles never serve the pool, so accepting here would
        # ack a job nothing schedules). Same contract as not-leader:
        # 503 + the owning leader's address + Retry-After.
        fed = getattr(self, "federation", None)
        if fed is not None and pool_name and not fed.owns(pool_name):
            owner_url = fed.owner_url(pool_name) or self._leader_hint()
            if obs.tracer.enabled:
                # redirect hint span: a traced caller bouncing between
                # groups sees WHERE the 503 detour happened instead of
                # an unexplained gap before the owning group's submit
                inbound = obs.parse_traceparent(
                    req.headers.get("traceparent", ""))
                if inbound is not None:
                    t_ms = obs.now_ms()
                    obs.tracer.record(
                        "fed.redirect", trace_id=inbound[0],
                        parent_id=inbound[1], start_ms=t_ms, end_ms=t_ms,
                        attrs={"pool": pool_name, "group": fed.group,
                               "leader": owner_url or ""})
            return Response(503, {
                "error": f"pool {pool_name} owned by another leader "
                         "group",
                "leader": owner_url},
                headers={"Retry-After": "1"})

        groups = [self._parse_group(g, req.user)
                  for g in body.get("groups", [])]
        group_uuids = {g.uuid for g in groups} | set(self.store.groups)
        jobs = [self._parse_job(j, req.user, pool_name, group_uuids)
                for j in body["jobs"]]
        # job-adjuster plugin at submission (adjust-job; the reference
        # rewrites the job txn — pool_mover migrates pools here). An
        # adjusted pool must still be a REAL pool: a typo'd destination
        # would blackhole the job (no cycle ever serves it), so revert
        # bad migrations instead of committing them.
        if self.plugins is not None:
            for j in jobs:
                before = j.pool
                j = self.plugins.adjuster.adjust_job(j)
                if j.pool != before and self.pools is not None:
                    ok = (self.pools.get(j.pool).name == j.pool
                          and self.pools.accepts_submissions(j.pool))
                    if not ok:
                        log.warning(
                            "adjuster moved job %s to unknown/closed "
                            "pool %r; reverting to %r", j.uuid, j.pool,
                            before)
                        j.pool = before

        # trace context: one root span per job, stamped into the job
        # record BEFORE the store txn so the durable "job" event (and
        # every later scheduling layer) carries it.  An incoming W3C
        # traceparent header continues the caller's trace; otherwise
        # each job starts a fresh one.
        traced_roots = []   # (job, parent_span_id)
        if obs.tracer.enabled:
            inbound = obs.parse_traceparent(
                req.headers.get("traceparent", ""))
            for j in jobs:
                trace_id = inbound[0] if inbound else obs.new_trace_id()
                root_sid = obs.new_span_id()
                j.traceparent = obs.make_traceparent(trace_id, root_sid)
                traced_roots.append((j, inbound[1] if inbound else ""))

        # failover idempotency: a retry after a mid-submission 503 may
        # find its own uuids already present as UNCOMMITTED jobs (the
        # old leader appended the create but fenced before the commit,
        # and the successor replayed it). A resubmission with an
        # identical essential spec just commits those instead of 409ing.
        resubmits = []
        dupes = []
        def same_spec(a: Job, b: Job) -> bool:
            # the FULL essential spec must match — a resubmission that
            # changed any resource/placement field is a new request and
            # must 409 instead of silently committing the stale spec
            return all(getattr(a, f) == getattr(b, f) for f in (
                "user", "command", "mem", "cpus", "gpus", "priority",
                "pool", "env", "labels", "constraints", "group",
                "max_retries", "ports", "container", "checkpoint"))

        for j in (() if bulk else jobs):
            existing = self.store.jobs.get(j.uuid)
            if existing is None:
                continue
            if not existing.committed and same_spec(existing, j):
                resubmits.append(j.uuid)
            else:
                dupes.append(j.uuid)
        if dupes:
            raise ApiError(409, {"message": "The following job UUIDs were "
                                            "already used", "data": dupes})
        try:
            # ONE transaction creates the batch already-committed (the
            # reference likewise transacts job txns + latch commit in a
            # single d/transact, rest/api.clj:1825-1850), so the
            # leadership fence is evaluated once — no window where a
            # fence between create and commit strands the batch.
            rs = set(resubmits)
            fresh = [j for j in jobs if j.uuid not in rs]
            t_txn0 = obs.now_ms()
            if fresh or groups:
                if self.ingest is not None:
                    # coalescing ingest queue: the call returns after
                    # the batch's group-commit fdatasync, so the 201
                    # below still means "durable"
                    uuids = self.ingest.submit_and_wait(fresh, groups)
                else:
                    uuids = self.store.create_jobs(fresh, groups,
                                                   committed=True)
            else:
                uuids = []
            t_txn1 = obs.now_ms()
            if resubmits:
                self.store.commit_jobs(resubmits)
        except NotLeaderError:
            raise   # handle() maps it to 503 + leader hint (failover)
        except IngestQueueFull as e:
            # admission control: shed load with an explicit retry hint
            # instead of queueing unboundedly
            return Response(429, {"error": "ingest queue saturated; "
                                           "retry later"},
                            headers={"Retry-After": str(e.retry_after_s)})
        except TransactionError as e:
            raise ApiError(409, str(e))
        for j, parent_sid in traced_roots:
            ctx = obs.parse_traceparent(j.traceparent)
            if ctx is None:
                continue
            obs.tracer.record(
                "job.submit", trace_id=ctx[0], span_id=ctx[1],
                parent_id=parent_sid, start_ms=t_submit0,
                end_ms=obs.now_ms(),
                attrs={"uuid": j.uuid, "user": j.user, "pool": j.pool})
            obs.tracer.record(
                "store.create_jobs", trace_id=ctx[0], parent_id=ctx[1],
                start_ms=t_txn0, end_ms=t_txn1)
        ordered = [j.uuid for j in jobs]
        return Response(201, {"jobs": ordered})

    def _parse_job(self, spec: dict, user: str, pool: Optional[str],
                   group_uuids: set) -> Job:
        if not isinstance(spec, dict):
            raise ApiError(400, "each job must be an object")
        uuid = str(spec.get("uuid") or new_uuid()).lower()
        if not _UUID_RE.match(uuid):
            raise ApiError(400, f"invalid job uuid {uuid!r}")
        command = spec.get("command")
        if not command or not isinstance(command, str):
            raise ApiError(400, f"job {uuid}: 'command' is required")
        try:
            mem = float(spec.get("mem", 0))
            cpus = float(spec.get("cpus", 0))
            gpus = float(spec.get("gpus", 0))
        except (TypeError, ValueError):
            raise ApiError(400, f"job {uuid}: mem/cpus/gpus must be numbers")
        if mem <= 0 or cpus <= 0:
            raise ApiError(400, f"job {uuid}: mem and cpus must be positive")
        if mem > self.tc.max_mem_mb:
            raise ApiError(400, f"job {uuid}: mem {mem} exceeds max "
                                f"{self.tc.max_mem_mb} MB")
        if cpus > self.tc.max_cpus:
            raise ApiError(400, f"job {uuid}: cpus {cpus} exceeds max "
                                f"{self.tc.max_cpus}")
        if gpus < 0 or gpus > self.tc.max_gpus or gpus != int(gpus):
            raise ApiError(400, f"job {uuid}: gpus must be a non-negative "
                                f"integer <= {self.tc.max_gpus}")
        name = spec.get("name", "cookjob")
        if not _NAME_RE.match(name):
            raise ApiError(400, f"job {uuid}: invalid name {name!r}")
        priority = int(spec.get("priority", 50))
        if not 0 <= priority <= 100:
            raise ApiError(400, f"job {uuid}: priority must be in [0, 100]")
        max_retries = int(spec.get("max_retries", spec.get("max-retries", 1)))
        if not 1 <= max_retries <= self.tc.max_retries:
            raise ApiError(400, f"job {uuid}: max_retries must be in "
                                f"[1, {self.tc.max_retries}]")
        group = spec.get("group")
        if group is not None:
            group = str(group).lower()
            if group not in group_uuids:
                raise ApiError(400, f"job {uuid}: group {group} is not "
                                    "defined in this request or the system")
        constraints = []
        for c in spec.get("constraints", []):
            if not (isinstance(c, (list, tuple)) and len(c) == 3):
                raise ApiError(400, f"job {uuid}: constraints must be "
                                    "[attribute, operator, pattern] triples")
            attr, op, pat = c
            if str(op).upper() != "EQUALS":
                raise ApiError(400, f"job {uuid}: only EQUALS constraints "
                                    "are supported")
            constraints.append((str(attr), "EQUALS", str(pat)))
        env = {str(k): str(v) for k, v in (spec.get("env") or {}).items()}
        labels = {str(k): str(v)
                  for k, v in (spec.get("labels") or {}).items()}
        checkpoint = spec.get("checkpoint")
        if checkpoint is not None:
            from cook_tpu_torch.backends.kube.checkpoint import VALID_MODES
            if not isinstance(checkpoint, dict) or \
                    checkpoint.get("mode") not in VALID_MODES:
                raise ApiError(
                    400, f"job {uuid}: checkpoint.mode must be one of "
                         f"{list(VALID_MODES)}")
        max_runtime = int(spec.get("max_runtime", spec.get("max-runtime",
                                                           2 ** 53)))
        return Job(
            uuid=uuid, user=user, command=command, mem=mem, cpus=cpus,
            gpus=gpus, name=name, priority=priority, max_retries=max_retries,
            max_runtime_ms=max_runtime,
            expected_runtime_ms=spec.get("expected_runtime"),
            ports=self._parse_ports(spec),
            pool=pool or "default", group=group, env=env, labels=labels,
            constraints=constraints, uris=self._parse_uris(spec),
            container=spec.get("container"),
            application=spec.get("application"),
            progress_output_file=spec.get("progress_output_file", ""),
            progress_regex_string=spec.get("progress_regex_string", ""),
            checkpoint=checkpoint,
            disable_mea_culpa_retries=bool(
                spec.get("disable_mea_culpa_retries", False)),
            datasets=spec.get("datasets", []),
        )

    @staticmethod
    def _parse_uris(spec: dict) -> list:
        uris = spec.get("uris", [])
        if not isinstance(uris, list):
            raise ApiError(400, "uris must be a list")
        for u in uris:
            if not isinstance(u, dict) or \
                    not isinstance(u.get("value"), str) or not u["value"]:
                raise ApiError(
                    400, "each uri must be an object with a string 'value'")
        return uris

    @staticmethod
    def _parse_ports(spec: dict) -> int:
        ports = spec.get("ports", 0)
        if not isinstance(ports, int) or isinstance(ports, bool) \
                or ports < 0 or ports > 256:
            raise ApiError(400, "ports must be an integer in [0, 256]")
        return ports

    def _parse_group(self, spec: dict, user: str) -> Group:
        uuid = str(spec.get("uuid") or new_uuid()).lower()
        if not _UUID_RE.match(uuid):
            raise ApiError(400, f"invalid group uuid {uuid!r}")
        name = spec.get("name", "defaultgroup")
        if not _NAME_RE.match(name):
            raise ApiError(400, f"group {uuid}: invalid name {name!r}")
        hp = spec.get("host_placement", spec.get("host-placement",
                                                 {"type": "all"}))
        if hp.get("type") not in ("all", "balanced", "unique",
                                  "attribute-equals"):
            raise ApiError(400, f"group {uuid}: unknown host-placement type")
        sh = spec.get("straggler_handling", spec.get("straggler-handling",
                                                     {"type": "none"}))
        if sh.get("type") not in ("none", "quantile-deviation"):
            raise ApiError(400, f"group {uuid}: unknown straggler-handling "
                                "type")
        return Group(uuid=uuid, name=name, user=user, host_placement=hp,
                     straggler_handling=sh)

    # ------------------------------------------------------------------
    # queries
    def _authorized_job(self, req: Request, uuid: str, verb="read") -> Job:
        job = self.store.get_job(uuid.lower())
        if job is None:
            raise ApiError(404, f"unknown job {uuid}")
        require_authorized(self.auth, req.user, verb, job.user)
        return job

    def read_jobs(self, req: Request) -> Response:
        uuids = req.qlist("uuid", "job")
        if uuids:
            jobs = [self._authorized_job(req, u) for u in uuids]
        else:
            user = req.qp("user", req.user)
            require_authorized(self.auth, req.user, "read", user)
            states = set((req.qp("state") or
                          "waiting+running+completed").split("+"))
            start = int(req.qp("start", 0) or 0)
            end = int(req.qp("end", 2 ** 62) or 2 ** 62)
            name_pat = req.qp("name")
            pool = req.qp("pool")
            jobs = [j for j in self.store.jobs.values()
                    if j.user == user and _job_status(j) in states
                    and start <= j.submit_time_ms < end
                    and (pool is None or j.pool == pool)
                    and (name_pat is None or
                         re.fullmatch(name_pat.replace("*", ".*"), j.name))]
        return Response(200, [job_response(j, self.store) for j in jobs])

    def read_jobs_deprecated(self, req: Request) -> Response:
        return self.read_jobs(req)

    def read_job_single(self, req: Request, uuid: str) -> Response:
        if not _UUID_RE.match(uuid):
            raise ApiError(400, f"invalid uuid {uuid!r}")
        return Response(200, job_response(
            self._authorized_job(req, uuid), self.store))

    def destroy_jobs(self, req: Request) -> Response:
        uuids = req.qlist("uuid", "job")
        if not uuids:
            raise ApiError(400, "no job uuids supplied")
        jobs = [self._authorized_job(req, u, verb="kill") for u in uuids]
        for job in jobs:
            to_kill = self.store.kill_job(job.uuid)
            for tid in to_kill:
                self.store.update_instance(tid, InstanceStatus.FAILED,
                                           reason_code=1004)
                if self.coord is not None:
                    self.coord._backend_kill(tid)
        return Response(204)

    def read_instance(self, req: Request, uuid: str) -> Response:
        inst = self.store.get_instance(uuid)
        if inst is None:
            raise ApiError(404, f"unknown instance {uuid}")
        job = self.store.get_job(inst.job_uuid)
        require_authorized(self.auth, req.user, "read", job.user)
        return Response(200, instance_response(inst, job))

    def kill_instances(self, req: Request) -> Response:
        task_ids = req.qlist("uuid", "instance")
        if not task_ids:
            raise ApiError(400, "no instance uuids supplied")
        for tid in task_ids:
            inst = self.store.get_instance(tid)
            if inst is None:
                raise ApiError(404, f"unknown instance {tid}")
            job = self.store.get_job(inst.job_uuid)
            require_authorized(self.auth, req.user, "kill", job.user)
            self.store.update_instance(tid, InstanceStatus.FAILED,
                                       reason_code=1004)
            if self.coord is not None:
                self.coord._backend_kill(tid)
        return Response(204)

    # ------------------------------------------------------------------
    # share / quota (share.clj, quota.clj endpoint semantics)
    def _limit_params(self, req: Request, write: bool):
        user = req.qp("user") or (req.body or {}).get("user")
        if not user:
            raise ApiError(400, "user parameter is required")
        pool = req.qp("pool") or (req.body or {}).get("pool") or \
            (self.pools.default_pool if self.pools else "default")
        if write:
            require_authorized(self.auth, req.user, "update", None)
        return user, pool

    def get_share(self, req: Request) -> Response:
        user, pool = self._limit_params(req, write=False)
        return Response(200, _jsonable_limits(self.shares.get(user, pool)))

    def set_share(self, req: Request) -> Response:
        user, pool = self._limit_params(req, write=True)
        vals = (req.body or {}).get("share", {})
        if not vals:
            raise ApiError(400, "body must contain a 'share' object")
        try:
            self.shares.set(user, pool, **{k: float(v)
                                           for k, v in vals.items()})
        except ValueError as e:
            raise ApiError(400, str(e))
        return Response(201, _jsonable_limits(self.shares.get(user, pool)))

    def retract_share(self, req: Request) -> Response:
        user, pool = self._limit_params(req, write=True)
        self.shares.retract(user, pool)
        return Response(204)

    def get_quota(self, req: Request) -> Response:
        user, pool = self._limit_params(req, write=False)
        return Response(200, _jsonable_limits(self.quotas.get(user, pool)))

    def set_quota(self, req: Request) -> Response:
        user, pool = self._limit_params(req, write=True)
        vals = (req.body or {}).get("quota", {})
        if not vals:
            raise ApiError(400, "body must contain a 'quota' object")
        try:
            self.quotas.set(user, pool, **{k: float(v)
                                           for k, v in vals.items()})
        except ValueError as e:
            raise ApiError(400, str(e))
        return Response(201, _jsonable_limits(self.quotas.get(user, pool)))

    def retract_quota(self, req: Request) -> Response:
        user, pool = self._limit_params(req, write=True)
        self.quotas.retract(user, pool)
        return Response(204)

    def get_usage(self, req: Request) -> Response:
        """Per-user running usage, grouped by pool (+ per-group breakdown
        like rest/api.clj:2648)."""
        user = req.qp("user", req.user)
        require_authorized(self.auth, req.user, "read", user)
        pools = [p.name for p in self.pools.all()] if self.pools else \
            ["default"]
        by_pool = {}
        for pool in pools:
            u = self.store.user_usage(pool).get(
                user, {"mem": 0.0, "cpus": 0.0, "gpus": 0.0, "jobs": 0})
            by_pool[pool] = {"total_usage": u}
        total = {"mem": sum(p["total_usage"]["mem"] for p in by_pool.values()),
                 "cpus": sum(p["total_usage"]["cpus"]
                             for p in by_pool.values()),
                 "gpus": sum(p["total_usage"]["gpus"]
                             for p in by_pool.values()),
                 "jobs": sum(p["total_usage"]["jobs"]
                             for p in by_pool.values())}
        return Response(200, {"total_usage": total, "pools": by_pool})

    # ------------------------------------------------------------------
    def get_retry(self, req: Request) -> Response:
        uuid = req.qp("job")
        if not uuid:
            raise ApiError(400, "job parameter is required")
        job = self._authorized_job(req, uuid)
        return Response(200, job.max_retries)

    def post_retry(self, req: Request) -> Response:
        body = req.body or {}
        uuids = req.qlist("job", "jobs") or \
            ([body["job"]] if "job" in body else body.get("jobs", []))
        retries = body.get("retries")
        increment = body.get("increment")
        if retries is None and increment is None:
            raise ApiError(400, "retries or increment is required")
        if not uuids:
            raise ApiError(400, "job uuid(s) required")
        out = []
        for u in uuids:
            job = self._authorized_job(req, u, verb="retry")
            n = int(retries) if retries is not None else \
                job.max_retries + int(increment)
            if not 1 <= n <= self.tc.max_retries:
                raise ApiError(400, f"retries must be in "
                                    f"[1, {self.tc.max_retries}]")
            self.store.retry_job(job.uuid, n, failed_only=True)
            out.append(job.uuid)
        return Response(201, out)

    def read_groups(self, req: Request) -> Response:
        uuids = req.qlist("uuid")
        if not uuids:
            raise ApiError(400, "uuid parameter is required")
        detailed = (req.qp("detailed", "false") or "").lower() == "true"
        out = []
        for u in uuids:
            group = self.store.groups.get(u.lower())
            if group is None:
                raise ApiError(404, f"unknown group {u}")
            require_authorized(self.auth, req.user, "read", group.user)
            jobs = [self.store.jobs[j] for j in group.jobs
                    if j in self.store.jobs]
            resp = {
                "uuid": group.uuid, "name": group.name,
                "host_placement": group.host_placement,
                "straggler_handling": group.straggler_handling,
                "waiting": [j.uuid for j in jobs
                            if j.state == JobState.WAITING],
                "running": [j.uuid for j in jobs
                            if j.state == JobState.RUNNING],
                "completed": [j.uuid for j in jobs
                              if j.state == JobState.COMPLETED],
            }
            if detailed:
                resp["jobs"] = [job_response(j, self.store) for j in jobs]
            out.append(resp)
        return Response(200, out)

    # ------------------------------------------------------------------
    def failure_reasons(self, req: Request) -> Response:
        return Response(200, [{"code": r.code, "name": r.name,
                               "description": r.string,
                               "mea_culpa": r.mea_culpa,
                               "failure_limit": r.failure_limit}
                              for r in REASONS])

    def get_settings(self, req: Request) -> Response:
        require_authorized(self.auth, req.user, "read", None)
        return Response(200, self.settings)

    def get_pools(self, req: Request) -> Response:
        if self.pools is None:
            return Response(200, [])
        return Response(200, [{"name": p.name, "purpose": p.purpose,
                               "state": p.state,
                               "dru-mode": p.dru_mode.value}
                              for p in self.pools.all()])

    def unscheduled_jobs(self, req: Request) -> Response:
        uuids = req.qlist("job", "uuid")
        if not uuids:
            raise ApiError(400, "job parameter is required")
        out = []
        for u in uuids:
            job = self._authorized_job(req, u)
            qpos = self._queue_position(job)
            rl = getattr(self.coord, "user_launch_rl", None)
            out.append({
                "uuid": job.uuid,
                "reasons": [{"reason": r, "data": d} for r, d in
                            unscheduled.reasons(self.store, job, self.quotas,
                                                self.shares,
                                                user_launch_rl=rl,
                                                queue_position=qpos)],
            })
        return Response(200, out)

    def _queue_position(self, job: Job) -> int:
        ahead = 0
        for other in self.store.pending_jobs(job.pool):
            if other.user != job.user or other.uuid == job.uuid:
                continue
            if (-other.priority, other.submit_time_ms) < \
                    (-job.priority, job.submit_time_ms):
                ahead += 1
        return ahead

    def unscheduled(self, req: Request) -> Response:
        """Why isn't this job running? Device-sourced decision
        provenance per job (Cook's /unscheduled, with the reasons the
        match cycle itself computed: rank vs cutoff, which quota and by
        how much, no-host-fit), joined with trace context and the
        static analyzers' fallback reasons."""
        from cook_tpu_torch.obs import decisions as dprov
        uuids = req.qlist("job", "uuid")
        if not uuids:
            raise ApiError(400, "job parameter is required")
        book = getattr(self.coord, "decisions", None)
        cfg = getattr(self.coord, "config", None)
        cutoff = getattr(cfg, "max_jobs_considered", 0)
        out = []
        for u in uuids:
            job = self._authorized_job(req, u)
            reasons = []
            history = book.job_decisions(job.uuid) if book else []
            if _job_status(job) != "waiting":
                reasons.append({
                    "reason": f"The job is {_job_status(job)}.",
                    "code": _job_status(job), "data": {}})
            elif history:
                # newest decision is THE answer; older ones ride along
                reasons.append(dprov.explain(history[0],
                                             num_considerable=cutoff))
            else:
                qpos = self._queue_position(job)
                reasons.append({
                    "reason": "The job has not been considered by a "
                              "match cycle yet (queued beyond the "
                              "decision window, or no cycle has run).",
                    "code": "rank_beyond_window",
                    "data": {"queue_position": qpos,
                             "window": cutoff}})
            # degraded backends starve jobs without the cycle ever
            # seeing them: surface circuit-broken / skipped clusters
            broken = []
            clusters = getattr(self.coord, "clusters", None)
            for cluster in clusters.all() if clusters else []:
                describe = getattr(cluster, "describe_agents", None)
                if describe is None:
                    continue
                for a in describe():
                    st = a.get("breaker", {}).get("state")
                    if st and st != "closed":
                        broken.append({"hostname": a["hostname"],
                                       "cluster": cluster.name,
                                       "state": st})
            if broken:
                reasons.append({
                    "reason": "Some backends are degraded "
                              "(circuit breaker open): their offers "
                              "are not participating in matching.",
                    "code": "backend_degraded",
                    "data": {"agents": broken}})
            # the overload controller shrinking the consider window is
            # a first-class reason a waiting job was never looked at
            ovl = getattr(self.coord, "overload", None)
            if ovl is not None and ovl.level >= 1:
                reasons.append({
                    "reason": "considered window reduced: overload "
                              "(the scheduler is shedding load; fewer "
                              "jobs per cycle are being considered).",
                    "code": "overload_shed",
                    "data": ovl.snapshot()})
            # clusters whose offer fetch failed recently were skipped
            # whole cycles — the pool ran degraded
            skipped = getattr(self.coord, "skipped_clusters", {}) \
                .get(job.pool, {})
            recent = [c for c, ts in skipped.items()
                      if time.monotonic() - ts < 300.0]
            if recent:
                reasons.append({
                    "reason": "Some compute clusters failed to offer "
                              "resources recently and were skipped "
                              "from match cycles.",
                    "code": "cluster_degraded",
                    "data": {"clusters": sorted(recent)}})
            # classic host-side analysis (quota math, rate limits,
            # placement-failure cache) for Cook parity and for causes
            # the device window can't see
            rl = getattr(self.coord, "user_launch_rl", None)
            for r, d in unscheduled.reasons(
                    self.store, job, self.quotas, self.shares,
                    user_launch_rl=rl,
                    queue_position=self._queue_position(job)):
                reasons.append({"reason": r, "data": d})
            out.append({
                "uuid": job.uuid,
                "traceparent": job.traceparent or None,
                "decisions": history,
                "reasons": reasons,
            })
        return Response(200, out)

    def get_debug_decisions(self, req: Request) -> Response:
        """Decision-provenance ring: newest-first per-cycle outcome
        summaries (matched / quota / rank-cutoff / no-fit counts per
        pool cycle) plus book stats; joins the flight recorder on
        (pool, cycle)."""
        book = getattr(self.coord, "decisions", None)
        if book is None:
            return Response(200, {"cycles": [], "stats": {}})
        limit = int(req.qp("limit", 64) or 64)
        pool = req.qp("pool")
        return Response(200, {"cycles": book.cycles(limit=limit,
                                                    pool=pool),
                              "stats": book.stats()})

    def stats_instances(self, req: Request) -> Response:
        require_authorized(self.auth, req.user, "read", None)
        status = req.qp("status")
        start = req.qp("start")
        end = req.qp("end")
        if not (status and start and end):
            raise ApiError(400, "status, start and end are required")
        if status not in ("success", "failed"):
            raise ApiError(400, "status must be success or failed")
        return Response(200, task_stats.get_stats(
            self.store, status, _parse_time(start), _parse_time(end),
            name_filter=req.qp("name")))

    def post_progress(self, req: Request, uuid: str) -> Response:
        """Sidecar progress intake (rest/api.clj:3298-3315)."""
        body = req.body or {}
        seq = body.get("progress_sequence", body.get("progress-sequence"))
        percent = body.get("progress_percent", body.get("progress-percent"))
        message = body.get("progress_message", body.get("progress-message"))
        if seq is None or (percent is None and message is None):
            raise ApiError(400, "progress_sequence and one of "
                                "progress_percent/progress_message required")
        inst = self.store.get_instance(uuid)
        if inst is None:
            raise ApiError(404, f"unknown instance {uuid}")
        accepted = self.store.update_progress(
            uuid, int(seq), int(percent if percent is not None
                                else inst.progress), message or "")
        return Response(202, {"accepted": accepted,
                              "instance": uuid})

    # ------------------------------------------------------------------
    def get_queue(self, req: Request) -> Response:
        require_authorized(self.auth, req.user, "read", None)
        limit = int(req.qp("limit", 100) or 100)
        out = {}
        pools = [p.name for p in self.pools.all()] if self.pools else \
            ["default"]
        for pool in pools:
            pending = sorted(self.store.pending_jobs(pool),
                             key=lambda j: (-j.priority, j.submit_time_ms))
            out[pool] = [job_response(j, self.store)
                         for j in pending[:limit]]
        return Response(200, out)

    def get_running(self, req: Request) -> Response:
        require_authorized(self.auth, req.user, "read", None)
        out = []
        for job in self.store.running_jobs():
            for inst in job.active_instances:
                out.append(instance_response(inst, job))
        return Response(200, out)

    def list_jobs(self, req: Request) -> Response:
        user = req.qp("user")
        if not user:
            raise ApiError(400, "user parameter is required")
        require_authorized(self.auth, req.user, "read", user)
        states = set((req.qp("state") or "").split("+")) - {""}
        if not states:
            raise ApiError(400, "state parameter is required")
        if "success" in states or "failed" in states:
            states.add("completed")
        start = int(req.qp("start-ms", req.qp("start_ms", 0)) or 0)
        end = int(req.qp("end-ms", req.qp("end_ms", 2 ** 62)) or 2 ** 62)
        limit = int(req.qp("limit", 150) or 150)
        name_pat = req.qp("name")
        jobs = []
        for j in self.store.jobs.values():
            if j.user != user or not j.committed:
                continue
            status = _job_status(j)
            fine = _job_state(j)
            if status not in states and fine not in states:
                continue
            if not (start <= j.submit_time_ms < end):
                continue
            if name_pat and not re.fullmatch(
                    name_pat.replace("*", ".*"), j.name):
                continue
            jobs.append(j)
        jobs.sort(key=lambda j: -j.submit_time_ms)
        return Response(200, [job_response(j, self.store)
                              for j in jobs[:limit]])

    def get_info(self, req: Request) -> Response:
        elector = getattr(self, "leader_elector", None)
        leader_url = self.leader_url
        is_leader = True
        if elector is not None:
            leader_url = elector.current_leader() or leader_url
            is_leader = elector.is_leader()
        return Response(200, {
            "authentication-scheme": self.auth.scheme,
            "commit": VERSION,
            "version": VERSION,
            "start-time": self.started_ms,
            "leader-url": leader_url,
            "is-leader": is_leader,
        })

    def get_debug(self, req: Request) -> Response:
        """Health + live backend summary (components.clj:140-151 health
        handler role): per-cluster host and tracked-task counts, plus
        percentiles over the coordinator's per-consume phase trace —
        the same measured distribution the e2e bench publishes as the
        co-located histogram, served live so an operator sees MEASURED
        p50/p99 consume latency (and which phase owns the tail) instead
        of phase-mean arithmetic."""
        clusters = {}
        consume: dict = {}
        if self.coord is not None:
            for cluster in self.coord.clusters.all():
                try:
                    hosts = len(cluster.host_attributes())
                except Exception:
                    hosts = 0
                try:
                    tasks = len(cluster.known_task_ids())
                except Exception:
                    tasks = 0
                clusters[cluster.name] = {
                    "kind": type(cluster).__name__,
                    "hosts": hosts, "tasks": tasks}
                if hasattr(cluster, "breaker_snapshots"):
                    clusters[cluster.name]["breakers"] = \
                        cluster.breaker_snapshots()
                if hasattr(cluster, "describe_agents"):
                    # per-agent view: outbox_dropped + breaker state
                    # ride along for the operator
                    clusters[cluster.name]["agents"] = \
                        cluster.describe_agents()
                transitions = getattr(cluster, "breaker_transitions",
                                      None)
                if transitions is not None:
                    # bounded deque; a racing append can fault the
                    # copy ("deque mutated during iteration") — an
                    # empty list beats a /debug 500
                    try:
                        clusters[cluster.name]["breaker_transitions"] \
                            = list(transitions)
                    except RuntimeError:
                        clusters[cluster.name]["breaker_transitions"] \
                            = []
            # locked point-in-time copy: a bare list(deque) here races
            # the consumer thread's appends ("deque mutated during
            # iteration" -> intermittent /debug 500s under load)
            trace = self.coord.consume_trace_snapshot()
            by_pool: dict[str, list] = {}
            for r in trace:
                by_pool.setdefault(r["pool"], []).append(r)
            for pool, rows in by_pool.items():
                stats = {"cycles": len(rows)}
                for k in ("total_ms", "readback_ms", "loop_ms",
                          "txn_ms", "backend_ms"):
                    vals = sorted(r[k] for r in rows)
                    n = len(vals)
                    stats[k] = {
                        "p50": round(vals[n // 2], 2),
                        # nearest-rank p99: ceil(0.99 n) as a 1-based
                        # rank ((n*99)//100 lands one rank high when n
                        # is a multiple of 100 — p99 would read as max)
                        "p99": round(vals[max(0, -(-n * 99 // 100) - 1)],
                                     2),
                        "max": round(vals[-1], 2)}
                consume[pool] = stats
        # same reader-vs-writer contract as the consume trace: the
        # match/consume threads insert metric keys concurrently, so
        # /debug must serve a locked point-in-time copy, never the
        # coordinator's live dict
        metrics = self.coord.metrics_snapshot() \
            if self.coord is not None else {}
        body = {"healthy": True, "version": VERSION,
                "clusters": clusters,
                "metrics": metrics,
                "consume_trace": consume,
                # crash-recovery evidence: how this store came back,
                # and what the restart reconciliation pass resolved
                "recovery": {
                    "restore_ms": round(
                        getattr(self.store, "restore_ms", 0.0), 2),
                    "restored_from": getattr(
                        self.store, "_restored_from", None),
                    "restore_deltas": getattr(
                        self.store, "_restore_deltas", 0),
                    "delta_chain_length":
                        self.store.delta_chain_length(),
                    "restart_reconcile": getattr(
                        self.coord, "last_restart_reconcile", {})
                        if self.coord is not None else {}},
                # pool-sharded store evidence: shard count, native
                # encoder state, per-shard txn/lock-wait/hold totals
                # (live_smoke scrapes this block)
                "store": {"shards": self.store.shard_stats()}}
        ovl = getattr(self.coord, "overload", None)
        if ovl is not None:
            # shed-ladder state: level, engaged actions, per-signal
            # readings and the recent shed/relax event ring
            body["overload"] = ovl.snapshot()
        fed = getattr(self, "federation", None)
        if fed is not None:
            # federated control plane: pool -> leader-group map, this
            # group's fencing epoch, last leadership handoff
            body["federation"] = fed.debug()
        for cluster in (self.coord.clusters.all()
                        if self.coord is not None else []):
            tracker = getattr(cluster, "liveness", None)
            if tracker is not None:
                clusters[cluster.name]["agent_liveness"] = \
                    tracker.snapshot()
        from cook_tpu_torch import chaos
        if chaos.controller.enabled:
            # operators must be able to tell an injected outage from a
            # real one at a glance
            body["chaos"] = chaos.controller.stats()
        return Response(200, body)

    # -- federation-aware tracing ---------------------------------------
    #
    # A migrated job's spans live in TWO groups' tracers: the source
    # recorded submit/match/fed.migrate, the destination recorded
    # fed.adopt/reconcile/launch.  /trace/<uuid> on EITHER group must
    # return the whole story, so the serving group fans out to its
    # peers over two dumb, non-recursive read endpoints
    # (/federation/trace/...) and merges before assembling the tree.
    # All recursion risk stays here: the peer endpoints only ever read
    # their local tracer/store.

    _PEER_TRACE_TIMEOUT_S = 1.5

    def _peer_get(self, url: str,
                  timeout: float = _PEER_TRACE_TIMEOUT_S
                  ) -> Optional[dict]:
        """GET a peer's read-only endpoint on the leader-to-leader
        machine channel; None on any failure (a dark peer degrades the
        answer, never the request)."""
        import urllib.request
        try:
            r = urllib.request.Request(url, headers={
                "X-Cook-Agent-Token": self.auth.agent_token or ""})
            with urllib.request.urlopen(r, timeout=timeout) as resp:
                return json.loads(resp.read().decode())
        except Exception:
            return None

    def get_trace(self, req: Request, uuid: str) -> Response:
        """Assembled span tree for one job's lifecycle: REST submit ->
        store txn -> match-cycle phases -> launch txn -> backend/agent
        launch -> completion, across process boundaries (the agent's
        spans arrive via the status-post echo).

        Federation-aware: when the job is unknown locally (migrated
        away, or submitted to another group) the owning peer is found
        via /federation/trace/job/<uuid>; once a trace id is in hand
        every peer's spans for it are merged (dedup by span id) so
        migrate -> adopt -> reconcile reads as ONE connected tree no
        matter which group serves the request."""
        fed = getattr(self, "federation", None)
        peers = fed.peers() if fed is not None else []
        job = self.store.get_job(uuid)
        trace_id, traceparent = "", ""
        if job is not None:
            ctx = obs.parse_traceparent(job.traceparent)
            if ctx is None:
                raise ApiError(404, f"no trace recorded for job {uuid}")
            trace_id, traceparent = ctx[0], job.traceparent
        else:
            # local miss: ask each peer to resolve uuid -> trace id
            # from ITS store (dumb lookup, no further fan-out)
            for _g, url in peers:
                got = self._peer_get(
                    f"{url}/federation/trace/job/{uuid}")
                if got and got.get("trace_id"):
                    trace_id = got["trace_id"]
                    traceparent = got.get("traceparent") or ""
                    break
            if not trace_id:
                raise ApiError(404, f"job {uuid} unknown")
        spans = {s["span"]: s for s in obs.tracer.trace(trace_id)}
        if peers:
            # merge every peer's spans for this trace id; dedup by
            # span id (the migration span is recorded per-job with one
            # shared id — txn-span convention — so it folds to one)
            with ThreadPoolExecutor(max_workers=max(1, len(peers))) \
                    as pool:
                fetched = pool.map(
                    lambda p: self._peer_get(
                        f"{p[1]}/federation/trace/{trace_id}"), peers)
            for got in fetched:
                for s in (got or {}).get("spans") or []:
                    if isinstance(s, dict) and s.get("span"):
                        spans.setdefault(s["span"], s)
        merged = sorted(spans.values(),
                        key=lambda s: s.get("t0", 0.0))
        return Response(200, {"uuid": uuid, "trace_id": trace_id,
                              "traceparent": traceparent,
                              "spans": merged,
                              "tree": obs.assemble_tree(merged)})

    def federation_trace(self, req: Request, trace_id: str) -> Response:
        """Peer-facing span read: THIS group's spans for one trace id.
        Deliberately dumb — never fans out — so a get_trace on any
        group terminates after one hop."""
        return Response(200, {"trace_id": trace_id,
                              "spans": obs.tracer.trace(trace_id)})

    def federation_trace_job(self, req: Request, uuid: str) -> Response:
        """Peer-facing uuid -> trace-id resolution from the LOCAL
        store only (the get_trace fan-out's discovery half)."""
        job = self.store.get_job(uuid)
        ctx = obs.parse_traceparent(job.traceparent) if job else None
        if ctx is None:
            raise ApiError(404, f"job {uuid} unknown or untraced")
        return Response(200, {"uuid": uuid, "trace_id": ctx[0],
                              "traceparent": job.traceparent,
                              "spans": obs.tracer.trace(ctx[0])})

    def get_debug_flight(self, req: Request) -> Response:
        """The coordinator's cycle flight recorder: the most recent
        per-cycle spans (phase timings embedded as children), newest
        first."""
        try:
            limit = int(req.qp("limit", "64"))
        except (TypeError, ValueError):
            limit = 64
        return Response(200, {"tracer": obs.tracer.stats(),
                              "spans": obs.tracer.recent(limit)})

    def get_debug_profile(self, req: Request) -> Response:
        """The always-on cycle profiler: streaming per-phase stats,
        critical-path blame shares and the dominant phase per cycle
        kind.  ``?worst=K`` appends the K worst cycles (full phase
        ledgers); ``?chrome=K`` returns those cycles as Chrome-trace
        JSON instead (open in Perfetto / chrome://tracing)."""
        from cook_tpu_torch.obs import profiler

        def _k(name: str) -> int:
            try:
                return max(0, min(256, int(req.qp(name, "0") or 0)))
            except (TypeError, ValueError):
                return 0

        chrome_k = _k("chrome")
        if chrome_k:
            return Response(200, profiler.chrome_trace(chrome_k))
        body = profiler.snapshot()
        worst_k = _k("worst")
        if worst_k:
            body["worst"] = profiler.worst(worst_k)
        return Response(200, body)

    # -- federated health rollup ---------------------------------------

    def _health_local(self) -> dict:
        """This group's health block: the numbers an operator triages a
        fleet with, cheap enough to serve on every peer poll.  Status
        is always "healthy" when this code runs at all — reachability
        is the caller's judgment (a group that answers is alive; a dark
        one is marked unreachable by the poller, never by itself)."""
        from cook_tpu_torch.obs import profiler
        from cook_tpu_torch.utils.metrics import registry
        fed = getattr(self, "federation", None)
        out: dict = {"status": "healthy", "version": VERSION}
        if fed is not None:
            fdbg = fed.debug()
            exchange = fdbg.get("exchange") or {}
            out.update({
                "group": fed.group,
                "epoch": fdbg.get("epoch", 0),
                "pools": sorted(p for p, e in
                                (fdbg.get("pools") or {}).items()
                                if e.get("local")),
                "exchange": {
                    g: {"age_s": e.get("age_s"), "stale": e.get("stale")}
                    for g, e in exchange.items()},
                "stale_folds": registry.counter(
                    "federation_stale_folds_total",
                    group=fed.group).value,
                # live-reconfiguration evidence: the membership view
                # the reconfiguration soak asserts survivors agree on,
                # plus the reload/policy-migration counters the
                # metrics satellite exports
                "membership": fdbg.get("membership", {}),
                "membership_epoch": fed.membership_epoch,
                "reloads": registry.counter(
                    "federation_reloads_total", outcome="ok",
                    group=fed.group).value,
                "policy_migrations": registry.counter(
                    "federation_policy_migrations_total",
                    outcome="ok", group=fed.group).value,
            })
        prof = profiler.snapshot()
        out["decisions_per_s"] = prof.get("decisions_per_s", 0.0)
        out["profile"] = {
            kind: {"dominant": ks.get("dominant"),
                   "blame": {p: b.get("share")
                             for p, b in (ks.get("blame") or {}).items()}}
            for kind, ks in (prof.get("kinds") or {}).items()}
        ovl = getattr(self.coord, "overload", None) \
            if self.coord is not None else None
        if ovl is not None:
            snap = ovl.snapshot()
            out["overload_level"] = snap.get("level", 0)
        # store shard lock-wait p99: max across shards, read from the
        # registry histograms (shard_stats() totals are cumulative
        # sums, not distributions)
        p99 = 0.0
        for key, m in registry.snapshot().items():
            if key.startswith("store_shard_lock_wait_ms"):
                p99 = max(p99, float(m.get("p99", 0.0) or 0.0))
        out["shard_lock_wait_p99_ms"] = round(p99, 3)
        return out

    def federation_health(self, req: Request) -> Response:
        """Fleet-wide health rollup: this group's block plus every
        peer's, fetched concurrently over the machine channel
        (``?local=1`` — the form peers request — skips the fan-out so
        polling never recurses).  A dark peer degrades to
        ``status: "unreachable"``; it never blocks or fails the
        rollup — that IS the signal the operator is here for."""
        local = self._health_local()
        if req.qp("local"):
            return Response(200, local)
        return Response(200, self.fleet_health_snapshot(local))

    def fleet_health_snapshot(self, local: Optional[dict] = None) \
            -> dict:
        """The full fleet rollup dict — the /federation/health body
        and the FleetRebalancer's health_fn (the hot/cold score folds
        exactly what the operator sees)."""
        if local is None:
            local = self._health_local()
        fed = getattr(self, "federation", None)
        peers = fed.peers() if fed is not None else []
        groups = {local.get("group", "local"): local}
        if peers:
            with ThreadPoolExecutor(max_workers=max(1, len(peers))) \
                    as pool:
                fetched = pool.map(
                    lambda p: (p, self._peer_get(
                        f"{p[1]}/federation/health?local=1")), peers)
            for (g, url), got in fetched:
                if got is None:
                    got = {"group": g, "url": url,
                           "status": "unreachable"}
                groups[got.get("group", g)] = got
        statuses = [e.get("status") for e in groups.values()]
        return {
            "fleet": {"groups": len(groups),
                      "healthy": statuses.count("healthy"),
                      "unreachable": statuses.count("unreachable")},
            "groups": groups}

    # -- data-locality debug endpoints (data_locality.clj debug REST,
    # rest/api.clj data-local routes) ----------------------------------
    def _data_locality(self):
        dl = getattr(self.coord, "data_locality", None)
        if dl is None:
            raise ApiError(404, "data locality not configured")
        return dl

    def data_local_status(self, req: Request) -> Response:
        dl = self._data_locality()
        with dl._lock:
            return Response(200, {
                "weight": dl.weight,
                "batch_size": dl.batch_size,
                "cache_ttl_s": dl.cache_ttl_s,
                "jobs_with_costs": len(dl._costs),
                "last_update_times": dict(
                    sorted(dl._fetched_at.items())[-50:]),
            })

    def data_local_costs(self, req: Request, uuid: str) -> Response:
        dl = self._data_locality()
        costs = dl.get_costs(uuid)
        if not costs and self.store.get_job(uuid) is None:
            raise ApiError(404, f"job {uuid} unknown")
        return Response(200, {"uuid": uuid, "costs": costs})


# ----------------------------------------------------------------------
# response shaping (the JobResponse/InstanceResponse schemas)
def _job_status(job: Job) -> str:
    return job.state.value


def _job_state(job: Job) -> str:
    """Fine-grained state: waiting|running|success|failed."""
    if job.state == JobState.COMPLETED:
        return "success" if job.success else "failed"
    return job.state.value


def job_response(job: Job, store) -> dict:
    return {
        "uuid": job.uuid,
        "name": job.name,
        "command": job.command,
        "user": job.user,
        "status": _job_status(job),
        "state": _job_state(job),
        "priority": job.priority,
        "mem": job.mem,
        "cpus": job.cpus,
        "gpus": job.gpus,
        "ports": job.ports,
        "max_retries": job.max_retries,
        "max_runtime": job.max_runtime_ms,
        "retries_remaining": job.retries_remaining(),
        "submit_time": job.submit_time_ms,
        "pool": job.pool,
        "env": job.env,
        "labels": job.labels,
        "constraints": [list(c) for c in job.constraints],
        "uris": job.uris,
        "container": job.container,
        "application": job.application,
        "groups": [job.group] if job.group else [],
        "instances": [instance_response(i, job) for i in job.instances],
    }


def instance_response(inst: Instance, job: Job) -> dict:
    reason = _REASON_BY_CODE.get(inst.reason_code or -1)
    out = {
        "task_id": inst.task_id,
        "job_uuid": inst.job_uuid,
        "status": inst.status.value,
        "hostname": inst.hostname,
        "backend": inst.backend,
        "start_time": inst.start_time_ms,
        "end_time": inst.end_time_ms,
        "progress": inst.progress,
        "progress_message": inst.progress_message,
        "exit_code": inst.exit_code,
        "sandbox_directory": inst.sandbox_directory,
        "output_url": inst.output_url,
        "preempted": inst.preempted,
        "ports": inst.ports,
    }
    if reason is not None:
        out["reason_code"] = reason.code
        out["reason_string"] = reason.string
        out["reason_mea_culpa"] = reason.mea_culpa
    return out


def _jsonable_limits(d: dict) -> dict:
    return {k: ("unlimited" if v == UNLIMITED else v) for k, v in d.items()}


def _parse_time(s: str) -> int:
    """Epoch-millis or ISO date."""
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return int(time.mktime(time.strptime(s, "%Y-%m-%d")) * 1000)
    except ValueError:
        raise ApiError(400, f"unparseable time {s!r}")
