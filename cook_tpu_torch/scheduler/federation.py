"""Federated per-pool control plane: the host layer that promotes the
`parallel/federation.py` dry-run math into the serving stack.

Cook runs ONE match loop per pool behind HA masters
(scheduler.clj:1557-1578); this module gives each *leader group* of
pools its own election, its own store, and its own scheduling cycles,
so the control plane scales out horizontally while every pool still
sees exactly the single-coordinator decision sequence:

  - A **group** is a named set of pools served by one leader process
    (plus standbys) over one shared snapshot+log. The group's election
    reuses the existing electors (FileLeaderElector / LeaseElector) —
    one lock path / lease name per group — and its takeover mints a
    durable fencing epoch in the group store's epoch ledger
    (state/store.py mint_epoch), runs the PR-6 restart-reconcile
    census scoped to the group's pools, and only then opens the gates.
  - **Routing**: the REST front door 503s submissions for pools a peer
    group owns, hinting the owning leader's address (rest/api.py); the
    coordinator's per-pool cycle threads are narrowed by
    Coordinator.pool_filter so this leader never matches a peer's
    pools.
  - **Cross-shard DRU reconciliation**: pool-keyed shares/quotas are
    already shard-local (DRU divisors and quota tensors resolve per
    (user, pool)), so disjoint ownership reproduces the
    single-coordinator per-pool decisions exactly — the fleet
    differential oracle in tests/test_federation.py pins this.
    ShareExchange adds the slow-cadence piece a split brain of quotas
    cannot see: each leader publishes per-user usage aggregates for
    its owned pools (/federation/usage) and folds what peers report
    into FederatedQuotaView, so a DEFAULT-keyed (blanket) quota can
    bind globally. The fold is opt-in (`global_quota: true`): a
    single coordinator enforces quota per pool independently, and the
    default keeps the federation byte-equal to it.

Config (Settings.federation):

    {"group": "blue",
     "groups": {"blue":  {"pools": ["default"], "url": "http://...:a",
                          "devices": [0, 1]},
                "green": {"pools": ["gpu"],     "url": "http://...:b",
                          "devices": [2]}},
     "exchange_interval_s": 2.0,
     "global_quota": false,
     "global_quota_staleness_s": 10.0,
     "rebalance": {"enabled": false, "interval_s": 15.0,
                   "hysteresis_rounds": 2, "cooldown_s": 120.0}}

Fleet-scale additions (N >= 3 groups carrying real traffic):

  - **Placement**: a group may claim local accelerator devices
    (``devices``: indices into jax.devices()); each owned pool's
    resident cycle is pinned to one of them
    (parallel/federation.place_pools — stable pool-hash spread, so a
    pool keeps its chip across restarts). Group ownership therefore
    picks which device a pool's resident state lives on.
  - **Live migration**: ``reassign`` flips a pool's ownership at
    runtime (the REST layer's POST /federation/migrate drives the full
    drain -> durable fedmove -> pool-scoped epoch fence -> adopt
    handoff; see rest/api.py federation_migrate). The 503 ownership
    hint follows the overlay immediately, so clients chase the new
    owner from the first rejected submission.
  - **Exchange staleness**: every fold is stamped with the LOCAL
    receive time; ``remote_usage`` EXCLUDES folds older than
    ``global_quota_staleness_s`` (flagged in /debug and counted in
    ``federation_stale_folds_total``, never silently trusted). A
    group gone dark therefore stops shrinking its peers' effective
    quota — the quota pie rebalances to the live groups instead of
    being pinned by a dead leader's last report.

A process with no federation config still gets a single-group host
owning every pool (FederationHost.single), so /debug carries the
federation block and the fencing-epoch evidence in every deployment.
"""
from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Optional

from cook_tpu_torch.state.limits import QuotaStore

log = logging.getLogger(__name__)


class FederationHost:
    """One process's view of the federated control plane: which group
    it serves, which pools that group owns, where the peer groups
    live, and the takeover evidence (epoch, transitions, handoff
    timing) the observability layer surfaces."""

    def __init__(self, group: str, groups: Optional[dict] = None,
                 store=None, url: str = "",
                 exchange_interval_s: float = 2.0,
                 global_quota: bool = False,
                 global_quota_staleness_s: float = 10.0):
        self.group = group
        self.groups: dict[str, dict] = dict(groups or {})
        self.store = store
        self.url = url
        self.exchange_interval_s = float(exchange_interval_s)
        self.global_quota = bool(global_quota)
        self.global_quota_staleness_s = float(global_quota_staleness_s)
        # pool -> owning group name, from the explicit group specs;
        # pools listed nowhere belong to the LOCAL group (so the
        # default single-group federation owns everything, and a pool
        # added at runtime is served rather than blackholed). Live
        # migration mutates this map at runtime under _owner_lock; all
        # readers go through _owner_of so a reassignment is visible to
        # routing, cycle filtering, and the 503 hint atomically.
        self._pool_owner: dict[str, str] = {}
        self._owner_lock = threading.Lock()
        for name, spec in self.groups.items():
            for pool in spec.get("pools", ()):
                self._pool_owner[pool] = name
        self.transitions = 0
        self.last_handoff: dict = {}
        # live-migration evidence: [{pool, from, to, t_ms, ...}]
        self.migrations: list[dict] = []
        # remote usage fold: peer group -> its last usage snapshot,
        # plus the LOCAL monotonic receive stamp the staleness bound
        # is measured against (a peer's own t_ms is wall clock on a
        # different box — skew-prone; what "stale" means here is "WE
        # have not heard from it", which only our clock can say)
        self._remote: dict[str, dict] = {}
        self._remote_rx: dict[str, float] = {}
        self._remote_lock = threading.Lock()
        self._exchange_stop: Optional[threading.Event] = None
        # live membership (tentpole: fleet topology as a runtime
        # object): the membership epoch counts committed reconfigs,
        # durably journaled in the store's membership ledger; every
        # view change goes through _swap_membership — the ONE blessed
        # mutation site for self.groups / self._pool_owner outside
        # __init__/reassign (pinned by cookcheck R14). pending_reload
        # holds a dangling ledger "begin" found at boot, for the
        # server to resume once the leadership gates open.
        self.membership_epoch: int = 0
        self.pending_reload: Optional[dict] = None
        # membership-change evidence ring: [{mepoch, groups, note,...}]
        self.membership_log: list[dict] = []
        self.rebalancer: Optional["FleetRebalancer"] = None

    @classmethod
    def single(cls, store=None, url: str = "") -> "FederationHost":
        """The degenerate federation every non-federated deployment
        runs: one group, owning all pools, no peers."""
        return cls(group="all", groups={}, store=store, url=url)

    # ------------------------------------------------------------------
    # ownership / routing
    def _owner_of(self, pool: str) -> str:
        with self._owner_lock:
            return self._pool_owner.get(pool, self.group)

    def owns(self, pool: str) -> bool:
        return self._owner_of(pool) == self.group

    def owned_pools(self) -> list[str]:
        with self._owner_lock:
            return sorted(p for p, g in self._pool_owner.items()
                          if g == self.group)

    def owner_url(self, pool: str) -> Optional[str]:
        """The owning group's leader address (the 503 hint for a
        misrouted submission); None when we own it / nothing better
        than the caller's fallback is known."""
        owner = self._owner_of(pool)
        if owner == self.group:
            return None
        return self.groups.get(owner, {}).get("url") or None

    def reassign(self, pool: str, group: str, note: str = "") -> dict:
        """Flip a pool's ownership at runtime — the routing half of a
        live migration. After this returns, owns()/owner_url() answer
        for the NEW owner: misrouted submissions 503 with the new
        leader's address, and the cycle loops (narrowed by
        Coordinator.pool_filter = owns) stop/start serving the pool on
        their next round. The durable half (drain, fedmove txn,
        pool-scoped epoch fence, adopt) is orchestrated by the REST
        migration route; this method only moves the map and records
        the evidence /debug serves."""
        if group != self.group and group not in self.groups:
            raise ValueError(f"unknown leader group {group!r}")
        with self._owner_lock:
            prev = self._pool_owner.get(pool, self.group)
            self._pool_owner[pool] = group
        rec = {"pool": pool, "from": prev, "to": group,
               "t_ms": int(time.time() * 1e3)}
        if note:
            rec["note"] = note
        self.migrations.append(rec)
        if prev != group:
            from cook_tpu_torch.utils.metrics import registry
            registry.counter("federation_pool_migrations_total",
                             group=self.group).inc()
        return rec

    def pools_of(self, group: str) -> list[str]:
        """Pools the named group owns per the CURRENT view (runtime
        reassignments included) — what the rebalancer and the reload
        drain loop enumerate."""
        with self._owner_lock:
            return sorted(p for p, g in self._pool_owner.items()
                          if g == group)

    # ------------------------------------------------------------------
    # live membership (tentpole: config reload under a membership
    # epoch). The view swap is ATOMIC: groups and the pool->owner map
    # are replaced together under _owner_lock, so any reader — routing
    # 503 hints, owns() cycle filtering, peers() for the exchange —
    # sees exactly the old or the new view, never a half-applied one.
    def diff_membership(self, target: dict) -> tuple[list, list]:
        """(joins, leaves) of group names between the current view and
        a target ``groups`` mapping."""
        cur = set(self.groups) or {self.group}
        new = set(target or {}) or {self.group}
        return sorted(new - cur), sorted(cur - new)

    def membership_view(self) -> dict:
        """The agreed-membership evidence /federation/health serves:
        {epoch, groups} — what the reconfiguration soak asserts every
        survivor converges to."""
        with self._owner_lock:
            names = sorted(self.groups) or [self.group]
        return {"epoch": self.membership_epoch, "groups": names}

    def _swap_membership(self, groups: dict, mepoch: int,
                         note: str = "") -> dict:
        """THE blessed membership swap (cookcheck R14 flags any other
        mutation of the membership tables): atomically replace
        self.groups and self._pool_owner under _owner_lock and advance
        the membership epoch. Runtime pool reassignments (live
        migrations) survive the swap when their owner remains a member
        of the new view — a reload must not silently undo a migration
        the fleet already committed; pools owned by a DEPARTED group
        fall back to the target spec's claim (the reload drain already
        moved their jobs)."""
        new_groups = {name: dict(spec)
                      for name, spec in (groups or {}).items()}
        base: dict[str, str] = {}
        for name, spec in new_groups.items():
            for pool in spec.get("pools", ()):
                base[pool] = name
        with self._owner_lock:
            for pool, owner in self._pool_owner.items():
                if owner != self.group and owner not in new_groups:
                    continue   # departed owner: target spec claim wins
                if pool not in base:
                    base[pool] = owner   # runtime-only pool, no claim
                elif owner != base[pool]:
                    base[pool] = owner   # live migration overlay wins
            self.groups = new_groups
            self._pool_owner = base
            self.membership_epoch = int(mepoch)
            names = sorted(new_groups) or [self.group]
        rec = {"mepoch": int(mepoch), "groups": names,
               "t_ms": int(time.time() * 1e3)}
        if note:
            rec["note"] = note
        self.membership_log.append(rec)
        del self.membership_log[:-32]
        from cook_tpu_torch.utils.metrics import registry
        registry.gauge("federation_membership_epoch",
                       group=self.group).set(float(mepoch))
        log.info("federation[%s]: membership epoch %d -> groups %s%s",
                 self.group, int(mepoch), names,
                 f" ({note})" if note else "")
        return rec

    def bootstrap_membership(self) -> Optional[dict]:
        """Replay the membership ledger at boot: apply the last
        COMMITTED target view over the config-file view (after a
        reload, the ledger is newer truth than the config a restarted
        process read), and return the dangling "begin" record — a
        reload that journaled intent but never committed/aborted — for
        the server to resume once leadership gates open. Begins older
        than a later committed epoch are dead (superseded), not
        resumable."""
        if self.store is None:
            return None
        records = self.store.membership_records()
        closed: dict[int, str] = {}
        for r in records:
            if r.get("phase") in ("commit", "abort"):
                closed[int(r.get("mepoch", 0))] = r["phase"]
        last_committed, dangling = None, None
        top_closed = max(closed, default=0)
        top_committed = max(
            (ep for ep, ph in closed.items() if ph == "commit"),
            default=0)
        for r in records:
            if r.get("phase") != "begin":
                continue
            ep = int(r.get("mepoch", 0))
            if closed.get(ep) == "commit":
                last_committed = r
            elif ep not in closed and ep > top_closed:
                dangling = r
        if last_committed is not None and \
                last_committed.get("target") is not None:
            self._swap_membership(last_committed["target"],
                                  int(last_committed["mepoch"]),
                                  note="ledger replay")
        elif top_committed > self.membership_epoch:
            self.membership_epoch = top_committed
        self.pending_reload = dangling
        return dangling

    # ------------------------------------------------------------------
    # pool -> device placement (tentpole: group ownership picks which
    # device a pool's resident cycle runs on)
    def placement_index(self, pool: str) -> Optional[int]:
        """Device index (into jax.devices()) this pool's resident
        state should live on, per the owning group's ``devices`` claim;
        None when the group claims none (default-device behavior).
        Only meaningful for pools THIS group owns — a peer's pools run
        on the peer's devices."""
        spec = self.groups.get(self._owner_of(pool), {})
        devices = spec.get("devices") or ()
        if not devices:
            return None
        from cook_tpu_torch.parallel.federation import place_pools
        return place_pools([pool], devices)[pool]

    def placement(self) -> dict:
        """pool -> device index for every owned pool with a claim (the
        /debug placement block + the server's enable_resident hook)."""
        spec = self.groups.get(self.group, {})
        devices = spec.get("devices") or ()
        if not devices:
            return {}
        from cook_tpu_torch.parallel.federation import place_pools
        return place_pools(self.owned_pools(), devices)

    def peers(self) -> list[tuple[str, str]]:
        """[(group, url)] for every OTHER group with an address."""
        return [(name, spec["url"])
                for name, spec in sorted(self.groups.items())
                if name != self.group and spec.get("url")]

    # ------------------------------------------------------------------
    # takeover evidence (satellite: /debug federation block + metrics)
    def record_takeover(self, epoch: int, duration_ms: float) -> None:
        """Called by the server's on_leadership once the gates open:
        counts the transition, observes the failover duration (the
        MTTR the soak and bench.py failover bound), and pins the
        handoff record /debug serves."""
        from cook_tpu_torch.utils.metrics import registry
        self.transitions += 1
        registry.counter("leader_transitions_total",
                         group=self.group).inc()
        registry.histogram("failover_duration_ms",
                           group=self.group).observe(duration_ms)
        # pre-touch the live-reconfiguration metric families so every
        # deployment (even one that never reloads) exposes them at
        # zero — live-smoke gates on their presence
        registry.gauge("federation_membership_epoch",
                       group=self.group).set(
                           float(self.membership_epoch))
        registry.counter("federation_reloads_total", outcome="ok",
                         group=self.group).inc(0)
        registry.counter("federation_policy_migrations_total",
                         outcome="ok", group=self.group).inc(0)
        self.last_handoff = {"epoch": epoch,
                             "t_ms": int(time.time() * 1e3),
                             "duration_ms": round(duration_ms, 1)}

    @property
    def epoch(self) -> int:
        return getattr(self.store, "epoch", 0) if self.store else 0

    def debug(self) -> dict:
        pools = {}
        with self._owner_lock:
            names = set(self._pool_owner)
            owner_map = dict(self._pool_owner)
        if self.store is not None:
            # pools with live state but no explicit spec: owned locally
            names |= set(getattr(self.store, "_pending", {}))
        placement = self.placement()
        for pool in sorted(names):
            owner = owner_map.get(pool, self.group)
            pools[pool] = {
                "group": owner,
                "leader": (self.url if owner == self.group
                           else self.groups.get(owner, {}).get("url")),
                "local": owner == self.group}
            if pool in placement:
                pools[pool]["device"] = placement[pool]
        now = time.monotonic()
        bound = self.global_quota_staleness_s
        with self._remote_lock:
            exchange = {}
            for g, s in self._remote.items():
                age_s = now - self._remote_rx.get(g, now)
                exchange[g] = {"pools": sorted(s.get("pools", {})),
                               "epoch": s.get("epoch", 0),
                               "t_ms": s.get("t_ms", 0),
                               "age_s": round(age_s, 3),
                               "stale": bool(bound > 0 and age_s > bound)}
        self._export_exchange_age(exchange)
        out = {"group": self.group,
               "pools": pools,
               "epoch": self.epoch,
               "transitions": self.transitions,
               "last_handoff": dict(self.last_handoff),
               "migrations": [dict(m) for m in self.migrations[-16:]],
               "membership": self.membership_view(),
               "membership_log": [dict(m)
                                  for m in self.membership_log[-8:]],
               "exchange": exchange,
               "global_quota": self.global_quota,
               "global_quota_staleness_s": bound}
        if self.rebalancer is not None:
            out["rebalance"] = self.rebalancer.debug()
        return out

    # ------------------------------------------------------------------
    # cross-shard usage exchange
    def usage_snapshot(self) -> dict:
        """What this leader publishes at /federation/usage: per-user
        running aggregates for the pools it owns, stamped with its
        fencing epoch so a peer can drop a deposed leader's stale
        report."""
        pools: dict[str, dict] = {}
        if self.store is not None:
            owned = self.owned_pools() or \
                sorted(getattr(self.store, "_usage", {}))
            for pool in owned:
                usage = self.store.user_usage(pool)
                if usage:
                    pools[pool] = usage
        return {"group": self.group, "epoch": self.epoch,
                "t_ms": int(time.time() * 1e3), "pools": pools}

    def fold_remote(self, group: str, snapshot: dict) -> None:
        """Absorb a peer's usage snapshot. Epoch-monotone per group: a
        partitioned old leader's report (lower epoch than one already
        folded) is dropped, the same staleness rule the store applies
        to log entries. Every accepted fold is stamped with the local
        monotonic receive time — the clock the staleness bound below
        is measured against (a frozen/dead peer stops refreshing it)."""
        if not isinstance(snapshot, dict) or group == self.group:
            return
        with self._remote_lock:
            prev = self._remote.get(group)
            if prev and snapshot.get("epoch", 0) < prev.get("epoch", 0):
                return
            self._remote[group] = snapshot
            self._remote_rx[group] = time.monotonic()

    def _fresh_snaps(self) -> tuple[list, list]:
        """(fresh snapshots, stale group names): a fold whose local
        receive stamp is older than global_quota_staleness_s is
        EXCLUDED from the quota fold and flagged — trusting it would
        let a dead leader's last report pin its users' fleet-wide
        quota forever. Exclusion IS the quota-pie rebalance: the dark
        group's usage stops shrinking the live groups' effective
        ceilings until its successor reports again."""
        now = time.monotonic()
        bound = self.global_quota_staleness_s
        fresh, stale = [], []
        with self._remote_lock:
            items = [(g, s, self._remote_rx.get(g, now))
                     for g, s in self._remote.items()]
        for g, snap, rx in items:
            if bound > 0 and (now - rx) > bound:
                stale.append(g)
            else:
                fresh.append(snap)
        if stale:
            from cook_tpu_torch.utils.metrics import registry
            registry.counter("federation_stale_folds_total",
                             group=self.group).inc(len(stale))
        return fresh, stale

    def _export_exchange_age(self, exchange: Optional[dict] = None) \
            -> None:
        """Refresh the per-peer ``cook_federation_exchange_age_s``
        gauge (labeled by the REPORTING group) so dashboards see fold
        age climbing BEFORE it crosses the staleness bound — the
        leading indicator for the ``federation_stale_folds_total``
        counter's step.  Called from the exchange poll loop each round
        and from debug(), which already computed the ages."""
        from cook_tpu_torch.utils.metrics import registry
        if exchange is None:
            now = time.monotonic()
            with self._remote_lock:
                exchange = {
                    g: {"age_s": round(now - self._remote_rx.get(g, now),
                                       3)}
                    for g in self._remote}
        for g, ent in exchange.items():
            registry.gauge("federation_exchange_age_s",
                           group=g).set(ent["age_s"])

    def remote_usage(self, user: str, pool: str) -> dict:
        """The user's usage as reported by PEER groups, for the quota
        fold. {} unless global_quota is on (the default keeps the
        federation byte-equal to a single coordinator, which enforces
        quota per pool independently). With it on, the user's total
        remote usage — every FRESH peer report, every pool — shrinks
        the effective quota, so a blanket ceiling binds fleet-wide.
        Folds past the staleness bound are excluded (see
        _fresh_snaps), never silently trusted."""
        if not self.global_quota:
            return {}
        del pool  # blanket fold: the ceiling is global by definition
        out = {"mem": 0.0, "cpus": 0.0, "gpus": 0.0, "jobs": 0.0}
        any_usage = False
        snaps, _ = self._fresh_snaps()
        for snap in snaps:
            for usage in snap.get("pools", {}).values():
                u = usage.get(user)
                if not u:
                    continue
                any_usage = True
                for k in out:
                    out[k] += float(u.get(k, 0.0))
        return out if any_usage else {}

    # ------------------------------------------------------------------
    # exchange transport (leader-only thread; peers poll each other)
    def start_exchange(self) -> None:
        if not self.peers() or self._exchange_stop is not None:
            return
        stop = self._exchange_stop = threading.Event()

        def poll_once() -> None:
            for group, url in self.peers():
                try:
                    with urllib.request.urlopen(
                            f"{url}/federation/usage",
                            timeout=2.0) as resp:
                        self.fold_remote(
                            group, json.loads(resp.read().decode()))
                except Exception:
                    # a dead / partitioned / mid-failover peer is
                    # normal life; the last folded snapshot stands
                    # until its successor reports
                    continue
            self._export_exchange_age()

        def body() -> None:
            while not stop.wait(self.exchange_interval_s):
                poll_once()

        self._poll_once = poll_once   # tests drive one round inline
        threading.Thread(target=body, daemon=True,
                         name=f"fed-exchange-{self.group}").start()

    def stop_exchange(self) -> None:
        if self._exchange_stop is not None:
            self._exchange_stop.set()
            self._exchange_stop = None

    # ------------------------------------------------------------------
    # policy-initiated migration (tentpole b): a slow-cadence
    # rebalancer that folds the /federation/health rollup into a
    # hot/cold score and drives the PR-18 migration protocol itself
    def configure_rebalance(self, cfg: Optional[dict] = None,
                            health_fn=None,
                            migrate_fn=None) -> "FleetRebalancer":
        """Build (but do not start) this host's FleetRebalancer.
        ``health_fn`` returns the fleet health rollup dict;
        ``migrate_fn(pool, src_group, dst_group)`` drives one
        migration and returns True on success — both injected by the
        REST layer so the policy core stays unit-testable without
        servers."""
        self.rebalancer = FleetRebalancer(self, cfg, health_fn,
                                          migrate_fn)
        return self.rebalancer

    def start_rebalancer(self) -> None:
        if self.rebalancer is not None:
            self.rebalancer.start()

    def stop_rebalancer(self) -> None:
        if self.rebalancer is not None:
            self.rebalancer.stop()


REBALANCE_DEFAULTS = {
    "enabled": False,          # default OFF: bench.py fleet unchanged
    "interval_s": 15.0,        # policy cadence (slow by design)
    "hysteresis_rounds": 2,    # consecutive hot observations required
    "cooldown_s": 120.0,       # per-pool: no re-move inside this
    "hot_score": 20.0,         # a peer at/above this is a candidate
    "cold_score": 5.0,         # only a group at/below this pulls work
    "unreachable_weight": 100.0,   # dark/frozen peer: maximally hot
    "overload_weight": 10.0,       # per overload rung
    "stale_weight": 5.0,           # per stale exchange entry it holds
    "dps_weight": 10.0,            # scaled by decisions/s over the ref
    "hot_decisions_per_s": 0.0,    # 0 disables the decision-rate term
}


class FleetRebalancer:
    """Policy-initiated pool migration: fold each group's health
    evidence (decisions/s, overload rung, exchange staleness,
    reachability) into one hot/cold score and, when a peer stays hot
    across ``hysteresis_rounds`` consecutive polls while THIS group is
    cold, pull one of its pools here through the ordinary
    /federation/migrate protocol.

    Every enabled leader runs its own instance and only PULLS work
    toward itself — no global coordinator. Two cold groups racing for
    the same hot pool resolve at the source's migrate route (first
    drain wins; the loser's POST gets the 503 ownership hint). Flap
    control is layered: hysteresis before acting, a per-pool cooldown
    after acting, at-most-one-migration-in-flight-per-pool, and at
    most one migration per tick."""

    def __init__(self, fed: FederationHost, cfg: Optional[dict] = None,
                 health_fn=None, migrate_fn=None):
        self.fed = fed
        merged = dict(REBALANCE_DEFAULTS)
        merged.update(cfg or {})
        self.cfg = merged
        self.health_fn = health_fn
        self.migrate_fn = migrate_fn
        self._stop: Optional[threading.Event] = None
        self._hot_streak: dict[str, int] = {}
        self._cooldown_until: dict[str, float] = {}
        self._in_flight: set[str] = set()
        self.decisions: list[dict] = []   # evidence ring for /debug
        self.ticks = 0

    @property
    def enabled(self) -> bool:
        return bool(self.cfg.get("enabled"))

    def score(self, entry) -> float:
        """One group's hotness from its /federation/health block. An
        unreachable / non-healthy group scores the unreachable weight
        — a SIGSTOP-frozen leader can't serve its pools, which is
        exactly when policy should move them."""
        if not isinstance(entry, dict) or \
                entry.get("status") != "healthy":
            return float(self.cfg["unreachable_weight"])
        s = float(entry.get("overload_level", 0) or 0) * \
            float(self.cfg["overload_weight"])
        stale = sum(1 for e in (entry.get("exchange") or {}).values()
                    if isinstance(e, dict) and e.get("stale"))
        s += stale * float(self.cfg["stale_weight"])
        ref = float(self.cfg["hot_decisions_per_s"] or 0.0)
        if ref > 0:
            dps = float(entry.get("decisions_per_s", 0.0) or 0.0)
            s += (dps / ref) * float(self.cfg["dps_weight"])
        return s

    def tick(self, rollup: Optional[dict] = None) -> Optional[dict]:
        """One policy round (tests drive this inline for determinism).
        Returns the migration decision acted on, else None."""
        self.ticks += 1
        if rollup is None and self.health_fn is not None:
            try:
                rollup = self.health_fn()
            except Exception:
                rollup = None
        groups = (rollup or {}).get("groups") or {}
        if not groups:
            return None
        scores = {g: self.score(e) for g, e in groups.items()}
        me = self.fed.group
        # hysteresis ledger first, so a hot spell is tracked even on
        # rounds where we ourselves are too busy to act.
        # _hot_streak/_in_flight are confined to this loop thread —
        # debug() only reads the decisions ring.
        for g, s in scores.items():
            if g != me and s >= float(self.cfg["hot_score"]):
                self._hot_streak[g] = self._hot_streak.get(g, 0) + 1  # cookcheck: disable=R2
            else:
                self._hot_streak.pop(g, None)
        if scores.get(me, 0.0) > float(self.cfg["cold_score"]):
            return None   # only a cold group pulls work toward itself
        ripe = sorted(((s, g) for g, s in scores.items()
                       if g != me and self._hot_streak.get(g, 0) >=
                       int(self.cfg["hysteresis_rounds"])),
                      reverse=True)
        if not ripe:
            return None
        _, victim = ripe[0]
        now = time.monotonic()
        pool = next(
            (p for p in self.fed.pools_of(victim)
             if p not in self._in_flight and
             now >= self._cooldown_until.get(p, 0.0)), None)
        if pool is None:
            return None
        decision = {"pool": pool, "from": victim, "to": me,
                    "score": round(scores[victim], 2),
                    "t_ms": int(time.time() * 1e3)}
        from cook_tpu_torch.utils.metrics import registry
        self._in_flight.add(pool)  # cookcheck: disable=R2
        try:
            ok = bool(self.migrate_fn(pool, victim, me)) \
                if self.migrate_fn else False
        except Exception as e:
            log.warning("rebalance[%s]: migrate %s from %s failed: %s",
                        me, pool, victim, e)
            ok = False
        finally:
            self._in_flight.discard(pool)
        # cooldown regardless of outcome: a failing source (frozen
        # leader) must not be hammered every tick
        self._cooldown_until[pool] = now + float(self.cfg["cooldown_s"])
        self._hot_streak.pop(victim, None)   # re-observe from scratch
        decision["outcome"] = "ok" if ok else "failed"
        registry.counter("federation_policy_migrations_total",
                         outcome=decision["outcome"],
                         group=me).inc()
        self.decisions.append(decision)
        del self.decisions[:-32]
        log.info("rebalance[%s]: %s %s <- %s (score %.1f)", me,
                 decision["outcome"], pool, victim, scores[victim])
        return decision

    def start(self) -> None:
        if not self.enabled or self._stop is not None:
            return
        stop = self._stop = threading.Event()

        def body() -> None:
            while not stop.wait(float(self.cfg["interval_s"])):
                try:
                    self.tick()
                except Exception:
                    log.exception("rebalance[%s]: tick failed",
                                  self.fed.group)

        threading.Thread(target=body, daemon=True,
                         name=f"fed-rebalance-{self.fed.group}").start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    def debug(self) -> dict:
        return {"enabled": self.enabled,
                "interval_s": float(self.cfg["interval_s"]),
                "ticks": self.ticks,
                "hot_streak": dict(self._hot_streak),
                "in_flight": sorted(self._in_flight),
                "decisions": [dict(d) for d in self.decisions[-8:]]}


class FederatedQuotaView(QuotaStore):
    """A QuotaStore whose get() subtracts the usage PEER shards report
    for the same user, clamped at zero — transparent to
    tensorize.quota_arrays, so the matcher needs no federation
    awareness. With the exchange idle (or global_quota off) this is
    bit-for-bit the base QuotaStore: the fleet differential oracle
    relies on that."""

    def __init__(self, federation: FederationHost):
        super().__init__()
        self._federation = federation

    def get(self, user: str, pool: str) -> dict:
        q = super().get(user, pool)
        remote = self._federation.remote_usage(user, pool)
        if not remote:
            return q
        out = {}
        for k, v in q.items():
            used = remote.get("jobs" if k == "count" else k, 0.0)
            # inf stays inf; a finite ceiling already consumed remotely
            # clamps at zero rather than going negative (quota_arrays
            # feeds these straight into the device tensors)
            out[k] = max(0.0, v - used)
        return out
