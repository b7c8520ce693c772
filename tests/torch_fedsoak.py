"""Leader-kill / partition failover soak over an HA coordinator pair.

The day-soak churns the AGENT fleet under one coordinator; this tier
churns the COORDINATOR tier itself. Two real server processes of the
port (an HA pair, ``tests.torch_livestack.LiveServer`` with per-member
file suffixes, each on the device it is given)
share one durable store directory and campaign for a flock lease
(``FileLeaderElector``). A seeded ``chaos.churn.generate_leader_churn``
schedule then:

  - ``leader_kill``: SIGKILLs whoever leads at fire time. The standby
    must acquire the lease, mint a fencing epoch in the durable epoch
    ledger (``events.log.epoch``), replay, census, and open its gates —
    the harness measures kill -> takeover-visible as MTTR and then
    respawns the victim as a standby.
  - ``leader_partition``: SIGSTOPs the leader for ``down_s`` and
    SIGCONTs it — a partitioned-but-alive leader whose sockets stay
    open. The flock is still held, so no takeover happens; the fleet
    must ride out the stall (clients retry, agents re-deliver).

Traffic runs throughout: agents live in THIS process (launch-count
evidence survives server kills) and clients submit over the HA pair
with kill-retry, both following 503 leader hints. After the churn a
post-wave of submissions guarantees instances are created under the
post-takeover epoch, so the per-record ``"ep"`` stamps in the shared
event log span leader generations — the at-most-once-across-epochs
evidence.

The harness also runs the split-brain proof the whole design exists
for: a store handle replaying the SHARED log (no writer — it must not
touch the live leader's file) is given a superseded epoch, exactly the
view of a deposed leader that never noticed the takeover, and its next
transaction must raise ``StaleEpochError`` off the fsync'd ledger and
bump ``stale_epoch_writes_rejected_total``.

Evidence is COLLECTED here and asserted by the caller
(tests/test_torch_failover_soak.py; ``bench_torch.py failover`` and
chip_smoke.py measure the MTTR half on the card). Every input schedule
and ledger is written to $CHAOS_ARTIFACTS_DIR so a red run ships its
replay.
"""
import json
import os
import shutil
import signal
import threading
import time
import uuid as uuidlib

from cook_tpu_torch.agent.daemon import AgentDaemon
from cook_tpu_torch.chaos.churn import (LEADER_KILL, LEADER_PARTITION,
                                  MEMBER_JOIN, MEMBER_JOIN_KILL,
                                  MEMBER_LEAVE, MEMBER_LEAVE_HOT,
                                  MEMBER_LEAVE_KILL, MEMBER_LEAVE_STOP,
                                  generate_leader_churn,
                                  generate_membership_churn)
from cook_tpu_torch.client import JobClient
from cook_tpu_torch.sim.gen import generate_trace
from cook_tpu_torch.state.model import Job, new_uuid
from cook_tpu_torch.state.store import (JobStore, StaleEpochError,
                                  _read_membership_ledger)
from tests.torch_livestack import LiveServer

READY_BOUND_S = 25.0
SUBMIT_RETRIES = 20


def _read_epoch_ledger(path: str) -> list:
    """All mint records, in file order; torn final line skipped (same
    tolerance as the store's reader)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def _scan_inst_events(log_path: str) -> list:
    """Every ``k=="inst"`` record in the shared event log — the durable
    at-most-once ledger the gates scan: one record per task, stamped
    with the minting leader's epoch."""
    out = []
    try:
        with open(log_path) as f:
            for line in f:
                line = line.strip()
                if not line or '"inst"' not in line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if ev.get("k") == "inst":
                    out.append(ev)
    except OSError:
        pass
    return out


def run_failover_soak(store_root, seed, tag=None, jobs=8, agents=2,
                      window_s=6.0, wall_s=90.0, kills=2, partitions=1,
                      post_jobs=2, churn=True, device="cuda"):
    """One compressed failover day. Returns an evidence dict; asserts
    nothing. churn=False is the quiet baseline: same pair, same
    traffic, zero leader faults — exactly one epoch ever minted. Both
    servers run on ``device`` ("cuda" unless the caller asks for
    "cpu"); their logs (``server-a.log``, ``server-b.log`` in
    ``store_root``) name each incarnation's device and, once stopped,
    its kernel launches (``tests.torch_livestack.incarnations``).

    Full-magnitude nightly parameters (documented here, driven by the
    CI federation-soak job): jobs=40, window_s=15, wall_s=300,
    kills=3, partitions=2.
    """
    tag = tag or f"fed{seed}"
    violations: list[str] = []
    transitions: list[dict] = []
    launch_counts: dict[str, int] = {}
    lock_path = os.path.join(str(store_root), "leader.lock")
    overrides = {"leader_lock_path": lock_path,
                 "scheduler": {"heartbeat_timeout_s": 6.0}}
    servers = {
        "a": LiveServer(store_root, name="a", sites=None, seed=seed,
                        max_kills=0, overrides=overrides, device=device),
        "b": LiveServer(store_root, name="b", sites=None, seed=seed,
                        max_kills=0, overrides=overrides, device=device),
    }
    shared_log = os.path.join(str(store_root), "events.log")
    ha_urls = ",".join(s.url for s in servers.values())

    def _fed(srv):
        try:
            return srv.debug().get("federation", {})
        except Exception:
            return {}

    def _leader():
        """The member whose store epoch matches the newest mint — the
        federation block is served by standbys too, with their (stale
        or zero) replayed epoch, so max wins."""
        best, best_ep = None, 0
        for name, s in servers.items():
            ep = _fed(s).get("epoch", 0)
            if ep > best_ep:
                best, best_ep = name, ep
        return best, best_ep

    def _wait_leader(timeout_s=READY_BOUND_S):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            name, ep = _leader()
            if name is not None:
                return name, ep
            time.sleep(0.05)
        return None, 0

    def make_daemon(host):
        d = AgentDaemon(ha_urls, hostname=host, mem=4096.0, cpus=8.0,
                        sandbox_root=str(store_root / f"sbx-{host}"
                                         / str(time.monotonic_ns())),
                        heartbeat_interval_s=0.4,
                        agent_token=LiveServer.AGENT_TOKEN)
        orig = d.executor.launch

        def counted(task_id, *a, _orig=orig, **kw):
            launch_counts[task_id] = launch_counts.get(task_id, 0) + 1
            return _orig(task_id, *a, **kw)

        d.executor.launch = counted
        return d

    clients: dict[str, JobClient] = {}
    uuids: list[tuple] = []

    def submit_with_retry(user, priority=50):
        """Kill-retry submission: a dead or frozen leader mid-submit is
        the point of this soak. The HA client follows 503 hints; the
        dedup probe keeps the retry loop at-most-once."""
        cli = clients.setdefault(
            user, JobClient(ha_urls, user=user, timeout=5.0))
        u = str(uuidlib.uuid4())
        for _ in range(SUBMIT_RETRIES):
            try:
                cli.submit(command="sleep 0.4", mem=64.0, cpus=1.0,
                           uuid=u, priority=priority, max_retries=4)
                break
            except Exception:
                try:
                    if cli.query_jobs([u]):
                        break
                except Exception:
                    pass
                time.sleep(0.5)
        else:
            violations.append(f"submit of {u} never landed")
        uuids.append((u, user))

    schedule = generate_leader_churn(seed, duration_s=window_s + 2.0,
                                     kills=kills,
                                     partitions=partitions) \
        if churn else None
    stop_evt = threading.Event()
    frozen_pids: list[int] = []

    def _do_leader_event(ev):
        name, ep_before = _wait_leader()
        if name is None:
            violations.append(f"no leader to {ev.action} at t={ev.t_s}")
            return
        victim = servers[name]
        if ev.action == LEADER_KILL:
            t0 = time.monotonic()
            victim.sup.kill()
            survivor = servers["b" if name == "a" else "a"]
            ep_after, deadline = 0, time.monotonic() + READY_BOUND_S
            while time.monotonic() < deadline:
                f = _fed(survivor)
                if f.get("epoch", 0) > ep_before and f.get("last_handoff"):
                    ep_after = f["epoch"]
                    break
                if stop_evt.wait(0.05):
                    break
            mttr_ms = (time.monotonic() - t0) * 1e3
            if not ep_after:
                violations.append(
                    f"no takeover within {READY_BOUND_S}s after "
                    f"killing leader {name} (epoch {ep_before})")
            transitions.append(
                {"action": LEADER_KILL, "victim": name,
                 "epoch_before": ep_before, "epoch_after": ep_after,
                 "mttr_ms": round(mttr_ms, 1)})
            # the victim rejoins as a standby over the same store dir
            try:
                victim.ensure_alive(READY_BOUND_S)
            except Exception as e:
                violations.append(f"killed leader {name} failed to "
                                  f"rejoin as standby: {e}")
        elif ev.action == LEADER_PARTITION:
            proc = getattr(victim.sup, "_proc", None)
            if proc is None or proc.poll() is not None:
                return
            os.kill(proc.pid, signal.SIGSTOP)
            frozen_pids.append(proc.pid)
            try:
                stop_evt.wait(ev.down_s)
            finally:
                try:
                    os.kill(proc.pid, signal.SIGCONT)
                except OSError:
                    pass
                frozen_pids.remove(proc.pid)
            # the flock is still held through the freeze: this must be
            # a survivable stall, not a takeover. Give the thawed
            # process a beat to answer /debug again.
            f, deadline = {}, time.monotonic() + 10.0
            while not f and time.monotonic() < deadline:
                f = _fed(victim)
                if not f and stop_evt.wait(0.1):
                    break
            transitions.append(
                {"action": LEADER_PARTITION, "victim": name,
                 "down_s": round(ev.down_s, 3),
                 "epoch_before": ep_before,
                 "epoch_after": f.get("epoch", 0)})
            if f.get("epoch", 0) > ep_before:
                violations.append(
                    f"partitioned (frozen) leader {name} was deposed: "
                    f"epoch {ep_before} -> {f['epoch']}; SIGSTOP must "
                    f"not lose the flock")

    def churn_worker(t0):
        # sequential on purpose: leader events are min_gap-spaced and
        # each one must settle before the next resolves "the leader"
        for ev in schedule.events:
            if stop_evt.wait(max(0.0, ev.t_s - (time.time() - t0))):
                return
            _do_leader_event(ev)

    daemons: list[AgentDaemon] = []
    jobs_final: dict = {}
    stale_fence: dict = {}
    try:
        servers["a"].start()
        servers["b"].start()
        name0, ep0 = _wait_leader()
        if name0 is None:
            violations.append("no initial leader elected")
        for i in range(agents):
            d = make_daemon(f"{tag}-a{i}")
            d.start()
            daemons.append(d)

        # pre-wave: one job must be RUNNING under the initial epoch
        # before any leader fault fires — with the post-wave below this
        # pins instances on BOTH sides of every takeover, making the
        # "ep stamps span leader generations" gate deterministic
        submit_with_retry("prewave")
        pre_u = uuids[-1][0]
        deadline = time.monotonic() + READY_BOUND_S
        while time.monotonic() < deadline:
            try:
                js = clients["prewave"].query_jobs([pre_u])
                if js and js[0].instances:
                    break
            except Exception:
                pass
            time.sleep(0.1)
        else:
            violations.append("pre-wave job never got an instance")

        t0 = time.time()
        churn_t = None
        if schedule is not None:
            churn_t = threading.Thread(target=churn_worker, args=(t0,),
                                       daemon=True)
            churn_t.start()

        # traffic throughout the churn window, then a post-wave that
        # pins instances under the final epoch
        trace = generate_trace(n_jobs=jobs, n_users=3, seed=seed,
                               submit_window_ms=int(window_s * 1e3))
        for t in sorted(trace, key=lambda t: t["submit-time-ms"]):
            delay = t["submit-time-ms"] / 1e3
            now = time.time() - t0
            if delay > now:
                time.sleep(delay - now)
            submit_with_retry(t["job/user"], t["job/priority"])
        if churn_t is not None:
            churn_t.join(timeout=wall_s / 2)
            if churn_t.is_alive():
                violations.append("churn schedule did not finish")
        for i in range(post_jobs):
            submit_with_retry("postwave")

        def poll():
            by_user: dict[str, list] = {}
            for u, user in uuids:
                by_user.setdefault(user, []).append(u)
            out = {}
            for user, us in by_user.items():
                for j in clients[user].query_jobs(us):
                    out[j.uuid] = j
            return out

        deadline = time.time() + wall_s
        while time.time() < deadline:
            try:
                jobs_final = poll()
            except Exception:
                time.sleep(0.4)
                continue
            if len(jobs_final) == len(uuids) and all(
                    j.status == "completed"
                    for j in jobs_final.values()):
                break
            time.sleep(0.4)

        # ---- the split-brain proof: a deposed leader's next append ----
        ledger = _read_epoch_ledger(shared_log + ".epoch")
        epochs = [r.get("epoch", 0) for r in ledger]
        if len(epochs) >= 2:
            stale = epochs[0]
            from cook_tpu_torch.obs.metrics import registry as metrics
            ctr = metrics.counter("stale_epoch_writes_rejected_total")
            before = ctr.value
            # replay the shared log WITHOUT a writer: this handle is
            # the deposed leader's view and must never touch the live
            # leader's file (no trim, no append)
            h = JobStore.restore(None, log_path=shared_log,
                                 trim_tail=False, open_writer=False)
            h.epoch = stale
            rejected = False
            try:
                h.create_jobs([Job(uuid=new_uuid(), user="fence-probe",
                                   command="true", mem=1.0, cpus=0.1)])
            except StaleEpochError:
                rejected = True
            except Exception as e:
                violations.append(
                    f"stale-epoch probe died unexpectedly: {e!r}")
            stale_fence = {"attempt_epoch": stale,
                           "ledger_max": max(epochs),
                           "rejected": rejected,
                           "counter_delta": ctr.value - before}
            if not rejected:
                violations.append(
                    f"stale-epoch write at epoch {stale} was ACCEPTED "
                    f"with ledger at {max(epochs)} — fence breached")

        stop_evt.set()
        inst_events = _scan_inst_events(shared_log)
        evidence = {
            "seed": seed,
            "tag": tag,
            "violations": violations,
            "jobs": jobs_final,
            "expected_jobs": len(uuids),
            "launch_counts": dict(launch_counts),
            "transitions": transitions,
            "epochs": epochs,
            "epoch_ledger": ledger,
            "stale_fence": stale_fence,
            "inst_tasks": [
                {"task": e.get("task"), "ep": e.get("ep", 0)}
                for e in inst_events],
            "churn_events": ([e.as_dict() for e in schedule.events]
                             if schedule else []),
            "server_deaths": {n: len(s.sup.deaths)
                              for n, s in servers.items()},
            "kill_ledgers": {n: s.kills()
                             for n, s in servers.items()},
        }
        _dump_artifacts(tag, servers, schedule, shared_log, evidence)
        return evidence
    finally:
        stop_evt.set()
        for pid in list(frozen_pids):
            try:
                os.kill(pid, signal.SIGCONT)
            except OSError:
                pass
        for d in daemons:
            try:
                d.stop()
            except Exception:
                pass
        for s in servers.values():
            try:
                s.stop()
            except Exception:
                pass


def _settled_health(url, n_groups, timeout_s=20.0):
    """GET /federation/health (auth-bypassed) until the rollup settles
    at every group healthy with zero stale folds, or the timeout
    passes; returns the last rollup either way — the caller's gate
    decides."""
    import urllib.request
    deadline = time.time() + timeout_s
    body = {}
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url + "/federation/health",
                                        timeout=10.0) as r:
                body = json.loads(r.read().decode())
        except Exception as e:
            body = {"error": repr(e)}
            time.sleep(0.5)
            continue
        fleet = body.get("fleet", {})
        stale = [g for g, e in body.get("groups", {}).items()
                 if any(x.get("stale")
                        for x in (e.get("exchange") or {}).values())]
        if fleet.get("healthy") == n_groups and \
                fleet.get("unreachable", 1) == 0 and not stale:
            return body
        time.sleep(0.5)
    return body


def _admin_post(url, path, body, timeout_s=15.0):
    """Admin-channel POST (header auth, user=admin). Returns
    (status, parsed body); HTTP errors come back as their status +
    body instead of raising, so callers can assert on 409/503."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "X-Cook-User": "admin"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.getcode(), json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode())
        except Exception:
            return e.code, {}


def run_fleet_soak(store_root, seed, tag=None, groups=3,
                   jobs_per_group=6, agents_per_group=1, window_s=6.0,
                   wall_s=120.0, group_kill=True, migrate=True,
                   migrate_burst=4):
    """One compressed fleet day: N single-leader groups, each with its
    own durable store dir and its own agent(s), federated by config —
    every member's federation block names every group, so misrouted
    submissions 503-hint to the owner and the fleet client follows.

    Faults exercised (both optional):
      - ``group_kill``: SIGKILL one group's leader mid-traffic; the
        supervisor respawns it over its own store dir and the harness
        measures kill -> epoch-advanced-and-serving as that group's
        MTTR (no standby — a fleet group's availability story is
        restart-from-durable-state; the HA-pair soak covers standby
        takeover).
      - ``migrate``: burst-submit into one group's pool, then drive the
        live migration admin route to hand the pool (pending jobs
        included) to another group. Evidence pins the 503 ownership
        hint BEFORE (source serves) and AFTER (source redirects to the
        destination), and the burst uuids ride the shared completeness
        + at-most-once gates.

    Returns an evidence dict; asserts nothing (tests/test_fleet.py and
    the CI fleet-smoke job own the gates)."""
    from tests.torch_livestack import free_port
    tag = tag or f"fleet{seed}"
    violations: list[str] = []
    launch_counts: dict[str, int] = {}
    gnames = [f"g{i}" for i in range(groups)]
    pools = {g: f"pool-{g}" for g in gnames}
    ports = {g: free_port() for g in gnames}
    urls = {g: f"http://127.0.0.1:{ports[g]}" for g in gnames}
    fleet_urls = ",".join(urls.values())
    fed_groups = {g: {"pools": [pools[g]], "url": urls[g]}
                  for g in gnames}
    all_pools = [{"name": p} for p in pools.values()]

    servers: dict[str, LiveServer] = {}
    for g in gnames:
        overrides = {
            "default_pool": pools[g],
            "pools": all_pools,   # every pool known everywhere: a
            # misrouted submission must 503-hint, not 400
            "auth": {"admins": ["admin"]},
            "federation": {"group": g, "groups": fed_groups,
                           "exchange_interval_s": 0.5,
                           "global_quota_staleness_s": 5.0},
        }
        servers[g] = LiveServer(os.path.join(str(store_root), g),
                                name=g, port=ports[g], seed=seed,
                                max_kills=0, overrides=overrides)

    def _fed(srv):
        try:
            return srv.debug().get("federation", {})
        except Exception:
            return {}

    def _wait_group(g, min_epoch=1, timeout_s=READY_BOUND_S):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ep = _fed(servers[g]).get("epoch", 0)
            if ep >= min_epoch:
                return ep
            time.sleep(0.05)
        return 0

    def make_daemon(g, host, pool=None):
        # offers are pool-keyed (backends/agent.pending_offers filters
        # on the agent's registered pool), so each daemon carries its
        # group's pool — and a migration must bring capacity to the
        # destination, hence the extra migrated-pool daemon below
        d = AgentDaemon(urls[g], hostname=host, mem=4096.0, cpus=8.0,
                        pool=pool or pools[g],
                        sandbox_root=os.path.join(
                            str(store_root), g, f"sbx-{host}",
                            str(time.monotonic_ns())),
                        heartbeat_interval_s=0.4,
                        agent_token=LiveServer.AGENT_TOKEN)
        orig = d.executor.launch

        def counted(task_id, *a, _orig=orig, **kw):
            launch_counts[task_id] = launch_counts.get(task_id, 0) + 1
            return _orig(task_id, *a, **kw)

        d.executor.launch = counted
        return d

    # ONE fleet client per user, given every member's URL: misrouted
    # submissions follow the federation ownership hint to the owner.
    # Dedup probes and the completeness poll instead ask each group
    # DIRECTLY (admin clients): stores are disjoint here — unlike the
    # HA pair — so "did it land" means "does ANY group have it", and a
    # non-owner legitimately 404s.
    clients: dict[str, JobClient] = {}
    admin_clients = {g: JobClient(urls[g], user="admin", timeout=5.0)
                     for g in gnames}
    uuids: list[tuple] = []

    def _find_job(u):
        for g in gnames:
            try:
                got = admin_clients[g].query_jobs([u])
            except Exception:   # 404 here = this group doesn't own it
                continue
            if got:
                return got[0]
        return None

    def submit_with_retry(user, pool, priority=50):
        cli = clients.setdefault(
            user, JobClient(fleet_urls, user=user, timeout=5.0))
        u = str(uuidlib.uuid4())
        for _ in range(SUBMIT_RETRIES):
            try:
                cli.submit(command="sleep 0.3", mem=64.0, cpus=1.0,
                           uuid=u, pool=pool, priority=priority,
                           max_retries=4)
                break
            except Exception:
                if _find_job(u) is not None:
                    break   # landed before the response was lost
                time.sleep(0.5)
        else:
            violations.append(f"submit of {u} (pool {pool}) never "
                              "landed")
        uuids.append((u, user, pool))

    daemons: list[AgentDaemon] = []
    transitions: list[dict] = []
    migration: dict = {}
    jobs_final: dict = {}
    try:
        for g in gnames:
            servers[g].start()
        for g in gnames:
            if not _wait_group(g):
                violations.append(f"group {g} never minted an epoch")
        for g in gnames:
            for i in range(agents_per_group):
                d = make_daemon(g, f"{tag}-{g}-a{i}")
                d.start()
                daemons.append(d)

        # traffic: every group carries its own pool's jobs, submitted
        # through the fleet client (ownership hints exercised when the
        # client's first URL is a non-owner)
        t0 = time.time()
        trace = generate_trace(n_jobs=jobs_per_group * groups,
                               n_users=3, seed=seed,
                               submit_window_ms=int(window_s * 1e3))
        kill_at = window_s * 0.4 if group_kill else None
        victim = gnames[-1] if group_kill else None
        for i, t in enumerate(sorted(trace,
                                     key=lambda t: t["submit-time-ms"])):
            delay = t["submit-time-ms"] / 1e3
            now = time.time() - t0
            if delay > now:
                time.sleep(delay - now)
            if kill_at is not None and time.time() - t0 >= kill_at:
                # ---- group-kill: restart-from-durable-state MTTR ----
                ep_before = _fed(servers[victim]).get("epoch", 0)
                tk = time.monotonic()
                servers[victim].sup.kill()
                # SIGKILL delivery is async: wait for the reap so
                # ensure_alive sees a dead child and actually respawns
                dd = time.monotonic() + 5.0
                while servers[victim].sup.alive() and \
                        time.monotonic() < dd:
                    time.sleep(0.02)
                try:
                    servers[victim].ensure_alive(READY_BOUND_S)
                except Exception as e:
                    violations.append(
                        f"killed group {victim} failed to respawn: {e}")
                ep_after = _wait_group(victim, ep_before + 1)
                mttr_ms = (time.monotonic() - tk) * 1e3
                if not ep_after:
                    violations.append(
                        f"group {victim} did not re-mint past epoch "
                        f"{ep_before} within {READY_BOUND_S}s")
                transitions.append(
                    {"action": "group_kill", "victim": victim,
                     "epoch_before": ep_before,
                     "epoch_after": ep_after,
                     "mttr_ms": round(mttr_ms, 1)})
                kill_at = None
            pool = pools[gnames[i % groups]]
            submit_with_retry(t["job/user"], pool, t["job/priority"])

        if migrate and groups >= 2:
            # ---- live pool migration under traffic ----
            src, dst = gnames[0], gnames[1]
            mpool = pools[src]
            for _ in range(migrate_burst):
                submit_with_retry("migrator", mpool)
            burst = [u for u, user, p in uuids if user == "migrator"]
            hint_before = _admin_post(
                urls[src], "/jobs",
                {"jobs": [{"uuid": str(uuidlib.uuid4()),
                           "command": "true", "mem": 1.0, "cpus": 0.1}],
                 "pool": mpool})
            # 409 (RUNNING jobs) is expected while the burst drains:
            # retry until the guard admits the handoff
            status, resp = 0, {}
            deadline = time.monotonic() + READY_BOUND_S
            while time.monotonic() < deadline:
                status, resp = _admin_post(
                    urls[src], "/federation/migrate",
                    {"pool": mpool, "to": dst})
                if status != 409:
                    break
                time.sleep(0.3)
            if status != 200:
                violations.append(
                    f"migration of {mpool} {src}->{dst} failed: "
                    f"{status} {resp}")
            # ownership hint must now flip to the destination
            status_h, resp_h = _admin_post(
                urls[src], "/jobs",
                {"jobs": [{"uuid": str(uuidlib.uuid4()),
                           "command": "true", "mem": 1.0, "cpus": 0.1}],
                 "pool": mpool})
            migration = {
                "pool": mpool, "from": src, "to": dst,
                "result": {"status": status, **(resp or {})},
                "burst_uuids": burst,
                "hint_before": {"status": hint_before[0],
                                "leader": (hint_before[1] or {}).get(
                                    "leader")},
                "hint_after": {"status": status_h,
                               "leader": (resp_h or {}).get("leader")},
                "expected_owner_url": urls[dst],
            }
            if status == 200:
                if status_h != 503 or \
                        resp_h.get("leader") != urls[dst]:
                    violations.append(
                        f"post-migration ownership hint did not flip "
                        f"to {urls[dst]}: {status_h} {resp_h}")
                # the pool's capacity moves with it: the destination
                # gets an agent registered in the migrated pool
                d = make_daemon(dst, f"{tag}-{dst}-migrated",
                                pool=mpool)
                d.start()
                daemons.append(d)
                # a few more submissions must follow the new hint and
                # land at the destination
                for _ in range(2):
                    submit_with_retry("postmigrate", mpool)

        # ---- completeness: every submission completes SOMEWHERE ----
        # (after a migration "somewhere" is a different group than the
        # one that acked the submit — exactly the zero-lost property)
        deadline = time.time() + wall_s
        while time.time() < deadline:
            done = {}
            for u, _user, _pool in uuids:
                j = _find_job(u)
                if j is not None:
                    done[u] = j
            jobs_final = done
            if len(done) == len(uuids) and all(
                    j.status == "completed" for j in done.values()):
                break
            time.sleep(0.5)

        # per-group durable evidence
        epoch_ledgers = {}
        inst_tasks = []
        for g in gnames:
            glog = os.path.join(str(store_root), g, "events.log")
            epoch_ledgers[g] = [
                r.get("epoch", 0) for r in
                _read_epoch_ledger(glog + ".epoch")]
            for e in _scan_inst_events(glog):
                inst_tasks.append({"group": g, "task": e.get("task"),
                                   "ep": e.get("ep", 0)})
        stale_info = {g: _fed(servers[g]).get("exchange", {})
                      for g in gnames}
        # federated health rollup: at soak end (kills recovered,
        # migration settled) every group must be reachable again and
        # no exchange fold left flagged stale — retried briefly so a
        # just-restarted group's first fold has time to land
        health = _settled_health(urls[gnames[0]], len(gnames))
        evidence = {
            "seed": seed,
            "tag": tag,
            "groups": gnames,
            "pools": pools,
            "urls": urls,
            "violations": violations,
            "jobs": jobs_final,
            "expected_jobs": len(uuids),
            "launch_counts": dict(launch_counts),
            "transitions": transitions,
            "migration": migration,
            "epoch_ledgers": epoch_ledgers,
            "inst_tasks": inst_tasks,
            "exchange": stale_info,
            "health": health,
            "server_deaths": {g: len(s.sup.deaths)
                              for g, s in servers.items()},
        }
        _dump_fleet_artifacts(tag, servers, evidence)
        return evidence
    finally:
        for d in daemons:
            try:
                d.stop()
            except Exception:
                pass
        for s in servers.values():
            try:
                s.stop()
            except Exception:
                pass


def run_reconfig_soak(store_root, seed, tag=None, groups=3,
                      jobs_per_wave=2, window_s=12.0, wall_s=120.0,
                      joins=1, leaves=1, kill_mid_reload=False,
                      kill_mid_drain=False, leave_hot=False,
                      stop_departing=False, hot_burst=3):
    """Live-reconfiguration soak: the fleet's TOPOLOGY changes while
    traffic flows. A seeded ``generate_membership_churn`` schedule is
    executed against a real N-group fleet (one LiveServer per group,
    disjoint stores, ``g0`` is the fixed reload coordinator):

      - ``member_join``: a new group boots with the full TARGET view
        in its config, then one ``POST /federation/reload`` at the
        coordinator announces it fleet-wide (propagate). Jobs are then
        submitted into its pool through the fleet client.
      - ``member_leave[_hot]``: the target view drops a group; the
        coordinator drains every pool it owns through the ordinary
        migrate protocol into a target-spec claim on a survivor (an
        agent for the moving pool is registered at the destination
        first — capacity travels ahead of the handoff). ``_hot``
        burst-submits into the departing pool right before the reload
        so the drain's 409/retry window is exercised for real. Once
        every survivor's membership view converges the departed server
        is stopped — retirement — after its terminal job statuses are
        snapshotted (completed history legitimately stays in the
        departed store; the zero-lost gate folds the snapshot in).
      - ``member_join_kill`` / ``member_leave_kill``: the coordinator
        is armed (``store.membership`` / ``fed.reload_drain`` kill
        points) and SIGKILLs itself mid-reload / mid-retire-drain; the
        supervisor respawns it and boot replay + resume finish the
        journaled change — the harness only waits for convergence.
      - ``member_leave_stop``: the DEPARTING group is SIGSTOP-frozen
        for ``down_s`` right before the reload, so the coordinator's
        drain has to wait the freeze out (409/connect stalls retried).

    Collects evidence, asserts nothing (tests/test_reconfig.py and the
    CI fleet-smoke job own the gates)."""
    from tests.torch_livestack import free_port
    tag = tag or f"reconfig{seed}"
    violations: list[str] = []
    launch_counts: dict[str, int] = {}
    transitions: list[dict] = []
    departed_statuses: dict[str, str] = {}
    schedule = generate_membership_churn(
        seed, duration_s=window_s, joins=joins, leaves=leaves,
        kill_mid_reload=kill_mid_reload, kill_mid_drain=kill_mid_drain,
        leave_hot=leave_hot, stop_departing=stop_departing)

    gnames = [f"g{i}" for i in range(groups)]
    jnames = [f"j{i}" for i in range(joins)]
    pools = {g: f"pool-{g}" for g in gnames + jnames}
    ports = {g: free_port() for g in gnames + jnames}
    urls = {g: f"http://127.0.0.1:{ports[g]}" for g in gnames + jnames}
    # every pool (join slots included) known everywhere from boot: a
    # pool adopted mid-soak must 503-hint at non-owners, not 400
    all_pools = [{"name": p} for p in pools.values()]
    view = {g: {"pools": [pools[g]], "url": urls[g]} for g in gnames}
    coord = gnames[0]     # fixed coordinator; never departs
    sites = {}
    if kill_mid_reload:
        sites["store.membership"] = 1.0
    if kill_mid_drain:
        sites["fed.reload_drain"] = 1.0

    def _mk_server(g, groups_view, armed=False):
        overrides = {
            "default_pool": pools[g],
            "pools": all_pools,
            "auth": {"admins": ["admin"]},
            "federation": {"group": g, "groups": groups_view,
                           "exchange_interval_s": 0.5,
                           "global_quota_staleness_s": 5.0},
        }
        return LiveServer(os.path.join(str(store_root), g), name=g,
                          port=ports[g], seed=seed,
                          sites=sites if armed else None,
                          max_kills=(len(sites) if armed else 0),
                          overrides=overrides)

    servers: dict[str, LiveServer] = {
        g: _mk_server(g, view, armed=(g == coord)) for g in gnames}
    live: list[str] = list(gnames)

    def _fed(g):
        try:
            return servers[g].debug().get("federation", {})
        except Exception:
            return {}

    def _wait_epoch(g, min_epoch=1, timeout_s=READY_BOUND_S):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if _fed(g).get("epoch", 0) >= min_epoch:
                return True
            time.sleep(0.05)
        return False

    def _wait_converged(target, skip_epoch=(), timeout_s=READY_BOUND_S):
        """Every live group's membership view must settle at the
        target's group SET (membership epochs are per-group ledgers —
        each member journals its own apply — so the set, not the
        number, is the convergence object). ``skip_epoch`` exempts
        groups whose view legitimately never changed (a joiner boots
        with the target view already, so the propagated reload no-ops
        there) from the journaled-epoch requirement."""
        want = set(target)
        deadline = time.monotonic() + timeout_s
        views = {}
        while time.monotonic() < deadline:
            views = {g: (_fed(g).get("membership") or {})
                     for g in live}
            if all(set(v.get("groups") or {}) == want and
                   (g in skip_epoch or v.get("epoch", 0) >= 1)
                   for g, v in views.items()):
                return True, views
            time.sleep(0.2)
        return False, views

    daemons: list[AgentDaemon] = []

    def make_daemon(g, host, pool=None):
        d = AgentDaemon(urls[g], hostname=host, mem=4096.0, cpus=8.0,
                        pool=pool or pools[g],
                        sandbox_root=os.path.join(
                            str(store_root), g, f"sbx-{host}",
                            str(time.monotonic_ns())),
                        heartbeat_interval_s=0.4,
                        agent_token=LiveServer.AGENT_TOKEN)
        orig = d.executor.launch

        def counted(task_id, *a, _orig=orig, **kw):
            launch_counts[task_id] = launch_counts.get(task_id, 0) + 1
            return _orig(task_id, *a, **kw)

        d.executor.launch = counted
        d.start()
        daemons.append(d)
        return d

    clients: dict[str, JobClient] = {}
    admin_clients = {g: JobClient(urls[g], user="admin", timeout=5.0)
                     for g in gnames + jnames}
    uuids: list[tuple] = []

    def _find_job(u):
        for g in live:
            try:
                got = admin_clients[g].query_jobs([u])
            except Exception:
                continue
            if got:
                return got[0]
        return None

    def submit_with_retry(user, pool):
        cli = clients.setdefault(user, JobClient(
            ",".join(urls[g] for g in live), user=user, timeout=5.0))
        u = str(uuidlib.uuid4())
        for _ in range(SUBMIT_RETRIES):
            try:
                cli.submit(command="sleep 0.3", mem=64.0, cpus=1.0,
                           uuid=u, pool=pool, max_retries=4)
                break
            except Exception:
                if _find_job(u) is not None:
                    break
                time.sleep(0.5)
        else:
            violations.append(f"submit of {u} (pool {pool}) never "
                              "landed")
        uuids.append((u, user, pool))

    def _wave(note):
        # traffic flows across every membership change: one job per
        # live pool, routed through the fleet client (post-change
        # clients are rebuilt so the URL set tracks the live view)
        clients.clear()
        for g in list(live):
            submit_with_retry(f"wave-{note}", pools[g])

    def _reload(target, expect_kill=False):
        """POST the target view at the coordinator; on an armed kill
        the socket dies mid-request — respawn the coordinator and let
        boot replay + resume finish the journaled change."""
        status, resp = 0, {}
        try:
            status, resp = _admin_post(
                urls[coord], "/federation/reload",
                {"federation": {"groups": target}, "propagate": True},
                timeout_s=60.0)
        except Exception as e:
            resp = {"error": repr(e)}
        if expect_kill:
            dd = time.monotonic() + 5.0
            while servers[coord].sup.alive() and time.monotonic() < dd:
                time.sleep(0.02)
            if servers[coord].sup.alive():
                violations.append(
                    "armed coordinator survived the reload kill point")
            try:
                servers[coord].ensure_alive(READY_BOUND_S)
            except Exception as e:
                violations.append(
                    f"killed coordinator failed to respawn: {e}")
        elif status != 200:
            violations.append(
                f"reload to {sorted(target)} failed: {status} {resp}")
        return status, resp

    def do_join(ev, slot):
        g = jnames[slot]
        target = {**{k: dict(v) for k, v in view.items()},
                  g: {"pools": [pools[g]], "url": urls[g]}}
        servers[g] = _mk_server(g, target)
        servers[g].start()
        if not _wait_epoch(g):
            violations.append(f"joining group {g} never minted")
        make_daemon(g, f"{tag}-{g}-a0")
        status, resp = _reload(
            target, expect_kill=(ev.action == MEMBER_JOIN_KILL))
        live.append(g)
        view.clear()
        view.update(target)
        ok, views = _wait_converged(target, skip_epoch={g})
        if not ok:
            violations.append(
                f"fleet never converged on join of {g}: "
                f"{ {k: sorted(v.get('groups') or {}) for k, v in views.items()} }")
        _wave(f"join-{g}")
        transitions.append({"action": ev.action, "group": g,
                            "status": status,
                            "resp": {k: v for k, v in (resp or {}).items()
                                     if k != "propagated"},
                            "converged": ok,
                            "deaths": len(servers[coord].sup.deaths)})

    def do_leave(ev):
        # newest non-coordinator member departs (shrink undoes growth)
        g = next(x for x in reversed(live) if x != coord)
        dest = next(x for x in live if x != g and x != coord) \
            if len(live) > 2 else coord
        target = {k: dict(v) for k, v in view.items() if k != g}
        # target-spec claim: the departing pool is assigned to a named
        # survivor, and capacity is registered there BEFORE the drain
        target[dest]["pools"] = sorted(
            set(target[dest].get("pools") or []) | {pools[g]})
        make_daemon(dest, f"{tag}-{dest}-adopt-{g}", pool=pools[g])
        if ev.action == MEMBER_LEAVE_HOT:
            for _ in range(hot_burst):
                submit_with_retry("hot", pools[g])
        frozen_pid = None
        if ev.action == MEMBER_LEAVE_STOP:
            frozen_pid = servers[g].sup._proc.pid
            os.kill(frozen_pid, signal.SIGSTOP)
            threading.Timer(max(ev.down_s, 0.2), os.kill,
                            args=(frozen_pid, signal.SIGCONT)).start()
        status, resp = _reload(
            target, expect_kill=(ev.action == MEMBER_LEAVE_KILL))
        view.clear()
        view.update({k: dict(v) for k, v in target.items()})
        ok, views = _wait_converged(target,
                                    timeout_s=READY_BOUND_S * 2)
        if not ok:
            violations.append(
                f"fleet never converged on leave of {g}: "
                f"{ {k: sorted(v.get('groups') or {}) for k, v in views.items()} }")
        # retire: completed history stays in the departed store — take
        # its terminal snapshot before stopping it so the zero-lost
        # gate can account for jobs that finished there pre-drain
        if frozen_pid is not None:
            try:
                os.kill(frozen_pid, signal.SIGCONT)
            except OSError:
                pass
        pool_uuids = [u for u, _, p in uuids if p == pools[g]]
        snap: dict = {}
        deadline = time.monotonic() + READY_BOUND_S
        while pool_uuids and time.monotonic() < deadline:
            try:
                got = admin_clients[g].query_jobs(pool_uuids)
            except Exception:
                got = []
            snap = {j.uuid: j.status for j in got}
            # a uuid ABSENT here was exported by the drain and will be
            # found live at the destination — only jobs that stayed
            # must have reached terminal state before retirement
            if all(snap.get(u, "completed") == "completed"
                   for u in pool_uuids):
                break
            time.sleep(0.3)
        departed_statuses.update(
            {u: s for u, s in snap.items() if s == "completed"})
        live.remove(g)
        servers[g].stop()
        _wave(f"leave-{g}")
        transitions.append({"action": ev.action, "group": g,
                            "dest": dest, "status": status,
                            "resp": {k: v for k, v in (resp or {}).items()
                                     if k != "propagated"},
                            "converged": ok, "snapshot": len(snap),
                            "deaths": len(servers[coord].sup.deaths)})

    jobs_final: dict = {}
    try:
        for g in gnames:
            servers[g].start()
        for g in gnames:
            if not _wait_epoch(g):
                violations.append(f"group {g} never minted an epoch")
            make_daemon(g, f"{tag}-{g}-a0")
        _wave("boot")
        join_slot = 0
        for ev in schedule.events:
            time.sleep(0.5)   # settle gap (schedule t_s is the
            # ordering artifact; the soak compresses the clock)
            if ev.action in (MEMBER_JOIN, MEMBER_JOIN_KILL):
                do_join(ev, join_slot)
                join_slot += 1
            else:
                do_leave(ev)
        _wave("final")

        # ---- completeness: every submission completes SOMEWHERE ----
        # (a live group, or — terminal-snapshotted — a retired one)
        deadline = time.time() + wall_s
        while time.time() < deadline:
            done = {}
            for u, _user, _pool in uuids:
                if departed_statuses.get(u) == "completed":
                    done[u] = "completed"
                    continue
                j = _find_job(u)
                if j is not None:
                    done[u] = j.status
            jobs_final = done
            if len(done) == len(uuids) and all(
                    s == "completed" for s in done.values()):
                break
            time.sleep(0.5)

        epoch_ledgers, membership_ledgers, inst_tasks = {}, {}, []
        for g in gnames + jnames[:join_slot]:
            glog = os.path.join(str(store_root), g, "events.log")
            epoch_ledgers[g] = [r.get("epoch", 0) for r in
                                _read_epoch_ledger(glog + ".epoch")]
            membership_ledgers[g] = _read_membership_ledger(
                glog + ".membership")
            for e in _scan_inst_events(glog):
                inst_tasks.append({"group": g, "task": e.get("task"),
                                   "ep": e.get("ep", 0)})
        health = _settled_health(urls[live[0]], len(live))
        mviews = {g: (_fed(g).get("membership") or {}) for g in live}
        evidence = {
            "seed": seed,
            "tag": tag,
            "schedule": [e.as_dict() for e in schedule.events],
            "groups": list(gnames), "joined": jnames[:join_slot],
            "live": list(live), "pools": pools, "urls": urls,
            "violations": violations,
            "jobs": jobs_final,
            "expected_jobs": len(uuids),
            "departed_statuses": departed_statuses,
            "launch_counts": dict(launch_counts),
            "transitions": transitions,
            "epoch_ledgers": epoch_ledgers,
            "membership_ledgers": membership_ledgers,
            "membership_views": mviews,
            "inst_tasks": inst_tasks,
            "health": health,
            "server_deaths": {g: len(s.sup.deaths)
                              for g, s in servers.items()},
        }
        _dump_fleet_artifacts(tag, servers, evidence,
                              prefix="reconfig", schedule=schedule)
        return evidence
    finally:
        for d in daemons:
            try:
                d.stop()
            except Exception:
                pass
        for s in servers.values():
            try:
                s.stop()
            except Exception:
                pass


def _dump_fleet_artifacts(tag, servers, evidence, prefix="fleet",
                          schedule=None):
    out = os.environ.get("CHAOS_ARTIFACTS_DIR")
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    if schedule is not None:
        schedule.save(os.path.join(out, f"{prefix}-{tag}-churn.jsonl"))
    for name, s in servers.items():
        if os.path.exists(s.server_log):
            shutil.copy(s.server_log,
                        os.path.join(out, f"{prefix}-{tag}-server-{name}.log"))
        for suffix, kind in ((".epoch", "epoch"),
                             (".membership", "membership")):
            led = os.path.join(s.store_dir, "events.log" + suffix)
            if os.path.exists(led):
                shutil.copy(led, os.path.join(
                    out, f"{prefix}-{tag}-{kind}-{name}.jsonl"))
    slim = {k: v for k, v in evidence.items() if k != "jobs"}
    slim["job_statuses"] = {
        u: (j if isinstance(j, str) else j.status)
        for u, j in evidence["jobs"].items()}
    with open(os.path.join(out, f"{prefix}-{tag}-evidence.json"),
              "w") as f:
        json.dump(slim, f, indent=1)


def _dump_artifacts(tag, servers, schedule, shared_log, evidence):
    out = os.environ.get("CHAOS_ARTIFACTS_DIR")
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    if schedule is not None:
        schedule.save(os.path.join(out, f"fed-{tag}-churn.jsonl"))
    for name, s in servers.items():
        for src, dst in ((s.server_log, f"fed-{tag}-server-{name}.log"),
                         (s.budget_file, f"fed-{tag}-kills-{name}.jsonl")):
            if os.path.exists(src):
                shutil.copy(src, os.path.join(out, dst))
    if os.path.exists(shared_log + ".epoch"):
        shutil.copy(shared_log + ".epoch",
                    os.path.join(out, f"fed-{tag}-epoch-ledger.jsonl"))
    slim = {k: v for k, v in evidence.items() if k != "jobs"}
    slim["job_statuses"] = {u: j.status
                           for u, j in evidence["jobs"].items()}
    with open(os.path.join(out, f"fed-{tag}-evidence.json"), "w") as f:
        json.dump(slim, f, indent=1)
