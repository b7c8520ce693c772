"""Compressed production-day soak harness: every failure layer armed
at once.

The earlier soak tiers each prove one layer in isolation —
test_chaos_soak.py perturbs transport RPCs, test_crash_soak.py SIGKILLs
the coordinator process. A production day delivers all of it together,
plus the one thing neither tier exercises: the FLEET churns. Agents are
killed, bounced by their supervisor, crash-looped, and partitioned
while the coordinator is itself being killed and every RPC is lossy.

This module runs that day at compressed timescale:

  - traffic: ``sim.generate_trace(diurnal=True)`` — two workday bursts
    scaled from 24 h down to ``window_s`` seconds;
  - transport chaos: the ``cook_tpu_torch.chaos`` controller armed in the
    AGENT process (this one) over the agent.* RPC sites;
  - process chaos: ``chaos.procfault`` SIGKILLs the real coordinator
    subprocess (the port's server, on the device it is given) at seeded
    store/cycle kill points (tests.torch_livestack);
  - fleet churn: a ``chaos.churn`` schedule executed against live
    AgentDaemon threads — kill / restart / flap / partition — driving
    the lease-based liveness machine (suspect -> dead -> grace ->
    mea-culpa requeue; resurrect -> census -> adopt).

Everything is a pure function of one seed, and every input schedule is
written to $CHAOS_ARTIFACTS_DIR so a red run ships its replay.

The harness COLLECTS evidence; the caller
(tests/test_torch_day_soak.py, chip_smoke.py, or ``bench_torch.py
day-soak`` for the full-magnitude run on the card) asserts the gates:
zero lost jobs, at-most-once launch per task_id across every agent
incarnation, monotone instance history across coordinator restarts,
bounded server RSS, bounded front-door p99.
"""
import json
import os
import shutil
import threading
import time
import uuid as uuidlib

from cook_tpu_torch import chaos
from cook_tpu_torch.agent.daemon import AgentDaemon
from cook_tpu_torch.chaos.churn import (FLAP, KILL, PARTITION, RESTART,
                                  generate_churn)
from cook_tpu_torch.sim.gen import generate_trace
from tests.torch_livestack import LiveServer, incarnations

TERMINAL = ("success", "failed")
READY_BOUND_S = 20.0

# transport faults on the agent<->coordinator RPCs (agent-process side)
TRANSPORT_SITES = {
    "agent.register": {"drop": 0.05},
    "agent.heartbeat": {"drop": 0.05},
    "agent.status_post": {"drop": 0.10, "duplicate": 0.05},
    "agent.progress_post": {"drop": 0.10},
}

# coordinator-process SIGKILL points (procfault, subprocess side)
KILL_SITES = {"store.launch_txn": 0.35, "cycle.mid": 0.05}


def _p99(vals):
    if not vals:
        return 0.0
    vs = sorted(vals)
    return vs[max(0, -(-len(vs) * 99 // 100) - 1)]


def _server_rss_mb(sup) -> float:
    proc = getattr(sup, "_proc", None)
    if proc is None or proc.poll() is not None:
        return 0.0
    try:
        with open(f"/proc/{proc.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _server_own_rss_mb(sup) -> float:
    """The server's resident memory less the clean pages of the files it
    maps read-only (its libraries' code and constant data): the memory
    the server itself holds, which is what grows with its backlog or a
    leak. Read from /proc/<pid>/smaps: each read-only file mapping
    counts only its Anonymous (copied-on-write) pages, every other
    mapping its whole Rss. Where smaps has no Anonymous field the
    read-only file mappings count nothing, which under-counts by their
    relocated pages (a few MB). The pages left out sit in the page
    cache, shared with every process that maps the same files: torch
    built for CUDA maps its CUDA libraries (GBs of them resident on an
    H100 host: `bench_torch.py day-soak` prints both readings)."""
    proc = getattr(sup, "_proc", None)
    if proc is None or proc.poll() is not None:
        return 0.0
    total_kb = shared_kb = 0
    clean = False
    try:
        with open(f"/proc/{proc.pid}/smaps") as f:
            for line in f:
                key = line.split(None, 1)[0]
                if key == "Rss:":
                    kb = int(line.split()[1])
                    total_kb += kb
                    if clean:
                        shared_kb += kb
                elif key == "Anonymous:" and clean:
                    shared_kb -= int(line.split()[1])
                elif not key.endswith(":"):
                    # a mapping's header: range perms offset dev inode path
                    parts = line.split(None, 5)
                    path = parts[5].strip() if len(parts) > 5 else ""
                    clean = (parts[1][1] == "-" and path != ""
                             and not path.startswith("["))
    except (OSError, IndexError, ValueError):
        return 0.0
    return (total_kb - shared_kb) / 1024.0


def run_day_soak(store_root, seed, tag=None, jobs=8, agents=3,
                 window_s=4.0, wall_s=90.0, max_kills=1,
                 events_per_agent=1.0, kill_fraction=0.2,
                 churn=True, transport=True, kill_sites=None,
                 device="cuda"):
    """One compressed day. Returns an evidence dict; asserts nothing.
    The server runs on ``device`` ("cuda" unless the caller asks for
    "cpu"); the evidence's ``incarnations`` are its incarnations
    (``tests.torch_livestack.incarnations``), read once it stopped, so
    the last one's kernel launches are in it.

    Full-magnitude nightly parameters (documented here, driven by
    ``bench_torch.py day-soak``): jobs=120, agents=6, window_s=30,
    wall_s=600,
    max_kills=3, events_per_agent=2.0 — a fleet where most agents fault
    at least twice and the coordinator dies three times mid-burst.
    """
    tag = tag or f"day{seed}"
    violations: list[str] = []
    launch_counts: dict[str, int] = {}
    submit_lat_ms: list[float] = []
    daemons: dict[str, AgentDaemon] = {}
    dlock = threading.Lock()
    hostnames = [f"{tag}-a{i}" for i in range(agents)]

    live = LiveServer(store_root,
                      sites=kill_sites if kill_sites is not None
                      else (KILL_SITES if max_kills else None),
                      seed=seed, max_kills=max_kills,
                      # a compressed day compresses the watchdogs too:
                      # a churn-killed agent's restored tasks must be
                      # settled (3000 mea-culpa) within the soak wall
                      overrides={"scheduler":
                                 {"heartbeat_timeout_s": 6.0}},
                      device=device)
    if transport:
        chaos.controller.configure(seed=seed, sites=TRANSPORT_SITES)
    else:
        chaos.controller.reset()

    def make_daemon(host):
        d = AgentDaemon(live.url, hostname=host, mem=4096.0, cpus=8.0,
                        sandbox_root=str(store_root / f"sbx-{host}"
                                         / str(time.monotonic_ns())),
                        heartbeat_interval_s=0.4,
                        agent_token=LiveServer.AGENT_TOKEN)
        orig = d.executor.launch

        def counted(task_id, *a, _orig=orig, **kw):
            # the at-most-once ledger: shared across ALL incarnations
            # of every agent, so a relaunch after resurrection shows up
            launch_counts[task_id] = launch_counts.get(task_id, 0) + 1
            return _orig(task_id, *a, **kw)

        d.executor.launch = counted
        return d

    schedule = generate_churn(seed, hostnames,
                              duration_s=window_s + 6.0,
                              events_per_agent=events_per_agent,
                              kill_fraction=kill_fraction) \
        if churn else None
    stop_evt = threading.Event()
    action_threads: list[threading.Thread] = []

    def _do_action(ev):
        with dlock:
            d = daemons.get(ev.hostname)
        try:
            if ev.action == PARTITION:
                if d is None:
                    return
                d.set_partitioned(True)
                if stop_evt.wait(ev.down_s):
                    d.set_partitioned(False)
                    return
                with dlock:
                    d2 = daemons.get(ev.hostname)
                if d2 is not None:
                    d2.set_partitioned(False)
            elif ev.action == KILL:
                with dlock:
                    daemons[ev.hostname] = None
                if d is not None:
                    d.stop()
            elif ev.action in (RESTART, FLAP):
                if d is not None:
                    d.stop()
                if stop_evt.wait(ev.down_s):
                    return
                nd = make_daemon(ev.hostname)
                nd.start()
                with dlock:
                    daemons[ev.hostname] = nd
        except Exception:
            pass  # churn racing a dying daemon must not fail the soak

    def churn_worker(t0):
        for ev in schedule.events:
            if stop_evt.wait(max(0.0, ev.t_s - (time.time() - t0))):
                return
            t = threading.Thread(target=_do_action, args=(ev,),
                                 daemon=True)
            t.start()
            action_threads.append(t)

    seen_instances: dict[str, int] = {}
    max_rss_mb = 0.0
    max_rss_own_mb = 0.0
    overload_level_max = 0
    jobs_final: dict = {}
    try:
        live.start()
        for host in hostnames:
            d = make_daemon(host)
            d.start()
            daemons[host] = d

        t0 = time.time()
        if schedule is not None:
            threading.Thread(target=churn_worker, args=(t0,),
                             daemon=True).start()

        # a compressed diurnal day of submissions, kill-retry like the
        # crash soak: a dead coordinator mid-submit is part of the day
        trace = generate_trace(n_jobs=jobs, n_users=3, seed=seed,
                               submit_window_ms=86_400_000,
                               diurnal=True)
        scale = window_s / 86_400_000
        subs = sorted((t["submit-time-ms"] * scale, t["job/user"],
                       t["job/priority"]) for t in trace)
        clients = {}
        uuids = []
        for delay, user, priority in subs:
            now = time.time() - t0
            if delay > now:
                time.sleep(delay - now)
            cli = clients.setdefault(user, live.client(user))
            u = str(uuidlib.uuid4())
            for _ in range(8):
                try:
                    ts = time.monotonic()
                    cli.submit(command="sleep 0.4", mem=64.0, cpus=1.0,
                               uuid=u, priority=priority, max_retries=4)
                    submit_lat_ms.append(
                        (time.monotonic() - ts) * 1e3)
                    break
                except Exception:
                    try:
                        if cli.query_jobs([u]):
                            break
                    except Exception:
                        pass
                    live.ensure_alive(READY_BOUND_S)
                    time.sleep(0.25)
            else:
                violations.append(f"submit of {u} never landed")
            uuids.append((u, user))

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
            live.ensure_alive(READY_BOUND_S)
            max_rss_mb = max(max_rss_mb, _server_rss_mb(live.sup))
            max_rss_own_mb = max(max_rss_own_mb,
                                 _server_own_rss_mb(live.sup))
            try:
                jobs_final = poll()
            except Exception:
                continue
            for u, j in jobs_final.items():
                n = len(j.instances)
                if n < seen_instances.get(u, 0):
                    violations.append(
                        f"{u} instance count shrank across restart "
                        f"({seen_instances[u]} -> {n})")
                seen_instances[u] = max(n, seen_instances.get(u, 0))
            try:
                dbg = live.debug()
                lvl = dbg.get("overload", {}).get("level", 0)
                overload_level_max = max(overload_level_max, lvl)
            except Exception:
                pass
            if len(jobs_final) == len(uuids) and all(
                    j.status == "completed"
                    for j in jobs_final.values()):
                break
            time.sleep(0.4)

        stop_evt.set()
        for t in action_threads:
            t.join(timeout=5)
        injected = sum(chaos.controller.stats()
                       .get("injected", {}).values())
        _dump_artifacts(live, tag, schedule)
        out = {
            "seed": seed,
            "tag": tag,
            "kill_ledger": live.budget_file,
            "server_log": live.server_log,
            "violations": violations,
            "jobs": jobs_final,
            "expected_jobs": len(uuids),
            "launch_counts": dict(launch_counts),
            "transport_injected": injected,
            "kills": live.kills(),
            "server_deaths": len(live.sup.deaths),
            "ready_times_s": list(live.sup.ready_times_s),
            "churn_events": ([e.as_dict() for e in schedule.events]
                             if schedule else []),
            "submit_p99_ms": round(_p99(submit_lat_ms), 1),
            "max_rss_mb": round(max_rss_mb, 1),
            "max_rss_own_mb": round(max_rss_own_mb, 1),
            "overload_level_max": overload_level_max,
        }
    finally:
        stop_evt.set()
        chaos.controller.reset()
        with dlock:
            ds = [d for d in daemons.values() if d is not None]
        for d in ds:
            try:
                d.set_partitioned(False)
                d.stop()
            except Exception:
                pass
        live.stop()
    out["incarnations"] = incarnations(live.server_log)
    return out


def _dump_artifacts(live, tag, schedule):
    out = os.environ.get("CHAOS_ARTIFACTS_DIR")
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    if schedule is not None:
        schedule.save(os.path.join(out, f"day-{tag}-churn.jsonl"))
    chaos.controller.save_events(
        os.path.join(out, f"day-{tag}-transport.jsonl"))
    for src, name in ((live.server_log, f"day-{tag}-server.log"),
                      (live.budget_file, f"day-{tag}-kills.jsonl")):
        if os.path.exists(src):
            shutil.copy(src, os.path.join(out, name))
