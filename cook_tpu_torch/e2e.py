"""bench.py::bench_e2e's workload on the port: the production match path
end to end, `Coordinator.match_cycle` over a durable store.

    store events -> ResidentPool mirrors and delta packing -> ship ->
    device_cycle (exact_scan, or match_rounds with exact_scan and
    best_host) -> the compact readback -> the bulk launch transaction in
    the store -> the mock backend's launches -> completions flowing back
    as credits

The same workload, knobs and defaults as bench_e2e (bench.py:733-741):
P0 = 100,000 pending jobs and H = 10,000 `MockHost`s (mem U(64, 256)
GiB, cpus U(16, 64)), U = 500 users, jobs of mem U(1, 10) GiB and cpus
U(0.5, 4) that run `runtime_s` = 10 s on the mock's virtual clock, the
backlog refilled as jobs complete (the clock advances 1 s a cycle), a
durable log in a temp file over `store_shards` = 4 shards with
bench_e2e's rotation (at `rotate_lines`) and retention threads,
`status_shards=19`, a synchronous consumer unless asked otherwise; the
seed draws hosts, then the backlog, then each refill from one
generator, in bench_e2e's order. With `pools` = K > 1, host i is in
pool p(i % K) and the n-th job in p(n % K), and a bench cycle drives
the K pools' `match_cycle`s from K threads at once (bench_e2e's
executor). `sequential_threshold` is the coordinator's
`sequential_match_threshold`, `native` the native consume switch
(restored at `close`), `decision_provenance` the coordinator's (None:
its default, on) and `durability_check` bench_e2e's cold-replay
check. Job uuids are deterministic (a counter), so two runs of one seed
submit the same jobs.

`bench_torch.py e2e|e2e-small|e2e-smoke|...` and chip_smoke.py's e2e
and bench phases drive it. Imports torch, numpy and cook_tpu_torch
only.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import glob
import itertools
import os
import sys
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

from cook_tpu_torch.backends.base import ClusterRegistry
from cook_tpu_torch.backends.mock import MockCluster, MockHost
from cook_tpu_torch.native import consumefold
# the server's, called at leadership takeover and by bench_e2e after
# seeding; re-exported for bench_torch.py and chip_smoke.py
from cook_tpu_torch.rest.server import apply_gc_discipline  # noqa: F401
from cook_tpu_torch.scheduler.coordinator import Coordinator, SchedulerConfig
from cook_tpu_torch.state import model
from cook_tpu_torch.state.model import Job
from cook_tpu_torch.state.pools import Pool, PoolRegistry
from cook_tpu_torch.state.store import JobStore

POOL = "default"
# bench_e2e's seed, and the defaults of its knobs: the tasks' runtime on
# the mock's clock, the store's shards, the log rotation; its retention
SEED = 0
RUNTIME_S = 10.0
STORE_SHARDS = 4
ROTATE_LINES = 1_000_000
RETENTION_S = 120.0
# bench_e2e's phase metrics, in the coordinator's names: the cycle
# thread's, then the consume's (inline on the same thread here)
PHASES = ("drain_ms", "ship_ms", "dispatch_ms", "readback_ms",
          "consume_fold_ms", "launch_loop_ms", "consume_frame_ms",
          "launch_txn_ms", "consume_bookkeep_ms", "backend_launch_ms")


# the wall clock `pinned_clocks` holds
PINNED_WALL_S = 1_700_000_000.0


@contextlib.contextmanager
def pinned_clocks(wall_s: float = PINNED_WALL_S):
    """Within the block `time.time()` and the store's clock read
    `wall_s` and `uuid.uuid4()` counts from 1: two runs of one scenario
    then stamp the same submit and start times and the same task ids
    (the mock backend orders completions of one instant by task id)."""
    counter = itertools.count(1)
    lock = threading.Lock()

    def uuid4():
        with lock:
            return uuid.UUID(int=next(counter))

    saved = (time.time, uuid.uuid4)
    time.time, uuid.uuid4 = (lambda: wall_s), uuid4
    model.set_clock(lambda: wall_s)   # the store's clock (now_ms)
    try:
        yield
    finally:
        time.time, uuid.uuid4 = saved
        model.reset_clock()


def job_uuid(n: int) -> str:
    """The workload's n-th job uuid (from 0): a counter kept apart from
    the task ids `pinned_clocks` counts."""
    return str(uuid.UUID(int=(1 << 64) + n))


def pool_names(pools: int) -> list:
    """bench_e2e's pool names: ["default"], or p0..pK-1."""
    return [POOL] if pools == 1 else [f"p{i}" for i in range(pools)]


class Workload:
    """bench_e2e's store, mock cluster and coordinator, seeded and with
    the resident pool of every pool enabled (its host axis sharded over
    `shard_devices` when given). `launched` lists every backend launch as
    (job uuid, hostname), in order, and `by_pool` each pool's."""

    def __init__(self, P0=100_000, H=10_000, U=500, consider=None,
                 pipeline_depth=None, async_consumer=False, device="cuda",
                 durable=True, status_shards=19, shard_devices=None,
                 pools=1, store_shards=STORE_SHARDS, runtime_s=RUNTIME_S,
                 rotate_lines=ROTATE_LINES, sequential_threshold=None,
                 native=None, decision_provenance=None):
        self.rng = rng = np.random.default_rng(SEED)
        self.U = U
        self.pools = K = max(1, int(pools))
        self.pool_names = names = pool_names(K)
        self.rotate_lines = rotate_lines
        hosts = [MockHost(f"h{i}", mem=float(rng.uniform(64, 256) * 1024),
                          cpus=float(rng.uniform(16, 64)),
                          pool=names[i % K])
                 for i in range(H)]
        self.log_path = self.snap_path = None
        if durable:
            fd, self.log_path = tempfile.mkstemp(prefix="cook_e2e_",
                                                 suffix=".log")
            os.close(fd)
            fd, self.snap_path = tempfile.mkstemp(prefix="cook_e2e_",
                                                  suffix=".snap")
            os.close(fd)
        self.store = JobStore(log_path=self.log_path,
                              store_shards=store_shards)
        self.cluster = MockCluster(
            hosts, runtime_fn=lambda s: (runtime_s, True, None),
            bulk_status=True)
        reg = ClusterRegistry()
        reg.register(self.cluster)
        cfg = SchedulerConfig()
        if sequential_threshold is not None:
            cfg.sequential_match_threshold = sequential_threshold
        if consider:
            cfg.max_jobs_considered = consider
        if pipeline_depth is not None:
            cfg.pipeline_depth = int(pipeline_depth)
        if decision_provenance is not None:
            # bench_e2e's decision-overhead switch: the why rows on the
            # prefix readback and their recording
            cfg.decision_provenance = bool(decision_provenance)
        preg = PoolRegistry(names[0])
        for name in names[1:]:
            preg.add(Pool(name=name))
        # as bench_e2e: from before the coordinator to `close`
        self._native_was = consumefold.enabled()
        if native is not None:
            consumefold.set_enabled(bool(native))
        try:
            self.coord = Coordinator(self.store, reg, config=cfg,
                                     pools=preg, status_shards=status_shards,
                                     device=device)
            self.launched: list = []
            self.by_pool: dict = {p: [] for p in names}
            launch = self.cluster.launch_tasks

            def record(pool, specs):
                got = [(s.job_uuid, s.hostname) for s in specs]
                self.launched.extend(got)
                self.by_pool[pool].extend(got)
                return launch(pool, specs)

            self.cluster.launch_tasks = record
            self._seq = 0
            t0 = time.perf_counter()
            self.store.create_jobs(self.mkjobs(P0))
            self.seed_s = time.perf_counter() - t0
            for p in names:
                self.coord.enable_resident(pool=p,
                                           synchronous=not async_consumer,
                                           devices=shard_devices)
        except BaseException:
            consumefold.set_enabled(self._native_was)
            raise
        self.rp = self.coord._resident[names[0]]
        # K > 1: one executor drives every pool's match_cycle at once
        self._exec = (ThreadPoolExecutor(max_workers=K,
                                         thread_name_prefix="bench-pool")
                      if K > 1 else None)
        self._stop = threading.Event()
        self._threads: list = []
        self.rotations: list = []
        self.retired = 0

    def mkjobs(self, n: int) -> list:
        rng, base, names = self.rng, self._seq, self.pool_names
        self._seq += n
        return [Job(uuid=job_uuid(base + i),
                    user=f"u{int(rng.integers(0, self.U))}",
                    command="true", pool=names[(base + i) % self.pools],
                    mem=float(rng.uniform(1, 10) * 1024),
                    cpus=float(rng.uniform(0.5, 4)))
                for i in range(n)]

    def cycle(self, concurrent: bool = True):
        """One bench cycle: every pool's `match_cycle`, from K threads at
        once (bench_e2e's executor) or, with `concurrent` false, one
        pool after another in name order. With K > 1 the stats are
        bench_e2e's: matched summed, cycle_ms the largest (the pools'
        cycles overlap in wall time)."""
        co = self.coord
        if self._exec is None:
            return co.match_cycle(self.pool_names[0])
        if concurrent:
            stats = list(self._exec.map(co.match_cycle, self.pool_names))
        else:
            stats = [co.match_cycle(p) for p in self.pool_names]
        return SimpleNamespace(matched=sum(s.matched for s in stats),
                               cycle_ms=max(s.cycle_ms for s in stats))

    def pool_metric(self, key: str, op=max, pop: bool = False,
                    default=None):
        """`op` over the pools' `match.<pool>.<key>` metrics
        (bench_e2e's pool_metric)."""
        vals = []
        for p in self.pool_names:
            mk = f"match.{p}.{key}"
            v = (self.coord.metrics.pop(mk, None) if pop
                 else self.coord.metrics.get(mk))
            if v is not None:
                vals.append(v)
        return op(vals) if vals else default

    def drain(self) -> None:
        for p in self.pool_names:
            self.coord.drain_resident(p)
        if self.coord.status_shards is not None:
            self.coord.status_shards.drain()

    def advance(self) -> int:
        """One virtual second: due tasks complete, and as many new jobs
        are submitted."""
        done = self.cluster.advance(1.0)
        if done:
            self.store.create_jobs(self.mkjobs(done))
        return done

    def start_threads(self) -> None:
        """bench_e2e's deployment threads: the snapshot loop's log
        rotation at `rotate_lines` and the retention GC."""
        store, stop = self.store, self._stop

        def rotate_loop():
            while not stop.wait(2.0):
                try:
                    if store.log_lines() >= self.rotate_lines > 0:
                        t_r = time.perf_counter()
                        ticket = store.rotate_log(self.snap_path,
                                                  wait=False)
                        if ticket is not None:
                            ticket.wait()
                        self.rotations.append(
                            (time.perf_counter() - t_r) * 1e3)
                except Exception as e:
                    print(f"# rotation failed: {e!r}", file=sys.stderr)

        def retention_loop():
            while not stop.wait(15.0):
                try:
                    self.retired += store.gc_completed(
                        int(RETENTION_S * 1e3))
                except Exception as e:
                    print(f"# retention gc failed: {e!r}", file=sys.stderr)

        for fn in (rotate_loop, retention_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop_threads(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)

    def durability_check(self) -> dict:
        """bench_e2e's ack-durability gate (bench.py:1120-1152): stop the
        background writers, rebuild the store cold from disk alone as a
        restart would (the snapshot chain if a rotation happened, else
        the whole log), and demand that every live pending job and
        running task is in it and that its digest is the live store's."""
        self.stop_threads()
        cold = JobStore.restore(self.snap_path if self.rotations else None,
                                log_path=self.log_path, open_writer=False)
        live_pending = {j.uuid for j in self.store.pending_jobs()}
        live_running = {i.task_id for i in self.store.running_instances()}
        cold_pending = {j.uuid for j in cold.pending_jobs()}
        cold_running = {i.task_id for i in cold.running_instances()}
        return {
            "acked_all_durable": (live_pending <= cold_pending
                                  and live_running <= cold_running),
            "live_pending": len(live_pending),
            "cold_pending": len(cold_pending),
            "live_running": len(live_running),
            "cold_running": len(cold_running),
            "state_hash_match": (self.store.state_hash()
                                 == cold.state_hash()),
        }

    def close(self) -> None:
        self.stop_threads()
        if self._exec is not None:
            self._exec.shutdown(wait=True)
        try:
            self.coord.stop()
        finally:
            consumefold.set_enabled(self._native_was)
            for p in (self.log_path, self.snap_path):
                # the log, the snapshot and what rotation left beside them
                for f in glob.glob(glob.escape(p) + "*") if p else ():
                    try:
                        os.unlink(f)
                    except OSError:
                        pass


def run_cycles(w: Workload, cycles: int, warmup: int,
               on_cycle=None, concurrent: bool = True) -> dict:
    """bench_e2e's loop (bench.py:991): `cycles` cycles in all, the
    first `warmup` of them untimed, each one bench cycle
    (`Workload.cycle`: every pool's `match_cycle`, timed together on the
    host clock, with the coordinator's phase metrics and the cyclic
    collector's pauses in it), then one virtual second with its refill.
    A phase is the mean over the pools and a resync the longest
    (bench_e2e's pool_metric). `on_cycle(c, stats)` runs after each
    cycle's match, before the advance. Returns the measured lists."""
    co = w.coord
    wall, matched, resyncs, refreezes = [], [], [], []
    phases = {k: [] for k in PHASES}
    gc_ms, gc_gen, completed = [], [], 0
    mean = lambda v: sum(v) / len(v)
    # the collector's pauses in this cycle, whichever thread ran them:
    # [ms, oldest generation collected (-1: none), start of the current]
    pause = [0.0, -1, 0.0]

    def on_gc(phase, info):
        if phase == "start":
            pause[2] = time.perf_counter()
        else:
            pause[0] += (time.perf_counter() - pause[2]) * 1e3
            pause[1] = max(pause[1], info["generation"])

    gc.callbacks.append(on_gc)
    try:
        for c in range(cycles):
            pause[0], pause[1] = 0.0, -1
            t_c = time.perf_counter()
            stats = w.cycle(concurrent)
            t_m = time.perf_counter()
            rs = w.pool_metric("resync_ms", op=max, pop=True)
            if rs is not None:
                resyncs.append((c, rs))
            refreeze = co.metrics.pop("gc.refreeze_ms", None)
            if refreeze is not None:
                refreezes.append((c, refreeze))
            if c >= warmup:
                wall.append((t_m - t_c) * 1e3)
                gc_ms.append(pause[0])
                gc_gen.append(pause[1])
                matched.append(stats.matched)
                for k in PHASES:
                    phases[k].append(w.pool_metric(k, op=mean, default=0.0))
            if on_cycle is not None:
                on_cycle(c, stats)
            completed += w.advance()
    finally:
        gc.callbacks.remove(on_gc)
    w.drain()
    return {"wall": wall, "matched": matched, "phases": phases,
            "gc_ms": gc_ms, "gc_gen": gc_gen, "resyncs": resyncs,
            "gc_refreezes": refreezes, "warmup": warmup,
            "completed": completed}


def summary(r: dict) -> dict:
    """bench_e2e's key names, where they apply, from `run_cycles`."""
    wall = np.asarray(r["wall"])
    return {
        "value": float(np.mean(r["matched"]) / (np.mean(wall) / 1e3)),
        "unit": "decisions/sec",
        "p50_cycle_ms": float(np.percentile(wall, 50)),
        "p99_cycle_ms": float(np.percentile(wall, 99)),
        "p999_cycle_ms": float(np.percentile(wall, 99.9)),
        "mean_cycle_ms": float(wall.mean()),
        "max_cycle_ms": float(wall.max()),
        "matched_per_cycle": float(np.mean(r["matched"])),
        "phase_median_ms": {k: float(np.median(v))
                            for k, v in r["phases"].items()},
        "phase_means_ms": {k: float(np.mean(v))
                           for k, v in r["phases"].items()},
        "readback_mean_ms": float(np.mean(r["phases"]["readback_ms"])),
        "resyncs": r["resyncs"],
        "gc_refreezes": r["gc_refreezes"],
        # the cyclic collector's pauses inside match_cycle
        "gc_ms_median": float(np.median(r["gc_ms"])),
        "gc_ms_max": float(np.max(r["gc_ms"])),
        # the phases of the slowest cycles, and the collector's pause
        # and oldest generation in each ("cycle" counts the warm-up too,
        # as resyncs and gc_refreezes do)
        "worst_cycles": [
            {"cycle": int(i) + r["warmup"], "wall_ms": float(wall[i]),
             "gc_ms": float(r["gc_ms"][i]), "gc_gen": int(r["gc_gen"][i]),
             **{k: float(v[i]) for k, v in r["phases"].items()}}
            for i in np.argsort(wall)[-5:][::-1]],
        "cycles": len(wall),
    }


def launch_trace(device, cycles: int, mode: str = "inline",
                 advance: bool = True, until_dense: int = 0,
                 audit: bool = False, concurrent: bool = True,
                 **kw) -> dict:
    """A deterministic run of `cycles` cycles of one seeded Workload (no
    durable log unless `durable=True` is passed, statuses applied inline,
    clocks and uuids pinned), for holding one run against another: on
    another device, or with K pools' cycles in turn (`concurrent`
    false) against K threads. `mode` is "inline" (pipeline_depth 0
    unless `pipeline_depth` is passed), "pipelined" (depth 1: cycle N is
    consumed after cycle N+1 was dispatched) or "async" (a consumer
    thread). While no cycle has run a dense round of `match_rounds`, up
    to `until_dense` cycles in all are run. With `audit`, every read of
    a cycle's early pinned copies is held against a synchronous copy of
    the same device outputs. Returns the backend launches of each cycle
    (sync modes; for "async" one list after the final drain), all
    launches in order, each pool's launches by cycle (the same lists per
    pool), the dense rounds of each cycle, the most cycles in flight
    seen at a consume, the tasks completed, the audit's reads and
    mismatches, with `durable=True` bench_e2e's durability check after
    the final drain, each bench cycle's host-clock ms, and the instances
    (hostname, status, reason code) of every job launched more than
    once."""
    from cook_tpu_torch.ops import match as match_ops
    from cook_tpu_torch.scheduler import resident

    depth = kw.pop("pipeline_depth", 1 if mode == "pipelined" else 0)
    kw.setdefault("durable", False)
    read = resident.read_outputs
    audited, bad = [0], []

    def read_audited(out, names, n=None):
        got = read(out, names, n)
        if out.host is not None:
            # a plain copy on this thread's stream, ordered after the
            # cycle that wrote these outputs (nothing writes them later)
            want = [getattr(out, k).cpu().numpy() for k in names]
            for k, g, x in zip(names, got, want):
                x = x if n is None else x[:n]
                if not np.array_equal(g, x):
                    bad.append(f"cycle {out.cycle_no} {k}")
            audited[0] += 1
        return got

    with pinned_clocks():
        w = Workload(device=device, status_shards=0, pipeline_depth=depth,
                     async_consumer=mode == "async", **kw)
        co, seen = w.coord, [0]
        consume = co._consume_cycle

        def counted(pool, rp, out):
            seen[0] = max(seen[0], len(rp._inflight))
            return consume(pool, rp, out)

        co._consume_cycle = counted
        if audit:
            resident.read_outputs = read_audited
        per, dense, done, durability, cycle_ms = [], [], 0, None, []
        per_pool = {p: [] for p in w.pool_names}

        def cut(n0, p0):
            per.append(list(w.launched[n0:]))
            for p, got in w.by_pool.items():
                per_pool[p].append(list(got[p0[p]:]))

        try:
            c = 0
            while c < cycles or (c < until_dense and not sum(dense)):
                n0, d0 = len(w.launched), match_ops.ROUNDS["dense"]
                p0 = {p: len(v) for p, v in w.by_pool.items()}
                t0 = time.perf_counter()
                w.cycle(concurrent)
                cycle_ms.append((time.perf_counter() - t0) * 1e3)
                dense.append(match_ops.ROUNDS["dense"] - d0)
                if mode != "async":
                    cut(n0, p0)
                if advance:
                    done += w.advance()
                c += 1
            n0, p0 = len(w.launched), {p: len(v)
                                       for p, v in w.by_pool.items()}
            w.drain()
            cut(n0, p0)
            if w.log_path:
                durability = w.durability_check()
            # every instance of a job the backend launched more than
            # once: (hostname, status, reason code) in launch order
            counts = collections.Counter(u for u, _ in w.launched)
            repeats = {u: [(i.hostname, i.status.value, i.reason_code)
                           for i in w.store.jobs[u].instances]
                       for u, n in counts.items() if n > 1}
        finally:
            resident.read_outputs = read
            w.close()
    return {"per_cycle": per, "launched": list(w.launched),
            "per_pool": per_pool, "dense_rounds": dense,
            "max_inflight": seen[0], "completed": done,
            "audited_reads": audited[0], "audit_mismatches": bad,
            "durability": durability, "cycle_ms": cycle_ms,
            "repeats": repeats}


# the coordinator's other device paths: a default pool of H_PATHS hosts
# drawn as bench_e2e draws them and a gpu pool of 8-gpu hosts, both
# filled past capacity by "greedy" users, then a few "poor" users submit
PATHS_HOSTS, PATHS_GPU_HOSTS = 512, 32
PATHS_GREEDY, PATHS_GREEDY_GPU, PATHS_POOR = 6000, 160, 64


def device_paths(device) -> list:
    """One seeded run of the coordinator's device paths besides the
    resident cycle, clocks and uuids pinned: the legacy `match_cycle`
    (it re-tensorizes the queue each cycle; `rank_and_match` with the
    batched matcher at C=8192, then the sequential one at C=1024) in a
    default pool and in a gpu pool (the gpu DRU rank), and
    `rebalance_cycle` in both (`_dru_pending_head`, then `rebalance`),
    each followed by a cycle. Returns the trace: per cycle its dense
    rounds and the launched (job uuid, hostname) pairs; per rebalance
    the preempted count, the placed count, the decisions and the
    preempted jobs."""
    from cook_tpu_torch.ops import match as match_ops
    from cook_tpu_torch.scheduler.coordinator import RebalancerParams
    from cook_tpu_torch.state.pools import DruMode, Pool

    rng = np.random.default_rng(SEED)
    hosts = [MockHost(f"h{i}", mem=float(rng.uniform(64, 256) * 1024),
                      cpus=float(rng.uniform(16, 64)), pool=POOL)
             for i in range(PATHS_HOSTS)]
    hosts += [MockHost(f"g{i}", mem=1024.0 * 1024, cpus=96.0, gpus=8.0,
                       pool="gpu") for i in range(PATHS_GPU_HOSTS)]
    seq = itertools.count()

    def jobs(n, user, pool=POOL, gpus=0.0):
        return [Job(uuid=job_uuid(next(seq)),
                    user=f"{user}{int(rng.integers(0, 8))}",
                    command="true", pool=pool,
                    mem=float(rng.uniform(1, 10) * 1024),
                    cpus=float(rng.uniform(2, 8)), gpus=gpus)
                for _ in range(n)]

    trace = []
    with pinned_clocks():
        store = JobStore()
        cluster = MockCluster(hosts, runtime_fn=lambda s: (3600.0, True,
                                                           None))
        reg = ClusterRegistry()
        reg.register(cluster)
        pools = PoolRegistry(POOL)
        pools.add(Pool(name="gpu", dru_mode=DruMode.GPU))
        cfg = SchedulerConfig(rebalancer=RebalancerParams(
            safe_dru_threshold=0.0, min_dru_diff=0.05))
        coord = Coordinator(store, reg, config=cfg, pools=pools,
                            status_shards=0, device=device)
        coord.shares.set("default", POOL, mem=64.0 * 1024, cpus=32.0)
        coord.shares.set("default", "gpu", gpus=8.0, mem=1e9, cpus=1e9)
        launched = []
        launch = cluster.launch_tasks

        def record(pool, specs):
            launched.extend((s.job_uuid, s.hostname) for s in specs)
            return launch(pool, specs)

        cluster.launch_tasks = record

        def cycle(pool, consider):
            cfg.max_jobs_considered = consider
            n0, d0 = len(launched), match_ops.ROUNDS["dense"]
            coord.match_cycle(pool)
            trace.append(("cycle", pool, consider,
                          match_ops.ROUNDS["dense"] - d0, launched[n0:]))

        def rebalance(pool):
            res = coord.rebalance_cycle(pool)
            victims = sorted(j.uuid for j in store.jobs.values()
                             if any(i.preempted for i in j.instances))
            trace.append(("rebalance", pool, res["preempted"],
                          res["placed"], res.get("decisions", []),
                          victims))

        try:
            store.create_jobs(jobs(PATHS_GREEDY, "greedy"))
            store.create_jobs(jobs(PATHS_GREEDY_GPU, "greedy", "gpu", 2.0))
            cycle(POOL, 8192)
            cycle(POOL, 1024)
            cycle("gpu", 1024)
            store.create_jobs(jobs(PATHS_POOR, "poor"))
            store.create_jobs(jobs(PATHS_POOR // 4, "poor", "gpu", 2.0))
            for pool in (POOL, "gpu"):
                rebalance(pool)
                cycle(pool, 1024)
        finally:
            coord.stop()
    return trace
