"""bench.py's remaining device entry points on the port (bench_torch.py:
contended, stream, and bench_e2e's pools / store_shards / durability /
sequential_threshold / native knobs through cook_tpu_torch/e2e.py),
held against cook_tpu on the CPU at small sizes. Every output compared
is an integer or a bool, so every comparison is exact.

Also the launch counters (fused_match.LAUNCHES, match.ROUNDS), which K
pools' cycles bump from K threads at once: the totals must be exact.
"""
import functools
import gc
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bench
import bench_torch
from cook_tpu_torch import e2e
from cook_tpu_torch.e2e import job_uuid, pool_names
from cook_tpu_torch.ops import fused_match as fm
from cook_tpu_torch.ops import match as match_ops
from tests.torch_coord_harness import run

CPU = torch.device("cpu")


class YieldingTable(dict):
    """A counter table whose read lets other threads run before the
    value is returned: an unguarded `t[k] += 1` then loses bumps, as
    it may wherever the interpreter switches threads inside one."""

    def __getitem__(self, k):
        v = super().__getitem__(k)
        time.sleep(1e-5)
        return v


@pytest.mark.parametrize("which", ["LAUNCHES", "ROUNDS", "yielding"])
def test_counters_are_exact_when_bumped_from_threads(which):
    """K threads bump one counter N times each through fm.count (the
    GIL switched as often as it can be): the total is exactly K x N."""
    table, name, N = {"LAUNCHES": (fm.LAUNCHES, "exact_scan", 20_000),
                      "ROUNDS": (match_ops.ROUNDS, "dense", 20_000),
                      "yielding": (YieldingTable(n=0), "n", 300)}[which]
    K = 8
    saved, interval = table[name], sys.getswitchinterval()
    table[name] = 0
    go = threading.Barrier(K)

    def bump():
        go.wait()
        for _ in range(N):
            fm.count(table, name)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(K)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert table[name] == K * N
    finally:
        sys.setswitchinterval(interval)
        table[name] = saved


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("contended", [False, True],
                         ids=["default", "contended"])
def test_cycle_setup_equals_bench_py(contended):
    """bench_torch.cycle_setup draws bench.py::_cycle_setup's arrays bit
    for bit from the same seed, the default mix and the contended one;
    the contended draw changes the pending jobs' mem and cpus alone."""
    shape = (60, 400, 24, 7)
    ref, _ = bench._cycle_setup(*shape, contended=contended)
    got = bench_torch.cycle_setup(*shape, CPU, contended=contended)
    default = bench_torch.cycle_setup(*shape, CPU)
    assert len(got) == len(ref) == 24
    for i, (a, b, d) in enumerate(zip(ref, got, default)):
        if a is None:
            assert b is None and d is None, i
            continue
        fields = a._fields if hasattr(a, "_fields") else (None,)
        for f in fields:
            x, y, z = (_numpy(getattr(v, f) if f else v) for v in (a, b, d))
            assert x.dtype == y.dtype and x.shape == y.shape, (i, f)
            assert x.tobytes() == y.tobytes(), (i, f)
            assert (y.tobytes() == z.tobytes()) != \
                (contended and i in (9, 10)), (i, f)


def _reference_ladder(args, C):
    """bench.py::bench_cycle's ladder on cook_tpu (its rank_and_match
    with the reference's default routes)."""
    from cook_tpu.ops import cycle as cycle_ops
    from cook_tpu.scheduler.coordinator import AdaptiveHead

    audit_inv = None
    for h in AdaptiveHead.LADDER:
        res = cycle_ops.rank_and_match(
            *args, num_considerable=C, sequential=False,
            match_kw=(("head_exact", h),))
        inv = bench._audit_head_window(res, args)
        if audit_inv is None or inv < audit_inv:
            audit_inv = inv
        if inv == 0:
            return h, 0, res
    return AdaptiveHead.LADDER[-1], audit_inv, res


def test_contended_ladder_equals_cook_tpu():
    """`contended` at bench.py's `small` shape (R=1k, P=10k, H=1k, U=100,
    C=2048): the port's ladder (bench_torch.head_ladder) ends at
    cook_tpu's rung with cook_tpu's inversion count, and the rung's
    job_host is cook_tpu's."""
    shape, C = (1_000, 10_000, 1_000, 100), 2_048
    ref_args, _ = bench._cycle_setup(*shape, contended=True)
    want = _reference_ladder(ref_args, C)
    got = bench_torch.head_ladder(
        bench_torch.cycle_setup(*shape, CPU, contended=True), C,
        use_kernel=True)
    assert got[:2] == want[:2]
    assert got[0] > 0   # the contended mix climbs off head 0
    jh = got[2].job_host.numpy()
    assert (jh >= 0).sum() > 0
    np.testing.assert_array_equal(jh, np.asarray(want[2].job_host))


def _last_json(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def test_stream_equals_bench_py(capsys):
    """bench_stream's jobs_placed and cycles equal bench.py::
    bench_stream's at a small size and job total."""
    kw = dict(total_jobs=30_000, R=200, P=1_000, H=64, U=16, C=256)
    bench.bench_stream(**kw)
    want = _last_json(capsys.readouterr().out)
    bench_torch.bench_stream(**kw, device="cpu")
    got = _last_json(capsys.readouterr().out)
    assert (got["jobs_placed"], got["cycles"]) == \
        (want["jobs_placed"], want["cycles"])
    assert got["jobs_placed"] >= kw["total_jobs"]
    assert got["cycles"] % bench_torch.STREAM_BATCH == 0


def multi_pool_scenario(P0, H, U, cycles, K=4, sequential_threshold=None):
    """bench_e2e's workload with `pools` = K for either package: host i
    in pool p(i % K), the n-th job in p(n % K), a store of 4 shards, the
    pools' cycles driven one after another in name order."""
    names = pool_names(K)

    def scenario(t):
        p = t.pkg
        rng = np.random.default_rng(0)
        hosts = [p.MockHost(f"h{i}", mem=float(rng.uniform(64, 256) * 1024),
                            cpus=float(rng.uniform(16, 64)),
                            pool=names[i % K])
                 for i in range(H)]
        cfg = p.SchedulerConfig()
        if sequential_threshold is not None:
            cfg.sequential_match_threshold = sequential_threshold
        pools = p.PoolRegistry(names[0])
        for name in names[1:]:
            pools.add(p.Pool(name=name))
        store, cluster, coord = t.build(
            hosts=hosts, runtime_fn=lambda s: (10.0, True, None),
            config=cfg, pools=pools, store_kw={"store_shards": 4})
        cluster.bulk_status = True

        def mkjobs(n):
            base = len(t.jobs)
            return [t.mkjob(uuid_=job_uuid(base + i),
                            user=f"u{int(rng.integers(0, U))}",
                            mem=float(rng.uniform(1, 10) * 1024),
                            cpus=float(rng.uniform(0.5, 4)),
                            pool=names[(base + i) % K])
                    for i in range(n)]

        store.create_jobs(mkjobs(P0))
        for name in names:
            coord.enable_resident(pool=name)
        for _ in range(cycles):
            for name in names:
                t.cycle(coord, pool=name)
            done = cluster.advance(1.0)
            if done:
                store.create_jobs(mkjobs(done))
        t.note(*[(len(store.pending_jobs(n)), len(store.running_instances(n)))
                 for n in names])
    return scenario


@pytest.mark.parametrize("threshold", [None, 512],
                         ids=["sequential", "threshold512"])
def test_multi_pool_e2e_equals_cook_tpu(threshold):
    """4 pools x 4 store shards: every pool's cycle launches the same
    (job, host) pairs under both packages, cycle by cycle, through the
    completions of the tenth cycle on; with sequential_threshold 512 the
    C = 1024 window takes match_rounds."""
    scenario = multi_pool_scenario(3000, 200, 40, 12,
                                   sequential_threshold=threshold)
    ref = run(scenario, "cook_tpu")
    got = run(scenario, "cook_tpu_torch")
    for c, (a, b) in enumerate(zip(got[0], ref[0])):
        assert a == b, f"pool cycle {c} differs"
    assert got == ref
    cycles = [e for e in got[0] if e[0] == "cycle"]
    assert all(sum(e[1] for e in cycles[k::4]) > 0 for k in range(4))
    assert sum(e[1] for e in cycles[40:]) > 0   # after completions


def test_workload_pools_are_the_scenario():
    """e2e.Workload(pools=4) draws and launches what the scenario above
    does, pool by pool and cycle by cycle."""
    trace, _ = run(multi_pool_scenario(1600, 80, 20, 12), "cook_tpu_torch")
    got = e2e.launch_trace("cpu", 12, P0=1600, H=80, U=20, pools=4,
                           concurrent=False)
    index = {job_uuid(i): i for i in range(4000)}
    cycles = [e[2] for e in trace if e[0] == "cycle"]
    for k, name in enumerate(pool_names(4)):
        want = cycles[k::4]
        assert [{index[u]: [h] for u, h in cyc}
                for cyc in got["per_pool"][name][:12]] == want, name
    assert sum(len(c) for v in got["per_pool"].values() for c in v) == \
        len(got["launched"]) > 0


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_concurrent_pools_launch_what_pools_in_turn_launch(native):
    """e2e-smoke's shape at a toy size (4 pools x 4 store shards, depth
    2, a durable log): the K pools' cycles from K threads launch, pool
    by pool and cycle by cycle, what the pools launch in turn, the cold
    replay holds every acked job and the live store's digest, and the
    native consume folds launch what the Python folds launch."""
    kw = dict(P0=1200, H=48, U=12, pools=4, store_shards=4,
              pipeline_depth=2, native=native, consider=64, durable=True)
    seq = e2e.launch_trace("cpu", 5, concurrent=False, **kw)
    conc = e2e.launch_trace("cpu", 5, concurrent=True, **kw)
    assert conc["per_pool"] == seq["per_pool"]
    assert all(sum(map(len, v)) for v in seq["per_pool"].values())
    for r in (seq, conc):
        assert r["durability"]["acked_all_durable"]
        assert r["durability"]["state_hash_match"]
        assert r["durability"]["live_running"] > 0
    if not native:
        assert seq["per_pool"] == e2e.launch_trace(
            "cpu", 5, concurrent=False, **{**kw, "native": True})[
                "per_pool"]


def test_durability_check_true_for_both_packages(capsys):
    """bench_e2e's cold-replay check (bench.py:1120-1152) reports true
    for cook_tpu's bench_e2e and the port's Workload at e2e-smoke's
    knobs, a toy size, rotation and retention threads running."""
    from cook_tpu.native import consumefold as ref_fold
    from cook_tpu_torch.native import consumefold

    knobs = dict(pools=4, store_shards=4, pipeline_depth=2, native=True)
    was = ref_fold.enabled(), consumefold.enabled()
    ref = {}
    try:
        bench.bench_e2e(P0=1200, H=48, U=12, cycles=3, warmup=1,
                        durability_check=True, consider=64, stats_out=ref,
                        **knobs)
    finally:
        gc.unfreeze()   # bench_e2e's gc discipline freezes the heap
    capsys.readouterr()
    assert ref_fold.enabled() == was[0]
    w = e2e.Workload(P0=1200, H=48, U=12, consider=64, device="cpu",
                     **knobs)
    try:
        w.start_threads()
        r = e2e.run_cycles(w, 3, 1, concurrent=False)
        got = w.durability_check()
    finally:
        w.close()
    assert consumefold.enabled() == was[1]
    for d in (ref["durability_check"], got):
        assert d["acked_all_durable"] and d["state_hash_match"], d
    assert ref["pools"] == 4 and sum(r["matched"]) > 0


def test_e2e_smoke_knobs_follow_bench_py(monkeypatch):
    """e2e-smoke's defaults are bench.py's production shape; bench.py's
    E2E_SMOKE_* variables override them and the flags override those."""
    for k in ("SHARDS", "POOLS", "DEPTH", "NATIVE"):
        monkeypatch.delenv(f"E2E_SMOKE_{k}", raising=False)
    kw = bench_torch.smoke_knobs()
    assert (kw["pools"], kw["store_shards"], kw["pipeline_depth"],
            kw["native"]) == (4, 4, 2, True)
    assert kw["label"].endswith("4 pools x 4 shards, depth 2, native on")
    monkeypatch.setenv("E2E_SMOKE_POOLS", "1")
    monkeypatch.setenv("E2E_SMOKE_NATIVE", "0")
    kw = bench_torch.smoke_knobs(store_shards=1)
    assert (kw["pools"], kw["store_shards"], kw["native"]) == (1, 1, False)
    assert bench_torch.E2E_MODES["e2e-batched"]["sequential_threshold"] \
        == 512
    assert bench_torch.E2E_MODES["longevity"]["cycles"] == 8400


def test_ingest_equals_bench_py(capsys):
    """bench_torch.py ingest at tiny counts acks, and replays cold from
    its log, what bench.py's bench_ingest does: every leg's jobs, every
    acked uuid durable."""
    kw = dict(n_single=12, n_conc=48, n_bulk=256, threads=4, batch=16,
              workers=2)
    ref = {}
    bench.bench_ingest(**kw, stats_out=ref)
    capsys.readouterr()
    got = bench_torch.bench_ingest(**kw, device="cpu")
    assert set(ref) <= set(got)
    assert got["acked_total"] == ref["acked_total"] == 12 + 48 + 256
    assert got["durability_check"] == ref["durability_check"] == {
        "acked_all_durable": True, "acked": 316, "replayed": 316,
        "missing": 0}
    assert got["device"] == {"platform": "cpu"}


# a fleet member's scale (FLEET_BENCH_*), and the cycles that launch:
# at 500 x 50 the first cycle places every job; at 3,000 x 200 each
# cycle places its 1,024 considered jobs until the hosts fill
FLEET_TOYS = {
    "500x50": (dict(P0=500, H=50, U=100, CYCLES=7, WARMUP=2, SHARDS=1), 1),
    "3000x200": (dict(P0=3000, H=200, U=100, CYCLES=5, WARMUP=1,
                      SHARDS=1), 3),
}


@pytest.mark.parametrize("toy", sorted(FLEET_TOYS))
def test_fleet_worker_equals_cook_tpu(capsys, monkeypatch, toy):
    """One fleet member on the CPU at each FLEET_TOYS scale:
    `bench_torch.py fleet-worker` in its own process prints bench.py's
    keys, runs on the device it was given and holds durable
    what it acked; what it launched, cycle by cycle (its
    `launch_digests`), is what bench.py's fleet member
    (bench._fleet_worker on cook_tpu) launches at the same FLEET_BENCH_*
    scale, its job uuids pinned to the port's, and the two end in the
    same pending and running counts. The runs are deterministic at these
    scales: tasks run 10 s of the mock's clock, so none completes within
    the run and no status races a cycle."""
    import subprocess
    from cook_tpu.backends.mock import MockCluster
    from cook_tpu.scheduler.coordinator import Coordinator
    from cook_tpu.state import model

    FLEET_TOY, launching = FLEET_TOYS[toy]

    env = dict(os.environ, FLEET_WORKER_ID="3",
               **{f"FLEET_BENCH_{k}": str(v) for k, v in FLEET_TOY.items()})
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "fleet-worker", "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.abspath(bench_torch.__file__)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = _last_json(proc.stdout)
    for k, v in FLEET_TOY.items():
        monkeypatch.setenv(f"FLEET_BENCH_{k}", str(v))
    monkeypatch.setenv("FLEET_WORKER_ID", "3")
    ref = {}
    monkeypatch.setattr(bench, "bench_e2e", functools.partial(
        bench.bench_e2e, stats_out=ref))
    # bench_e2e's n-th job gets the port workload's n-th uuid; every
    # backend launch is recorded with the match_cycle it ran in
    seq = iter(range(10 ** 6))
    monkeypatch.setattr(model, "new_uuid", lambda: job_uuid(next(seq)))
    launched, marks = [], []
    launch, cycle = MockCluster.launch_tasks, Coordinator.match_cycle

    def launch_tasks(self, pool, specs):
        launched.extend((s.job_uuid, s.hostname) for s in specs)
        return launch(self, pool, specs)

    def match_cycle(self, *a, **kw):
        try:
            return cycle(self, *a, **kw)
        finally:
            marks.append(len(launched))

    monkeypatch.setattr(MockCluster, "launch_tasks", launch_tasks)
    monkeypatch.setattr(Coordinator, "match_cycle", match_cycle)
    try:
        bench._fleet_worker()
    finally:
        gc.unfreeze()   # bench_e2e's gc discipline freezes the heap
    marks.append(len(launched))
    capsys.readouterr()
    assert got["metric"] == ref["metric"] == \
        "sched decisions/sec, fleet member 3"
    assert {"value", "p99_cycle_ms", "phase_means_ms",
            "durability_check"} <= set(got) & set(ref)
    assert got["device"] == {"platform": "cpu"} and got["pools"] == 1
    assert len(marks) == FLEET_TOY["CYCLES"] + 1
    assert got["cycles"] == FLEET_TOY["CYCLES"] - FLEET_TOY["WARMUP"]
    assert got["launch_digests"] == bench_torch.launch_digests(launched,
                                                               marks)
    assert sum(a < b for a, b in zip([0] + marks, marks)) == launching
    assert got["durability_check"] == ref["durability_check"]
    assert got["durability_check"]["acked_all_durable"]
    assert got["durability_check"]["state_hash_match"]


def test_fleet_on_the_cpu(monkeypatch):
    """bench_torch.py fleet at a toy scale: a single member, then two at
    once, each in its own process on the device it was given, every
    one durable; bench.py's keys and gate fields."""
    for k, v in {"P0": 500, "H": 50, "U": 20, "CYCLES": 3,
                 "WARMUP": 1}.items():
        monkeypatch.setenv(f"FLEET_BENCH_{k}", str(v))
    out = bench_torch.bench_fleet(groups=2, device="cpu")
    assert out["durable_ok"] and out["state_hash_match"]
    assert out["groups"] == len(out["per_group"]) == 2
    for g in out["per_group"] + [out["single_leader"]]:
        assert g["platform"] == "cpu" and g["acked_all_durable"]
        assert g["exact_scan_launches"] == 0   # the plain walk on the CPU
    assert out["speedup_gate"]["applied"] == ((os.cpu_count() or 1) >= 2)
    assert out["ok"] == (out["durable_ok"] and out["scale_ok"])
    assert out["worker_scale"]["P0"] == 500
    assert out["compute_mode"] is None and out["device"] == {
        "platform": "cpu"}


def reference_e2e(monkeypatch, capsys, **kw):
    """cook_tpu's bench.py::bench_e2e at `kw` on the CPU, clocks and
    uuids pinned (e2e.pinned_clocks, and cook_tpu's store clock), its
    n-th job given the port workload's n-th uuid and every backend
    launch recorded with the match_cycle it ran in. Returns its printed
    line, its launch digests (per cycle, then the final drain's, as
    bench_torch.launch_digests) and the decisions its metrics registry
    recorded. Unpinned, both packages' launches from the second cycle
    on follow the wall clock (submit and start times in ms)."""
    from cook_tpu.backends.mock import MockCluster
    from cook_tpu.scheduler.coordinator import Coordinator
    from cook_tpu.state import model
    from cook_tpu.utils.metrics import registry

    def recorded():
        return sum(v["value"] for k, v in registry.snapshot().items()
                   if k.startswith("decisions_total"))

    seq = iter(range(10 ** 6))
    launched, marks = [], []
    launch, cycle = MockCluster.launch_tasks, Coordinator.match_cycle

    def launch_tasks(self, pool, specs):
        launched.extend((s.job_uuid, s.hostname) for s in specs)
        return launch(self, pool, specs)

    def match_cycle(self, *a, **k):
        try:
            return cycle(self, *a, **k)
        finally:
            marks.append(len(launched))

    with monkeypatch.context() as m:
        m.setattr(model, "new_uuid", lambda: job_uuid(next(seq)))
        m.setattr(MockCluster, "launch_tasks", launch_tasks)
        m.setattr(Coordinator, "match_cycle", match_cycle)
        ref, before = {}, recorded()
        with e2e.pinned_clocks():
            model.set_clock(lambda: e2e.PINNED_WALL_S)
            try:
                bench.bench_e2e(stats_out=ref, **kw)
            finally:
                model.reset_clock()
                gc.unfreeze()   # bench_e2e's gc discipline freezes the heap
    marks.append(len(launched))
    capsys.readouterr()
    return ref, bench_torch.launch_digests(launched, marks), \
        recorded() - before


# bench.py main()'s e2e-small and e2e-batched settings at a toy scale
# where every cycle places jobs and none completes (tasks run 10 s of
# the mock's clock)
E2E_PARITY = {
    "e2e-small": {},
    "e2e-batched": {"sequential_threshold": 512},
}


@pytest.mark.parametrize("mode", sorted(E2E_PARITY))
def test_e2e_cycles_and_launches_equal_cook_tpu(monkeypatch, capsys, mode):
    """bench_torch.bench_e2e counts cycles as bench.py's bench_e2e does
    (`cycles` in all, the first `warmup` untimed) and launches what it
    launches, cycle by cycle, at the mode's knobs, both with clocks and
    uuids pinned: equal launch digests (the inline consumer), equal
    timed cycles and matched per cycle."""
    kw = dict(P0=3000, H=200, U=100, cycles=5, warmup=2, **E2E_PARITY[mode])
    ref, want, _ = reference_e2e(monkeypatch, capsys, **kw)
    with e2e.pinned_clocks():
        got = bench_torch.bench_e2e(device="cpu", digests=True, **kw)
    capsys.readouterr()
    assert len(want) == kw["cycles"] + 1
    assert got["launch_digests"] == want
    assert got["cycles"] == ref["cycles"] == kw["cycles"] - kw["warmup"]
    assert got["matched_per_cycle"] == pytest.approx(
        ref["matched_per_cycle"], abs=0.05)
    assert got["sequential"] == (mode == "e2e-small")
