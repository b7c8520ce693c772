"""Entry points: the fused cycle and a populated resident pool.

entry(device)          -> (fn, args): `rank_and_match` with the exact_scan
                          kernel on, and the arguments of
                          `cycle_args()` (the counterpart of
                          __graft_entry__.entry()).
cycle_args(...)        -> the seeded `rank_and_match` workload; the base
                          draws are those of __graft_entry__._cycle_args
                          and bench.py::_cycle_setup, so both packages
                          can be fed the same numbers.
rebalance_args(...)    -> the seeded `rebalance` workload of
                          bench.py::bench_rebalance (same draws, same
                          order), optionally laid out as a gpu-mode pool.
ResidentWorkload(...)  -> a populated `ResidentState` plus a seeded stream
                          of per-cycle deltas: completions credit hosts,
                          matched jobs start running, new pending jobs
                          (some constrained) arrive. Each cycle takes the
                          coordinator's matcher for its C: sequential up
                          to SEQUENTIAL_MATCH_THRESHOLD, `match_rounds`
                          beyond.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device
from cook_tpu_torch.ops import cycle as cycle_ops
from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.scheduler.resident import (EST_NEVER, ResidentState,
                                               RUN_FIELDS)
from cook_tpu_torch.scheduler.tensorize import F32_MAX, bucket

INF = np.float32(3.4e38)
# resident workload mix: shares of gpu hosts and gpu jobs, and the share
# of hosts each constrained job forbids
GPU_HOSTS, GPU_JOBS, FORBID_DENSITY = 0.05, 0.01, 0.05
# a data-local job's bonus: the hosts of its dataset's replicas (HDFS's
# default replication) and the largest bonus, w * (1 - cost) with costs
# in [0, 1] and a locality weight (0.25 by default, config.clj:418-428)
# of at most 0.3
LOCALITY_HOSTS, LOCALITY_MAX = 3, 0.3

# the coordinator's matcher choice (a copy of cook_tpu's
# SchedulerConfig.sequential_match_threshold and the dispatch at
# coordinator.py:898-905): the exact sequential walk for a considerable
# batch of at most this many jobs, the batched match_rounds beyond
SEQUENTIAL_MATCH_THRESHOLD = 2048
# the coordinator's audit-gated exact-head ladder for match_rounds
# (AdaptiveHead, coordinator.py:162-164) and its starting rung, which is
# also match_rounds' default head_exact
HEAD_LADDER = (0, 64, 128, 256)
HEAD_START = 256


def sequential_for(num_considerable: int) -> bool:
    """True when the coordinator matches a batch of this size with the
    sequential walk, False when it takes match_rounds."""
    return num_considerable <= SEQUENTIAL_MATCH_THRESHOLD


def cycle_arrays(R=256, Pn=512, H=64, U=16, seed=0, constrained=0.0,
                 ports=False, est=False, rng=None):
    """numpy (args, kwargs) of one `rank_and_match` call. The first draws
    replay __graft_entry__._cycle_args exactly; the optional lanes
    (a constrained share of pending jobs with a dense forbidden mask,
    ports, estimated completion) are drawn after them. `rng` continues
    a stream (pools drawn one after another) instead of `seed`."""
    rng = np.random.default_rng(seed) if rng is None else rng
    f32, i32 = np.float32, np.int32
    args = [
        rng.integers(0, U, R).astype(i32),
        rng.uniform(1, 10, R).astype(f32),
        rng.uniform(1, 4, R).astype(f32),
        rng.integers(0, 3, R).astype(i32),
        rng.integers(0, 100, R).astype(i32),
        rng.random(R) < 0.8,
        np.full(R, 100.0, f32),
        np.full(R, 20.0, f32),
        rng.integers(0, U, Pn).astype(i32),
        rng.uniform(1, 10, Pn).astype(f32),
        rng.uniform(0.5, 4, Pn).astype(f32),
        np.zeros(Pn, f32),
        rng.integers(0, 3, Pn).astype(i32),
        rng.integers(100, 200, Pn).astype(i32),
        rng.random(Pn) < 0.9,
        np.full(Pn, 100.0, f32),
        np.full(Pn, 20.0, f32),
        np.full(Pn, -1, i32),
        np.zeros(Pn, bool),
    ]
    h_mem = rng.uniform(20, 60, H).astype(f32)
    h_cpus = rng.uniform(8, 24, H).astype(f32)
    hosts = dict(mem=h_mem, cpus=h_cpus, gpus=np.zeros(H, f32),
                 cap_mem=h_mem, cap_cpus=h_cpus, cap_gpus=np.zeros(H, f32),
                 valid=np.ones(H, bool),
                 task_slots=np.full(H, 10_000, i32))
    forb = np.zeros((Pn, H), bool)
    kwargs = {}
    if constrained:
        rows = rng.random(Pn) < constrained
        forb[rows] = rng.random((int(rows.sum()), H)) < 0.25
    if ports:
        kwargs["pend_ports"] = (rng.integers(0, 3, Pn)
                                * (rng.random(Pn) < 0.3)).astype(i32)
        kwargs["host_ports"] = rng.integers(0, 4, H).astype(i32)
    if est:
        kwargs["pend_est_s"] = np.where(rng.random(Pn) < 0.3,
                                        rng.integers(60, 3600, Pn),
                                        0).astype(i32)
        kwargs["host_death_s"] = np.where(rng.random(H) < 0.3,
                                          rng.integers(100, 4000, H),
                                          EST_NEVER).astype(i32)
        kwargs["now_s"] = np.int32(50)
    quotas = [np.full(U, INF), np.full(U, INF), np.full(U, 1e9, f32)]
    return args + [hosts, forb] + quotas, kwargs


def cycle_args(R=256, Pn=512, H=64, U=16, seed=0, device="cuda", **opts):
    """Tensors on `device` of `cycle_arrays(...)`: (args, kwargs)."""
    dev = resolve_device(device)
    arrays, kw = cycle_arrays(R, Pn, H, U, seed, **opts)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    args = [match_ops.Hosts(**{k: t(v) for k, v in a.items()})
            if isinstance(a, dict) else t(a) for a in arrays]
    return tuple(args), {k: t(v) for k, v in kw.items()}


def pool_cycle_args(n_pools, R=256, Pn=512, H=64, U=16, seed=0,
                    device="cuda"):
    """`n_pools` pools of `cycle_arrays` drawn one after another from one
    seeded stream (__graft_entry__._cycle_args with n_pools), stacked on
    a leading pools axis as tensors on `device`: the arguments of a
    parallel.pools / parallel.federation cycle."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    parts = [cycle_arrays(R, Pn, H, U, rng=rng)[0] for _ in range(n_pools)]

    def stack(xs):
        return torch.from_numpy(np.stack(xs)).to(dev)

    return tuple(
        match_ops.Hosts(**{k: stack([x[k] for x in col]) for k in col[0]})
        if isinstance(col[0], dict) else stack(col)
        for col in zip(*parts))


def entry(device="cuda"):
    """(fn, args): the fused cycle with the exact_scan kernel on."""
    args, _ = cycle_args(device=device)
    fn = functools.partial(cycle_ops.rank_and_match, num_considerable=256,
                           use_kernel=True)
    return fn, args


def rebalance_arrays(T0=50_000, P=64, H=2_000, U=500, seed=0, gpu=False):
    """numpy inputs of one `rebalance` call: bench.py::bench_rebalance's
    draws in its order (T0 running tasks, P pending jobs in the trailing
    slots, H hosts, U users; safe_dru_threshold 0.5 and min_dru_diff 0.1
    go with them). `gpu` lays the pool out as the coordinator's
    rebalance_cycle does for a gpu-mode pool (coordinator.py:2113-2140),
    from draws made after the others: 1-3 gpus a task and a job, 0-2
    spare a host, gpus in the mem lane over a gpu share of 8, a zero cpus
    lane, and the real (mem, cpus) as two feasibility lanes. Returns
    (tasks, pending, spare_mem, spare_cpus, forbidden, quota mem, cpus,
    count) as dicts and arrays, and the spare extra lanes or None."""
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32
    T = T0 + P
    tasks = dict(
        user=np.concatenate([rng.integers(0, U, T0), np.zeros(P)]),
        mem=np.concatenate([rng.uniform(1, 10, T0), np.zeros(P)]),
        cpus=np.concatenate([rng.uniform(0.5, 4, T0), np.zeros(P)]),
        priority=np.zeros(T), start_time=np.arange(T),
        host=np.concatenate([rng.integers(0, H, T0), np.zeros(P)]),
        valid=np.arange(T) < T0,
        mem_share=np.full(T, 100.0), cpus_share=np.full(T, 20.0))
    pending = dict(
        user=rng.integers(0, U, P), mem=rng.uniform(1, 10, P),
        cpus=rng.uniform(0.5, 4, P), priority=np.zeros(P),
        start_time=np.arange(P) + T, valid=np.ones(P, bool),
        mem_share=np.full(P, 100.0), cpus_share=np.full(P, 20.0))
    spare_mem = rng.uniform(0, 4, H)
    spare_cpus = rng.uniform(0, 2, H)
    spare_extra = None
    if gpu:
        for d, n in ((tasks, T0), (pending, P)):
            gpus = rng.integers(1, 4, n).astype(f32)
            if d is tasks:
                gpus = np.concatenate([gpus, np.zeros(P, f32)])
            d["extra"] = np.stack([d["mem"], d["cpus"]], -1).astype(f32)
            d["mem"], d["cpus"] = gpus, np.zeros_like(gpus)
            d["mem_share"] = np.full(len(gpus), 8.0)
        spare_extra = np.stack([spare_mem, spare_cpus], -1).astype(f32)
        spare_mem = rng.integers(0, 3, H)
        spare_cpus = np.zeros(H)
    ints = ("user", "priority", "start_time", "host")
    for d in (tasks, pending):
        for k, v in d.items():
            d[k] = v if v.dtype == bool else v.astype(
                i32 if k in ints else f32)
    return (tasks, pending, spare_mem.astype(f32), spare_cpus.astype(f32),
            np.zeros((P, H), bool), np.full(U, INF), np.full(U, INF),
            np.full(U, 2.0 ** 31, f32)), spare_extra


def rebalance_args(T0=50_000, P=64, H=2_000, U=500, seed=0, gpu=False,
                   device="cuda"):
    """Tensors on `device` of `rebalance_arrays(...)`: (args, kwargs) of
    `ops.rebalance.rebalance(*args, safe_dru_threshold,
    min_dru_diff, **kwargs)`."""
    from cook_tpu_torch.ops import rebalance as reb

    dev = resolve_device(device)
    arrays, spare_extra = rebalance_arrays(T0, P, H, U, seed, gpu)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tasks, pending = ({k: t(v) for k, v in d.items()} for d in arrays[:2])
    args = (reb.TaskState(**tasks), reb.PendingJobs(**pending),
            *(t(a) for a in arrays[2:]))
    return args, ({} if spare_extra is None
                  else {"spare_extra": t(spare_extra)})


class ResidentWorkload:
    """A resident pool at a given scale with a seeded delta stream.

    Sizing follows the reference's rebuild (resident.py:557-570) with a
    pipeline depth of 2: Pcap = bucket(P + P/5 + 2C), Rcap = bucket(
    max(R + R/5 + 2C, P/8)), Hcap = bucket(H). Hosts and running tasks
    follow bench.py::_cycle_setup's ranges; `constrained` of the pending
    jobs own a forbidden row (FORBID_DENSITY of the hosts); `ports` and
    `est` switch on the ports and estimated-completion lanes.
    `groups=(share, size)` puts that share of the arriving pending jobs
    into host-placement-unique groups of `size` members each (Spark
    executors: one a host), with dense group ids minted in arrival order
    and the cycle's num_groups the resident pool's rule (1 without
    groups, else bucket(groups seen)); `locality` gives that share of
    them a sparse data-locality bonus row (U(0, LOCALITY_MAX) on the
    LOCALITY_HOSTS hosts that hold their dataset's replicas, 0
    elsewhere), shipped as the resident pool ships them. Each
    `cycle()` ships the deltas marked since the last one, runs one
    `device_cycle`, reads back the matched prefix, and then advances the
    stream from that result: matched jobs become running tasks, C
    running tasks finish (crediting their hosts), and as
    many new pending jobs arrive as rows were freed.
    """

    def __init__(self, R=10_000, P=100_000, H=10_000, U=500, C=1024,
                 forb_cap=4096, constrained=0.02, ports=True, est=True,
                 groups=None, locality=0.0, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.U, self.C, self.H = U, C, H
        self.constrained = constrained
        self.ports = ports
        self.group_share, self.group_size = groups or (0.0, 1)
        self.grouped_jobs = 0       # jobs given a group so far
        self.locality = locality
        self.now_s = 0
        head = 2 * C
        Pcap = bucket(max(P + P // 5 + head, 1024))
        Rcap = bucket(max(R + R // 5 + head, P // 8, 1024))
        Hcap = max(bucket(H), 64)
        bonus_cap = bucket(int(locality * (P + P // 5))) if locality else 1
        rs = self.rs = ResidentState(Pcap, Rcap, Hcap, forb_cap=forb_cap,
                                     bonus_cap=bonus_cap,
                                     with_bonus=bool(locality),
                                     with_est=est, device=self.device)
        rng = self.rng

        # hosts
        hm = rs.host_m
        gpu = rng.random(H) < GPU_HOSTS
        hm["cap_mem"][:H] = rng.uniform(64, 256, H)
        hm["cap_cpus"][:H] = rng.uniform(16, 64, H)
        hm["cap_gpus"][:H] = np.where(gpu, rng.choice([4.0, 8.0], H), 0.0)
        hm["valid"][:H] = True
        hm["task_slots"][:H] = 10_000
        hm["ports"][:H] = 1000 if ports else 0
        if est:
            hm["death_s"][:H] = np.where(rng.random(H) < 0.1,
                                         rng.integers(600, 7200, H),
                                         EST_NEVER)

        # running tasks, each on a host; availability = cap - usage
        rm = rs._run_m
        rm["user"][:R] = rng.integers(0, U, R)
        rm["mem"][:R] = rng.uniform(1, 10, R)
        rm["cpus"][:R] = rng.uniform(1, 4, R)
        rm["priority"][:R] = rng.integers(0, 3, R)
        rm["start_time"][:R] = rng.integers(0, 100, R)
        rm["valid"][:R] = True
        rm["mem_share"][:R] = 1000.0
        rm["cpus_share"][:R] = 200.0
        self.run_host = np.full(Rcap, -1, np.int64)
        self.run_host[:R] = rng.integers(0, H, R)
        self.run_ports = np.zeros(Rcap, np.int32)
        hm["mem"][:H] = np.maximum(hm["cap_mem"][:H] - np.bincount(
            self.run_host[:R], rm["mem"][:R], minlength=H), 0)
        hm["cpus"][:H] = np.maximum(hm["cap_cpus"][:H] - np.bincount(
            self.run_host[:R], rm["cpus"][:R], minlength=H), 0)
        hm["gpus"][:H] = hm["cap_gpus"][:H]
        self.run_free = list(range(Rcap - 1, R - 1, -1))

        # pending jobs
        self.pend_free = list(range(Pcap - 1, -1, -1))
        self.forb_free = list(range(forb_cap - 1, -1, -1))
        self.bonus_free = list(range(rs.bonus_cap - 1, -1, -1))
        self._arrive(P)

        # per-user quotas: a tenth of the users are capped near their
        # running count, so the quota gate and its provenance codes fire
        qn = np.full(U, 1e9, np.float32)
        capped = rng.random(U) < 0.1
        qn[capped] = rng.integers(5, 40, int(capped.sum()))
        d = self.device
        self.qm = torch.full((U,), float(INF), device=d)
        self.qc = torch.full((U,), float(INF), device=d)
        self.qn = torch.from_numpy(qn).to(d)
        rs.upload()

    def _arrive(self, n: int) -> None:
        """n new pending jobs into free rows (marked for shipping)."""
        rng, rs = self.rng, self.rs
        n = min(n, len(self.pend_free))
        rows = np.asarray([self.pend_free.pop() for _ in range(n)],
                          np.int64)
        pm = rs._pend_m
        pm["user"][rows] = rng.integers(0, self.U, n)
        pm["mem"][rows] = rng.uniform(1, 10, n)
        pm["cpus"][rows] = rng.uniform(0.5, 4, n)
        pm["gpus"][rows] = np.where(rng.random(n) < GPU_JOBS, 1.0, 0.0)
        pm["priority"][rows] = rng.integers(0, 3, n)
        pm["start_time"][rows] = 100 + self.now_s
        pm["valid"][rows] = True
        pm["mem_share"][rows] = 1000.0
        pm["cpus_share"][rows] = 200.0
        pm["ports"][rows] = (rng.integers(1, 3, n) * (rng.random(n) < 0.1)
                             if self.ports else 0)
        pm["est_s"][rows] = np.where(rng.random(n) < 0.2,
                                     rng.integers(60, 3600, n), 0)
        pm["forb_slot"][rows] = -1
        con = rows[rng.random(n) < self.constrained]
        con = con[:len(self.forb_free)]
        if len(con):
            slots = np.asarray([self.forb_free.pop() for _ in con])
            pm["forb_slot"][con] = slots
            rs._forb_rows_m[slots] = (rng.random((len(con), rs.Hcap))
                                < FORBID_DENSITY)
            rs.mark_forb(slots)
        pm["group"][rows] = -1
        pm["unique_group"][rows] = False
        if self.group_share:
            grouped = rows[rng.random(n) < self.group_share]
            pm["group"][grouped] = (self.grouped_jobs + np.arange(
                len(grouped))) // self.group_size
            pm["unique_group"][grouped] = True
            self.grouped_jobs += len(grouped)
        pm["bonus_slot"][rows] = -1
        if self.locality:
            loc = rows[rng.random(n) < self.locality]
            loc = loc[:len(self.bonus_free)]
            slots = np.asarray([self.bonus_free.pop() for _ in loc],
                               np.int64)
            pm["bonus_slot"][loc] = slots
            rs._bonus_rows_m[slots] = 0.0
            hosts = rng.integers(0, self.H, (len(loc), LOCALITY_HOSTS))
            rs._bonus_rows_m[slots[:, None], hosts] = rng.uniform(
                0, LOCALITY_MAX, hosts.shape)
            rs.mark_bonus(slots)
        rs.mark_pend(rows)

    @property
    def num_groups(self) -> int:
        """The cycle's group bound, the resident pool's rule
        (resident.py:1387-1389): 1 without groups, else the bucket of
        the groups minted so far."""
        n = -(-self.grouped_jobs // self.group_size)
        return 1 if n == 0 else bucket(n)

    def advance(self, mat_idx: np.ndarray, mat_host: np.ndarray) -> None:
        """Fold one cycle's readback into the mirrors and mark the next
        cycle's deltas."""
        rng, rs = self.rng, self.rs
        pm, rm = rs._pend_m, rs._run_m
        # completions first (tasks started this cycle keep running)
        live = np.flatnonzero(rm["valid"])
        done = rng.choice(live, min(self.C, len(live)), replace=False)
        for r in done:
            h = int(self.run_host[r])
            rs.credit(h, float(rm["mem"][r]), float(rm["cpus"][r]),
                      float(rm["gpus"][r]), 1, int(self.run_ports[r]))
            self.run_free.append(int(r))
        rm["valid"][done] = False
        rs.mark_run(done)
        # matched jobs leave the pending table and start running
        pm["valid"][mat_idx] = False
        for p, h in zip(mat_idx.tolist(), mat_host.tolist()):
            if pm["forb_slot"][p] >= 0:
                self.forb_free.append(int(pm["forb_slot"][p]))
            if pm["bonus_slot"][p] >= 0:
                self.bonus_free.append(int(pm["bonus_slot"][p]))
            self.pend_free.append(p)
            if not self.run_free:
                continue
            r = self.run_free.pop()
            for f in RUN_FIELDS:
                rm[f][r] = pm[f][p]
            self.run_host[r] = h
            self.run_ports[r] = pm["ports"][p]
            rs.mark_run([r])
        self.now_s += 10
        self._arrive(len(mat_idx))

    def cycle(self, use_kernel: bool = True, sequential=None,
              match_kw=None):
        """Ship, run one device cycle, read back, advance. Returns
        (device outputs, mat_idx, mat_host). `sequential` defaults to
        the coordinator's choice for C (`sequential_for`); `match_kw`
        goes to match_rounds."""
        rs = self.rs
        if sequential is None:
            sequential = sequential_for(self.C)
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        bundle = rs.ship(rs.drain())
        t1 = time.perf_counter()
        out = rs.run_cycle(bundle, self.qm, self.qc, self.qn, self.C,
                           self.now_s, self.C, num_groups=self.num_groups,
                           use_kernel=use_kernel, sequential=sequential,
                           match_kw=match_kw)
        mat_idx, mat_host = rs.readback(out)
        t2 = time.perf_counter()
        if cuda:
            ev[1].record()
        self.advance(mat_idx, mat_host)
        t3 = time.perf_counter()
        # host-clock phases of this cycle: pack + upload the deltas, run
        # the device cycle through the prefix readback (which waits for
        # the device), fold the result into the seeded stream
        self.timing = {"ship_ms": (t1 - t0) * 1e3,
                       "cycle_ms": (t2 - t1) * 1e3,
                       "advance_ms": (t3 - t2) * 1e3}
        if cuda:
            # CUDA events from before the delta upload to after the
            # prefix readback, on the current stream
            ev[1].synchronize()
            self.timing["event_ms"] = ev[0].elapsed_time(ev[1])
        return out, mat_idx, mat_host


def resident_workload(**kw) -> ResidentWorkload:
    """A populated resident pool plus its seeded delta stream (see
    `ResidentWorkload`; defaults are the 100k-pending x 10k-host
    deployment: R=10,000, P=100,000, H=10,000, U=500, C=1024, the
    sequential path; C=8192 is BASELINE's headline batched cycle,
    bench.py `bench_cycle`)."""
    return ResidentWorkload(**kw)


def dryrun_multichip(n_devices: int, device="cuda", devices=None) -> None:
    """__graft_entry__.dryrun_multichip on the port: one step each of the
    mesh paths over `n_devices` shards, at tiny shapes, printing the
    reference's line. The shards are the first `n_devices` visible
    devices of type `device` (raises when fewer are visible), or an
    explicit `devices` list, which may repeat a device (`[cpu] * 8`, or
    four shards on one card).

    1. the pool-sharded cycle with psum totals;
    2. the host-sharded greedy match, 4 unique placement groups;
    3. the federated 2-D (slice x pools) cycle, when n is even and >= 4;
    4. a Coordinator with one resident pool per mesh device, running
       cycles and launching, completions flowing back;
    5. ONE resident pool sharded over all the shards through the
       Coordinator, launching what the single-device pool launches, its
       unique group on distinct hosts."""
    from cook_tpu_torch.backends.base import ClusterRegistry
    from cook_tpu_torch.backends.mock import MockCluster, MockHost
    from cook_tpu_torch.parallel import pools as pool_par
    from cook_tpu_torch.parallel import sharded_match, visible_devices
    from cook_tpu_torch.scheduler.coordinator import (Coordinator,
                                                      SchedulerConfig)
    from cook_tpu_torch.state.model import Group, Job, JobState, new_uuid
    from cook_tpu_torch.state.pools import Pool, PoolRegistry
    from cook_tpu_torch.state.store import JobStore

    devs = (visible_devices(n_devices, device) if devices is None
            else [resolve_device(d) if not isinstance(d, torch.device)
                  else d for d in devices])
    if len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    devs = devs[:n_devices]

    # 1. pool-sharded full cycle with psum aggregates
    mesh = pool_par.make_pool_mesh(devices=devs)
    runner = pool_par.pool_sharded_cycle(mesh, num_considerable=32)
    out = runner(pool_cycle_args(n_devices, R=32, Pn=48, H=8, U=4,
                                 device=devs[0]))
    assert int(out.stats.total_matched) >= 0

    # 2. host-sharded distributed greedy match, unique host-placement
    # groups riding the sharded path (per-shard occupancy)
    hmesh = sharded_match.make_host_mesh(devices=devs)
    fn = sharded_match.sharded_match_scan(hmesh, num_groups=4)
    rng = np.random.default_rng(1)
    N, H = 32, 2 * n_devices
    grp = rng.integers(-1, 4, N).astype(np.int32)
    jobs = match_ops.make_jobs(
        mem=rng.uniform(1, 20, N).astype(np.float32),
        cpus=rng.uniform(0.5, 8, N).astype(np.float32),
        group=grp, unique_group=grp >= 0, device=devs[0])
    hosts = match_ops.make_hosts(
        mem=rng.uniform(30, 100, H).astype(np.float32),
        cpus=rng.uniform(8, 32, H).astype(np.float32), device=devs[0])
    res = fn(jobs, hosts, torch.zeros((N, H), dtype=torch.bool,
                                      device=devs[0])).job_host.cpu().numpy()

    # 3. multi-slice federation: 2-D (slice x pools) mesh with
    # hierarchical psums, when the device count splits into two axes
    fed_matched = "skipped"
    if n_devices >= 4 and n_devices % 2 == 0:
        from cook_tpu_torch.parallel import federation
        fmesh = federation.make_federation_mesh(2, n_devices // 2,
                                                devices=devs)
        frunner = federation.federated_cycle(fmesh, num_considerable=32)
        fout = frunner(federation.slice_args(pool_cycle_args(
            n_devices, R=32, Pn=48, H=8, U=4, device=devs[0]), 2))
        assert int(fout.stats.per_slice_matched.sum()) == \
            int(fout.stats.total_matched)
        fed_matched = int(fout.stats.total_matched)

    # 4. the production path: a real Coordinator (store, mock backend,
    # resident pools pinned one per mesh device) runs match cycles and
    # launches through the bulk transaction; completions flow back
    store = JobStore()
    pools = PoolRegistry("pool0")
    mhosts = []
    for p in range(n_devices):
        pools.add(Pool(name=f"pool{p}"))
        mhosts += [MockHost(f"p{p}h{i}", mem=1000, cpus=16,
                            pool=f"pool{p}") for i in range(2)]
    cluster = MockCluster(mhosts, runtime_fn=lambda s: (5.0, True, None))
    reg = ClusterRegistry()
    reg.register(cluster)
    coord = Coordinator(store, reg, pools=pools,
                        config=SchedulerConfig(max_jobs_considered=64),
                        device=devs[0])
    for p in range(n_devices):
        coord.enable_resident(f"pool{p}", synchronous=True, device=devs[p])
    rng2 = np.random.default_rng(2)
    js = [Job(uuid=new_uuid(), user=f"u{int(rng2.integers(0, 4))}",
              command="true", mem=float(rng2.uniform(10, 200)),
              cpus=float(rng2.uniform(0.5, 4)), pool=f"pool{i % n_devices}")
          for i in range(8 * n_devices)]
    store.create_jobs(js)
    launched = completed = 0
    for _ in range(4):
        for p in range(n_devices):
            launched += coord.match_cycle(f"pool{p}").matched
        completed += cluster.advance(3.0)
    coord.drain_resident()
    assert launched > 0, "resident coordinator launched nothing"
    assert completed > 0, "no completions flowed back"
    # every pool's resident tensors live on the device it was given
    for p in range(n_devices):
        placed = coord._resident[f"pool{p}"].state["pend"]["mem"].device
        assert placed == devs[p], (p, placed, devs[p])
    n_running = sum(j.state == JobState.RUNNING for j in js)
    coord.stop()

    # 5. ONE production pool spanning ALL the shards: its host and mask
    # tensors sharded, dispatch running the distributed scan through the
    # Coordinator; the launch set equals the single-device oracle,
    # a unique-host-placement group included
    def shard_scenario(shards):
        st = JobStore()
        pl = PoolRegistry("big")
        pl.add(Pool(name="big"))
        cl = MockCluster([MockHost(f"bh{i}", mem=500, cpus=8, pool="big")
                          for i in range(6)],
                         runtime_fn=lambda s: (30.0, True, None))
        rg = ClusterRegistry()
        rg.register(cl)
        co = Coordinator(st, rg, pools=pl,
                         config=SchedulerConfig(max_jobs_considered=64),
                         device=devs[0])
        co.enable_resident("big", synchronous=True, devices=shards)
        rr = np.random.default_rng(7)
        g = Group(uuid=new_uuid(), name="g",
                  host_placement={"type": "unique"})
        jb = [Job(uuid=new_uuid(), user=f"u{int(rr.integers(0, 3))}",
                  command="true", mem=float(rr.uniform(20, 120)),
                  cpus=float(rr.uniform(0.5, 3)), pool="big")
              for _ in range(20)]
        gs = [Job(uuid=new_uuid(), user="u0", command="true", mem=30.0,
                  cpus=1.0, pool="big", group=g.uuid) for _ in range(4)]
        st.create_jobs(jb + gs, groups=[g])
        co.match_cycle("big")
        hostset = sorted(j.instances[0].hostname for j in jb + gs
                         if j.instances)
        ghosts = [j.instances[0].hostname for j in gs if j.instances]
        rp = co._resident["big"]
        co.stop()
        return hostset, ghosts, rp

    sharded_hosts, sharded_ghosts, srp = shard_scenario(devs)
    oracle_hosts, _, _ = shard_scenario(None)
    assert sharded_hosts == oracle_hosts, (sharded_hosts, oracle_hosts)
    assert len(sharded_ghosts) == len(set(sharded_ghosts)), sharded_ghosts
    shards = list(srp.mesh.devices.flat)
    assert [h["mem"].device for h in srp.state["host"]] == shards == devs

    print(f"dryrun_multichip({n_devices}): pool-sharded cycle matched "
          f"{int(out.stats.total_matched)}; host-sharded match placed "
          f"{int((res >= 0).sum())}/{N}; federated 2d mesh "
          f"matched {fed_matched}; resident coordinator on {n_devices} "
          f"devices launched {launched} (completed {completed}, running "
          f"{n_running}, one pool per device); ONE pool sharded over "
          f"{len(shards)} devices launched {len(sharded_hosts)} == "
          f"single-device oracle, unique group on "
          f"{len(set(sharded_ghosts))} distinct hosts")
