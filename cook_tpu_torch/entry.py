"""Entry points: the fused cycle and a populated resident pool.

entry(device)          -> (fn, args): `rank_and_match` with the exact_scan
                          kernel on, and the arguments of
                          `cycle_args()` (the counterpart of
                          __graft_entry__.entry()).
cycle_args(...)        -> the seeded `rank_and_match` workload; the base
                          draws are those of __graft_entry__._cycle_args
                          and bench.py::_cycle_setup, so both packages
                          can be fed the same numbers.
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
                 ports=False, est=False):
    """numpy (args, kwargs) of one `rank_and_match` call. The first draws
    replay __graft_entry__._cycle_args exactly; the optional lanes
    (a constrained share of pending jobs with a dense forbidden mask,
    ports, estimated completion) are drawn after them."""
    rng = np.random.default_rng(seed)
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


def entry(device="cuda"):
    """(fn, args): the fused cycle with the exact_scan kernel on."""
    args, _ = cycle_args(device=device)
    fn = functools.partial(cycle_ops.rank_and_match, num_considerable=256,
                           use_kernel=True)
    return fn, args


class ResidentWorkload:
    """A resident pool at a given scale with a seeded delta stream.

    Sizing follows the reference's rebuild (resident.py:557-570) with a
    pipeline depth of 2: Pcap = bucket(P + P/5 + 2C), Rcap = bucket(
    max(R + R/5 + 2C, P/8)), Hcap = bucket(H). Hosts and running tasks
    follow bench.py::_cycle_setup's ranges; `constrained` of the pending
    jobs own a forbidden row (FORBID_DENSITY of the hosts); `ports` and
    `est` switch on the ports and estimated-completion lanes. Each
    `cycle()` ships the deltas marked since the last one, runs one
    `device_cycle`, reads back the matched prefix, and then advances the
    stream from that result: matched jobs become running tasks, C
    running tasks finish (crediting their hosts), and as
    many new pending jobs arrive as rows were freed.
    """

    def __init__(self, R=10_000, P=100_000, H=10_000, U=500, C=1024,
                 forb_cap=4096, constrained=0.02, ports=True, est=True,
                 seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.U, self.C, self.H = U, C, H
        self.constrained = constrained
        self.ports = ports
        self.now_s = 0
        head = 2 * C
        Pcap = bucket(max(P + P // 5 + head, 1024))
        Rcap = bucket(max(R + R // 5 + head, P // 8, 1024))
        Hcap = max(bucket(H), 64)
        rs = self.rs = ResidentState(Pcap, Rcap, Hcap, forb_cap=forb_cap,
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
        rm = rs.run_m
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
        pm = rs.pend_m
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
            rs.forb_m[slots] = (rng.random((len(con), rs.Hcap))
                                < FORBID_DENSITY)
            rs.mark_forb(slots)
        rs.mark_pend(rows)

    def advance(self, mat_idx: np.ndarray, mat_host: np.ndarray) -> None:
        """Fold one cycle's readback into the mirrors and mark the next
        cycle's deltas."""
        rng, rs = self.rng, self.rs
        pm, rm = rs.pend_m, rs.run_m
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
        out = rs.dispatch(bundle, self.qm, self.qc, self.qn, self.C,
                          self.now_s, self.C, use_kernel=use_kernel,
                          sequential=sequential, match_kw=match_kw)
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
