#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cook_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and exits non-zero
   when torch sees no CUDA device.
2. Builds the CUDA kernels from csrc/ (nvcc, first use, one process per
   source, all started together) and prints the build seconds.
3. Holds each kernel against its plain PyTorch version on the card:
   - exact_scan at S=1024 jobs x H=16384 hosts (the sequential path's
     shape) with a mixed workload, and three adversarial cases (all
     hosts identical, all jobs infeasible, H = 16411). job_host must be
     equal and the (16, H) host stack bit-equal.
   - best_host at D=1024 rows x H=16384 hosts (the batched path's dense
     prefix) on the same mix: no bonus at spread 0.2 and 0, and a
     U(0, 0.5) bonus at spread 0; adversarial: all hosts identical (the
     lowest index wins across every block), all rows infeasible,
     H = 16411, N = 200. best_host must be equal and best_fit bit-equal.
   Both kernels round every f32 op like their plain versions (no FMA
   contraction, IEEE division).
4. The sequential path: a device-resident pool of 100,000 pending x
   10,000 hosts (Pcap 131072, Hcap 16384), 10,000 running, 500 users,
   C=1024 considered per cycle (the coordinator's sequential matcher),
   2% of pending jobs constrained, the ports and estimated-completion
   lanes on, no bonus. CYCLES cycles through `device_cycle`; the
   exact_scan counter must rise by one per cycle. Checks: jobs matched,
   no host lane below -eps, matched rows invalid afterwards. The first
   REPLAY cycles are replayed from the same seed through the same entry
   point with the kernel wrappers routed to their plain versions;
   mat_idx / mat_host / why_code must agree.
5. The batched path: the same deployment at C=8192 considered per cycle
   (BASELINE's headline cycle, bench.py `bench_cycle`; Pcap 262144,
   Rcap 32768, Hcap 16384), so the coordinator's choice is match_rounds
   with its 256-job exact head. BATCHED cycles with the kernels on; each
   must launch exact_scan once (the head) and best_host at least once
   (the dense rounds), keep every host lane >= -1e-6 and slot count
   >= 0, leave no matched row valid, and show no head-of-line inversion
   at queue positions < head_exact (the host-side audit over the first
   AUDIT_WINDOW positions, whose whole count is printed). The first
   BATCHED_REPLAY cycles are replayed the same way, match_rounds then
   running both kernels' plain versions: mat_idx, mat_host and why_code
   must be equal and no kernel counter may move.
6. Prints timings as JSON: per cycle CUDA events from the delta upload
   to the prefix readback, and the host clock around the whole cycle
   (including the workload's own bookkeeping); each kernel alone by CUDA
   events; all beside the card's name and power limit. Then one line
   {"kernels": [...]}, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Imports torch, numpy and cook_tpu_torch only. Any failure exits non-zero
before the last line.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

CYCLES = 12
REPLAY = 3
BATCHED = 8
BATCHED_REPLAY = 2
AUDIT_WINDOW = 512
S_MAIN, H_MAIN = 1024, 16384
C_BATCHED, D_MAIN = 8192, 1024

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
HBM_BPS = 3.35e12
F32_OPS = 67e12
# f32/compare operations per (job, host) pair of one exact_scan step: 5
# feasibility compares, 3 eps adds, fitness 2 subs + 2 adds + 3 muls + 1
# add, the argmax compare
OPS_PER_PAIR = 17
# best_host, counted for the function, not for the kernel's blocking:
# per host once, the 3 eps adds and 2 used subtractions; per (row, host)
# pair, feasibility 6 compares and the argmax 2; per FEASIBLE pair also
# the fitness (2 compares, 2 adds, 2 divisions, 1 add, 1 mul), the
# jitter hash (3 integer multiplies, 1 add, 2 shifts, 2 xors, 1 and,
# 1 convert, 1 division, 1 mul, 1 add) when spread > 0, and 1 add with a
# bonus; integer operations counted at the f32 rate. It reads 9 of the
# host stack's 16 rows.
BH_OPS_HOST, BH_OPS_PAIR, BH_OPS_FIT, BH_OPS_JITTER, BH_OPS_BONUS = \
    5, 8, 8, 13, 1
BH_HOST_ROWS = 9


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def scan_problem(rng, S, H, device):
    """Mixed exact_scan / best_host inputs: 2% forbidden density, ~5% gpu
    hosts, some gpu jobs, slot-exhausted and invalid hosts, unique-group
    jobs."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    cap_mem = rng.uniform(64, 256, H).astype(np.float32)
    cap_cpus = rng.uniform(16, 64, H).astype(np.float32)
    gpu = rng.random(H) < 0.05
    cap_gpus = np.where(gpu, 8.0, 0.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    hp = fm.pack_hosts(
        t(cap_mem * rng.uniform(0.05, 1, H).astype(np.float32)),
        t(cap_cpus * rng.uniform(0.05, 1, H).astype(np.float32)),
        t((cap_gpus * rng.uniform(0, 1, H)).round().astype(np.float32)),
        t(cap_mem), t(cap_cpus), t(cap_gpus),
        t(np.where(rng.random(H) < 0.03, 0, rng.integers(1, 6, H))
          .astype(np.int32)),
        t(rng.random(H) > 0.01), t(rng.random(H) < 0.03))
    jp = fm.pack_jobs(
        t(rng.uniform(1, 48, S).astype(np.float32)),
        t(rng.uniform(0.5, 12, S).astype(np.float32)),
        t(np.where(rng.random(S) < 0.05, rng.integers(1, 3, S), 0)
          .astype(np.float32)),
        t(rng.random(S) > 0.02), t(rng.random(S) < 0.1))
    forb = t((rng.random((S, H)) < 0.02).astype(np.uint8))
    return jp, hp, forb


def check_kernel(jp, hp, forb, label):
    """exact_scan vs plain on the same inputs; returns (max |host lane
    diff|, jobs assigned)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    jh_k, hout_k = fm.exact_scan(jp, hp, forb)
    jh_p, hout_p = fm.exact_scan_plain(jp, hp, forb)
    torch.cuda.synchronize()
    if not torch.equal(jh_k, jh_p):
        bad = int((jh_k != jh_p).sum())
        fail(f"exact_scan {label}: job_host differs from plain at {bad} "
             f"jobs")
    if not torch.equal(hout_k, hout_p):
        fail(f"exact_scan {label}: host stack not bit-equal to plain "
             f"(max abs diff {float((hout_k - hout_p).abs().max())})")
    return float((hout_k - hout_p).abs().max()), int((jh_k >= 0).sum())


def check_best_host(jp, hp, forb, bonus, spread, label):
    """best_host vs plain on the same inputs; returns (max |fit diff|,
    rows assigned, best_host)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    fit_k, idx_k = fm.best_host(jp, hp, forb, bonus, spread)
    fit_p, idx_p = fm.best_host_plain(jp, hp, forb, bonus, spread)
    torch.cuda.synchronize()
    if not torch.equal(idx_k, idx_p):
        bad = int((idx_k != idx_p).sum())
        fail(f"best_host {label}: best_host differs from plain at {bad} "
             f"rows")
    if not torch.equal(fit_k, fit_p):
        fail(f"best_host {label}: best_fit not bit-equal to plain (max "
             f"abs diff {float((fit_k - fit_p).abs().max())})")
    return float((fit_k - fit_p).abs().max()), int((idx_k >= 0).sum()), \
        idx_k


def identical_hosts(S, H, device):
    """(jp, hp, forb): S unit jobs, H identical hosts with 5 slots."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    f = lambda v, n: torch.full((n,), v, dtype=torch.float32, device=device)
    hp = fm.pack_hosts(f(16.0, H), f(16.0, H), f(0.0, H), f(16.0, H),
                       f(16.0, H), f(0.0, H),
                       torch.full((H,), 5, dtype=torch.int32, device=device),
                       torch.ones(H, dtype=torch.bool, device=device),
                       torch.zeros(H, dtype=torch.bool, device=device))
    jp = fm.pack_jobs(f(1.0, S), f(1.0, S), f(0.0, S),
                      torch.ones(S, dtype=torch.bool, device=device),
                      torch.zeros(S, dtype=torch.bool, device=device))
    forb = torch.zeros((S, H), dtype=torch.uint8, device=device)
    return jp, hp, forb


def adversarial(device):
    """(label, jp, hp, forb) of the three small exact_scan cases."""
    import torch

    rng = np.random.default_rng(7)
    out = [("all_tie", *identical_hosts(64, 4096, device))]
    jp2, hp2, _ = scan_problem(rng, 32, 2048, device)
    out.append(("all_infeasible", jp2, hp2,
                torch.ones((32, 2048), dtype=torch.uint8, device=device)))
    # H not a multiple of 1024 (nor of 32)
    jp3, hp3, forb3 = scan_problem(rng, 200, 16411, device)
    out.append(("h16411", jp3, hp3, forb3))
    return out


def bound(bytes_moved, ops):
    """(bound_ms, bound_by) from bytes over HBM rate and operations over
    the f32 rate."""
    b_ms = bytes_moved / HBM_BPS * 1e3
    o_ms = ops / F32_OPS * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


@contextlib.contextmanager
def plain_kernels():
    """Route both kernel wrappers to their plain versions (replay only)."""
    from cook_tpu_torch.ops import fused_match as fm

    saved = fm.exact_scan, fm.best_host
    fm.exact_scan, fm.best_host = fm.exact_scan_plain, fm.best_host_plain
    try:
        yield
    finally:
        fm.exact_scan, fm.best_host = saved


def head_window_inversions(w, out, now_s):
    """Queue positions (< AUDIT_WINDOW) of head-of-line inversions in one
    batched cycle, by the copied host-side audit: jobs in compact slot
    (= queue) order, each host's capacity before the match (the state
    after it plus what the cycle's matches took), and each job's mask as
    the cycle built it (forbidden row, ports, estimated completion)."""
    import torch
    from cook_tpu_torch.ops import match as mo

    st = w.rs.state
    a = lambda t: t[:-1].cpu().numpy()
    pend = {k: a(st["pend"][k]) for k in
            ("mem", "cpus", "gpus", "ports", "est_s", "forb_slot",
             "unique_group")}
    host = {k: a(v) for k, v in st["host"].items()}
    cons_idx = out[0].cpu().numpy()
    cons_host = out[1].cpu().numpy()
    H = host["mem"].shape[0]
    m = (cons_idx >= 0) & (cons_host >= 0)
    mi, mh = cons_idx[m], cons_host[m]

    def before(lane, vals):
        return host[lane] + np.bincount(mh, vals, minlength=H)

    mem0 = before("mem", pend["mem"][mi])
    cpus0 = before("cpus", pend["cpus"][mi])
    gpus0 = before("gpus", pend["gpus"][mi])
    slots0 = host["task_slots"] + np.bincount(mh, minlength=H)
    ports0 = host["ports"] + np.bincount(mh, pend["ports"][mi],
                                         minlength=H).astype(np.int64)
    win = cons_idx[:AUDIT_WINDOW]
    valid = win >= 0
    rows = np.where(valid, win, 0)
    fslot = pend["forb_slot"][rows]
    forb = np.zeros((len(win), H), bool)
    has = valid & (fslot >= 0)
    forb[has] = st["forb"][:-1][torch.from_numpy(
        fslot[has].astype(np.int64)).to(st["forb"].device)].cpu().numpy()
    forb |= pend["ports"][rows][:, None] > ports0[None, :]
    est = pend["est_s"][rows]
    forb |= (est > 0)[:, None] & \
        ((now_s + est)[:, None] >= host["death_s"][None, :])
    jobs = mo.Jobs(mem=pend["mem"][rows], cpus=pend["cpus"][rows],
                   gpus=pend["gpus"][rows], valid=valid,
                   group=np.full(len(win), -1, np.int32),
                   unique_group=pend["unique_group"][rows])
    hosts = mo.Hosts(mem=mem0, cpus=cpus0, gpus=gpus0,
                     cap_mem=host["cap_mem"], cap_cpus=host["cap_cpus"],
                     cap_gpus=host["cap_gpus"], valid=host["valid"],
                     task_slots=slots0)
    return mo.inversion_positions_np(jobs, hosts, forb,
                                     cons_host[:AUDIT_WINDOW])


def check_cycle_state(w, mat_idx, c, label):
    import torch

    rs = w.rs
    h = rs.state["host"]
    for lane in ("mem", "cpus", "gpus"):
        low = float(h[lane][:-1].min())
        if low < -1e-6:
            fail(f"{label} cycle {c}: host lane {lane} went to {low}")
    if int(h["task_slots"][:-1].min()) < 0:
        fail(f"{label} cycle {c}: negative task slots")
    if len(mat_idx) and bool(rs.state["pend"]["valid"][
            torch.from_numpy(mat_idx).to(rs.device).long()].any()):
        fail(f"{label} cycle {c}: a matched row is still valid")


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cook_tpu_torch")):
        fail("the cook_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, here)
    from cook_tpu_torch.entry import (HEAD_START, resident_workload,
                                      sequential_for)
    from cook_tpu_torch.kernels import build
    from cook_tpu_torch.ops import fused_match as fm

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    print(json.dumps({"build_s": secs,
                      "build_wall_s": time.perf_counter() - t0}), flush=True)
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    dev = torch.device("cuda", 0)

    # ---- 2. exact_scan vs plain on the card --------------------------------
    rng = np.random.default_rng(0)
    jp, hp, forb = scan_problem(rng, S_MAIN, H_MAIN, dev)
    max_err, n_assigned = check_kernel(jp, hp, forb, "mixed 1024x16384")
    if n_assigned == 0:
        fail("mixed exact_scan assigned no job")
    for label, a, b, c in adversarial(dev):
        err, n = check_kernel(a, b, c, label)
        max_err = max(max_err, err)
        if label == "all_tie":
            jh, _ = fm.exact_scan(a, b, c)
            want = torch.arange(a.shape[0], device=dev) // 5
            if not torch.equal(jh.long(), want):
                fail("all_tie: lowest index did not win the ties")
        if label == "all_infeasible" and n != 0:
            fail("all_infeasible: a job was assigned")
    print(json.dumps({"exact_scan_vs_plain": "equal", "max_abs_err": max_err,
                      "mixed_assigned": n_assigned}), flush=True)
    kernel_ms = cuda_ms(lambda: fm.exact_scan(jp, hp, forb), 20)
    plain_ms = cuda_ms(lambda: fm.exact_scan_plain(jp, hp, forb), 2)
    jh_, fb_ = jp[:HEAD_START].contiguous(), forb[:HEAD_START].contiguous()
    head_ms = cuda_ms(lambda: fm.exact_scan(jh_, hp, fb_), 20)
    S, H = S_MAIN, H_MAIN
    scan_bound_ms, scan_bound_by = bound(
        S * 8 * 4 + 16 * H * 4 + S * H + S * 4 + 16 * H * 4,
        S * H * OPS_PER_PAIR)

    # ---- 3. best_host vs plain on the card ---------------------------------
    D = D_MAIN
    jp, hp, forb = scan_problem(np.random.default_rng(1), D, H_MAIN, dev)
    bonus = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 0.5, (D, H_MAIN)).astype(np.float32)).to(dev)
    bh_err = 0.0
    for b, spread, label in ((None, 0.2, "mixed spread 0.2"),
                             (None, 0.0, "mixed spread 0"),
                             (bonus, 0.0, "mixed bonus spread 0")):
        err, n, _ = check_best_host(jp, hp, forb, b, spread, label)
        bh_err = max(bh_err, err)
        if n == 0:
            fail(f"best_host {label}: no row found a host")
    a, b, c = identical_hosts(D, H_MAIN, dev)
    _, _, idx = check_best_host(a, b, c, None, 0.0, "all_tie")
    if not bool((idx == 0).all()):
        fail("best_host all_tie: the lowest index did not win")
    _, n, _ = check_best_host(jp, hp, torch.ones_like(forb), None, 0.2,
                              "all_infeasible")
    if n != 0:
        fail("best_host all_infeasible: a row found a host")
    for N_, H_ in ((D, 16411), (200, H_MAIN)):
        a, b, c = scan_problem(np.random.default_rng(3), N_, H_, dev)
        err, _, _ = check_best_host(a, b, c, None, 0.2, f"{N_}x{H_}")
        bh_err = max(bh_err, err)
    print(json.dumps({"best_host_vs_plain": "equal", "max_abs_err": bh_err}),
          flush=True)
    # the main path's call: no bonus, spread 0.2
    bh_ms = cuda_ms(lambda: fm.best_host(jp, hp, forb, None, 0.2), 50)
    bh_plain_ms = cuda_ms(lambda: fm.best_host_plain(jp, hp, forb, None,
                                                     0.2), 5)
    bh_bonus_ms = cuda_ms(lambda: fm.best_host(jp, hp, forb, bonus, 0.0), 50)
    feas = int(fm.best_host_feasible(jp, hp, forb).sum())
    # jobs, the host rows read, the mask (and the bonus), the outputs
    bh_bytes = D * 8 * 4 + BH_HOST_ROWS * H_MAIN * 4 + D * H_MAIN + D * 8
    bh_ops = H_MAIN * BH_OPS_HOST + D * H_MAIN * BH_OPS_PAIR
    bh_bound_ms, bh_bound_by = bound(
        bh_bytes, bh_ops + feas * (BH_OPS_FIT + BH_OPS_JITTER))
    bh_bonus_bound_ms, _ = bound(
        bh_bytes + D * H_MAIN * 4, bh_ops + feas * (BH_OPS_FIT + BH_OPS_BONUS))

    # ---- 4. the sequential path: resident cycles through exact_scan --------
    t0 = time.perf_counter()
    w = resident_workload(device=dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rs = w.rs
    if (rs.Pcap, rs.Hcap, w.C) != (131072, 16384, 1024) or \
            not sequential_for(w.C):
        fail(f"unexpected sizing {(rs.Pcap, rs.Hcap, w.C)}")
    recorded = []
    host_ms, matched = [], []
    phase_ms = {}
    fm.reset_launches()
    for c in range(CYCLES):
        t = time.perf_counter()
        out, mat_idx, mat_host = w.cycle(use_kernel=True)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in w.timing.items():
            phase_ms.setdefault(k, []).append(v)
        matched.append(len(mat_idx))
        check_cycle_state(w, mat_idx, c, "sequential")
        if c < REPLAY:
            recorded.append((mat_idx, mat_host, out[8].cpu().numpy()))
    seq_launches = dict(fm.LAUNCHES)
    if seq_launches != {"exact_scan": CYCLES, "best_host": 0}:
        fail(f"sequential path launches {seq_launches} in {CYCLES} cycles")
    if sum(matched) == 0:
        fail("the sequential cycles matched nothing")

    w2 = resident_workload(device=dev, seed=0)
    for c in range(REPLAY):
        with plain_kernels():
            out, mat_idx, mat_host = w2.cycle(use_kernel=True)
        ri, rh, rc = recorded[c]
        if not (np.array_equal(mat_idx, ri) and np.array_equal(mat_host, rh)
                and np.array_equal(out[8].cpu().numpy(), rc)):
            fail(f"replay cycle {c}: plain version disagrees with kernel")
    if fm.LAUNCHES != seq_launches:
        fail("the sequential plain replay launched a kernel")
    del w, w2

    # ---- 5. the batched path: match_rounds through both kernels ------------
    t0 = time.perf_counter()
    wb = resident_workload(device=dev, seed=0, C=C_BATCHED)
    torch.cuda.synchronize()
    b_setup_s = time.perf_counter() - t0
    rs = wb.rs
    if (rs.Pcap, rs.Rcap, rs.Hcap) != (262144, 32768, 16384) or \
            sequential_for(wb.C):
        fail(f"unexpected batched sizing {(rs.Pcap, rs.Rcap, rs.Hcap)}")
    b_recorded, b_host_ms, b_matched, b_phase = [], [], [], {}
    bh_per_cycle, inversions, why_counts = [], [], []
    fm.reset_launches()
    for c in range(BATCHED):
        before = dict(fm.LAUNCHES)
        now_s = wb.now_s
        t = time.perf_counter()
        out, mat_idx, mat_host = wb.cycle(use_kernel=True)
        torch.cuda.synchronize()
        b_host_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in wb.timing.items():
            b_phase.setdefault(k, []).append(v)
        b_matched.append(len(mat_idx))
        d_scan = fm.LAUNCHES["exact_scan"] - before["exact_scan"]
        d_bh = fm.LAUNCHES["best_host"] - before["best_host"]
        bh_per_cycle.append(d_bh)
        if d_scan != 1:
            fail(f"batched cycle {c}: exact_scan launched {d_scan} times")
        if d_bh < 1:
            fail(f"batched cycle {c}: best_host never launched")
        check_cycle_state(wb, mat_idx, c, "batched")
        why_counts.append(np.bincount(out[8].cpu().numpy(),
                                      minlength=8).tolist())
        inv = head_window_inversions(wb, out, now_s)
        inversions.append(len(inv))
        if (inv < HEAD_START).any():
            fail(f"batched cycle {c}: inversions inside the exact head at "
                 f"{inv[inv < HEAD_START][:10].tolist()}")
        if c < BATCHED_REPLAY:
            b_recorded.append((mat_idx, mat_host, out[8].cpu().numpy()))
    b_launches = dict(fm.LAUNCHES)
    if sum(b_matched) == 0:
        fail("the batched cycles matched nothing")
    print(json.dumps({"batched_best_host_launches_per_cycle": bh_per_cycle,
                      "batched_head_window_inversions": inversions,
                      "batched_why_code_counts": why_counts,
                      "audit_window": AUDIT_WINDOW}), flush=True)

    wb2 = resident_workload(device=dev, seed=0, C=C_BATCHED)
    for c in range(BATCHED_REPLAY):
        with plain_kernels():
            out, mat_idx, mat_host = wb2.cycle(use_kernel=True)
        ri, rh, rc = b_recorded[c]
        if not (np.array_equal(mat_idx, ri) and np.array_equal(mat_host, rh)
                and np.array_equal(out[8].cpu().numpy(), rc)):
            fail(f"batched replay cycle {c}: plain versions disagree with "
                 f"the kernels")
    if fm.LAUNCHES != b_launches:
        fail("the batched plain replay launched a kernel")

    def cycle_stats(phase, host, match):
        return {
            "cycle_event_ms_median": float(np.median(phase["event_ms"])),
            "cycle_event_ms_p99": float(np.percentile(phase["event_ms"],
                                                      99)),
            "cycle_host_ms_median": float(np.median(host)),
            "cycle_host_ms_p99": float(np.percentile(host, 99)),
            "cycle_host_ms_p99_after_first": float(
                np.percentile(host[1:], 99)),
            "phase_median_ms": {k: float(np.median(v))
                                for k, v in phase.items()},
            "cycle_host_ms": host,
            "matched_per_cycle": match,
        }

    timings = {
        "card": card, "kind": kind,
        "sequential": {"setup_s": setup_s, "cycles": CYCLES, "C": 1024,
                       **cycle_stats(phase_ms, host_ms, matched)},
        "batched": {"setup_s": b_setup_s, "cycles": BATCHED,
                    "C": C_BATCHED, "head_exact": HEAD_START,
                    "best_host_launches_per_cycle": bh_per_cycle,
                    **cycle_stats(b_phase, b_host_ms, b_matched)},
        "exact_scan_ms": kernel_ms,
        "exact_scan_head_ms": head_ms,
        "exact_scan_plain_ms": plain_ms,
        "exact_scan_bound_ms": scan_bound_ms,
        "best_host_ms": bh_ms,
        "best_host_bonus_ms": bh_bonus_ms,
        "best_host_bonus_bound_ms": bh_bonus_bound_ms,
        "best_host_plain_ms": bh_plain_ms,
        "best_host_bound_ms": bh_bound_ms,
        "best_host_feasible_pairs": feas,
        "library_note": "no single PyTorch call computes the sequential "
                        "scan or the masked fitness argmax",
    }
    print(json.dumps(timings), flush=True)
    by_path = {k: {"sequential": seq_launches[k], "batched": b_launches[k]}
               for k in seq_launches}
    print(json.dumps({"kernels": [
        {"name": "exact_scan", "route": "cuda",
         "source": "cook_tpu_torch/csrc/exact_scan.cu",
         "replaces": "cook_tpu/ops/pallas_match.py:166",
         "launches": sum(by_path["exact_scan"].values()),
         "launches_by_path": by_path["exact_scan"], "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": scan_bound_ms,
         "bound_by": scan_bound_by, "library_ms": None},
        {"name": "best_host", "route": "cuda",
         "source": "cook_tpu_torch/csrc/best_host.cu",
         "replaces": "cook_tpu/ops/pallas_match.py:285",
         "launches": sum(by_path["best_host"].values()),
         "launches_by_path": by_path["best_host"], "max_abs_err": bh_err,
         "ms": bh_ms, "plain_ms": bh_plain_ms, "bound_ms": bh_bound_ms,
         "bound_by": bh_bound_by, "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
