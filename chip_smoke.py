#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cook_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and exits non-zero
   when torch sees no CUDA device.
2. Builds the CUDA kernels from csrc/ (nvcc, first use) and prints the
   build seconds.
3. Holds the exact_scan kernel against its plain PyTorch version on the
   card: S=1024 jobs x H=16384 hosts (the main path's shape) with a mixed
   workload, and three adversarial cases (all hosts identical, all jobs
   infeasible, H not a multiple of 1024). job_host must be equal and
   the (16, H) host stack bit-equal: the kernel rounds every f32 op like
   the plain version (no FMA contraction, IEEE division).
4. Drives the port's main path: a device-resident pool of 100,000
   pending x 10,000 hosts (Pcap 131072, Hcap 16384), 10,000 running,
   500 users, C=1024 considered per cycle, 2% of pending jobs
   constrained, the ports and estimated-completion lanes on, no bonus.
   CYCLES cycles through `device_cycle` with the exact_scan kernel; the
   launch counter must rise by one per cycle. Checks: jobs matched, no
   host lane below -eps, matched rows invalid afterwards. The first 3
   cycles are replayed from the same seed with the kernel's plain
   version as the match step; mat_idx / mat_host / why_code must agree.
5. Prints timings as JSON: per cycle CUDA events from the delta upload
   to the prefix readback, and the host clock around the whole cycle
   (including the workload's own bookkeeping); the kernel alone by CUDA
   events; all beside the card's name and power limit. Then one line
   {"kernels": [...]}, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Imports torch, numpy and cook_tpu_torch only. Any failure exits non-zero
before the last line.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

CYCLES = 24
REPLAY = 3
S_MAIN, H_MAIN = 1024, 16384

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 op/s
HBM_BPS = 3.35e12
F32_OPS = 67e12
# f32/compare operations per (job, host) pair of one scan step: 5
# feasibility compares, 3 eps adds, fitness 2 subs + 2 adds + 3 muls + 1
# add, the argmax compare
OPS_PER_PAIR = 17


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
    """Mixed exact_scan inputs: 2% forbidden density, ~5% gpu hosts, some
    gpu jobs, slot-exhausted and invalid hosts, unique-group jobs."""
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
    """Kernel vs plain on the same inputs; returns max |host lane diff|."""
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


def adversarial(device):
    """(label, jp, hp, forb) of the three small adversarial cases."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm

    rng = np.random.default_rng(7)
    out = []
    # all hosts identical: the lowest index must win every tie
    S, H = 64, 4096
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
    out.append(("all_tie", jp, hp, forb))
    # all jobs infeasible
    jp2, hp2, _ = scan_problem(rng, 32, 2048, device)
    out.append(("all_infeasible", jp2, hp2,
                torch.ones((32, 2048), dtype=torch.uint8, device=device)))
    # H not a multiple of 1024 (nor of 32)
    jp3, hp3, forb3 = scan_problem(rng, 200, 16411, device)
    out.append(("h16411", jp3, hp3, forb3))
    return out


def plain_matcher(jobs, hosts, forb, bonus):
    """The match step through the kernel's plain version (replay only)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import match as mo

    H = hosts.mem.shape[0]
    occ = torch.zeros(H, dtype=torch.bool, device=hosts.mem.device)
    jp = fm.pack_jobs(jobs.mem, jobs.cpus, jobs.gpus, jobs.valid,
                      jobs.unique_group)
    hp = fm.pack_hosts(hosts.mem, hosts.cpus, hosts.gpus, hosts.cap_mem,
                       hosts.cap_cpus, hosts.cap_gpus, hosts.task_slots,
                       hosts.valid, occ)
    jh, hout = fm.exact_scan_plain(jp, hp, forb)
    return mo.MatchResult(jh, hout[fm.H_MEM], hout[fm.H_CPUS],
                          hout[fm.H_GPUS], hout[fm.H_SLOTS].to(torch.int32))


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "cook_tpu_torch")):
        fail("the cook_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, here)
    from cook_tpu_torch.entry import resident_workload
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

    # ---- 2. kernel vs plain on the card -----------------------------------
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
    print(json.dumps({"kernel_vs_plain": "equal", "max_abs_err": max_err,
                      "mixed_assigned": n_assigned}), flush=True)
    kernel_ms = cuda_ms(lambda: fm.exact_scan(jp, hp, forb), 20)
    plain_ms = cuda_ms(lambda: fm.exact_scan_plain(jp, hp, forb), 2)
    S, H = S_MAIN, H_MAIN
    bytes_moved = S * 8 * 4 + 16 * H * 4 + S * H + S * 4 + 16 * H * 4
    ops = S * H * OPS_PER_PAIR
    bound_bytes_ms = bytes_moved / HBM_BPS * 1e3
    bound_ops_ms = ops / F32_OPS * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"

    # ---- 3. the main path: resident cycles through the kernel -------------
    t0 = time.perf_counter()
    w = resident_workload(device=dev, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rs = w.rs
    if (rs.Pcap, rs.Hcap, w.C) != (131072, 16384, 1024):
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
        h = rs.state["host"]
        for lane in ("mem", "cpus", "gpus"):
            low = float(h[lane][:-1].min())
            if low < -1e-6:
                fail(f"cycle {c}: host lane {lane} went to {low}")
        if int(h["task_slots"][:-1].min()) < 0:
            fail(f"cycle {c}: negative task slots")
        if len(mat_idx) and bool(rs.state["pend"]["valid"][
                torch.from_numpy(mat_idx).to(dev).long()].any()):
            fail(f"cycle {c}: a matched row is still valid")
        if c < REPLAY:
            recorded.append((mat_idx, mat_host, out[8].cpu().numpy()))
    launches = fm.LAUNCHES["exact_scan"]
    if launches != CYCLES:
        fail(f"exact_scan launched {launches} times in {CYCLES} cycles")
    if sum(matched) == 0:
        fail("the resident cycles matched nothing")

    # ---- 4. replay the first cycles with the kernel's plain version -------
    w2 = resident_workload(device=dev, seed=0)
    for c in range(REPLAY):
        out, mat_idx, mat_host = w2.cycle(matcher=plain_matcher)
        ri, rh, rc = recorded[c]
        if not (np.array_equal(mat_idx, ri) and np.array_equal(mat_host, rh)
                and np.array_equal(out[8].cpu().numpy(), rc)):
            fail(f"replay cycle {c}: plain version disagrees with kernel")
    if fm.LAUNCHES["exact_scan"] != launches:
        fail("the plain replay launched the kernel")

    timings = {
        "card": card, "kind": kind,
        "setup_s": setup_s,
        "cycles": CYCLES,
        "cycle_event_ms_median": float(np.median(phase_ms["event_ms"])),
        "cycle_event_ms_p99": float(np.percentile(phase_ms["event_ms"], 99)),
        "cycle_host_ms_median": float(np.median(host_ms)),
        "cycle_host_ms_p99": float(np.percentile(host_ms, 99)),
        "cycle_host_ms_p99_after_first": float(
            np.percentile(host_ms[1:], 99)),
        "phase_median_ms": {k: float(np.median(v))
                            for k, v in phase_ms.items()},
        "cycle_host_ms": host_ms,
        "matched_per_cycle": matched,
        "exact_scan_ms": kernel_ms,
        "exact_scan_plain_ms": plain_ms,
        "exact_scan_bound_ms": bound_ms,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the sequential "
                        "scan",
    }
    print(json.dumps(timings), flush=True)
    print(json.dumps({"kernels": [{
        "name": "exact_scan", "route": "cuda",
        "source": "cook_tpu_torch/csrc/exact_scan.cu",
        "replaces": "cook_tpu/ops/pallas_match.py:166",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
