"""One kernel at its main-path calls, under two timers.

    python -m cook_tpu_torch.time_kernels --kernel KERNEL [--root DIR]
                                          [--reps 50]

KERNEL is exact_scan, best_host, blocked_cumsum, ordered_scatter or
sum_ordered.
Times the `cook_tpu_torch` package under DIR (default: this checkout;
an unpacked `git archive` of another commit compares two versions, one
process each, on the same card) on inputs made by this checkout's
chip_smoke.py, the same for both:
- exact_scan: the one-group walk without a bonus on the mixed workload,
  "main" (S=1024 jobs x H=16384 hosts, the sequential cycle's call),
  "head" (its first 256 jobs, the batched head's) and "chain_floor"
  (S=1024 x H = cluster x 32: one warp of hosts a CTA);
- best_host: D=1024 rows x H=16384 hosts of the mixed workload, "main"
  (no bonus, spread 0.2: the dense rounds' call), "bonus" (U(0, 0.5),
  spread 0) and "ieee_division" (one host of every 128 given a capacity
  of 2^61, so every 128-host tile divides with `__fdiv_rn`);
- blocked_cumsum: chip_smoke.CUMSUM_SHAPES ((262144, 2), the batched
  rank's; (131072, 2); (8192,); (16384,));
- ordered_scatter: chip_smoke.scatter_cases (8,192 bids over 16,384
  hosts, k=3; 32,768 tasks over 500 users with a 2,337-update run, k=3;
  2,048 credits onto a 16,384-host lane) and the rebalancer's usage
  (chip_smoke.rebalance_usage_case: 50,064 and 300,064 task slots over
  501 users, k=2: the cluster route, /sorted before it), added onto a
  working copy;
- sum_ordered: n = 1,024 (D), 16,384 (H) and 300,064 (the 300k
  rebalance pool's T: the cluster route, /levels before it); absent
  from packages before it existed.
Each case is held bit-equal to the package's plain version first, then
timed by CUDA events around `reps` back-to-back calls:
- "events_ms": the first event recorded right after a sync. Where the
  wrapper's host time per call is longer than the kernel, this reads
  the host's enqueue rate;
- "events_after_sleep_ms": a ~20 ms device sleep queued before the
  first event (chip_smoke.py's `cuda_ms`), so every call is enqueued
  before the events run: device time.
And the wrapper's host microseconds per call (enqueue, no sync), and
the launches per call by counter name. Prints one JSON line with the
card's name and power limit. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
KERNELS = ("exact_scan", "best_host", "blocked_cumsum", "ordered_scatter",
           "sum_ordered")


def _events_ms(fn, reps: int, sleep: bool) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if sleep:
        torch.cuda._sleep(35_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _host_us(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def _bits(t):
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def cases(kernel, smoke, dev):
    """{label: (call, plain call, timed call)} on this checkout's inputs:
    the first two return what they computed (as a tuple), the third is
    what is timed (ordered_scatter adds onto a working copy in place)."""
    import torch
    from cook_tpu_torch.ops import fused_match as fm
    from cook_tpu_torch.ops import segments as seg

    out = {}
    if kernel == "exact_scan":
        S, H = smoke.S_MAIN, smoke.H_MAIN
        jp, hp, forb = smoke.scan_problem(np.random.default_rng(0), S, H,
                                          dev)
        floor = smoke.scan_problem(np.random.default_rng(4), S,
                                   fm.exact_scan_cluster() * 32, dev)
        head = (jp[:256].contiguous(), hp, forb[:256].contiguous())
        for label, a in (("main", (jp, hp, forb)), ("head", head),
                         ("chain_floor", floor)):
            call = lambda a=a: fm.exact_scan(*a)
            out[label] = (call, lambda a=a: fm.exact_scan_plain(*a), call)
    elif kernel == "best_host":
        D, H = smoke.D_MAIN, smoke.H_MAIN
        jp, hp, forb = smoke.scan_problem(np.random.default_rng(1), D, H,
                                          dev)
        bonus = torch.from_numpy(np.random.default_rng(2).uniform(
            0, 0.5, (D, H)).astype(np.float32)).to(dev)
        hp_ieee = hp.clone()
        for lane in (fm.H_MEM, fm.H_CAP_MEM):
            hp_ieee[lane, ::128] = 2.0 ** 61
        for label, a in (("main", (jp, hp, forb, None, 0.2)),
                         ("bonus", (jp, hp, forb, bonus, 0.0)),
                         ("ieee_division", (jp, hp_ieee, forb, None, 0.2))):
            call = lambda a=a: fm.best_host(*a)
            out[label] = (call, lambda a=a: fm.best_host_plain(*a), call)
    elif kernel == "blocked_cumsum":
        rng = np.random.default_rng(0)
        for shape in smoke.CUMSUM_SHAPES:
            x = torch.from_numpy((10.0 ** rng.uniform(-3, 3, shape)
                                  * rng.choice([-1.0, 1.0], shape))
                                 .astype(np.float32)).to(dev)
            call = lambda x=x: (seg.blocked_cumsum(x),)
            out[str(shape)] = (call,
                               lambda x=x: (seg.blocked_cumsum_plain(x),),
                               call)
    elif kernel == "ordered_scatter":
        usage = [(f"rebalance_usage_{T0 + smoke.REB_P}x{smoke.REB_U + 1}",
                  *smoke.rebalance_usage_case(dev, T0))
                 for T0 in (50_000, 300_000)]
        for label, o, i, v in smoke.scatter_cases(dev) + usage:
            w = o.clone()
            out[label] = (
                lambda o=o, i=i, v=v: (
                    seg.scatter_add_ordered_(o.clone(), i, v),),
                lambda o=o, i=i, v=v: (
                    seg.scatter_add_ordered_plain_(o.clone(), i, v),),
                lambda w=w, i=i, v=v: seg.scatter_add_ordered_(w, i, v))
    elif kernel == "sum_ordered":
        if not hasattr(seg, "sum_ordered"):
            return None
        rng = np.random.default_rng(17)
        for n in (smoke.D_MAIN, smoke.H_MAIN, smoke.SUM_LEVELS_N):
            x = torch.from_numpy((10.0 ** rng.uniform(-3, 3, n)
                                  * rng.choice([-1.0, 1.0], n))
                                 .astype(np.float32)).to(dev)
            call = lambda x=x: (seg.sum_ordered(x),)
            out[f"n{n}"] = (call, lambda x=x: (seg.sum_ordered_plain(x),),
                            call)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=KERNELS)
    ap.add_argument("--root", default=None,
                    help="directory holding the cook_tpu_torch to time")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if args.root:
        # time another checkout's package: drop this one's modules first
        for m in [m for m in sys.modules
                  if m == "cook_tpu_torch" or m.startswith("cook_tpu_torch.")]:
            del sys.modules[m]
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_kernels: needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cook_tpu_torch.ops import fused_match as fm

    dev = torch.device("cuda", 0)
    out = {"card": smoke.card_line(), "kernel": args.kernel,
           "package": os.path.dirname(os.path.dirname(os.path.abspath(
               fm.__file__))), "reps": args.reps}
    calls = cases(args.kernel, smoke, dev)
    if calls is None:
        out["absent"] = True
        print(json.dumps(out), flush=True)
        return
    for label, (call, plain, fn) in calls.items():
        got, want = call(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(_bits(g), _bits(w))
                   for g, w in zip(got, want)):
            sys.exit(f"time_kernels: {args.kernel} {label}: kernel differs "
                     f"from plain")
        before = dict(fm.LAUNCHES)
        fn()
        launches = {k: v - before[k] for k, v in fm.LAUNCHES.items()
                    if v != before[k]}
        out[label] = {
            "events_ms": _events_ms(fn, args.reps, sleep=False),
            "events_after_sleep_ms": _events_ms(fn, args.reps, sleep=True),
            "host_us": _host_us(fn, 4 * args.reps),
            "launches_per_call": launches,
        }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
