"""best_host at the batched path's main call, under two timers.

    python -m cook_tpu_torch.time_best_host [--root DIR] [--reps 50]

Times the `cook_tpu_torch` package under DIR (default: this checkout;
an unpacked `git archive` of another commit compares two versions in
one process each, on the same card) on chip_smoke.py's inputs, made
from this checkout's chip_smoke.py: D=1024 rows x H=16384 hosts with
the mixed workload,
- "main": no bonus, spread 0.2 (the dense rounds' call);
- "bonus": a U(0, 0.5) bonus, spread 0;
- "ieee_division": the main call with one host of every 128 given a
  capacity of 2^61 (used 0): best_host.cu divides a 128-host tile
  holding such a host with `__fdiv_rn` (its per-host reciprocal is
  exact only inside [2^-60, 2^60]), so every tile does.
Each case is held bit-equal to `best_host_plain` first, then timed by
CUDA events around `reps` back-to-back calls:
- "events_ms": the first event recorded right after a sync. Where the
  wrapper's host time per call is longer than the kernel, this reads
  the host's enqueue rate;
- "events_after_sleep_ms": a ~20 ms device sleep queued before the
  first event (chip_smoke.py's `cuda_ms`), so every call is enqueued
  before the events run: device time.
And the wrapper's host microseconds per call (enqueue, no sync). Prints
one JSON line with the card's name and power limit. Needs a CUDA device.
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


def main() -> None:
    ap = argparse.ArgumentParser()
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
        sys.exit("time_best_host: needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from cook_tpu_torch.ops import fused_match as fm

    dev = torch.device("cuda", 0)
    D, H = smoke.D_MAIN, smoke.H_MAIN
    jp, hp, forb = smoke.scan_problem(np.random.default_rng(1), D, H, dev)
    bonus = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 0.5, (D, H)).astype(np.float32)).to(dev)
    hp_ieee = hp.clone()
    for lane in (fm.H_MEM, fm.H_CAP_MEM):
        hp_ieee[lane, ::128] = 2.0 ** 61
    cases = {"main": (jp, hp, forb, None, 0.2),
             "bonus": (jp, hp, forb, bonus, 0.0),
             "ieee_division": (jp, hp_ieee, forb, None, 0.2)}
    out = {"card": smoke.card_line(), "package": os.path.dirname(
        os.path.dirname(os.path.abspath(fm.__file__))), "reps": args.reps}
    for name, a in cases.items():
        fit_k, idx_k = fm.best_host(*a)
        fit_p, idx_p = fm.best_host_plain(*a)
        torch.cuda.synchronize()
        if not (torch.equal(idx_k, idx_p) and torch.equal(
                fit_k.view(torch.int32), fit_p.view(torch.int32))):
            sys.exit(f"time_best_host: {name}: kernel differs from plain")
        call = lambda a=a: fm.best_host(*a)
        out[name] = {
            "events_ms": _events_ms(call, args.reps, sleep=False),
            "events_after_sleep_ms": _events_ms(call, args.reps, sleep=True),
            "host_us": _host_us(call, 4 * args.reps),
        }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
