"""The batched accept step's exact fit test on the card: chip_smoke.py's
full-width readback run (e2e at 100k pending x 10k hosts, C = 8,192, the
async consumer, 13 cycles, completions flowing back) with
`match.fits_exact` in force and with it switched off (cook_tpu's accept
test alone), in turns. Without it the batched accept step's f32 prefix
can put a bid on a host that is already full; the mock backend refuses
that launch and the job is launched again on another host. Prints one
JSON line a run, then the jobs launched twice in each arm's runs. With
`--mode inline` (statuses applied in a fixed order) the runs are
deterministic, and each pair also prints the first cycle whose launches
differ between its two runs: where cook_tpu's accept test first lets a
bid past a host's capacity.

    python -m cook_tpu_torch.accept_check [--pairs 8] [--device cuda]
        [--mode async|inline] [--cycles 13] [--P0 100000 --H 10000
        --U 500 --consider 8192]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from cook_tpu_torch import e2e
from cook_tpu_torch.device import resolve_device
from cook_tpu_torch.ops import match

SHAPE = dict(P0=100_000, H=10_000, U=500)
CYCLES, CONSIDER = 13, 8192


def prefix_only(vals, p_host, left):
    """The arm without the exact test: every bid passes it."""
    return torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)


def run(dev, arm: str, shape=SHAPE, consider=CONSIDER, mode="async",
        cycles=CYCLES) -> dict:
    exact = match.fits_exact
    match.fits_exact = exact if arm == "exact" else prefix_only
    try:
        t0 = time.perf_counter()
        got = e2e.launch_trace(dev, cycles, mode=mode,
                               audit=mode != "inline", consider=consider,
                               **shape)
        s = time.perf_counter() - t0
    finally:
        match.fits_exact = exact
    jobs = [u for u, _ in got["launched"]]
    return {"arm": arm, "launched": len(jobs),
            "launched_twice": len(jobs) - len(set(jobs)),
            "instances": dict(list(got["repeats"].items())[:3]),
            "audit_mismatches": len(got["audit_mismatches"]),
            "completed": got["completed"], "s": s,
            "per_cycle": [sorted(c) for c in got["per_cycle"]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    for k, v in SHAPE.items():
        ap.add_argument(f"--{k}", type=int, default=v)
    ap.add_argument("--consider", type=int, default=CONSIDER)
    ap.add_argument("--mode", default="async", choices=("async", "inline"))
    ap.add_argument("--cycles", type=int, default=CYCLES)
    a = ap.parse_args(argv)
    shape = {k: getattr(a, k) for k in SHAPE}
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        from cook_tpu_torch.kernels import build
        build.build_all()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    twice = {"exact": [], "prefix_only": []}
    for _ in range(a.pairs):
        pair = {}
        for arm in twice:
            r = pair[arm] = run(dev, arm, shape, a.consider, a.mode,
                                a.cycles)
            twice[arm].append(r["launched_twice"])
            print(json.dumps({k: v for k, v in r.items()
                              if k != "per_cycle"}), flush=True)
        if a.mode == "inline":
            runs = zip(*(r["per_cycle"] for r in pair.values()))
            print(json.dumps({"first_differing_cycle": next(
                (c for c, (x, y) in enumerate(runs) if x != y), None),
                "cycles": len(pair["exact"]["per_cycle"])}), flush=True)
    print(json.dumps({"launched_twice": twice}), flush=True)


if __name__ == "__main__":
    main()
