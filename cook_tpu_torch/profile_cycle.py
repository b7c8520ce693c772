"""Where the time of one resident cycle goes, on the GPU.

    python -m cook_tpu_torch.profile_cycle [--batched] [--cycles 12]
                                           [--trace DIR]

Builds the 100k-pending x 10k-host resident workload of chip_smoke.py
(entry.resident_workload defaults: C=1024, the sequential path; with
`--batched` C=8192, the coordinator's match_rounds path with its exact
head and dense rounds), runs 3 warm-up cycles, then:

1. `--cycles` cycles timed on the host clock per phase (ship = pack and
   upload the deltas; cycle = device cycle through the prefix readback;
   advance = fold the result into the seeded stream) and by CUDA events
   from the upload to the readback (event);
2. 4 cycles under torch.profiler: device time per cycle summed over
   kernels, the device's idle share of the profiled wall time, the
   kernels ranked by device time (exact_scan's and best_host's named),
   and the host syncs per cycle (CUDA stream/device synchronisations;
   `.item()`-style reads, `nonzero` and the prefix readback each make
   one);
3. 1 more cycle under `torch.cuda.set_sync_debug_mode("warn")`: the
   source line of each synchronising call (PyTorch's sync debug mode is
   a prototype and may miss some).

Prints one JSON object with the card's name and power limit. Needs a
CUDA device; `--trace DIR` also writes a Chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from cook_tpu_torch.entry import resident_workload
from cook_tpu_torch.kernels import build


def _dev_time(evt) -> float:
    """Self device time (us) of a profiler average, across torch versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def _sync_sources(w) -> dict:
    """{"file:line": count} of the synchronising calls of one cycle."""
    import collections
    import warnings

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            w.cycle()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter()
    for r in rec:
        if "called a synchronizing" not in str(r.message):
            continue
        path = os.path.abspath(r.filename)
        path = (os.path.relpath(path, root) if path.startswith(root)
                else "/".join(path.split(os.sep)[-2:]))
        where[f"{path}:{r.lineno}"] += 1
    return dict(where.most_common())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=12)
    ap.add_argument("--batched", action="store_true",
                    help="C=8192: profile the match_rounds cycle")
    ap.add_argument("--trace", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cycle needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda", 0)
    w = resident_workload(device=dev, C=8192 if a.batched else 1024)
    for _ in range(3):
        w.cycle()
    phases = {}
    for _ in range(a.cycles):
        w.cycle()
        for k, v in w.timing.items():
            phases.setdefault(k, []).append(v)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    n_prof = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            w.cycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    kernels = []
    syncs = {}
    for evt in prof.key_averages():
        if evt.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                       "cudaEventSynchronize", "aten::_local_scalar_dense",
                       "aten::nonzero"):
            syncs[evt.key] = evt.count / n_prof
        t = _dev_time(evt)
        # device-side events only (kernels, copies): the aten op rows
        # carry the same device time again
        if t > 0 and evt.device_type == DeviceType.CUDA:
            kernels.append((evt.key, t / 1e3 / n_prof, evt.count / n_prof))
    kernels.sort(key=lambda k: -k[1])
    dev_ms = sum(k[1] for k in kernels)
    scan_ms = sum(k[1] for k in kernels if "exact_scan" in k[0])
    bh = [k for k in kernels if "best_host" in k[0]]
    bh_ms = sum(k[1] for k in bh)
    sync_sources = _sync_sources(w)
    if a.trace:
        os.makedirs(a.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(a.trace, "cycle_trace.json"))
    out = {
        "card": card,
        "C": w.C,
        "path": "batched" if a.batched else "sequential",
        "kind": torch.cuda.get_device_name(0),
        "phase_median_ms": {k: float(np.median(v))
                            for k, v in phases.items()},
        "phase_p99_ms": {k: float(np.percentile(v, 99))
                         for k, v in phases.items()},
        "profiled_cycles": n_prof,
        "profiled_wall_ms_per_cycle": wall_ms / n_prof,
        "device_ms_per_cycle": dev_ms,
        "device_idle_share": (1.0 - dev_ms * n_prof / wall_ms
                              if wall_ms > 0 else None),
        "exact_scan_ms_per_cycle": scan_ms,
        "exact_scan_share_of_device": scan_ms / dev_ms if dev_ms else None,
        "best_host_ms_per_cycle": bh_ms,
        "best_host_calls_per_cycle": sum(k[2] for k in bh),
        "best_host_share_of_device": bh_ms / dev_ms if dev_ms else None,
        "host_syncs_per_cycle": sum(
            v for k, v in syncs.items() if k.startswith("cuda")),
        "sync_events_per_cycle": syncs,
        "traced_syncs": sum(sync_sources.values()),
        "sync_sources": sync_sources,
        "kernel_launches_per_cycle": sum(k[2] for k in kernels),
        "top_kernels": [{"name": k[0][:90], "ms_per_cycle": k[1],
                         "calls_per_cycle": k[2]} for k in kernels[:20]],
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
