"""Where the time of the on-chip segment kernels goes, phase by phase.

    python -m cook_tpu_torch.kernel_phases

Builds instrumented copies of csrc/ordered_scatter.cu, csrc/sum_ordered.cu
and csrc/blocked_cumsum.cu (into cook_tpu_torch/_build/phases/, beside
the normal build): after every `__syncthreads()` (and cluster barrier)
of the one-launch and the cluster scatter kernels, the exclusive scan
inside the first, the one-CTA and the cluster sum kernels and the tree
CTA 0 of the cluster finishes, the on-chip cumsum kernels and their
shared-memory scan, thread 0 of block 0 (CTA 0 of a cluster) records
`clock64()`. The wrappers then run with the instrumented libraries on
chip_smoke.py's main-path inputs (the three scatter shapes and the
rebalancer's usage at 50,064 and 300,064 tasks; sums of 1,024, 16,384
and 300,064; the four cumsum shapes), and the script prints, per case,
the SM cycles between consecutive stamps (the first from the kernel's
start) and their total, with the card's name, power limit and SM
clocks. The stamps cost a few cycles each (the count in shared memory,
stores to device memory); times are cycles of the SM clock, not device
time. Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from cook_tpu_torch.kernels import build
from cook_tpu_torch.ops import segments as seg

REPO = Path(__file__).resolve().parents[1]
OUT = build.BUILD_DIR / "phases"

# the stamp count lives in shared memory (a global one is reloaded after
# every barrier: a device-memory latency inside each phase it measures);
# device memory only receives the stamps and the count
_HEAD = """
__device__ long long g_stamp[64];
__device__ int g_ns;
__shared__ int s_ns;
#define STAMP() do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  g_stamp[s_ns] = clock64(); s_ns = s_ns + 1; g_ns = s_ns; } } while (0)
#define STAMP0() do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  s_ns = 1; g_ns = 1; g_stamp[0] = clock64(); } } while (0)
"""
_TAIL = """
extern "C" int read_stamps(long long* h, int* n) {
  cudaMemcpyFromSymbol(h, g_stamp, sizeof(long long) * 64);
  return (int)cudaMemcpyFromSymbol(n, g_ns, sizeof(int));
}
"""

# (source, [(first text of a function, text after it, starts a kernel)])
_REGIONS = {
    "ordered_scatter": [
        ("__device__ void block_exclusive_scan(", "// the same digit", False),
        ("ordered_scatter_one_kernel(const I*",
         "template <int K, typename I>\nint launch_one", True),
        ("ordered_scatter_cluster_kernel(const I*",
         "// shared memory of a cluster CTA", True)],
    "sum_ordered": [
        ("sum_ordered_kernel(const float*", "// one tree level over", True),
        ("__device__ void finish_tree(", "// n > 32 x 8,192", False),
        ("sum_ordered_cluster_kernel(const float*",
         "// the cluster route's shared memory", True)],
    "blocked_cumsum": [
        ("__device__ void smem_scan(", "__global__ void", False),
        ("blocked_cumsum_one_cta_kernel(const float*",
         "__device__ __forceinline__ void cluster_barrier", True),
        ("blocked_cumsum_cluster_kernel(const float*",
         "int cluster_smem_bytes", True)],
}


def instrumented(name: str) -> str:
    """The source of kernel `name` with a stamp after every barrier of
    the functions in _REGIONS (and one at each kernel's start and, for
    the one-CTA scatter kernel, at its end)."""
    s = (build.CSRC / f"{name}.cu").read_text()
    s = s.replace("namespace {", _HEAD + "namespace {", 1)
    for start, end, kernel in _REGIONS[name]:
        a = s.index(start)
        b = s.index(end, a)
        body = s[a:b].replace("__syncthreads();",
                              "__syncthreads(); STAMP();")
        for barrier in ("cluster_barrier();", "cluster_exit();"):
            body = body.replace("  " + barrier, "  " + barrier + " STAMP();")
        first = body.index("{") + 1
        body = body[:first] + (" STAMP0();" if kernel else " STAMP();") \
            + body[first:]
        if start.startswith("ordered_scatter_one_kernel"):  # its last
            k = body.rindex("\n}\n")                        # warps
            body = body[:k] + "\n  __syncthreads(); STAMP();" + body[k:]
        s = s[:a] + body + s[b:]
    return s + _TAIL


def load_instrumented(name: str) -> ctypes.CDLL:
    """Build the instrumented copy and put it where `build.load` finds
    kernel `name`, so the wrappers launch it."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    lib_path = OUT / f"lib{name}.so"
    src.write_text(instrumented(name))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in build._SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    build._loaded[name] = lib
    return lib


def phases(lib) -> tuple[list[int], int]:
    """(cycles between consecutive stamps, total) of the last launch."""
    torch.cuda.synchronize()
    h = (ctypes.c_longlong * 64)()
    n = ctypes.c_int()
    lib.read_stamps(ctypes.addressof(h), ctypes.addressof(n))
    v = list(h)[:n.value]
    return [b - a for a, b in zip(v, v[1:])], v[-1] - v[0]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases needs a CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"card": smoke.card_line(), "sm_clocks": clocks}
    dev = torch.device("cuda", 0)
    lib = load_instrumented("ordered_scatter")
    usage = [(f"rebalance_usage_{T0 + smoke.REB_P}",
              *smoke.rebalance_usage_case(dev, T0))
             for T0 in (50_000, 300_000)]
    for label, o, i, v in smoke.scatter_cases(dev) + usage:
        for _ in range(3):       # the last of three launches
            seg.scatter_add_ordered_(o.clone(), i, v)
            d, total = phases(lib)
        out[f"ordered_scatter {label}"] = {
            "plan": seg.scatter_plan(i.shape[0], o.shape[0]),
            "cycles_total": total, "cycles_by_phase": d}
    lib = load_instrumented("sum_ordered")
    rng = np.random.default_rng(0)
    for n in (smoke.D_MAIN, smoke.H_MAIN, smoke.SUM_LEVELS_N):
        x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
        for _ in range(3):
            seg.sum_ordered(x)
            d, total = phases(lib)
        out[f"sum_ordered n{n}"] = {
            "route": seg.sum_ordered_route(n),
            "cycles_total": total, "cycles_by_phase": d}
    lib = load_instrumented("blocked_cumsum")
    rng = np.random.default_rng(0)
    for shape in smoke.CUMSUM_SHAPES:
        x = torch.from_numpy(rng.uniform(-1, 1, shape)
                             .astype(np.float32)).to(dev)
        for _ in range(3):
            seg.blocked_cumsum(x)
            d, total = phases(lib)
        out[f"blocked_cumsum {shape}"] = {
            "plan": seg.blocked_cumsum_plan(shape[0]),
            "cycles_total": total, "cycles_by_phase": d}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
