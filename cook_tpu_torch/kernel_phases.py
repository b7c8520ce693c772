"""Where the time of the one-CTA segment kernels goes, phase by phase.

    python -m cook_tpu_torch.kernel_phases

Builds instrumented copies of csrc/ordered_scatter.cu and
csrc/blocked_cumsum.cu (into cook_tpu_torch/_build/phases/, beside the
normal build): after every `__syncthreads()` (and cluster barrier) of
the one-launch scatter kernel, the exclusive scan inside it, the
on-chip cumsum kernels and their shared-memory scan, thread 0 of block 0
records `clock64()`. The wrappers then run with the instrumented
libraries on chip_smoke.py's main-path inputs (the three scatter shapes,
the four cumsum shapes), and the script prints, per case, the SM cycles
between consecutive stamps (the first from the kernel's start) and
their total, with the card's name, power limit and SM clocks. The
stamps cost a few cycles each; times are cycles of the SM clock, not
device time. Needs a CUDA device.
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

_HEAD = """
__device__ long long g_stamp[64];
__device__ int g_ns;
#define STAMP() do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  g_stamp[g_ns] = clock64(); g_ns = g_ns + 1; } } while (0)
#define STAMP0() do { if (threadIdx.x == 0 && blockIdx.x == 0) { \\
  g_ns = 1; g_stamp[0] = clock64(); } } while (0)
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
         "template <int K, typename I>\nint launch_one", True)],
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
    the scatter kernel, at its end)."""
    s = (build.CSRC / f"{name}.cu").read_text()
    s = s.replace("namespace {", _HEAD + "namespace {", 1)
    for start, end, kernel in _REGIONS[name]:
        a = s.index(start)
        b = s.index(end, a)
        body = s[a:b].replace("__syncthreads();",
                              "__syncthreads(); STAMP();")
        body = body.replace("  cluster_barrier();",
                            "  cluster_barrier(); STAMP();")
        first = body.index("{") + 1
        body = body[:first] + (" STAMP0();" if kernel else " STAMP();") \
            + body[first:]
        if kernel and name == "ordered_scatter":   # the long-run warps
            k = body.rindex("\n}\n")
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
    for label, o, i, v in smoke.scatter_cases(dev):
        for _ in range(3):       # the last of three launches
            seg.scatter_add_ordered_(o.clone(), i, v)
            d, total = phases(lib)
        out[f"ordered_scatter {label}"] = {
            "plan": seg.scatter_plan(i.shape[0], o.shape[0]),
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
