"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C launch function. At first use it
is compiled with nvcc for sm_90a into `cook_tpu_torch/_build/` (listed
in .gitignore), keyed by a hash of the source, the shared `csrc/*.cuh`
headers and the flags, and loaded with
ctypes: every pointer and the stream are passed as c_void_p. Only
sources in this package are compiled.

    python -m cook_tpu_torch.kernels.build      # build every kernel
    python -m cook_tpu_torch.kernels.build --sass best_host   # its SASS
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
KERNELS = ("exact_scan", "best_host", "blocked_cumsum", "ordered_scatter",
           "sum_ordered")

# argtypes of the C functions each kernel's library exports (all return
# int)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "exact_scan": {
        "exact_scan_launch": [_P] * 11 + [_I, _I, _I, _P],
        "exact_scan_cluster": []},
    "best_host": {
        "best_host_launch": [_P] * 8 + [_I, _I, _I, ctypes.c_float, _P],
        "best_host_div_check": [ctypes.c_uint, ctypes.c_uint, _P, _P]},
    "blocked_cumsum": {
        "blocked_cumsum_launch": [_P] * 2 + [_I, _I, _LL, _LL, _I, _I, _P],
        "blocked_cumsum_global_launch": [_P] * 2 + [
            _I, _I, _LL, _LL, _P, _LL, _P]},
    "ordered_scatter": {
        "ordered_scatter_launch": [_P] * 4 + [_I] * 7 + [_P],
        "ordered_scatter_sorted_launch": [_P] * 4 + [_I] * 3 + [_P],
        "ordered_scatter_cluster_launch": [_P] * 3 + [_I] * 4 + [_P],
        "ordered_scatter_cluster_ctas": [],
        "ordered_scatter_clusters": []},
    "sum_ordered": {
        "sum_ordered_launch": [_P] * 2 + [_I, _P],
        "sum_ordered_levels_launch": [_P] * 2 + [_LL, _LL, _I, _P],
        "sum_ordered_cluster_launch": [_P] * 2 + [_I, _P],
        "sum_ordered_cluster_ctas": [],
        "sum_ordered_noop_launch": [_I, _P]},
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    # the shared headers are part of every source's key
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start nvcc for one kernel; returns (process or None, out path)."""
    src, out = _target(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def _finish(name: str, proc, out: Path, t0: float) -> None:
    if proc is None:
        build_seconds.setdefault(name, 0.0)
        return
    log, _ = proc.communicate()
    build_log[name] = log
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every kernel not built yet, one nvcc per source, all
    started together. Returns seconds per kernel (0 = already built)."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in names}
        for n, (proc, out) in started.items():
            _finish(n, proc, out, t0)
        return {n: build_seconds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_target(name)[1]))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def sass_listing(name: str) -> str:
    """The sm_90a SASS of a built kernel (cuobjdump -sass; "" where the
    toolkit has no cuobjdump)."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return ""
    return subprocess.run([str(tool), "-sass", str(_target(name)[1])],
                          capture_output=True, text=True, check=True).stdout


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--sass"]:     # --sass NAME: print the listing
        build_all((sys.argv[2],))
        print(sass_listing(sys.argv[2]))
        sys.exit(0)
    for k, s in build_all().items():
        print(f"{k}: {s:.1f} s")
        print(build_log.get(k, ""))
