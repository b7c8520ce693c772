"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C launch function. At first use it
is compiled with nvcc for sm_90a into `cook_tpu_torch/_build/` (listed
in .gitignore), keyed by a hash of the source and flags, and loaded with
ctypes: every pointer and the stream are passed as c_void_p. Only
sources in this package are compiled.

    python -m cook_tpu_torch.kernels.build      # build every kernel
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
KERNELS = ("exact_scan", "best_host")

# argtypes of each kernel's launch function
_SIGNATURES = {
    "exact_scan": ("exact_scan_launch",
                   [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]),
    "best_host": ("best_host_launch",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]),
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
    key = hashlib.sha256(src.read_bytes()
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
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


if __name__ == "__main__":
    for k, s in build_all().items():
        print(f"{k}: {s:.1f} s")
        print(build_log.get(k, ""))
