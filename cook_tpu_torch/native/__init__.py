"""Native (C++) runtime components, loaded via ctypes.

The compute path of the framework is JAX/XLA/Pallas; this package holds
the host-side native runtime pieces that the reference keeps in
JVM/native land (libmesos JNI, the Datomic transactor JVM):

  eventlog.cpp — group-commit durable append-only log (store write path)

Shared objects are built on demand with g++ (toolchain is guaranteed in
the image) and cached in the package's build directory; a stale .so
(older than its .cpp) is rebuilt.  Every consumer must degrade
gracefully when the toolchain is missing: `build(...)` returns None and
callers fall back to pure-Python implementations.
"""
from __future__ import annotations

import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
# built objects go to the package's git-ignored build directory, each
# through a temp name of its own process and thread: concurrent
# processes (test workers) may build the same library at once, and the
# last os.replace installs a complete file
_OUT = os.path.join(os.path.dirname(_DIR), "_build", "native")
_BUILD_LOCK = threading.Lock()


def build(name: str) -> str | None:
    """Compile native/<name>.cpp → _build/native/lib<name>.so if
    needed; return the .so path, or None if the build fails (callers
    fall back)."""
    src = os.path.join(_DIR, f"{name}.cpp")
    so = os.path.join(_OUT, f"lib{name}.so")
    with _BUILD_LOCK:
        try:
            if (os.path.exists(so)
                    and os.path.getmtime(so) >= os.path.getmtime(src)):
                return so
            os.makedirs(_OUT, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 "-o", tmp, src],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
            return so
        except Exception:
            return None
