"""ctypes binding for the native group-commit event log (eventlog.cpp).

Drop-in replacement for state.store._PyLogWriter with one addition:
`sync()` — the durability barrier the commit latch uses before
acknowledging a batch submission (the reference gets this from Datomic's
transactor ack; here it is an explicit fdatasync watermark wait).
"""
from __future__ import annotations

import ctypes
from typing import Optional

from cook_tpu_torch import native as _native

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _native.build("eventlog")
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    lib.el_open.argtypes = [ctypes.c_char_p]
    lib.el_open.restype = ctypes.c_int64
    lib.el_append.argtypes = [ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.el_append.restype = ctypes.c_int64
    lib.el_lines.argtypes = [ctypes.c_int64]
    lib.el_lines.restype = ctypes.c_int64
    try:
        lib.el_append_batch.argtypes = [ctypes.c_int64, ctypes.c_char_p,
                                        ctypes.c_int64, ctypes.c_int64]
        lib.el_append_batch.restype = ctypes.c_int64
        lib._has_append_batch = True
    except AttributeError:
        # stale cached .so from before the batch entry point existed;
        # append_many degrades to per-line appends
        lib._has_append_batch = False
    try:
        lib.el_append_segments.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64]
        lib.el_append_segments.restype = ctypes.c_int64
        lib._has_append_segments = True
    except AttributeError:
        # stale cached .so predating the scatter-gather entry point;
        # append_segments degrades to a joined el_append_batch
        lib._has_append_segments = False
    lib.el_sync.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.el_sync.restype = ctypes.c_int
    lib.el_close.argtypes = [ctypes.c_int64]
    lib.el_close.restype = ctypes.c_int
    _lib = lib
    return _lib


class NativeLogWriter:
    """Append-only log backed by the C++ group-commit writer."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise OSError("native eventlog unavailable")
        self._lib = lib
        self._h = lib.el_open(path.encode())
        if self._h == 0:
            raise OSError(f"el_open failed for {path}")
        # weakref.finalize (NOT __del__): it runs at interpreter exit
        # even when the object is still reachable or gc.freeze()-pinned
        # — the C++ syncer thread MUST be joined before static
        # destruction or std::terminate aborts the process
        import weakref
        self._finalizer = weakref.finalize(self, _close_handle, lib,
                                           self._h)

    def append(self, line: str) -> None:
        b = line.encode()
        if self._lib.el_append(self._h, b, len(b)) < 0:
            raise OSError("el_append failed")

    def append_many(self, lines) -> None:
        """Batch append: one native call (one writer-mutex acquisition,
        one buffer splice) for the whole batch. Durability is unchanged
        — sync() still waits for the group-commit watermark."""
        if not lines:
            return
        if not getattr(self._lib, "_has_append_batch", False):
            for ln in lines:
                self.append(ln)
            return
        b = ("\n".join(lines) + "\n").encode()
        if self._lib.el_append_batch(self._h, b, len(b), len(lines)) < 0:
            raise OSError("el_append_batch failed")

    def append_segments(self, segs, nlines: int) -> None:
        """Scatter-gather batch append: segs is a list of bytes
        fragments concatenating to exactly `nlines` newline-terminated
        records. One native call, no Python-side join — the only copy
        is the C++ buffer splice. The ctypes arrays hold references to
        every fragment for the (synchronous) call's duration, so no
        segment can be collected mid-splice."""
        if not segs or not nlines:
            return
        if not getattr(self._lib, "_has_append_segments", False):
            self.append_many(
                b"".join(segs).decode("utf-8").splitlines())
            return
        n = len(segs)
        arr = (ctypes.c_char_p * n)(*segs)
        lens = (ctypes.c_int64 * n)(*[len(s) for s in segs])
        if self._lib.el_append_segments(self._h, arr, lens, n,
                                        nlines) < 0:
            raise OSError("el_append_segments failed")

    def lines(self) -> int:
        return int(self._lib.el_lines(self._h))

    def sync(self, timeout_ms: int = 10_000) -> None:
        rc = self._lib.el_sync(self._h, timeout_ms)
        if rc != 0:
            raise OSError("el_sync timed out — log not durable"
                          if rc == 1 else "el_sync failed")

    def close(self) -> None:
        if self._h:
            self._finalizer()   # idempotent: first call closes
            self._h = 0


def _close_handle(lib, h) -> None:
    try:
        lib.el_close(h)
    except Exception:
        pass


def make_log_writer(path: str):
    """Best writer available: native group-commit, else pure Python."""
    try:
        return NativeLogWriter(path)
    except Exception:
        from cook_tpu_torch.state.store import _PyLogWriter
        return _PyLogWriter(path)
