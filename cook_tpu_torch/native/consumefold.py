"""ctypes binding + blessed chokepoint for the native consume-side
fast path (consume.cpp).

Three per-cycle folds that the single-leader consume/dispatch loop
used to pay item-by-item in Python live behind this module:

  fold_status_lines — the hand-built "status" event lines of
      state/store.py update_instances_bulk, assembled as ONE buffer
  frame_concat      — CKS1 launch-frame splicing for
      backends/specwire.py frame_segments
  usage_totals      — the per-host resource sums behind the agent
      cluster's offer/_used bookkeeping

Each has a byte-identical pure-Python fallback (left-to-right float
sums included, so even the _used aggregate cannot drift between
paths); the differential oracle replays one fixed trace through both
and compares event logs byte for byte. `set_enabled(False)` (wired to
the `scheduler.native_consume` setting) forces the Python path
process-wide; a missing g++ toolchain degrades the same way.

cookcheck R10 enforces that status-line assembly, spec framing, and
_used folds go through here — this module is the consume twin of the
store's `_append_segments` chokepoint.
"""
from __future__ import annotations

import ctypes

from cook_tpu_torch import native as _native

_lib = None
_lib_failed = False

# byte twins of the fixed status-line fragments (the authoritative
# Python fragments live in state/store.py; the C side compiles the
# same literals — the differential oracle pins all three together)
_B_NULL = b"null"
_B_P_TRUE = b',"p":true,"e":'
_B_P_FALSE = b',"p":false,"e":'

# INT64_MIN: the "field is null" sentinel of the C ABI (reason/exit
# codes are small ints; anything outside int64 falls back to Python)
_NULL_SENTINEL = -(2 ** 63)
_I64_MAX = 2 ** 63 - 1


def _to_i64(v):
    """None -> sentinel; otherwise coerce like the store's
    str(int(v)) and range-check explicitly — ctypes array fill
    silently truncates out-of-range ints instead of raising."""
    if v is None:
        return _NULL_SENTINEL
    v = int(v)
    if v > _I64_MAX or v <= _NULL_SENTINEL:
        raise OverflowError("outside int64")
    return v

# process-wide off switch (scheduler.native_consume=false, and the
# differential oracle's Python-path runs)
_force_python = False


def set_enabled(on: bool) -> None:
    """Force the pure-Python path when `on` is false. Both paths are
    byte-identical; this exists for A/B benches, the differential
    oracle, and as an operational escape hatch."""
    global _force_python
    _force_python = not bool(on)


def enabled() -> bool:
    return not _force_python


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _native.build("consume")
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    lib.cf_status_lines.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64)]
    lib.cf_status_lines.restype = ctypes.POINTER(ctypes.c_char)
    lib.cf_concat.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.cf_concat.restype = ctypes.POINTER(ctypes.c_char)
    lib.cf_usage_totals.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.cf_usage_totals.restype = None
    lib.cf_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
    lib.cf_free.restype = None
    _lib = lib
    return _lib


def native_available() -> bool:
    return not _force_python and _load() is not None


# ----------------------------------------------------------------------
# status-line assembly (state/store.py update_instances_bulk)

def _fold_status_py(head_b: bytes, tail_b: bytes, rows) -> bytes:
    # byte-for-byte the store's historical per-item segment build,
    # flattened into one join
    parts = []
    for task_b, frag_b, reason, preempted, exit_code in rows:
        parts.append(head_b)
        parts.append(task_b)
        parts.append(frag_b)
        parts.append(str(int(reason)).encode()
                     if reason is not None else _B_NULL)
        parts.append(_B_P_TRUE if preempted else _B_P_FALSE)
        parts.append(str(int(exit_code)).encode()
                     if exit_code is not None else _B_NULL)
        parts.append(tail_b)
    return b"".join(parts)


def fold_status_lines(head_b: bytes, tail_b: bytes, rows) -> bytes:
    """Assemble the cycle's hand-built status lines into ONE buffer.

    rows: [(task_id_bytes, status_frag_bytes, reason_code|None,
    preempted_bool, exit_code|None), ...] — head/frag/tail are the
    store's precomputed per-txn / per-status byte fragments. Returns
    the concatenation of the n newline-terminated records (the caller
    hands it to `_append_segments([buf], n)`)."""
    n = len(rows)
    lib = _load() if not _force_python else None
    if lib is None or n == 0:
        return _fold_status_py(head_b, tail_b, rows)
    try:
        tasks = (ctypes.c_char_p * n)(*[r[0] for r in rows])
        task_lens = (ctypes.c_int32 * n)(*[len(r[0]) for r in rows])
        frags = (ctypes.c_char_p * n)(*[r[1] for r in rows])
        frag_lens = (ctypes.c_int32 * n)(*[len(r[1]) for r in rows])
        reasons = (ctypes.c_int64 * n)(*[_to_i64(r[2]) for r in rows])
        pre = (ctypes.c_uint8 * n)(*[1 if r[3] else 0 for r in rows])
        exits = (ctypes.c_int64 * n)(*[_to_i64(r[4]) for r in rows])
    except (TypeError, ValueError, OverflowError):
        # a reason/exit outside int64 (or a non-numeric backend value
        # str(int(...)) would have rejected anyway): Python path owns
        # the coercion edge cases
        return _fold_status_py(head_b, tail_b, rows)
    out_len = ctypes.c_int64(0)
    buf = lib.cf_status_lines(
        n, tasks, task_lens, frags, frag_lens, reasons, pre, exits,
        head_b, len(head_b), tail_b, len(tail_b),
        ctypes.byref(out_len))
    if not buf:
        return _fold_status_py(head_b, tail_b, rows)
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        lib.cf_free(buf)


# ----------------------------------------------------------------------
# CKS1 frame splicing (backends/specwire.py frame_segments)

def frame_concat(header: bytes, segments) -> bytes:
    """header + segments spliced once (byte-identical to
    b"".join((header, *segments)))."""
    lib = _load() if not _force_python else None
    n = len(segments)
    if lib is None or n == 0:
        return b"".join((header, *segments))
    try:
        segs = (ctypes.c_char_p * n)(*segments)
        lens = (ctypes.c_int64 * n)(*[len(s) for s in segments])
    except (TypeError, ValueError):
        # non-bytes buffer types (memoryview etc.): join accepts any
        # buffer, the ctypes marshal only bytes — Python path owns it
        return b"".join((header, *segments))
    out_len = ctypes.c_int64(0)
    buf = lib.cf_concat(n, segs, lens, header, len(header),
                        ctypes.byref(out_len))
    if not buf:
        return b"".join((header, *segments))
    try:
        return ctypes.string_at(buf, out_len.value)
    finally:
        lib.cf_free(buf)


# ----------------------------------------------------------------------
# offer/_used bookkeeping (backends/agent.py _track_bulk_locked)

def usage_totals(triples) -> tuple:
    """Left-to-right sums of (mem, cpus, gpus) triples — the batch
    twin of the agent cluster's per-spec `_used` folds. The C loop
    accumulates in the same order with the same IEEE ops, so both
    paths produce bit-identical aggregates."""
    n = len(triples)
    lib = _load() if not _force_python else None
    if lib is None or n == 0:
        m = c = g = 0.0
        for tm, tc, tg in triples:
            m += tm
            c += tc
            g += tg
        return (m, c, g)
    mem = (ctypes.c_double * n)(*[t[0] for t in triples])
    cpus = (ctypes.c_double * n)(*[t[1] for t in triples])
    gpus = (ctypes.c_double * n)(*[t[2] for t in triples])
    out = (ctypes.c_double * 3)()
    lib.cf_usage_totals(n, mem, cpus, gpus, out)
    return (out[0], out[1], out[2])
