"""Span exporters: JSONL sink + Chrome-trace/Perfetto conversion."""
from __future__ import annotations

import json
import os
import threading
from typing import Iterable, Optional


class SpanJsonlExporter:
    """Tracer listener that appends one JSON line per finished span.

    Sits alongside the metric reporters (utils.metrics.JsonlReporter)
    but is event-driven rather than interval-driven: attach with
    ``tracer.add_listener(exporter)``.

    ``max_mb`` bounds the file: when an append would cross the bound
    the current file is atomically renamed to ``<path>.1`` (replacing
    any previous generation) and a fresh file is started — a long-
    lived server holds at most ~2x the bound on disk instead of
    growing without limit.  ``max_mb=0`` disables rotation.
    """

    def __init__(self, path: str, max_mb: float = 0.0):
        self.path = path
        self.max_bytes = int(max(0.0, float(max_mb)) * 1024 * 1024)
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")
        self._size = os.path.getsize(path)

    def __call__(self, span: dict) -> None:
        line = json.dumps(span, separators=(",", ":")) + "\n"
        with self._lock:
            if self._f is None:
                return
            if self.max_bytes and self._size \
                    and self._size + len(line) > self.max_bytes:
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def _rotate_locked(self) -> None:
        """Swap in a fresh file; the old one becomes ``<path>.1``.

        ``os.replace`` is atomic on POSIX, so a tail-follower sees
        either the old generation or the new file, never a torn one.
        Rotation failure (e.g. a read-only dir racing a permission
        change) falls back to continuing in the current file — losing
        the bound beats losing the spans."""
        try:
            self._f.close()
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._f = open(self.path, "a", encoding="utf-8")
        self._size = os.path.getsize(self.path)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def to_chrome_trace(spans: Iterable[dict], pid: int = 1,
                    tid_key: str = "pool") -> dict:
    """Convert span dicts to Chrome-trace JSON (opens in Perfetto /
    chrome://tracing).

    Each span becomes a complete ("ph": "X") event; flight-recorder
    entries inline their phase ``children`` on the same track.  Tracks
    (tids) are keyed by ``attrs[tid_key]`` when present, else by trace
    id, with "M"etadata events naming each track.
    """
    events = []
    tids: dict = {}

    def _tid(span: dict) -> int:
        key = (span.get("attrs") or {}).get(tid_key) \
            or span.get("trace") or "main"
        key = str(key)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": tids[key],
                           "name": "thread_name", "args": {"name": key}})
        return tids[key]

    def _emit(span: dict, tid: Optional[int] = None) -> None:
        if tid is None:
            tid = _tid(span)
        t0, t1 = float(span.get("t0", 0.0)), float(span.get("t1", 0.0))
        args = {k: v for k, v in (span.get("attrs") or {}).items()}
        if span.get("span"):
            args["span"] = span["span"]
        if span.get("parent"):
            args["parent"] = span["parent"]
        events.append({"name": span.get("name", "?"), "ph": "X",
                       "cat": "cook", "pid": pid, "tid": tid,
                       "ts": round(t0 * 1000.0, 1),
                       "dur": round(max(t1 - t0, 0.0) * 1000.0, 1),
                       "args": args})
        for child in span.get("children", ()):
            _emit(child, tid)

    for s in spans:
        _emit(s)
    return {"traceEvents": events, "displayTimeUnit": "ms"}
