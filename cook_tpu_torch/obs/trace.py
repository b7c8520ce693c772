"""Lock-safe tracer + flight recorder (the tentpole's core).

Model
-----
A *span* is a finished dict ``{"name", "trace", "span", "parent",
"t0", "t1", "attrs"}`` with wall-clock millisecond bounds.  Spans are
either

* **trace-indexed** — they carry a 32-hex trace id and land in a
  bounded, LRU-evicted per-trace index so ``/trace/<job_uuid>`` can
  assemble the job's whole lifecycle tree, or
* **flight** — per-cycle scheduler spans (phase timings embedded as
  ``children``) appended to a bounded ring, the "flight recorder"
  served by ``/debug/flight``.

Context propagates as a W3C-style ``traceparent`` string
``00-<32 hex trace id>-<16 hex span id>-01`` carried in job records,
launch-spec wire dicts and agent status posts.

Cost discipline: when ``tracer.enabled`` is False every entry point
returns immediately with zero allocation (``start_span`` hands back a
shared no-op span).  When enabled, span *bodies* (the ``attrs`` dict)
are sampled — 1 in ``attr_sample_every`` finished spans keeps its
attrs — while timings are always kept, so the recorder stays useful
without unbounded label cardinality.
"""
from __future__ import annotations

import collections
import re
import threading
import time
import uuid
from typing import Iterable, Optional

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def now_ms() -> float:
    return time.time() * 1000.0


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def make_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(tp) -> Optional[tuple]:
    """``(trace_id, span_id)`` for a well-formed traceparent, else None."""
    if not isinstance(tp, str):
        return None
    m = _TRACEPARENT_RE.match(tp)
    if m is None:
        return None
    return m.group(1), m.group(2)


class Span:
    """A live span; ``finish()`` (or context-manager exit) records it."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t0", "attrs", "_done")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str, attrs: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = now_ms()
        self.attrs = attrs
        self._done = False

    @property
    def traceparent(self) -> str:
        return make_traceparent(self.trace_id, self.span_id)

    def set_attr(self, key, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def finish(self, end_ms: Optional[float] = None) -> None:
        if self._done:
            return
        self._done = True
        self.tracer.record(
            self.name, trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, start_ms=self.t0,
            end_ms=now_ms() if end_ms is None else end_ms, attrs=self.attrs)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.set_attr("error", getattr(exc_type, "__name__", "error"))
        self.finish()


class _NoopSpan:
    """Shared do-nothing span — the zero-allocation disabled path."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = ""
    traceparent = ""

    def set_attr(self, key, value) -> None:
        pass

    def finish(self, end_ms=None) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def assemble_tree(spans: Iterable[dict]) -> list:
    """Assemble finished span dicts into a forest: roots with nested
    ``children``, siblings ordered by start time.

    Module-level (not a Tracer method) so the federation-aware
    ``/trace`` path can assemble a MERGED span set — local spans plus
    the owning peer groups' — into one connected tree."""
    spans = list(spans)
    nodes = {s["span"]: dict(s, children=[]) for s in spans}
    roots = []
    for s in spans:
        node = nodes[s["span"]]
        parent = nodes.get(s["parent"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)

    def _sort(ns):
        ns.sort(key=lambda n: n["t0"])
        for n in ns:
            _sort(n["children"])
    _sort(roots)
    return roots


class Tracer:
    """Thread-safe span sink: flight ring + bounded per-trace index.

    One lock guards both structures; listeners (exporters) are invoked
    *outside* the lock so a slow file write never stalls the scheduler.
    """

    def __init__(self, ring_capacity: int = 2048, max_traces: int = 512,
                 max_spans_per_trace: int = 256, enabled: bool = True,
                 attr_sample_every: int = 1):
        self.enabled = enabled
        self.attr_sample_every = max(1, int(attr_sample_every))
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_capacity)
        self._traces: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        self._listeners: list = []
        self._finished = 0
        self._dropped = 0

    # -- span creation -------------------------------------------------

    def start_span(self, name: str, parent=None, traceparent: str = "",
                   trace_id: str = "", parent_id: str = "",
                   attrs: Optional[dict] = None):
        """Open a live span; use as a context manager or ``.finish()`` it.

        Parent may be given as a ``Span`` (``parent=``), a traceparent
        string, or explicit ``trace_id``/``parent_id``.  With no parent
        a fresh trace is started.
        """
        if not self.enabled:
            return NOOP_SPAN
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif traceparent:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, parent_id = parsed
        if not trace_id:
            trace_id = new_trace_id()
        return Span(self, name, trace_id, new_span_id(), parent_id, attrs)

    # -- recording -----------------------------------------------------

    def record(self, name: str, trace_id: str = "",
               span_id: str = "", parent_id: str = "",
               start_ms: float = 0.0, end_ms: float = 0.0,
               attrs: Optional[dict] = None) -> str:
        """Record an already-timed span into the per-trace index.

        Used for phase spans reconstructed from existing timings and
        for remote spans reported by agents.  Returns the span id (""
        when tracing is disabled).
        """
        if not self.enabled:
            return ""
        sid = span_id or new_span_id()
        span = {"name": name, "trace": trace_id, "span": sid,
                "parent": parent_id, "t0": round(start_ms, 3),
                "t1": round(end_ms, 3)}
        with self._lock:
            self._finished += 1
            if attrs is not None and \
                    self._finished % self.attr_sample_every == 0:
                span["attrs"] = attrs
            if trace_id:
                spans = self._traces.get(trace_id)
                if spans is None:
                    spans = self._traces[trace_id] = []
                    while len(self._traces) > self.max_traces:
                        self._traces.popitem(last=False)
                        self._dropped += 1
                else:
                    self._traces.move_to_end(trace_id)
                if len(spans) < self.max_spans_per_trace:
                    spans.append(span)
                else:
                    self._dropped += 1
        self._notify(span)
        return sid

    def record_cycle(self, name: str, start_ms: float, end_ms: float,
                     phases: Iterable[tuple] = (),
                     attrs: Optional[dict] = None) -> None:
        """Append one per-cycle span to the flight ring.

        ``phases`` is ``[(phase_name, t0_ms, t1_ms), ...]`` — the
        existing phase timings, embedded as child spans so each ring
        entry is self-contained.  Flight spans always keep their attrs
        (they ARE the recorder's payload) but there is at most one per
        scheduler cycle, so cardinality is bounded by the ring.
        """
        if not self.enabled:
            return
        span = {"name": name, "span": new_span_id(), "parent": "",
                "t0": round(start_ms, 3), "t1": round(end_ms, 3),
                "attrs": attrs or {},
                "children": [{"name": p, "t0": round(a, 3),
                              "t1": round(b, 3)} for p, a, b in phases]}
        with self._lock:
            self._finished += 1
            self._ring.append(span)
        self._notify(span)

    def _notify(self, span: dict) -> None:
        for fn in tuple(self._listeners):
            try:
                fn(span)
            except Exception:
                pass   # an exporter must never take down the scheduler

    # -- reads ---------------------------------------------------------

    def trace(self, trace_id: str) -> list:
        """Copy of the finished spans recorded under ``trace_id``."""
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def tree(self, trace_id: str) -> list:
        """Assembled span forest for a trace: roots with nested
        ``children``, siblings ordered by start time."""
        return assemble_tree(self.trace(trace_id))

    def recent(self, limit: int = 64) -> list:
        """Newest-first flight-recorder entries (per-cycle spans)."""
        with self._lock:
            ring = list(self._ring)
        return ring[::-1][:max(0, int(limit))]

    def stats(self) -> dict:
        with self._lock:
            return {"finished": self._finished, "dropped": self._dropped,
                    "ring": len(self._ring), "traces": len(self._traces),
                    "enabled": self.enabled}

    # -- listeners / lifecycle ----------------------------------------

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._traces.clear()
            self._finished = 0
            self._dropped = 0


# Process-wide default, mirroring utils.metrics.registry.
tracer = Tracer()
