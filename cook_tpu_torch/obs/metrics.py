"""Process-wide metrics registry: one exposition path for everything.

The scheduler grew two generations of telemetry — codahale-style
dotted-name Meters/Timers (utils/metrics.py, reporter.clj lineage) and
ad-hoc `self.metrics` dicts — each rendered by its own code.  This
module is the single registry both generations now live in:

* **New API** — snake_case metric families with bounded label sets:
  ``registry.counter("match_matched_total", pool="default").inc(n)``,
  ``registry.histogram("match_cycle_ms", pool=p).observe(ms)`` (log-
  bucketed, Prometheus ``_bucket``/``_sum``/``_count`` exposition),
  ``registry.gauge("ingest_queue_depth").set(d)``.
* **Legacy API** — the same ``counter()/meter()/timer()/histogram()``
  verbs accept the old dotted names with no labels; Meters render as
  ``_total``+``_rate``, Timers as reservoir summaries with exact
  quantiles, so existing scrapes keep their shape while call sites
  migrate (cookcheck R7 tracks the stragglers).

Cardinality is bounded per family: past ``label_cap`` distinct label
sets, new children collapse into a single ``overflow="true"`` child and
``metrics_label_overflow_total{metric=...}`` counts the spill — a
runaway label (a uuid, a hostname set) degrades to one series instead
of an unbounded scrape.

``snapshot()`` keeps the typed-dict shape the Graphite/JSONL reporters
flatten (labeled children use Graphite 1.1 ``;k=v`` tag syntax), and
``render()`` is the one Prometheus text-exposition path `/metrics`
serves.  Deliberately dependency-free: stdlib only, no cook_tpu
imports (utils.metrics aliases its module-global registry to this one,
so importing from here must never import back).
"""
from __future__ import annotations

import collections
import math
import random
import re
import threading
import time
from typing import Optional

_SNAKE = re.compile(r"^[a-z][a-z0-9_]*$")

# Log-spaced (powers of two) default bounds. One table serves both
# millisecond latencies (0.25ms .. ~2.2min) and discrete sizes (batch
# jobs, queue depths) — the point is stable bucket edges across
# processes so histograms aggregate, not per-metric tuning.
DEFAULT_BUCKETS = tuple(float(2 ** i) for i in range(-2, 18))


def _fmt(v: float) -> str:
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def _prom_name(name: str) -> str:
    # identical sanitation to utils.metrics._prom_name so migrated
    # dotted names keep their historical exposition names
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    base = "".join(out)
    if base and base[0].isdigit():
        base = "_" + base
    return f"cook_{base}"


def _label_str(labels: tuple) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in labels:
        sv = str(v).replace("\\", r"\\").replace('"', r'\"')
        sv = sv.replace("\n", r"\n")
        parts.append(f'{k}="{sv}"')
    return "{" + ",".join(parts) + "}"


def _pctl(sorted_vals: list, p: float) -> float:
    """Linear-interpolated percentile (numpy.percentile semantics)."""
    if not sorted_vals:
        return 0.0
    k = (len(sorted_vals) - 1) * (p / 100.0)
    f, c = math.floor(k), math.ceil(k)
    if f == c:
        return sorted_vals[int(k)]
    return sorted_vals[f] * (c - k) + sorted_vals[c] * (k - f)


class Counter:
    """Monotonic (by convention) counter; set() kept for legacy gauges
    that historically rode Counter."""

    kind = "counter"

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}

    def render_into(self, lines: list, pn: str, ls: str) -> None:
        lines.append(f"{pn}{ls} {_fmt(self._v)}")


class Gauge:
    kind = "gauge"

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}

    def render_into(self, lines: list, pn: str, ls: str) -> None:
        lines.append(f"{pn}{ls} {_fmt(self._v)}")


class Meter:
    """Event rate over a sliding window (legacy codahale Meter)."""

    kind = "meter"

    def __init__(self, window_s: float = 60.0, clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        self._events: collections.deque = collections.deque()
        self._total = 0.0
        self._lock = threading.Lock()

    def mark(self, n: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            self._events.append((now, n))
            self._total += n
            cutoff = now - self.window_s
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    @property
    def rate(self) -> float:
        now = self._clock()
        with self._lock:
            cutoff = now - self.window_s
            recent = sum(n for t, n in self._events if t >= cutoff)
            return recent / self.window_s

    @property
    def count(self) -> float:
        return self._total

    def snapshot(self) -> dict:
        return {"type": "meter", "count": self.count, "rate": self.rate}

    def render_into(self, lines: list, pn: str, ls: str) -> None:
        lines.append(f"{pn}_total{ls} {_fmt(self.count)}")
        lines.append(f"{pn}_rate{ls} {self.rate:.6g}")


class Histogram:
    """Log-bucketed histogram: fixed power-of-two bounds, cumulative
    Prometheus ``_bucket{le=}`` exposition, O(len(buckets)) memory.

    Quantiles in ``snapshot()`` are bucket-interpolated estimates (good
    to one bucket width) so Graphite/JSONL export keeps its
    p50/p95/p99 keys without a reservoir."""

    kind = "histogram"

    def __init__(self, buckets: tuple = DEFAULT_BUCKETS):
        self._bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._bounds) + 1)   # +Inf tail
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect by hand: bounds are tiny (~20) and this avoids taking
        # an import on the hot path's behalf
        lo, hi = 0, len(self._bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self._bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._sum += v
            self._n += 1

    # legacy Histogram/Timer verb
    update = observe

    def time(self):
        hist = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe((time.perf_counter() - self.t0) * 1e3)
                return False

        return _Ctx()

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def _quantile(self, q: float, counts: list, total: int) -> float:
        target = q * total
        cum, lo = 0.0, 0.0
        for i, ub in enumerate(self._bounds):
            c = counts[i]
            if c and cum + c >= target:
                return lo + (target - cum) / c * (ub - lo)
            cum += c
            lo = ub
        return self._bounds[-1] if self._bounds else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._n, self._sum
        if total == 0:
            return {"type": "histogram", "count": 0}
        return {"type": "histogram", "count": total, "sum": s,
                "mean": s / total,
                "p50": self._quantile(0.50, counts, total),
                "p95": self._quantile(0.95, counts, total),
                "p99": self._quantile(0.99, counts, total)}

    def render_into(self, lines: list, pn: str, ls: str) -> None:
        with self._lock:
            counts = list(self._counts)
            total, s = self._n, self._sum
        inner = ls[1:-1] if ls else ""
        cum = 0
        for i, ub in enumerate(self._bounds):
            cum += counts[i]
            sep = "," if inner else ""
            lines.append(
                f'{pn}_bucket{{{inner}{sep}le="{_fmt(ub)}"}} {cum}')
        sep = "," if inner else ""
        lines.append(f'{pn}_bucket{{{inner}{sep}le="+Inf"}} {total}')
        lines.append(f"{pn}_sum{ls} {s:.6g}")
        lines.append(f"{pn}_count{ls} {total}")


class Timer:
    """Reservoir summary timer (legacy shape): exact quantiles over a
    sampled reservoir, ``{quantile="0.5"}`` exposition, ``time()``
    context manager.  Kept for dotted-name call sites whose scrapes
    pin summary lines; new latency metrics use Histogram."""

    kind = "timer"

    def __init__(self, reservoir: int = 4096):
        self.reservoir = reservoir
        self._vals: list = []
        self._n = 0
        self._lock = threading.Lock()
        self._rng = random.Random(0)

    def update(self, v: float) -> None:
        with self._lock:
            self._n += 1
            if len(self._vals) < self.reservoir:
                self._vals.append(float(v))
            else:  # vitter's algorithm R
                i = self._rng.randrange(self._n)
                if i < self.reservoir:
                    self._vals[i] = float(v)

    observe = update

    def time(self):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.update((time.perf_counter() - self.t0) * 1e3)
                return False

        return _Ctx()

    def snapshot(self) -> dict:
        with self._lock:
            vals = sorted(self._vals)
            n = self._n
        if not vals:
            return {"type": "timer", "count": 0}
        return {"type": "timer", "count": n, "min": vals[0],
                "max": vals[-1], "mean": sum(vals) / len(vals),
                "p50": _pctl(vals, 50), "p95": _pctl(vals, 95),
                "p99": _pctl(vals, 99)}

    def render_into(self, lines: list, pn: str, ls: str) -> None:
        snap = self.snapshot()
        inner = ls[1:-1] if ls else ""
        sep = "," if inner else ""
        for q_key, q_label in (("p50", "0.5"), ("p95", "0.95"),
                               ("p99", "0.99")):
            if q_key in snap:
                lines.append(
                    f'{pn}{{{inner}{sep}quantile="{q_label}"}} '
                    f"{snap[q_key]:.6g}")
        lines.append(f"{pn}_count{ls} {_fmt(float(snap['count']))}")
        if "mean" in snap:
            lines.append(f"{pn}_mean{ls} {snap['mean']:.6g}")


# TYPE line per kind; meters expose two series so the header is split
_TYPE_LINE = {"counter": "counter", "gauge": "gauge",
              "histogram": "histogram", "timer": "summary"}


class _Family:
    """All children of one metric name: same kind, distinct label sets,
    bounded cardinality."""

    __slots__ = ("name", "kind", "cls", "kwargs", "children", "cap",
                 "label_names")

    def __init__(self, name: str, cls, kwargs: dict, cap: int):
        self.name = name
        self.cls = cls
        self.kind = cls.kind
        self.kwargs = kwargs
        self.children: dict = {}      # label-tuple -> metric
        self.cap = cap
        self.label_names: Optional[tuple] = None


_OVERFLOW_LABELS = (("overflow", "true"),)


class Registry:
    """The process-wide metric registry (see module docstring)."""

    def __init__(self, label_cap: int = 64):
        self._families: dict = {}
        self._lock = threading.Lock()
        self.label_cap = label_cap

    # -- creation ---------------------------------------------------

    def _get(self, name: str, cls, labels: dict, kwargs: dict = None):
        if labels:
            if not _SNAKE.match(name):
                raise ValueError(
                    f"labeled metric name {name!r} must be snake_case")
            for k in labels:
                if not _SNAKE.match(k):
                    raise ValueError(
                        f"label name {k!r} must be snake_case")
            key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        else:
            key = ()
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, cls, kwargs or {}, self.label_cap)
            if fam.cls is not cls:
                raise ValueError(
                    f"{name} is a {fam.kind}, requested {cls.kind}")
            if key and fam.label_names is None:
                fam.label_names = tuple(k for k, _ in key)
            elif key and fam.label_names != tuple(k for k, _ in key):
                raise ValueError(
                    f"{name} label names {fam.label_names} != "
                    f"{tuple(k for k, _ in key)}")
            m = fam.children.get(key)
            if m is None:
                if key and len(fam.children) >= fam.cap:
                    # cardinality spill: one overflow child, counted
                    key = _OVERFLOW_LABELS
                    m = fam.children.get(key)
                    ovf = self._families.get(
                        "metrics_label_overflow_total")
                    if ovf is None:
                        ovf = self._families[
                            "metrics_label_overflow_total"] = _Family(
                                "metrics_label_overflow_total",
                                Counter, {}, self.label_cap)
                    okey = (("metric", name),)
                    oc = ovf.children.get(okey)
                    if oc is None:
                        oc = ovf.children[okey] = Counter()
                        ovf.label_names = ("metric",)
                    oc.inc()
                if m is None:
                    m = fam.children[key] = cls(**fam.kwargs)
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def meter(self, name: str, **labels) -> Meter:
        return self._get(name, Meter, labels)

    def timer(self, name: str, **labels) -> Timer:
        return self._get(name, Timer, labels)

    def histogram(self, name: str, buckets: tuple = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, Histogram, labels,
                         {"buckets": buckets})

    # -- export -----------------------------------------------------

    def snapshot(self) -> dict:
        """Typed-dict snapshot, one entry per child.  Labeled children
        key as ``name;k=v;k2=v2`` (Graphite 1.1 tag syntax) so the
        Graphite/JSONL reporters flatten them unchanged."""
        with self._lock:
            fams = [(f.name, list(f.children.items()))
                    for f in self._families.values()]
        out = {}
        for name, children in fams:
            for key, m in children:
                if key:
                    tag = ";".join(f"{k}={v}" for k, v in key)
                    out[f"{name};{tag}"] = m.snapshot()
                else:
                    out[name] = m.snapshot()
        return out

    def render(self) -> str:
        """Prometheus text exposition — the one `/metrics` code path."""
        with self._lock:
            fams = sorted(
                ((f.name, f.kind, list(f.children.items()))
                 for f in self._families.values()),
                key=lambda t: t[0])
        lines = []
        for name, kind, children in fams:
            pn = _prom_name(name)
            if kind == "meter":
                lines.append(f"# TYPE {pn}_total counter")
                lines.append(f"# TYPE {pn}_rate gauge")
            else:
                lines.append(f"# TYPE {pn} {_TYPE_LINE[kind]}")
            for key, m in sorted(children, key=lambda kv: kv[0]):
                m.render_into(lines, pn, _label_str(key))
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Drop every family (test isolation only)."""
        with self._lock:
            self._families.clear()


# the process-wide default registry; utils.metrics aliases its module
# global to this exact instance so both generations share exposition
registry = Registry()
