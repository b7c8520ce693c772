"""Metrics registry: counters, meters, timers, histograms + reporters.

Equivalent of the reference's codahale metrics usage (monitor.clj,
reporter.clj:32-82): a process-wide registry with the four metric kinds
the scheduler instruments everywhere (cycle timers, completion meters,
DRU histograms), and periodic reporters (console / JSONL file — the
JMX/Graphite/Riemann role).  Stdlib + numpy only.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from typing import Optional

import numpy as np


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        return self._v


class Meter:
    """Event rate over a sliding window."""

    def __init__(self, window_s: float = 60.0, clock=time.monotonic):
        self.window_s = window_s
        self._clock = clock
        # deque: mark() runs once per match, and list.pop(0) made the
        # window trim O(n) on exactly that hot path
        self._events: collections.deque[tuple[float, float]] = \
            collections.deque()
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
        """events/sec over the window."""
        now = self._clock()
        with self._lock:
            cutoff = now - self.window_s
            recent = sum(n for t, n in self._events if t >= cutoff)
            return recent / self.window_s

    @property
    def count(self) -> float:
        return self._total


class Histogram:
    """Reservoir histogram with percentile snapshots."""

    def __init__(self, reservoir: int = 4096):
        self.reservoir = reservoir
        self._vals: list[float] = []
        self._n = 0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(0)

    def update(self, v: float) -> None:
        with self._lock:
            self._n += 1
            if len(self._vals) < self.reservoir:
                self._vals.append(float(v))
            else:  # vitter's algorithm R
                i = int(self._rng.integers(0, self._n))
                if i < self.reservoir:
                    self._vals[i] = float(v)

    def snapshot(self) -> dict:
        with self._lock:
            if not self._vals:
                return {"count": 0}
            arr = np.asarray(self._vals)
            return {"count": self._n, "min": float(arr.min()),
                    "max": float(arr.max()), "mean": float(arr.mean()),
                    "p50": float(np.percentile(arr, 50)),
                    "p95": float(np.percentile(arr, 95)),
                    "p99": float(np.percentile(arr, 99))}


class Timer(Histogram):
    """Duration histogram in milliseconds with a context-manager API."""

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


class MetricRegistry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            assert isinstance(m, cls), f"{name} is {type(m).__name__}"
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            if isinstance(m, Timer):
                out[name] = {"type": "timer", **m.snapshot()}
            elif isinstance(m, Histogram):
                out[name] = {"type": "histogram", **m.snapshot()}
            elif isinstance(m, Meter):
                out[name] = {"type": "meter", "count": m.count,
                             "rate": m.rate}
            elif isinstance(m, Counter):
                out[name] = {"type": "counter", "value": m.value}
        return out


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    base = "".join(out)
    if base and base[0].isdigit():
        base = "_" + base
    return f"cook_{base}"


def render_prometheus(snapshot: dict) -> str:
    """Text exposition format (the modern equivalent of the reference's
    Graphite/JMX reporters, reporter.clj:32-82): counters/meters as
    counters, histogram/timer percentiles as labeled gauges."""
    lines = []
    for name, data in sorted(snapshot.items()):
        pn = _prom_name(name)
        kind = data.get("type")
        if kind == "counter":
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {data['value']}")
        elif kind == "meter":
            lines.append(f"# TYPE {pn}_total counter")
            lines.append(f"{pn}_total {data['count']}")
            lines.append(f"# TYPE {pn}_rate gauge")
            lines.append(f"{pn}_rate {data['rate']:.6g}")
        elif kind in ("histogram", "timer"):
            lines.append(f"# TYPE {pn} summary")
            for q_key, q_label in (("p50", "0.5"), ("p95", "0.95"),
                                   ("p99", "0.99")):
                if q_key in data:
                    lines.append(
                        f'{pn}{{quantile="{q_label}"}} '
                        f"{data[q_key]:.6g}")
            if "count" in data:
                lines.append(f"{pn}_count {data['count']}")
            if "mean" in data:
                lines.append(f"{pn}_mean {data['mean']:.6g}")
    return "\n".join(lines) + "\n"


# Process-wide default registry (the codahale default-registry role).
# This IS the obs registry instance: every producer that
# imports `registry` from here lands on the same labeled-family
# registry /metrics renders, so exposition has exactly one code path
# (obs/metrics.py Registry.render). The MetricRegistry class above and
# render_prometheus below remain for standalone registries
# (StatsMonitor, tests) and for Graphite snapshot rendering.
from cook_tpu_torch.obs.metrics import registry  # noqa: E402


class Reporter:
    """Periodic snapshot publisher (reporter.clj:32-82)."""

    def __init__(self, reg: MetricRegistry, interval_s: float = 60.0):
        self.registry = reg
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish(self, snapshot: dict) -> None:
        raise NotImplementedError

    def start(self) -> "Reporter":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.publish(self.registry.snapshot())
                except Exception:
                    pass
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()


class ConsoleReporter(Reporter):
    def publish(self, snapshot: dict) -> None:
        print(json.dumps({"ts": time.time(), "metrics": snapshot},
                         default=str))


class JsonlReporter(Reporter):
    """Append snapshots to a JSONL file."""

    def __init__(self, reg: MetricRegistry, path: str,
                 interval_s: float = 60.0):
        super().__init__(reg, interval_s)
        self.path = path

    def publish(self, snapshot: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"ts": time.time(),
                                "metrics": snapshot}) + "\n")


class GraphiteReporter(Reporter):
    """Push snapshots over the Graphite plaintext protocol
    (`<prefix>.<name> <value> <unix-ts>\\n` per metric; the
    {:kind :graphite} sink of reporter.clj:44-59). One connection per
    flush; errors are swallowed by the Reporter loop and retried next
    interval."""

    def __init__(self, reg: MetricRegistry, host: str, port: int = 2003,
                 prefix: str = "cook", interval_s: float = 60.0):
        super().__init__(reg, interval_s)
        self.host, self.port, self.prefix = host, port, prefix

    @staticmethod
    def _flatten(prefix: str, val, out: list) -> None:
        if isinstance(val, dict):
            for k, v in val.items():
                if k == "type":      # metric-kind tag, not a value
                    continue
                # collapse {"value": v} so counters/gauges publish under
                # their own name, graphite-style
                sub = prefix if k == "value" else f"{prefix}.{k}"
                GraphiteReporter._flatten(sub, v, out)
        elif isinstance(val, (int, float)) and not isinstance(val, bool):
            out.append((prefix, float(val)))

    def publish(self, snapshot: dict) -> None:
        import socket

        lines: list = []
        ts = int(time.time())
        self._flatten(self.prefix, snapshot, lines)
        payload = "".join(
            f"{name.replace(' ', '_')} {value} {ts}\n"
            for name, value in lines)
        with socket.create_connection((self.host, self.port),
                                      timeout=5) as sock:
            sock.sendall(payload.encode())
