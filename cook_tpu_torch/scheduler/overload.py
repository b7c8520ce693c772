"""Adaptive overload controller: shed load in a documented priority
order, reversibly, with hysteresis.

The control plane has exactly one overload response today: the ingest
queue's 429. Everything downstream of admission — the match cycle, the
launch transaction, provenance bookkeeping, metrics flushes — runs at
full fidelity no matter how far behind it falls. This controller closes
the loop: it watches a small set of pressure signals and walks a
four-rung shed ladder, one rung per sustained-overload observation
window, releasing rungs the same way when pressure clears.

Shed priority order (rung N implies rungs 1..N-1; each is reversible):

    1. consider_window       halve the cycle's consider window — fewer
                             jobs tensorized per cycle, fastest lever,
                             invisible to correctness (jobs just wait)
    2. provenance_sampling   stop the decision-provenance readback and
                             trace sampling — /unscheduled degrades to
                             fallback reasons, cycles shed the epilogue
                             readback
    3. metrics_flush         defer non-critical metrics publication
                             (fairness gauges) — /metrics serves stale
                             fairness data until pressure clears
    4. ingest_throttle       tighten admission: reject at half the
                             configured ingest queue depth, pushing
                             429+Retry-After to clients earlier

Hysteresis is double: escalation needs `escalate_after` CONSECUTIVE
over-watermark evaluations, relaxation needs `relax_after` consecutive
evaluations with every signal under `relax_margin` x its watermark; the
band in between holds the current rung. All state changes land in the
metrics registry (`overload_state` gauge, `overload_shed_total` /
`overload_relax_total` counters per action) and in a bounded event
ledger served by /debug.

The controller is pull-based and cheap: `evaluate()` is called from the
coordinator's timer loop; the cycle paths consult `consider_scale()` /
`provenance_enabled()` inline (one attribute read + int compare when
healthy, the obs.trace discipline).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.utils.lockwitness import witness_lock
from cook_tpu_torch.state.model import now_ms
from cook_tpu_torch.utils.metrics import registry as metrics_registry

# the shed ladder, in priority order; rung i engages ACTIONS[:i]
ACTIONS = ("consider_window", "provenance_sampling", "metrics_flush",
           "ingest_throttle")


def _p99(samples) -> float:
    if not samples:
        return 0.0
    vals = sorted(samples)
    return vals[max(0, -(-len(vals) * 99 // 100) - 1)]


class OverloadController:
    def __init__(self, cycle_p99_ms: float = 1000.0,
                 launch_txn_p99_ms: float = 500.0,
                 escalate_after: int = 3,
                 relax_after: int = 10,
                 relax_margin: float = 0.7,
                 clock: Callable[[], float] = time.monotonic):
        self.cycle_p99_ms = float(cycle_p99_ms)
        self.launch_txn_p99_ms = float(launch_txn_p99_ms)
        if int(escalate_after) < 1 or int(relax_after) < 1:
            raise ValueError("overload dwell counts must be >= 1")
        self.escalate_after = int(escalate_after)
        self.relax_after = int(relax_after)
        self.relax_margin = float(relax_margin)
        self._clock = clock
        self._lock = witness_lock("OverloadController._lock")
        # level is read lock-free on the cycle hot path (int load is
        # atomic); all writers hold the lock
        self.level = 0
        self._hot_streak = 0
        self._calm_streak = 0
        # latency windows fed by the coordinator's cycle and consume
        # paths, DRAINED by each evaluate(): a control step judges only
        # the samples produced since the previous step. A rolling
        # window would let one warm-up spike (the first JIT compiles
        # run a cycle for seconds) hold the p99 hot for 256 samples —
        # observed walking a freshly booted idle server to rung 4.
        # Sustained overload keeps refilling the window, so real
        # pressure still accumulates the escalate streak; an idle or
        # empty window reads 0 (calm).
        self._cycle_ms: "collections.deque[float]" = \
            collections.deque(maxlen=256)
        self._txn_ms: "collections.deque[float]" = \
            collections.deque(maxlen=256)
        # name -> (reader, high_watermark): registered by the server
        # wiring for admission-queue depth and resident-structure sizes
        self._sources: dict[str, tuple[Callable[[], float], float]] = {}
        self._last_signals: dict[str, dict] = {}
        self.events: "collections.deque[dict]" = \
            collections.deque(maxlen=256)
        metrics_registry.gauge("overload_state").set(0)

    # -- wiring --------------------------------------------------------
    def add_source(self, name: str, reader: Callable[[], float],
                   high: float) -> None:
        """Register a pressure signal: `reader()` is polled each
        evaluation and compared against the `high` watermark. Readers
        must be cheap and must not raise (a raising reader reads 0)."""
        with self._lock:
            self._sources[name] = (reader, float(high))

    def note_cycle_ms(self, ms: float) -> None:
        self._cycle_ms.append(float(ms))

    def note_launch_txn_ms(self, ms: float) -> None:
        self._txn_ms.append(float(ms))

    @staticmethod
    def _drain(dq: "collections.deque[float]") -> list[float]:
        # popleft races benignly with concurrent append (both are
        # atomic); anything appended mid-drain lands in the next window
        out = []
        while True:
            try:
                out.append(dq.popleft())
            except IndexError:
                return out

    # -- the ladder, as queries consulted at the shed sites ------------
    def consider_scale(self) -> float:
        """Multiplier for the cycle's consider window (composes with
        the per-pool scaleback via min() at the call site)."""
        return 0.5 if self.level >= 1 else 1.0

    def provenance_enabled(self) -> bool:
        return self.level < 2

    def defer_metrics_flush(self) -> bool:
        return self.level >= 3

    def ingest_tightened(self) -> bool:
        return self.level >= 4

    # -- evaluation ----------------------------------------------------
    def evaluate(self) -> int:
        """One control-loop step: poll every signal, update the streak
        counters, and walk the ladder at most one rung. Returns the
        (possibly new) level."""
        signals: dict[str, dict] = {}
        hot = []
        calm = True

        def judge(name: str, value: float, high: float) -> None:
            nonlocal calm
            over = high > 0 and value > high
            signals[name] = {"value": round(float(value), 2),
                             "high": high, "over": over}
            if over:
                hot.append(name)
            if high > 0 and value > self.relax_margin * high:
                calm = False

        judge("cycle_p99_ms", _p99(self._drain(self._cycle_ms)),
              self.cycle_p99_ms)
        judge("launch_txn_p99_ms", _p99(self._drain(self._txn_ms)),
              self.launch_txn_p99_ms)
        with self._lock:
            sources = list(self._sources.items())
        for name, (reader, high) in sources:
            try:
                value = float(reader())
            except Exception:
                value = 0.0
            judge(name, value, high)

        with self._lock:
            if hot:
                self._hot_streak += 1
                self._calm_streak = 0
            elif calm:
                self._calm_streak += 1
                self._hot_streak = 0
            else:
                # in the hysteresis band: hold the rung, reset streaks
                self._hot_streak = 0
                self._calm_streak = 0
            fired = None
            if self._hot_streak >= self.escalate_after and \
                    self.level < len(ACTIONS):
                self.level += 1
                self._hot_streak = 0
                fired = ("shed", ACTIONS[self.level - 1], list(hot))
            elif self._calm_streak >= self.relax_after and self.level > 0:
                fired = ("relax", ACTIONS[self.level - 1], [])
                self.level -= 1
                self._calm_streak = 0
            level = self.level
            self._last_signals = signals
            if fired is not None:
                self.events.append({
                    "kind": fired[0], "action": fired[1],
                    "level": level, "hot": fired[2], "t_ms": now_ms()})
        if fired is not None:
            kind, action, _ = fired
            if kind == "shed":
                metrics_registry.counter(
                    "overload_shed_total", action=action).inc()
            else:
                metrics_registry.counter(
                    "overload_relax_total", action=action).inc()
        metrics_registry.gauge("overload_state").set(level)
        return level

    # -- inspection ----------------------------------------------------
    def engaged(self) -> list[str]:
        return list(ACTIONS[:self.level])

    def snapshot(self) -> dict:
        with self._lock:
            try:
                events = list(self.events)
            except RuntimeError:
                events = []
            return {"level": self.level,
                    "engaged": list(ACTIONS[:self.level]),
                    "ladder": list(ACTIONS),
                    "signals": dict(self._last_signals),
                    "hot_streak": self._hot_streak,
                    "calm_streak": self._calm_streak,
                    "events": events}
