"""Per-endpoint circuit breaker (CLOSED -> OPEN -> HALF_OPEN).

`AgentCluster` keeps one of these per agent host: after
``failure_threshold`` consecutive RPC failures the breaker opens and
the cluster stops offering that host's resources (and stops burning
launch-path latency on a box that is black-holing requests). After
``reset_timeout_s`` a single half-open probe is let through; success
closes the breaker, failure re-opens it for another full timeout.

Thread-safe; the clock is injectable for tests.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class BreakerOpenError(ConnectionError):
    """Raised by callers that consult an open breaker; subclasses
    ConnectionError so existing transport-failure handling applies."""


class CircuitBreaker:
    __slots__ = ("failure_threshold", "reset_timeout_s", "_clock",
                 "_lock", "_failures", "_state", "_opened_at",
                 "_probing", "trips", "on_transition")

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Callable[[str, str], None] = None):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False  # a half-open probe is already in flight
        self.trips = 0  # lifetime CLOSED/HALF_OPEN -> OPEN transitions
        # fn(old_state, new_state), invoked OUTSIDE the lock on every
        # state change — the observability hook (/debug transition log,
        # Prometheus counters); must not raise into the RPC path
        self.on_transition = on_transition

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            return HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """True when a call may proceed. In HALF_OPEN only the first
        caller wins the probe slot; the rest are refused until the
        probe reports back."""
        with self._lock:
            st = self._state_locked()
            if st == CLOSED:
                return True
            if st == HALF_OPEN:
                if self._probing:
                    return False
                self._state = HALF_OPEN
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            old = self._state_locked()
            self._failures = 0
            self._state = CLOSED
            self._probing = False
        if old != CLOSED and self.on_transition is not None:
            try:
                self.on_transition(old, CLOSED)
            except Exception:
                pass

    def record_failure(self) -> None:
        fired = None
        with self._lock:
            old = self._state_locked()
            self._failures += 1
            if self._state == HALF_OPEN or \
                    self._failures >= self.failure_threshold:
                if self._state != OPEN:
                    self.trips += 1
                self._state = OPEN
                self._opened_at = self._clock()
                self._probing = False
                if old != OPEN:
                    fired = (old, OPEN)
        if fired is not None and self.on_transition is not None:
            try:
                self.on_transition(*fired)
            except Exception:
                pass

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state_locked(),
                    "consecutive_failures": self._failures,
                    "trips": self.trips}
