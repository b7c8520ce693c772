"""Unified retry policy: exponential backoff + full jitter + deadline.

Every retry loop in cook_tpu goes through this module — cookcheck R6
(analysis/retry_discipline.py) flags hand-rolled `time.sleep` +
multiply-backoff loops anywhere else. Centralizing the loop buys three
things the ad-hoc versions each got wrong in a different way:

* **Full jitter** (delay = U(0, min(cap, base * 2**attempt)), per the
  AWS architecture blog): a fleet of agents that lost the same leader
  must not re-register in lockstep.
* **Permanent-failure classification**: a 4xx response (except 408 /
  429) means the request itself is wrong — retrying it hammers the
  server for the same answer. `HttpJsonError` carries the status so
  the policy can stop immediately.
* **An overall deadline**, so "retry forever-ish" paths still converge
  while the caller holds resources.
"""
from __future__ import annotations

import time
import random
from typing import Callable, Optional

from .httpjson import HttpJsonError


def default_retryable(exc: BaseException) -> bool:
    """Transport flakes retry; malformed requests do not. 408 (server
    gave up waiting) and 429 (asked to come back later) are the two
    4xx codes that are explicitly about *timing*, not the request."""
    if isinstance(exc, HttpJsonError):
        return not (400 <= exc.status < 500 and exc.status not in (408, 429))
    return isinstance(exc, (ConnectionError, OSError))


class RetryPolicy:
    """Bounded-or-unbounded retry with exponential backoff, full
    jitter, and an optional overall deadline.

    ``max_attempts=0`` means unbounded (the agent registration loop);
    pair it with ``should_abort`` so daemon shutdown still wins.
    """

    __slots__ = ("max_attempts", "base_delay_s", "max_delay_s",
                 "deadline_s")

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.2,
                 max_delay_s: float = 5.0,
                 deadline_s: Optional[float] = None):
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.deadline_s = deadline_s

    def backoff_s(self, attempt: int, rng: Callable[[], float]) -> float:
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        return rng() * cap

    def call(self, fn: Callable, *,
             retryable: Callable[[BaseException], bool] = default_retryable,
             should_abort: Optional[Callable[[], bool]] = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             sleep: Callable[[float], None] = time.sleep,
             rng: Callable[[], float] = random.random,
             clock: Callable[[], float] = time.monotonic):
        """Invoke ``fn()`` until it succeeds, a non-retryable error is
        raised, attempts/deadline run out, or ``should_abort()`` turns
        true (which raises the last error, or ``InterruptedError`` when
        aborted before the first attempt finished)."""
        start = clock()
        attempt = 0
        last: Optional[BaseException] = None
        while True:
            if should_abort is not None and should_abort():
                if last is not None:
                    raise last
                raise InterruptedError("retry aborted before first attempt")
            try:
                return fn()
            except BaseException as exc:  # noqa: BLE001 - classified below
                last = exc
                attempt += 1
                if not retryable(exc):
                    raise
                if self.max_attempts and attempt >= self.max_attempts:
                    raise
                delay = self.backoff_s(attempt - 1, rng)
                if self.deadline_s is not None and \
                        clock() - start + delay > self.deadline_s:
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc)
                sleep(delay)
