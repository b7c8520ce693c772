"""Shares, quotas, and token-bucket rate limits.

Equivalents of:
  share.clj  (205 LoC)  per-user per-pool fair-share = DRU divisor
  quota.clj  (234 LoC)  hard cap on running usage incl. job count
  rate_limit/ (288 LoC) token-bucket-filter limiters

Both share and quota resolve user -> pool -> resource with a `default`
user fallback and +inf when unset (share.clj:86-122, quota.clj:64).
They are deliberately the same shape (the reference calls them
"dangerously similar", quota.clj:24-25) — here they share one impl.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Optional

DEFAULT_USER = "default"
RESOURCES = ("mem", "cpus", "gpus")
UNLIMITED = math.inf


class _PerUserPoolResource:
    """user -> pool -> {resource: value} with default-user fallback."""

    def __init__(self, extra_keys=()):
        self._data: dict[str, dict[str, dict[str, float]]] = {}
        self._lock = threading.Lock()
        self._keys = RESOURCES + tuple(extra_keys)

    def set(self, user: str, pool: str, **values) -> None:
        with self._lock:
            slot = self._data.setdefault(user, {}).setdefault(pool, {})
            for k, v in values.items():
                if k not in self._keys:
                    raise ValueError(f"unknown resource {k}")
                slot[k] = float(v)

    def retract(self, user: str, pool: str) -> None:
        with self._lock:
            self._data.get(user, {}).pop(pool, None)

    def get(self, user: str, pool: str) -> dict[str, float]:
        with self._lock:
            for u in (user, DEFAULT_USER):
                slot = self._data.get(u, {}).get(pool)
                if slot is not None:
                    return {k: slot.get(k, UNLIMITED) for k in self._keys}
            return {k: UNLIMITED for k in self._keys}

    def users(self) -> list[str]:
        with self._lock:
            return [u for u in self._data if u != DEFAULT_USER]

    def as_dict(self) -> dict:
        with self._lock:
            return {u: {p: dict(r) for p, r in pools.items()}
                    for u, pools in self._data.items()}


class ShareStore(_PerUserPoolResource):
    """get-share/set-share!/retract-share! (share.clj:104-186). The share
    is the DRU divisor fed to ops/dru.py."""


class QuotaStore(_PerUserPoolResource):
    """Quota adds a job-`count` dimension (quota.clj:47-64)."""

    def __init__(self):
        super().__init__(extra_keys=("count",))


def below_quota(quota: dict[str, float], usage: dict[str, float]) -> bool:
    """util/below-quota? — every dimension within bounds."""
    for k, limit in quota.items():
        if usage.get(k, 0.0) > limit:
            return False
    return True


class TokenBucket:
    """Token-bucket filter (rate_limit/token_bucket_filter.clj:18-99):
    earns `tokens_per_sec` up to `max_tokens`; may go negative on forced
    spends (the reference launches matched cycles atomically then lets
    the bucket recover)."""

    def __init__(self, tokens_per_sec: float, max_tokens: float,
                 initial: Optional[float] = None, clock=time.monotonic):
        self.rate = float(tokens_per_sec)
        self.max = float(max_tokens)
        self.tokens = float(max_tokens if initial is None else initial)
        self._clock = clock
        self._last = clock()
        self._lock = threading.Lock()

    def _earn(self) -> None:
        now = self._clock()
        self.tokens = min(self.max, self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_spend(self, n: float = 1.0) -> bool:
        """Spend iff enough tokens (submission limiter path)."""
        with self._lock:
            self._earn()
            if self.tokens >= n:
                self.tokens -= n
                return True
            return False

    def spend(self, n: float = 1.0) -> None:
        """Unconditional spend; may drive the bucket negative (launch
        limiter spends whole match batches, rate_limit.clj:43-58)."""
        with self._lock:
            self._earn()
            self.tokens -= n

    def available(self) -> float:
        with self._lock:
            self._earn()
            return self.tokens


class RateLimiter:
    """Keyed limiter registry: per-user submission, per-user launch, and
    a global launch limiter (rate_limit.clj:28-58). `enforce=False`
    mirrors AllowAllRateLimiter / enforce? config."""

    def __init__(self, tokens_per_sec: float = UNLIMITED,
                 max_tokens: float = UNLIMITED, enforce: bool = True,
                 clock=time.monotonic):
        self.tps = tokens_per_sec
        self.max = max_tokens
        self.enforce = enforce and tokens_per_sec != UNLIMITED
        self._clock = clock
        self._buckets: dict[str, TokenBucket] = {}
        self._lock = threading.Lock()

    def _bucket(self, key: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(key)
            if b is None:
                b = self._buckets[key] = TokenBucket(self.tps, self.max,
                                                     clock=self._clock)
            return b

    def try_acquire(self, key: str = "global", n: float = 1.0) -> bool:
        if not self.enforce:
            return True
        return self._bucket(key).try_spend(n)

    def spend(self, key: str = "global", n: float = 1.0) -> None:
        if self.enforce:
            self._bucket(key).spend(n)

    def would_allow(self, key: str = "global", n: float = 1.0) -> bool:
        """True iff a spend of `n` would be within the budget right now.
        Requires a WHOLE token: the bucket earns continuously, so a
        `> 0` check would flip back to "allowed" microseconds after
        exhaustion (the reference's TBF earns integer tokens,
        token_bucket_filter.clj:58-80, so its > 0 check means >= 1)."""
        if not self.enforce:
            return True
        # clamp to the bucket capacity so a burst-sub-1 limiter
        # (max_tokens < 1) can still ever say yes at a full bucket
        return self._bucket(key).available() >= min(n, self.max)
