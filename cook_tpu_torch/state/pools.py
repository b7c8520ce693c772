"""Scheduling pools (pool.clj, schema.clj:797-816).

Each pool gets its own fair queue, match loop, and DRU mode; jobs name a
pool at submission or fall into the default pool. In the TPU design each
pool maps to a slice of the pool-sharded mesh axis
(cook_tpu.parallel.pools).
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field


class DruMode(str, enum.Enum):
    DEFAULT = "default"   # cpu/mem dominant share (pool.dru-mode/default)
    GPU = "gpu"           # cumulative gpu share  (pool.dru-mode/gpu)


@dataclass
class Pool:
    name: str
    purpose: str = ""
    state: str = "active"      # active | inactive (schema.clj:806)
    dru_mode: DruMode = DruMode.DEFAULT


class PoolRegistry:
    def __init__(self, default_pool: str = "default"):
        self._pools: dict[str, Pool] = {}
        self._default = default_pool
        self._lock = threading.Lock()
        self.add(Pool(name=default_pool, purpose="default pool"))

    @property
    def default_pool(self) -> str:
        return self._default

    def add(self, pool: Pool) -> None:
        with self._lock:
            self._pools[pool.name] = pool

    def get(self, name: str | None) -> Pool:
        with self._lock:
            return self._pools.get(name or self._default,
                                   self._pools[self._default])

    def accepts_submissions(self, name: str | None) -> bool:
        p = self.get(name)
        return p.state == "active"

    def all(self) -> list[Pool]:
        with self._lock:
            return list(self._pools.values())

    def active(self) -> list[Pool]:
        return [p for p in self.all() if p.state == "active"]

    def resolve(self, requested: str | None) -> str:
        """Pool selection for a submitted job (plugins/pool.clj default
        selector: requested name or the default pool)."""
        if requested and requested in self._pools:
            return requested
        return self._default
