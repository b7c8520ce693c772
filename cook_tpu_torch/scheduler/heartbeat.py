"""Heartbeat tracking: lose a task whose executor goes silent.

Equivalent of cook.mesos.heartbeat (heartbeat.clj): per-task deadlines
refreshed by executor heartbeats (notify-heartbeat :38); a task whose
deadline lapses fails with :heartbeat-lost / reason 3000
(handle-timeout :65).  A periodic sync registers tracking for any
running task that has never heartbeated (sync-with-datomic :95) so a
dead-on-arrival executor is still detected.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.utils.lockwitness import witness_lock
from cook_tpu_torch.state.model import InstanceStatus
from cook_tpu_torch.state.store import JobStore

HEARTBEAT_TIMEOUT_S = 15 * 60.0


class HeartbeatWatcher:
    def __init__(self, store: JobStore, timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 on_timeout: Optional[Callable[[str], None]] = None,
                 clock=time.monotonic):
        self.store = store
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._clock = clock
        self._deadlines: dict[str, float] = {}
        self._lock = witness_lock("HeartbeatWatcher._lock")

    def notify(self, task_id: str) -> None:
        """An executor heartbeat arrived: extend the deadline."""
        with self._lock:
            self._deadlines[task_id] = self._clock() + self.timeout_s

    def track(self, task_id: str) -> None:
        """Start tracking without a heartbeat (task just launched)."""
        with self._lock:
            self._deadlines.setdefault(task_id,
                                       self._clock() + self.timeout_s)

    def untrack(self, task_id: str) -> None:
        with self._lock:
            self._deadlines.pop(task_id, None)

    def sync(self) -> None:
        """Track every running instance; drop completed ones
        (sync-with-datomic heartbeat.clj:95)."""
        running = {i.task_id for i in self.store.running_instances()}
        with self._lock:
            for tid in running - self._deadlines.keys():
                self._deadlines[tid] = self._clock() + self.timeout_s
            for tid in list(self._deadlines.keys() - running):
                del self._deadlines[tid]

    def check(self) -> list[str]:
        """Fail every task past its deadline (handle-timeout
        heartbeat.clj:65). Returns the task ids timed out.

        Two-phase so a racing completion or heartbeat wins over the
        3000 write: the expiry snapshot is only a candidate list; each
        candidate re-checks (a) the store — an instance that went
        terminal since the snapshot keeps its terminal status/reason,
        and (b) its own deadline — a notify() that landed since the
        snapshot keeps the task alive. After the write the instance is
        re-read and the timeout is only reported (and on_timeout only
        fired) if FAILED/3000 actually stuck, so the store's
        transition machine stays the final arbiter.
        """
        now = self._clock()
        with self._lock:
            candidates = [tid for tid, dl in self._deadlines.items()
                          if dl <= now]
        expired = []
        for tid in candidates:
            inst = self.store.get_instance(tid)
            if inst is not None and not inst.active:
                # completed between snapshot and write: terminal wins —
                # just stop tracking (unless a notify re-armed it for a
                # NEW deadline, which sync() will reap anyway)
                with self._lock:
                    dl = self._deadlines.get(tid)
                    if dl is not None and dl <= now:
                        del self._deadlines[tid]
                continue
            with self._lock:
                dl = self._deadlines.get(tid)
                if dl is None or dl > now:
                    continue  # untrack()ed or freshly heartbeated
                del self._deadlines[tid]
            self.store.update_instance(tid, InstanceStatus.FAILED,
                                       reason_code=3000)
            after = self.store.get_instance(tid)
            if after is not None and (after.status != InstanceStatus.FAILED
                                      or after.reason_code != 3000):
                # the store dropped or re-attributed the write (e.g. a
                # queued completion won): not a heartbeat timeout
                continue
            expired.append(tid)
            if self.on_timeout:
                self.on_timeout(tid)
        return expired
