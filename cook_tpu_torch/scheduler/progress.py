"""Progress pipeline: aggregate executor/sidecar updates, publish in
batches.

Equivalent of cook.progress (progress.clj): the aggregator keeps the
highest-sequence update per task, drops stale sequences and excess
tasks above a threshold (progress-aggregator :33); a periodic publisher
flushes the batch to the store (progress-update-transactor :60-101).
The store's update_progress applies the same highest-sequence-wins rule
again, so direct REST /progress posts and this pipeline compose.
"""
from __future__ import annotations

import threading
from typing import Optional

from cook_tpu_torch.state.store import JobStore


class ProgressAggregator:
    def __init__(self, store: JobStore, pending_threshold: int = 4096):
        self.store = store
        self.pending_threshold = pending_threshold
        self._pending: dict[str, tuple[int, int, str]] = {}
        self._lock = threading.Lock()
        self.dropped = 0

    def handle(self, task_id: str, sequence: int, percent: int,
               message: str = "") -> bool:
        """Accept one update (handle-progress-message! progress.clj:102).
        Returns False when dropped (stale sequence or over threshold)."""
        with self._lock:
            cur = self._pending.get(task_id)
            if cur is not None and sequence <= cur[0]:
                self.dropped += 1
                return False
            if cur is None and len(self._pending) >= self.pending_threshold:
                self.dropped += 1
                return False
            self._pending[task_id] = (sequence, percent, message)
            return True

    def publish(self) -> int:
        """Flush the batch to the store (the chime'd publisher)."""
        with self._lock:
            batch = self._pending
            self._pending = {}
        n = 0
        for task_id, (seq, percent, message) in batch.items():
            if self.store.update_progress(task_id, seq, percent, message):
                n += 1
        return n
