"""Hash-sharded in-order executors for the status-update path.

Equivalent of async-in-order-processing (scheduler.clj:1524-1546): the
reference fans status updates across 19 agents hash-partitioned by
task-id, so updates for one task apply in arrival order while updates
for different tasks proceed concurrently — a slow store write for one
task never serializes the whole backend callback stream.
"""
from __future__ import annotations

import logging
import queue
import threading
from typing import Callable

log = logging.getLogger(__name__)


class InOrderShards:
    """N worker threads, each draining its own FIFO; items are routed
    by hash(key) so same-key items run in order on one worker."""

    def __init__(self, n: int, handler: Callable, name: str = "status"):
        self.n = max(1, n)
        self.handler = handler
        self._queues: list[queue.Queue] = [queue.Queue()
                                           for _ in range(self.n)]
        self._stop = threading.Event()
        self._threads = []
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Condition(self._inflight_lock)
        for i in range(self.n):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"{name}-shard-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def submit(self, key: str, *args, **kwargs) -> None:
        with self._inflight_lock:
            self._inflight += 1
        shard = hash(key) % self.n
        self._queues[shard].put((None, args, kwargs))

    def submit_batch(self, keyed_items: list, handler: Callable) -> None:
        """Partition (key, item) pairs onto the same shards `submit`
        uses and run `handler(sub_batch)` once per shard — a batched
        channel that preserves per-key ordering against the per-item
        channel (a bulk status batch must not reorder around a per-task
        status already queued for the same task)."""
        by_shard: dict[int, list] = {}
        for key, item in keyed_items:
            by_shard.setdefault(hash(key) % self.n, []).append(item)
        with self._inflight_lock:
            self._inflight += len(by_shard)
        for shard, items in by_shard.items():
            self._queues[shard].put((handler, (items,), {}))

    def _worker(self, i: int) -> None:
        q = self._queues[i]
        while not self._stop.is_set():
            try:
                item = q.get(timeout=0.2)
            except queue.Empty:
                continue
            handler, args, kwargs = item
            try:
                (handler or self.handler)(*args, **kwargs)
            except Exception:
                log.exception("sharded handler failed")
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._idle.notify_all()

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until every submitted item has been handled (tests and
        orderly shutdown)."""
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    def stop(self) -> None:
        self.drain(timeout=5.0)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
