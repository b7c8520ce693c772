"""Admission-controlled, coalescing ingest for job submissions.

The submission hot path used to pay one store transaction — and with it
one group-commit fdatasync — per HTTP request. At high request rates the
disk barrier, not the CPU, bounds ingest throughput. This module is the
batching layer between the REST handlers and the store:

  handler thread --> bounded queue --> N ingest workers --> store txn
      (validates)     (admission)        (coalesce)        (1 fsync/batch)

* **Admission / backpressure**: the queue is bounded. When it is full
  the submit raises :class:`IngestQueueFull`, which the API maps to
  HTTP 429 + ``Retry-After`` — the million-user front door sheds load
  instead of queueing unboundedly (the reference throttles through its
  rate limiter; this adds a capacity-based second stage).
* **Coalescing**: each worker drains whatever requests are queued (up
  to ``max_batch``) and commits them as ONE ``store.create_jobs``
  transaction — one log append, one group-commit fdatasync amortized
  over every request in the batch.
* **Durability contract unchanged**: a request's latch is resolved only
  after ``create_jobs`` returns, i.e. after the batch's barrier — every
  201 still means "on disk".
* **Atomicity isolation**: requests carrying group objects are always
  committed per-request (group-merge bookkeeping must not interleave),
  and when a coalesced transaction is rejected (e.g. a duplicate uuid
  in ONE request) the worker retries each request individually so one
  bad submission cannot poison its batch-mates.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Iterable, Optional

from cook_tpu_torch.state.store import TransactionError
from cook_tpu_torch.utils.metrics import registry

log = logging.getLogger(__name__)


class IngestQueueFull(Exception):
    """Admission control refused the request; retry after a beat."""

    def __init__(self, retry_after_s: int):
        super().__init__(f"ingest queue full; retry after {retry_after_s}s")
        self.retry_after_s = retry_after_s


class _Pending:
    """One validated submission waiting for its batch to become durable."""

    __slots__ = ("jobs", "groups", "done", "result", "error", "ts")

    def __init__(self, jobs, groups):
        self.jobs = jobs
        self.groups = groups
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.ts = time.monotonic()

    def resolve(self, uuids) -> None:
        self.result = uuids
        self.done.set()

    def reject(self, exc: BaseException) -> None:
        self.error = exc
        self.done.set()


class IngestBatcher:
    """Bounded-queue ingest with N coalescing workers.

    Thread-safe; ``submit_and_wait`` is called from HTTP handler threads
    and blocks until the submission is durable (or rejected)."""

    def __init__(self, store, workers: int = 2, queue_depth: int = 512,
                 max_batch: int = 512, retry_after_s: int = 1,
                 pressure=None):
        self.store = store
        self.max_batch = max(1, int(max_batch))
        self.retry_after_s = max(1, int(retry_after_s))
        # pressure: zero-arg callable; True means the overload
        # controller wants admission tightened — reject at half the
        # configured depth instead of waiting for a hard-full queue
        self.pressure = pressure
        self._depth = max(1, int(queue_depth))
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"ingest-worker-{i}")
            for i in range(max(1, int(workers)))]
        for t in self._threads:
            t.start()

    # -- handler-thread side -------------------------------------------
    def submit_and_wait(self, jobs: list, groups: Iterable = (),
                        timeout_s: float = 60.0) -> list:
        """Enqueue one validated submission; block until its batch's
        group commit lands. Returns the created uuids, re-raises the
        worker-side error (TransactionError, NotLeaderError, ...) in
        the calling thread, or raises IngestQueueFull immediately when
        admission control refuses."""
        p = _Pending(jobs, list(groups))
        if self.pressure is not None and self._q.qsize() >= self._depth // 2:
            try:
                tightened = bool(self.pressure())
            except Exception:
                tightened = False
            if tightened:
                registry.counter("ingest_rejected_total").inc()
                registry.counter("ingest_tightened_rejects_total").inc()
                raise IngestQueueFull(self.retry_after_s)
        try:
            self._q.put_nowait(p)
        except queue.Full:
            registry.counter("ingest_rejected_total").inc()
            raise IngestQueueFull(self.retry_after_s)
        registry.gauge("ingest_queue_depth").set(self._q.qsize())
        if not p.done.wait(timeout_s):
            # the latch never resolving means a worker died mid-commit
            # (process-level fault); surface loudly rather than hang
            raise OSError("ingest worker did not resolve submission "
                          f"within {timeout_s}s")
        if p.error is not None:
            raise p.error
        return p.result

    def queue_depth(self) -> int:
        """Instantaneous admission-queue depth (overload signal)."""
        return self._q.qsize()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        # reject anything still queued so no handler thread hangs
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.reject(OSError("ingest batcher stopped"))

    # -- worker side ---------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            registry.gauge("ingest_queue_depth").set(self._q.qsize())
            now = time.monotonic()
            wait = registry.histogram("ingest_wait_ms")
            for p in batch:
                wait.observe(max(0.0, (now - p.ts) * 1e3))
            try:
                self._commit(batch)
            except BaseException:   # never let a worker die silently
                log.exception("ingest worker: unexpected commit failure")
                for p in batch:
                    if not p.done.is_set():
                        p.reject(OSError("ingest commit failed"))

    def _commit(self, batch: list) -> None:
        """Commit a drained batch: coalesce what is safely coalescable
        into one store transaction, run the rest per-request."""
        coalesce, solo = [], []
        seen: set = set()
        for p in batch:
            uuids = {j.uuid for j in p.jobs}
            # group-carrying submissions keep per-request transactions
            # (group-merge bookkeeping must not interleave with other
            # requests); uuid overlap between requests falls back too
            # so the store's duplicate check points at one request
            if p.groups or (uuids & seen):
                solo.append(p)
            else:
                seen |= uuids
                coalesce.append(p)
        if len(coalesce) > 1:
            jobs = [j for p in coalesce for j in p.jobs]
            try:
                self.store.create_jobs(jobs, committed=True)
                registry.histogram("ingest_batch_requests").update(
                    len(coalesce))
                registry.histogram("ingest_batch_jobs").update(len(jobs))
                for p in coalesce:
                    p.resolve([j.uuid for j in p.jobs])
                coalesce = []
            except TransactionError:
                # one request's duplicate poisoned the combined txn
                # (nothing was applied: the store checks duplicates
                # before mutating) — isolate by retrying per-request
                pass
            except BaseException as e:
                for p in coalesce:
                    p.reject(e)
                coalesce = []
        for p in coalesce + solo:
            try:
                p.resolve(self.store.create_jobs(p.jobs, p.groups,
                                                 committed=True))
            except BaseException as e:
                p.reject(e)
