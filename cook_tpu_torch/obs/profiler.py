"""Always-on cycle phase ledger with critical-path attribution.

The tracer (trace.py) answers "where did THIS job's time go"; the
profiler answers "where does a scheduler CYCLE spend its wall-clock in
production, and which phase is on the critical path".  It is designed
to run enabled on every cycle:

* the coordinator opens a :class:`CycleRec` per cycle and routes every
  phase boundary through ``rec.stamp()`` / ``rec.phase()`` — the SAME
  stamps it already needed for ``self.metrics`` — so enabling the
  ledger adds no extra clock reads to the hot path;
* ``commit()`` is the gated half: disabled it returns immediately with
  zero allocation; enabled it appends one small dict to a bounded ring
  and folds the phase timings into streaming per-(kind, phase)
  histograms plus a blame ledger (which phase was the cycle's
  critical path, i.e. its largest wall segment), all under ONE lock;
* listeners (the ``profile_jsonl`` exporter) are invoked OUTSIDE the
  lock — cookcheck R13 enforces both disciplines.

Every record carries wall AND ``thread_time`` CPU per phase, so a
phase that is long but idle (blocked on the device, on a queue, on
fsync) is distinguishable from one burning the cycle thread.

Served by ``GET /debug/profile``; the K worst cycles export as
Chrome-trace/Perfetto JSON via :meth:`CycleProfiler.chrome_trace`.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from cook_tpu_torch.obs.export import to_chrome_trace

# Match-side tail phases overlap the consume record's own phases (the
# sync tail IS the consume cycle; the async tail is time blocked on
# the hand-off queue), so critical-path attribution skips them —
# otherwise every consume-bound cycle would be blamed twice.
OVERLAP_PHASES = frozenset({"consume", "queue_wait"})

# log2 bucket bounds in ms: ~15.6 us .. ~16.4 s
_BUCKET_MS = tuple(2.0 ** i for i in range(-6, 15))


class _Phase:
    """Handle for a ``with rec.phase(name):`` block.

    Measures exactly its own extent (wall + thread-CPU), appends it to
    the record, and advances the record's stamp boundary to the block
    end — so a following ``stamp()`` covers only what came after.
    ``.ms`` / ``.cpu_ms`` are readable after exit (the resync metric
    reads them).
    """

    __slots__ = ("_rec", "_name", "_pc0", "_ct0", "ms", "cpu_ms")

    def __init__(self, rec: "CycleRec", name: str):
        self._rec = rec
        self._name = name
        self.ms = 0.0
        self.cpu_ms = 0.0

    def __enter__(self) -> "_Phase":
        self._pc0 = time.perf_counter()
        self._ct0 = time.thread_time()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pc1 = time.perf_counter()
        ct1 = time.thread_time()
        self.ms = (pc1 - self._pc0) * 1e3
        self.cpu_ms = (ct1 - self._ct0) * 1e3
        rec = self._rec
        rec.phases.append((self._name, self._pc0, pc1, self.cpu_ms))
        rec._last, rec._clast = pc1, ct1


class CycleRec:
    """One cycle's phase ledger — the blessed stamp API (cookcheck R13).

    Always a real object (never a no-op): the coordinator's
    ``self.metrics`` phase keys are unconditional, so the stamps must
    be too.  Only :meth:`CycleProfiler.commit` is gated on enablement.
    """

    __slots__ = ("kind", "pool", "t0", "t0_ms", "_c0", "_last", "_clast",
                 "phases")

    def __init__(self, kind: str, pool: str):
        self.kind = kind
        self.pool = pool
        self.t0 = time.perf_counter()
        self.t0_ms = time.time() * 1e3
        self._c0 = time.thread_time()
        self._last = self.t0
        self._clast = self._c0
        # (name, pc0, pc1, cpu_ms) — perf_counter bounds + thread CPU
        self.phases: list = []

    @staticmethod
    def now() -> float:
        """Blessed raw ``perf_counter`` read for per-item sub-timings
        that are not cycle phases (e.g. the legacy path's per-job txn
        bounds, converted to wall via :meth:`wall_ms`)."""
        return time.perf_counter()

    def stamp(self, name: str) -> float:
        """Close the segment since the previous boundary as phase
        ``name``; returns the boundary's ``perf_counter`` value so
        callers can wall-anchor derived spans."""
        pc = time.perf_counter()
        ct = time.thread_time()
        self.phases.append((name, self._last, pc, (ct - self._clast) * 1e3))
        self._last, self._clast = pc, ct
        return pc

    def phase(self, name: str) -> _Phase:
        """Context manager measuring exactly its own block (used for
        optional segments like resync that must not swallow the
        surrounding gap)."""
        return _Phase(self, name)

    # -- derived reads -------------------------------------------------

    def ms(self, name: str) -> float:
        """Total wall ms recorded under phase ``name``."""
        return sum(b - a for n, a, b, _c in self.phases if n == name) * 1e3

    def cpu_ms(self, name: str) -> float:
        return sum(c for n, _a, _b, c in self.phases if n == name)

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def wall_ms(self, pc: float) -> float:
        """Map a ``perf_counter`` value to epoch wall ms (anchored at
        the record's start)."""
        return self.t0_ms + (pc - self.t0) * 1e3

    def walls(self) -> list:
        """Phases as ``(name, wall_t0_ms, wall_t1_ms)`` triples — the
        shape ``tracer.record_cycle`` embeds as children."""
        return [(n, self.wall_ms(a), self.wall_ms(b))
                for n, a, b, _c in self.phases]


class _PhaseStat:
    """Streaming per-(kind, phase) aggregate: count/sum/max plus log2
    bucket counts for quantile estimates.  Mutated only under the
    profiler lock."""

    __slots__ = ("n", "sum_ms", "sum_cpu", "max_ms", "buckets")

    def __init__(self):
        self.n = 0
        self.sum_ms = 0.0
        self.sum_cpu = 0.0
        self.max_ms = 0.0
        self.buckets = [0] * (len(_BUCKET_MS) + 1)

    def observe(self, ms: float, cpu_ms: float) -> None:
        self.n += 1
        self.sum_ms += ms
        self.sum_cpu += cpu_ms
        if ms > self.max_ms:
            self.max_ms = ms
        lo, hi = 0, len(_BUCKET_MS)
        while lo < hi:
            mid = (lo + hi) // 2
            if ms <= _BUCKET_MS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.buckets[lo] += 1

    def _quantile(self, q: float) -> float:
        target = q * self.n
        acc = 0
        for i, c in enumerate(self.buckets):
            acc += c
            if acc >= target:
                return _BUCKET_MS[i] if i < len(_BUCKET_MS) \
                    else self.max_ms
        return self.max_ms

    def snapshot(self) -> dict:
        if self.n == 0:
            return {"count": 0}
        return {"count": self.n,
                "mean_ms": round(self.sum_ms / self.n, 4),
                "p50_ms": round(self._quantile(0.50), 4),
                "p95_ms": round(self._quantile(0.95), 4),
                "max_ms": round(self.max_ms, 4),
                "cpu_mean_ms": round(self.sum_cpu / self.n, 4)}


class CycleProfiler:
    """Process-wide cycle ledger: bounded ring + streaming phase stats
    + critical-path blame shares.

    Lock discipline (cookcheck R13): ring/stat/blame mutation happens
    under ``self._lock``; listeners run OUTSIDE it so a slow JSONL
    write never stalls the cycle thread.
    """

    def __init__(self, ring: int = 2048, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._stats: dict = {}     # (kind, phase) -> _PhaseStat
        self._blame: dict = {}     # (kind, phase) -> [crit_cycles, ms]
        self._cycles: dict = {}    # kind -> committed count
        self._committed = 0
        self._listeners: list = []

    # -- the hot path --------------------------------------------------

    def cycle(self, kind: str, pool: str) -> CycleRec:
        """Open a record for one cycle.  Always real — see CycleRec."""
        return CycleRec(kind, pool)

    def commit(self, rec: CycleRec, **attrs) -> None:
        """Fold a finished record into the ledger.  Disabled: returns
        before allocating anything (the zero-cost always-on bargain)."""
        if not self.enabled:
            return
        end = time.perf_counter()
        wall_ms = (end - rec.t0) * 1e3
        cpu_ms = (time.thread_time() - rec._c0) * 1e3
        phases = []
        crit_name, crit_ms = "", -1.0
        for name, a, b, cpu in rec.phases:
            ms = (b - a) * 1e3
            phases.append({"name": name, "ms": round(ms, 4),
                           "cpu_ms": round(cpu, 4),
                           "off_ms": round((a - rec.t0) * 1e3, 4)})
            if name not in OVERLAP_PHASES and ms > crit_ms:
                crit_name, crit_ms = name, ms
        entry = {"kind": rec.kind, "pool": rec.pool,
                 "t0_ms": round(rec.t0_ms, 3),
                 "wall_ms": round(wall_ms, 4),
                 "cpu_ms": round(cpu_ms, 4),
                 "phases": phases, "crit": crit_name}
        if attrs:
            entry["attrs"] = attrs
        with self._lock:
            self._committed += 1
            self._cycles[rec.kind] = self._cycles.get(rec.kind, 0) + 1
            self._ring.append(entry)
            for name, a, b, cpu in rec.phases:
                key = (rec.kind, name)
                stat = self._stats.get(key)
                if stat is None:
                    stat = self._stats[key] = _PhaseStat()
                stat.observe((b - a) * 1e3, cpu)
            if crit_name:
                bl = self._blame.get((rec.kind, crit_name))
                if bl is None:
                    bl = self._blame[(rec.kind, crit_name)] = [0, 0.0]
                bl[0] += 1
                bl[1] += crit_ms
        for fn in tuple(self._listeners):
            try:
                fn(entry)
            except Exception:
                pass   # an exporter must never take down the scheduler

    # -- reads ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/debug/profile`` body: per-kind phase stats, blame
        shares (fraction of cycles each phase critically bounded, with
        the overlap tails excluded), the dominant phase per kind, and
        a decisions/s estimate over the ring window."""
        with self._lock:
            entries = list(self._ring)
            stats = {k: s.snapshot() for k, s in self._stats.items()}
            blame = {k: tuple(v) for k, v in self._blame.items()}
            cycles = dict(self._cycles)
            committed = self._committed
        kinds: dict = {}
        for kind, n in sorted(cycles.items()):
            phase_stats = {p: snap for (k, p), snap in stats.items()
                           if k == kind}
            total_crit = sum(c for (k, _p), (c, _ms) in blame.items()
                             if k == kind)
            shares = {}
            for (k, p), (c, ms) in blame.items():
                if k == kind and total_crit:
                    shares[p] = {"cycles": c,
                                 "share": round(c / total_crit, 4),
                                 "ms": round(ms, 2)}
            dominant = max(shares, key=lambda p: shares[p]["cycles"]) \
                if shares else ""
            kinds[kind] = {"cycles": n, "phases": phase_stats,
                           "blame": shares, "dominant": dominant}
        return {"enabled": self.enabled, "committed": committed,
                "ring": len(entries), "kinds": kinds,
                "decisions_per_s": self._rate(entries)}

    @staticmethod
    def _rate(entries: list) -> float:
        """Matched-jobs/s over the ring's consume records."""
        t_lo, t_hi, matched = None, None, 0
        for e in entries:
            if e["kind"] != "consume":
                continue
            t0, t1 = e["t0_ms"], e["t0_ms"] + e["wall_ms"]
            t_lo = t0 if t_lo is None or t0 < t_lo else t_lo
            t_hi = t1 if t_hi is None or t1 > t_hi else t_hi
            matched += int((e.get("attrs") or {}).get("matched", 0))
        if t_lo is None or t_hi is None or t_hi <= t_lo:
            return 0.0
        return round(matched / ((t_hi - t_lo) / 1e3), 2)

    def rate(self) -> float:
        with self._lock:
            entries = list(self._ring)
        return self._rate(entries)

    def worst(self, k: int = 8) -> list:
        """The K slowest cycles currently in the ring, worst first."""
        with self._lock:
            entries = list(self._ring)
        entries.sort(key=lambda e: e["wall_ms"], reverse=True)
        return entries[:max(0, int(k))]

    def chrome_trace(self, k: int = 8) -> dict:
        """The K worst cycles as Chrome-trace/Perfetto JSON."""
        spans = []
        for e in self.worst(k):
            attrs = dict(e.get("attrs") or {})
            attrs["pool"] = e["pool"]
            attrs["crit"] = e["crit"]
            spans.append({
                "name": f"cycle.{e['kind']}", "t0": e["t0_ms"],
                "t1": e["t0_ms"] + e["wall_ms"], "attrs": attrs,
                "children": [
                    {"name": p["name"],
                     "t0": e["t0_ms"] + p["off_ms"],
                     "t1": e["t0_ms"] + p["off_ms"] + p["ms"],
                     "attrs": {"cpu_ms": p["cpu_ms"]}}
                    for p in e["phases"]]})
        return to_chrome_trace(spans, tid_key="pool")

    # -- listeners / lifecycle ----------------------------------------

    def add_listener(self, fn) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def configure(self, ring: Optional[int] = None,
                  enabled: Optional[bool] = None) -> None:
        with self._lock:
            if ring is not None and ring != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=ring)
        if enabled is not None:
            self.enabled = enabled

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._stats.clear()
            self._blame.clear()
            self._cycles.clear()
            self._committed = 0


# Process-wide default, mirroring obs.trace.tracer.
profiler = CycleProfiler()
