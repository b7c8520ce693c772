"""ctypes binding for the native match-book driver (matchbook.cpp).

`NativeForbiddenBuilder` is the coordinator-facing surface: it keeps the
persistent per-job placement state (novel-host history, EQUALS
constraints) resident in C++ across cycles and fills the dense
forbidden[P, H] mask each cycle without Python-loop overhead — the
host-side driver half of the matcher (SURVEY.md §7.8; what Fenzo's
ConstraintEvaluator callbacks do per (job, host) in the reference,
constraints.clj:57-311).

Falls back cleanly: `NativeForbiddenBuilder.create()` returns None when
the toolchain is unavailable and callers keep using
`cook_tpu.scheduler.constraints.build_forbidden`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from cook_tpu_torch import native as _native

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _native.build("matchbook")
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    i64, i32, u8p = ctypes.c_int64, ctypes.c_int32, \
        ctypes.POINTER(ctypes.c_uint8)
    i64p, i32p = ctypes.POINTER(i64), ctypes.POINTER(i32)
    lib.mb_create.restype = i64
    lib.mb_destroy.argtypes = [i64]
    lib.mb_add_job.argtypes = [i64, i64]
    lib.mb_add_job.restype = i32
    lib.mb_remove_job.argtypes = [i64, i64]
    lib.mb_job_prior_host.argtypes = [i64, i32, i64]
    lib.mb_job_constraint.argtypes = [i64, i32, i64, i64]
    lib.mb_num_jobs.argtypes = [i64]
    lib.mb_num_jobs.restype = i64
    lib.mb_begin_cycle.argtypes = [i64]
    lib.mb_set_hosts.argtypes = [i64, i64p, i64]
    lib.mb_host_attr.argtypes = [i64, i32, i64, i64]
    lib.mb_set_host_attrs.argtypes = [i64, i32p, i64p, i64p, i64]
    lib.mb_reserve.argtypes = [i64, i64, i64]
    lib.mb_job_tmp_exclude.argtypes = [i64, i32, i64]
    lib.mb_job_tmp_constraint.argtypes = [i64, i32, i64, i64]
    lib.mb_fill_forbidden.argtypes = [i64, i32p, i64, u8p]
    _lib = lib
    return _lib


class _Interner:
    """str -> stable int64 id (strings never cross the C ABI).

    Cluster-bounded strings (host names, attribute names, attribute
    values observed on hosts) are interned forever — pinned — via
    `id()`. Job-scoped strings (job uuids, constraint patterns —
    unbounded over a coordinator's lifetime) go through
    `id_ref()`/`drop_ref()` refcounting so their entries die with the
    last job using them. A string seen through BOTH (a constraint
    pattern that is also a live host-attr value) is pinned: evicting it
    would mint a new id for the host side while C++ job constraints
    still hold the old one, silently un-matching them.
    """

    _PINNED = -1

    def __init__(self):
        self.ids: dict[str, int] = {}
        self._refs: dict[str, int] = {}
        self._next = 0

    def _intern(self, s: str) -> int:
        i = self.ids.get(s)
        if i is None:
            i = self.ids[s] = self._next
            self._next += 1
        return i

    def id(self, s: str) -> int:
        i = self._intern(s)
        self._refs[s] = self._PINNED
        return i

    def id_ref(self, s: str) -> int:
        i = self._intern(s)
        n = self._refs.get(s, 0)
        if n != self._PINNED:
            self._refs[s] = n + 1
        return i

    def drop_ref(self, s: str) -> None:
        """Release one reference; evict at zero (ids never reused)."""
        n = self._refs.get(s)
        if n is None or n == self._PINNED:
            return
        if n <= 1:
            del self._refs[s]
            self.ids.pop(s, None)
        else:
            self._refs[s] = n - 1

    def peek(self, s: str) -> int:
        """Existing id, or a fresh UNSTORED one. For transient mentions
        (reservation owners) that must compare equal to a live job's id
        when one exists but must never create a persistent entry."""
        i = self.ids.get(s)
        if i is not None:
            return i
        i = self._next
        self._next += 1
        return i


def _destroy_handle(lib, h):
    """Module-level so the finalizer holds no reference to the builder."""
    try:
        if h:
            lib.mb_destroy(h)
    except Exception:
        pass


class NativeForbiddenBuilder:
    """Drop-in producer of the forbidden[P, H] mask.

    Persistent job state is synced incrementally: per job we remember how
    many instances/constraints were already pushed to C++ and append only
    the delta — the 'ship deltas, not snapshots' design the <50 ms cycle
    budget requires (SURVEY.md §7 hard parts).

    Supports EQUALS constraints only, matching the REST API surface
    (rest/api.py rejects other operators); callers with GLOB constraints
    must use the numpy builder.
    """

    @classmethod
    def create(cls) -> Optional["NativeForbiddenBuilder"]:
        return cls() if _load() is not None else None

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise OSError("native matchbook unavailable")
        self._h = self._lib.mb_create()
        self._strs = _Interner()
        # job uuid -> [slot, n_prior_hosts_pushed, ref'd value strings].
        # Constraints are pushed once at first sight: the REST API fixes
        # a job's constraints at submission (rest/api.py) and nothing
        # mutates them afterwards, so only the instance list needs
        # delta-sync.
        self._jobs: dict[str, list] = {}
        # matchbook.cpp is single-writer by design; the coordinator calls
        # in from the match loop, the rebalancer loop, and backend status
        # threads (forget), and ctypes releases the GIL — serialize here
        self._lock = threading.Lock()
        # weakref.finalize (NOT __del__): the server gc.freeze()s the
        # coordinator graph at takeover, and a frozen object's __del__
        # never runs — the native handle must still be destroyed at
        # interpreter exit (same rule as native/eventlog.py)
        import weakref
        self._finalizer = weakref.finalize(
            self, _destroy_handle, self._lib, self._h)

    # -- job state sync ------------------------------------------------
    def _sync_job(self, job) -> int:
        ent = self._jobs.get(job.uuid)
        if ent is None:
            slot = self._lib.mb_add_job(self._h,
                                        self._strs.id_ref(job.uuid))
            vals: list[str] = []
            ent = self._jobs[job.uuid] = [slot, 0, vals]
            for (attr, op, pattern) in job.constraints:
                if op == "EQUALS":
                    v = "v:" + str(pattern)
                    self._lib.mb_job_constraint(
                        self._h, slot, self._strs.id("a:" + attr),
                        self._strs.id_ref(v))
                    vals.append(v)
        slot, n_hosts, _ = ent
        insts = job.instances
        for inst in insts[n_hosts:]:
            # same novel-host discipline as the numpy path: a 5003
            # launch-ack-timeout never fed the host a command, so it
            # doesn't join the exclusion set (the instance is terminal
            # by the time the job re-enters the pending feed, so the
            # reason code is final here)
            if not inst.counts_for_novel_host:
                continue
            self._lib.mb_job_prior_host(self._h, slot,
                                        self._strs.id("h:" + inst.hostname))
        ent[1] = len(insts)
        return slot

    def forget(self, job_uuid: str) -> None:
        """Drop a completed/killed job's state (frees the C++ slot)."""
        with self._lock:
            self._forget_locked(job_uuid)

    def _forget_locked(self, job_uuid: str) -> None:
        ent = self._jobs.pop(job_uuid, None)
        if ent is not None:
            uid = self._strs.ids.get(job_uuid)
            if uid is not None:
                self._lib.mb_remove_job(self._h, uid)
            # Job-scoped strings (uuid + constraint patterns) are
            # unbounded over a coordinator's lifetime — release them
            # with the C++ slot. Cluster-bounded host/attr strings are
            # pinned and stay.
            self._strs.drop_ref(job_uuid)
            for v in ent[2]:
                self._strs.drop_ref(v)

    def gc(self, live_uuids) -> int:
        """Forget every tracked job not in live_uuids (catches jobs
        killed while WAITING, which never get a backend status)."""
        with self._lock:
            dead = [u for u in self._jobs if u not in live_uuids]
            for u in dead:
                self._forget_locked(u)
            return len(dead)

    # -- the per-cycle call --------------------------------------------
    def fill(self, jobs, host_names, host_attrs, reservations=None,
             group_cotask_attr=None, group_cotask_hosts=None) -> np.ndarray:
        """Same contract as constraints.build_forbidden."""
        with self._lock:
            return self._fill_locked(jobs, host_names, host_attrs,
                                     reservations, group_cotask_attr,
                                     group_cotask_hosts)

    def _fill_locked(self, jobs, host_names, host_attrs, reservations,
                     group_cotask_attr, group_cotask_hosts) -> np.ndarray:
        lib, h = self._lib, self._h
        sid = self._strs.id
        lib.mb_begin_cycle(h)
        name_ids = np.fromiter((sid("h:" + n) for n in host_names),
                               np.int64, len(host_names))
        lib.mb_set_hosts(
            h, name_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(host_names))
        triples = [(hi, sid("a:" + attr), sid("v:" + str(val)))
                   for hi, attrs in enumerate(host_attrs)
                   for attr, val in attrs.items()]
        if triples:
            t = np.asarray(triples, np.int64)
            hcol = t[:, 0].astype(np.int32)
            acol = np.ascontiguousarray(t[:, 1])
            vcol = np.ascontiguousarray(t[:, 2])
            lib.mb_set_host_attrs(
                h, hcol.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                acol.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                vcol.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(triples))
        slots = np.empty(len(jobs), np.int32)
        for j, job in enumerate(jobs):
            slot = self._sync_job(job)
            slots[j] = slot
            if job.group and group_cotask_attr and \
                    job.group in group_cotask_attr:
                for attr, required in group_cotask_attr[job.group].items():
                    lib.mb_job_tmp_constraint(h, slot, sid("a:" + attr),
                                              sid("v:" + str(required)))
            if job.group and group_cotask_hosts and \
                    job.group in group_cotask_hosts:
                for hostname in group_cotask_hosts[job.group]:
                    lib.mb_job_tmp_exclude(h, slot, sid("h:" + hostname))

        # Reservations AFTER job sync: peek() must see an owner's
        # interned uuid when the owner is in this batch, or the owner
        # would be locked out of its own reserved host.
        for owner_uuid, hostname in (reservations or {}).items():
            lib.mb_reserve(h, sid("h:" + hostname),
                           self._strs.peek(owner_uuid))

        out = np.empty((len(jobs), len(host_names)), np.uint8)
        lib.mb_fill_forbidden(
            h, slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(jobs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out.view(bool)
