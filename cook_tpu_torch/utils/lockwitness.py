"""Opt-in runtime lock-witness: record REAL lock-acquisition edges.

The static analyzer (``cook_tpu/analysis/interproc.py``) computes the
lock-order graph by over-approximation; this module is the other half
of the contract — an instrumented-lock wrapper that records the edges
threads actually take, so ``python -m cook_tpu.analysis --witness``
can diff observed against static:

* an **observed edge the static graph lacks** means the model missed a
  call path — that diff FAILS CI, because a missed path is exactly
  where the next soak-only deadlock hides;
* a **static edge never observed** is a coverage gap, reported but
  non-fatal (the static side over-approximates on purpose).

Arming: set ``COOK_LOCK_WITNESS=<dir>`` before the process starts.
Unarmed (the default), :func:`witness_lock` returns a plain
``threading.Lock``/``RLock`` and :func:`witness_condition` a plain
``Condition`` — zero wrapper, zero overhead, production behavior
byte-identical. Armed, each named lock is wrapped with a thread-local
held-stack; on every acquisition the wrapper records one ``held ->
acquired`` edge per distinct held lock, and rewrites
``<dir>/witness-<pid>.jsonl`` (tmp + ``os.replace``) whenever a NEW
edge appears — the file is complete-at-every-instant, so a SIGKILL
mid-soak (the crash-soak job's whole point) still leaves a valid
witness file.

Lock identity is the **name literal** passed to the factory — the same
literal the static analyzer reads out of the callsite, so the two
vocabularies agree by construction. A lock list (the store's shard
locks) shares one family name (``...[*]``) and passes ``rank=i``; an
acquisition of rank *i* while holding rank *j* of the same family is
recorded ordered (``j < i``, the blessed ascending walk) or unordered
(``j > i`` — exactly the inversion R11 hunts). Same-instance re-entry
of a reentrant lock is legal and recorded as no edge; a *different*
instance under the same name records a self-edge.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Optional

_ENV = "COOK_LOCK_WITNESS"

_state_lock = threading.Lock()
_edges: dict = {}            # (src, dst, ordered) -> count
_out_dir: Optional[str] = None
_tls = threading.local()


def armed() -> bool:
    return bool(os.environ.get(_ENV))


def _held_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _flush_locked() -> None:
    if _out_dir is None:
        return
    path = os.path.join(_out_dir, f"witness-{os.getpid()}.jsonl")
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            for (src, dst, ordered), n in sorted(_edges.items()):
                f.write(json.dumps({"from": src, "to": dst,
                                    "ordered": ordered, "n": n}) + "\n")
        os.replace(tmp, path)
    except OSError:
        pass                 # witness is best-effort observability


def _record(name: str, rank: Optional[int], instance) -> None:
    """Called with the lock ACQUIRED: push the frame, record edges."""
    stack = _held_stack()
    if any(inst is instance for _, _, inst in stack):
        # reentrant re-acquisition: cannot block, so it constrains no
        # ordering — record nothing, not even edges from other held
        # locks (those were recorded at the first acquisition)
        stack.append((name, rank, instance))
        return
    new = False
    with _state_lock:
        for held_name, held_rank, held_inst in stack:
            if held_name == name:
                if held_inst is instance:
                    continue          # unreachable, kept for safety
                if rank is not None and held_rank is not None:
                    ordered = held_rank < rank
                else:
                    ordered = False
                key = (held_name, name, ordered)
            else:
                key = (held_name, name, False)
            if key not in _edges:
                new = True
            _edges[key] = _edges.get(key, 0) + 1
        if new:
            _flush_locked()
    stack.append((name, rank, instance))


def _unrecord(name: str, instance) -> None:
    stack = _held_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name and stack[i][2] is instance:
            del stack[i]
            return


class WitnessLock:
    """threading.Lock/RLock drop-in that records acquisition edges."""

    def __init__(self, name: str, reentrant: bool,
                 rank: Optional[int] = None):
        self._name = name
        self._rank = rank
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _record(self._name, self._rank, self)
        return got

    def release(self) -> None:
        _unrecord(self._name, self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessLock {self._name!r} {self._inner!r}>"


def witness_lock(name: str, reentrant: bool = False,
                 rank: Optional[int] = None):
    """A lock that records acquisition-order edges when the witness is
    armed; a plain ``threading.Lock``/``RLock`` otherwise."""
    if not armed():
        return threading.RLock() if reentrant else threading.Lock()
    _arm_dir()
    return WitnessLock(name, reentrant, rank)


def witness_condition(name: str):
    """A Condition whose underlying lock is witnessed when armed.

    ``threading.Condition`` drives an unfamiliar lock through plain
    ``acquire``/``release`` (no ``_release_save`` fast path), so
    ``wait()``'s release/re-acquire passes through the witness and the
    held-stack stays truthful across the wait.
    """
    if not armed():
        return threading.Condition()
    _arm_dir()
    return threading.Condition(lock=WitnessLock(name, reentrant=False))


def _arm_dir() -> None:
    global _out_dir
    if _out_dir is not None:
        return
    d = os.environ.get(_ENV)
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        _out_dir = d
    except OSError:
        pass


def observed_edges() -> dict:
    """(src, dst, ordered) -> count snapshot, for tests."""
    with _state_lock:
        return dict(_edges)


def reset() -> None:
    """Test helper: drop recorded edges (not the held stacks)."""
    with _state_lock:
        _edges.clear()
