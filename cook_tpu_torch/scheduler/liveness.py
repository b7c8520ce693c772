"""Lease-based agent liveness: alive -> suspect -> dead -> resurrected.

The per-RPC circuit breaker (utils/breaker.py) answers "should I post
to this host right now?"; it cannot distinguish a slow-but-reachable
agent from a dead one, and it knows nothing about the agent's OWN
traffic (registration, heartbeats, status posts). This tracker owns
that second question — the cook heartbeat.clj / fenzo lease-expiry
role — as an explicit state machine with hysteresis:

    alive        traffic within suspect_after_s of now
    suspect      quiet for suspect_after_s; still offerable (slow or
                 briefly partitioned != dead), one step from dead
    dead         quiet for the full lease_s: offers are withdrawn and
                 the host's running tasks enter a GRACE window; only
                 after the grace lapses (the lease has fully expired
                 twice over) are they failed mea-culpa and requeued
    resurrected  traffic returned from a dead host: the owner censuses
                 the agent (query_agent_tasks) and ADOPTS still-running
                 tasks instead of double-launching; the agent must
                 sustain traffic for resurrect_hold_s before it is
                 plain `alive` again (flap hysteresis)

The tracker is pure bookkeeping — it reports transitions and lapse
events; the AgentCluster performs the actions (offer withdrawal, task
requeue, census/adopt). Clock is injectable so the compressed-day soak
can drive it deterministically.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.utils.lockwitness import witness_lock
from cook_tpu_torch.state.model import now_ms
from cook_tpu_torch.utils.metrics import registry as metrics_registry

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
RESURRECTED = "resurrected"

_STATES = (ALIVE, SUSPECT, DEAD, RESURRECTED)


class _Lease:
    __slots__ = ("state", "last_seen", "state_since", "flaps", "lapsed")

    def __init__(self, now: float):
        self.state = ALIVE
        self.last_seen = now
        self.state_since = now
        self.flaps = 0        # lifetime dead -> resurrected transitions
        self.lapsed = False   # grace expired; tasks already requeued


class AgentLivenessTracker:
    """One lease per agent hostname; see module docstring for the
    state machine. ``observe`` is called from agent traffic handlers,
    ``tick`` from the cluster's periodic advance."""

    def __init__(self, lease_s: float = 30.0,
                 suspect_after_s: Optional[float] = None,
                 grace_s: float = 0.0,
                 resurrect_hold_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if lease_s <= 0:
            raise ValueError("lease_s must be > 0")
        self.lease_s = float(lease_s)
        # default: suspicion at half a lease — early enough to matter,
        # late enough that one delayed heartbeat doesn't flap the state
        self.suspect_after_s = float(suspect_after_s) \
            if suspect_after_s is not None else self.lease_s / 2.0
        self.grace_s = float(grace_s)
        self.resurrect_hold_s = float(resurrect_hold_s) \
            if resurrect_hold_s is not None else self.suspect_after_s
        self._clock = clock
        self._leases: dict[str, _Lease] = {}
        self._lock = witness_lock("AgentLivenessTracker._lock")
        # bounded transition ledger for /debug (same shape as the
        # breaker_transitions ring)
        self.transitions: "collections.deque[dict]" = \
            collections.deque(maxlen=256)

    # -- inputs --------------------------------------------------------
    def observe(self, hostname: str,
                now: Optional[float] = None) -> Optional[tuple]:
        """Agent traffic arrived (register/heartbeat/status/progress).
        Returns the (old, new) state transition this caused, or None.
        A dead host's traffic yields (DEAD, RESURRECTED) — the caller
        runs the census/adopt pass on that signal."""
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(hostname)
            if lease is None:
                self._leases[hostname] = _Lease(now)
                self._record_locked(hostname, "", ALIVE)
                return ("", ALIVE)
            lease.last_seen = now
            if lease.state == DEAD:
                lease.state = RESURRECTED
                lease.state_since = now
                lease.flaps += 1
                lease.lapsed = False
                self._record_locked(hostname, DEAD, RESURRECTED)
                return (DEAD, RESURRECTED)
            if lease.state == SUSPECT:
                lease.state = ALIVE
                lease.state_since = now
                self._record_locked(hostname, SUSPECT, ALIVE)
                return (SUSPECT, ALIVE)
            if lease.state == RESURRECTED and \
                    now - lease.state_since >= self.resurrect_hold_s:
                lease.state = ALIVE
                lease.state_since = now
                self._record_locked(hostname, RESURRECTED, ALIVE)
                return (RESURRECTED, ALIVE)
            return None

    def tick(self, now: Optional[float] = None) -> dict:
        """Evaluate time-based transitions. Returns
        {"transitions": [(hostname, old, new), ...],
         "lapsed": [hostname, ...]} where `lapsed` lists dead hosts
        whose grace window just expired — their tasks should be
        requeued mea-culpa NOW (and exactly once: the lapse fires one
        time per death)."""
        now = self._clock() if now is None else now
        transitions: list[tuple] = []
        lapsed: list[str] = []
        with self._lock:
            for hostname, lease in self._leases.items():
                quiet = now - lease.last_seen
                if lease.state in (ALIVE, RESURRECTED) and \
                        quiet >= self.suspect_after_s:
                    old = lease.state
                    lease.state = SUSPECT
                    lease.state_since = now
                    self._record_locked(hostname, old, SUSPECT)
                    transitions.append((hostname, old, SUSPECT))
                if lease.state == SUSPECT and quiet >= self.lease_s:
                    lease.state = DEAD
                    lease.state_since = now
                    self._record_locked(hostname, SUSPECT, DEAD)
                    transitions.append((hostname, SUSPECT, DEAD))
                if lease.state == DEAD and not lease.lapsed and \
                        now - lease.state_since >= self.grace_s:
                    lease.lapsed = True
                    lapsed.append(hostname)
        return {"transitions": transitions, "lapsed": lapsed}

    def forget(self, hostname: str) -> None:
        with self._lock:
            self._leases.pop(hostname, None)

    # -- queries -------------------------------------------------------
    def state(self, hostname: str) -> str:
        """Unknown hosts read as alive: liveness only ever REMOVES a
        host from consideration, it must not block a brand-new agent's
        first offers."""
        with self._lock:
            lease = self._leases.get(hostname)
            return lease.state if lease is not None else ALIVE

    def offerable(self, hostname: str) -> bool:
        """May this host's resources be offered? Suspect stays
        offerable (slow-but-reachable != dead); only dead withdraws."""
        return self.state(hostname) != DEAD

    def counts(self) -> dict[str, int]:
        with self._lock:
            out = {s: 0 for s in _STATES}
            for lease in self._leases.values():
                out[lease.state] += 1
            return out

    def snapshot(self) -> dict:
        """Point-in-time view for /debug."""
        with self._lock:
            agents = {h: {"state": lease.state,
                          "flaps": lease.flaps,
                          "lapsed": lease.lapsed}
                      for h, lease in self._leases.items()}
            try:
                transitions = list(self.transitions)
            except RuntimeError:
                transitions = []
        return {"lease_s": self.lease_s,
                "suspect_after_s": self.suspect_after_s,
                "grace_s": self.grace_s,
                "agents": agents,
                "transitions": transitions}

    # ------------------------------------------------------------------
    def _record_locked(self, hostname: str, old: str, new: str) -> None:
        self.transitions.append({"hostname": hostname, "from": old,
                                 "to": new, "t_ms": now_ms()})
        metrics_registry.counter(
            "agent_liveness_transitions_total", to=new).inc()
