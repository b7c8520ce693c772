"""Seeded, deterministic fault injection for the control plane.

Cook's whole value proposition is surviving a hostile cluster — agents
die, networks flap, disks lie — yet reactive failure handling is only
as good as the failures it has actually seen. This package lets tests
(and brave operators) *provoke* those failures deterministically at
named injection sites:

    from cook_tpu_torch import chaos
    a = chaos.act("agent.status_post")
    if a.kind == "drop": ...

Sites are consulted at the transport and durability choke points
(utils/httpjson, agent/daemon, backends/agent, state/store,
scheduler/leader); each returns one of:

    ""          no fault (the shared ACT_NONE — no allocation)
    "drop"      the operation never happens (request not sent)
    "delay"     sleep act.delay_s, then proceed
    "error"     raise a synthetic failure (HTTP act.status for
                transport sites, OSError for storage sites)
    "duplicate" perform the operation twice (at-least-once delivery)
    "torn"      storage only: persist a truncated record, then fail

Zero-overhead when disabled — the same discipline as obs.trace: every
entry point checks ``controller.enabled`` first and returns the shared
no-op ``ACT_NONE``; production pays one attribute load per site.

Determinism: each site owns an independent ``random.Random`` seeded
from ``(seed, site)``, so the N-th decision at a site is a pure
function of the seed regardless of how threads interleave *across*
sites (concurrent callers of the SAME site serialize on the controller
lock; their relative order is scheduling-dependent, but the multiset
of decisions the site hands out is not).

Configured via server settings (``chaos`` section, config.py) or env:
``COOK_CHAOS_SITES`` (JSON site->spec map) + ``COOK_CHAOS_SEED``.
Every decision is recorded in a bounded in-memory event log
(``controller.events_snapshot()`` / ``save_events``) so a failing soak
can ship the exact fault schedule as a CI artifact.
"""
from __future__ import annotations

import json
import os
import random
import threading
from collections import deque
from typing import Optional

_ACTIONS = ("drop", "delay", "error", "duplicate", "torn")


class Act:
    """One injection decision. ``kind`` is "" for no-fault (falsy, so
    callers gate on ``if a.kind:``)."""

    __slots__ = ("kind", "delay_s", "status")

    def __init__(self, kind: str = "", delay_s: float = 0.0,
                 status: int = 503):
        self.kind = kind
        self.delay_s = delay_s
        self.status = status

    def __repr__(self) -> str:
        return f"Act({self.kind or 'none'!r})"


ACT_NONE = Act()


class _Site:
    """Per-site fault schedule: cumulative probability ladder + its own
    deterministic RNG stream."""

    __slots__ = ("ladder", "delay_s", "status", "rng", "n")

    def __init__(self, spec: dict, seed: int, name: str):
        total = 0.0
        ladder = []
        for action in _ACTIONS:
            p = float(spec.get(action, 0.0))
            if p < 0:
                raise ValueError(f"chaos site {name}: {action} < 0")
            if p:
                total += p
                ladder.append((total, action))
        if total > 1.0 + 1e-9:
            raise ValueError(f"chaos site {name}: probabilities sum to "
                             f"{total:.3f} > 1")
        self.ladder = tuple(ladder)
        self.delay_s = float(spec.get("delay_ms", 50.0)) / 1000.0
        self.status = int(spec.get("error_status", 503))
        # seeded from (seed, site) so each site's decision stream is
        # independent of every other site's call volume
        self.rng = random.Random(f"{seed}:{name}")
        self.n = 0


class ChaosController:
    """Module-singleton fault injector (``chaos.controller``)."""

    def __init__(self):
        self.enabled = False
        self.seed = 0
        self._sites: dict[str, _Site] = {}
        self._lock = threading.Lock()
        # bounded decision log: (site, seq, action); ACT_NONE draws are
        # recorded too — replaying a schedule needs the full stream
        self._events: deque = deque(maxlen=8192)
        self.counts: dict[str, int] = {}

    # -- configuration -------------------------------------------------
    def configure(self, seed: int = 0, sites: Optional[dict] = None,
                  enabled: bool = True) -> None:
        """Install a fault schedule. ``sites`` maps site name -> spec
        dict with probabilities per action (``drop``/``delay``/
        ``error``/``duplicate``/``torn``) plus ``delay_ms`` and
        ``error_status`` knobs."""
        with self._lock:
            self.seed = int(seed)
            self._sites = {name: _Site(spec or {}, self.seed, name)
                           for name, spec in (sites or {}).items()}
            self._events.clear()
            self.counts = {}
            self.enabled = bool(enabled) and bool(self._sites)

    def configure_from_env(self, env=os.environ) -> bool:
        """Arm from COOK_CHAOS_SITES (JSON map) + COOK_CHAOS_SEED.
        Returns True when chaos was armed."""
        raw = env.get("COOK_CHAOS_SITES", "")
        if not raw:
            return False
        sites = json.loads(raw)
        self.configure(seed=int(env.get("COOK_CHAOS_SEED", "0")),
                       sites=sites)
        return self.enabled

    def reset(self) -> None:
        with self._lock:
            self.enabled = False
            self._sites = {}
            self._events.clear()
            self.counts = {}

    # -- the hot path --------------------------------------------------
    def act(self, site: str) -> Act:
        """One injection decision for ``site``. Disabled (the
        production default) returns the shared no-op after a single
        attribute check — nothing is allocated, no lock is taken."""
        if not self.enabled:
            return ACT_NONE
        return self._act_armed(site)

    def _act_armed(self, site: str) -> Act:
        with self._lock:
            st = self._sites.get(site)
            if st is None:
                return ACT_NONE
            st.n += 1
            u = st.rng.random()
            action = ""
            for cum, name in st.ladder:
                if u < cum:
                    action = name
                    break
            self._events.append((site, st.n, action))
            if not action:
                return ACT_NONE
            key = f"{site}:{action}"
            self.counts[key] = self.counts.get(key, 0) + 1
            return Act(action, delay_s=st.delay_s, status=st.status)

    # -- inspection / artifacts ----------------------------------------
    def events_snapshot(self) -> list:
        with self._lock:
            return [{"site": s, "seq": n, "action": a}
                    for s, n, a in self._events]

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "seed": self.seed,
                    "sites": sorted(self._sites),
                    "injected": dict(sorted(self.counts.items()))}

    def save_events(self, path: str) -> int:
        """Write the decision log as JSONL (one decision per line) for
        post-mortem artifacts; returns the number of lines written."""
        events = self.events_snapshot()
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, separators=(",", ":")) + "\n")
        return len(events)


controller = ChaosController()


def act(site: str) -> Act:
    return controller.act(site)
