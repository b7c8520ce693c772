"""Seeded, deterministic agent-churn schedules: kill / restart / flap /
partition as first-class chaos, the fleet-level counterpart of the
per-RPC sites in this package.

The transport sites (agent.heartbeat, agent.status_post, ...) perturb
individual messages; a production day also loses whole AGENTS — a node
is drained (kill), a daemon is bounced by its supervisor (restart), a
box reboots in a crash loop (flap), a rack loses its uplink for a
minute (partition). This module generates those events as a
deterministic schedule — a pure function of (seed, fleet, duration),
using the package's ``random.Random(f"{seed}:{site}")`` idiom — which
the day-soak harness and ``bench.py day-soak`` execute against live
AgentDaemon processes/threads:

    kill        stop the daemon and never bring it back (lease fully
                lapses; tasks requeue mea-culpa)
    restart     stop the daemon, start a fresh one on the same
                hostname after ``down_s`` (re-registration reconciles)
    flap        a short stop/start bounce, inside the suspect window
                when the fleet is healthy — the liveness hysteresis
                must NOT declare it dead
    partition   the daemon keeps running its tasks but its coordinator
                RPCs fail for ``down_s`` (network cut, process alive);
                on heal the liveness layer must resurrect + adopt, not
                double-launch

Like every chaos schedule here the event list is recorded and can be
written as a JSONL artifact so a red soak ships its exact churn.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field

SITE = "agent.churn"
LEADER_SITE = "leader.churn"
MEMBERSHIP_SITE = "membership.churn"

KILL = "kill"
RESTART = "restart"
FLAP = "flap"
PARTITION = "partition"

# coordinator-tier faults (the federation soak's schedule): a LEADER
# process is SIGKILLed mid-flight (the standby must take over behind
# the epoch fence), or a coordinator<->coordinator link is cut — the
# process freezes for ``down_s`` (SIGSTOP/SIGCONT in the harness),
# modelling a partitioned-but-alive leader whose sockets stay open
LEADER_KILL = "leader_kill"
LEADER_PARTITION = "leader_partition"

ACTIONS = (KILL, RESTART, FLAP, PARTITION)
LEADER_ACTIONS = (LEADER_KILL, LEADER_PARTITION)

# membership-tier faults (the reconfiguration soak's schedule): the
# fleet's TOPOLOGY changes while traffic flows — a group joins (boot +
# /federation/reload announce), a group leaves (drain every owned pool
# then retire), a group leaves while its pool still holds pending work
# ("hot" — the drain's 409/retry window is exercised for real). The
# _KILL/_STOP variants compound a crash into the change window: the
# reloading coordinator is SIGKILLed mid-reload (after the membership
# ledger's begin record — resume must finish the change), SIGKILLed
# mid-retire-drain (after >=1 pool moved — resume must not re-move
# it), or the DEPARTING group is SIGSTOP-frozen so the drain has to
# wait the freeze out.
MEMBER_JOIN = "member_join"
MEMBER_LEAVE = "member_leave"
MEMBER_LEAVE_HOT = "member_leave_hot"
MEMBER_JOIN_KILL = "member_join_kill"        # SIGKILL mid-reload
MEMBER_LEAVE_KILL = "member_leave_kill"      # SIGKILL mid-retire-drain
MEMBER_LEAVE_STOP = "member_leave_stop"      # SIGSTOP departing group
MEMBERSHIP_ACTIONS = (MEMBER_JOIN, MEMBER_LEAVE, MEMBER_LEAVE_HOT,
                      MEMBER_JOIN_KILL, MEMBER_LEAVE_KILL,
                      MEMBER_LEAVE_STOP)


@dataclass(frozen=True)
class ChurnEvent:
    """One scheduled fleet fault. ``t_s`` is seconds from soak start;
    ``down_s`` is how long the agent stays gone/cut (0 for kill —
    permanent)."""
    t_s: float
    action: str
    hostname: str
    down_s: float = 0.0

    def as_dict(self) -> dict:
        return {"t_s": round(self.t_s, 3), "action": self.action,
                "hostname": self.hostname,
                "down_s": round(self.down_s, 3)}


@dataclass
class ChurnSchedule:
    seed: int
    duration_s: float
    events: list = field(default_factory=list)
    site: str = SITE

    def save(self, path: str) -> int:
        """JSONL artifact (one event per line), the save_events shape."""
        with open(path, "w") as f:
            f.write(json.dumps({"seed": self.seed,
                                "duration_s": self.duration_s,
                                "site": self.site}) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev.as_dict(),
                                   separators=(",", ":")) + "\n")
        return len(self.events)


def generate_churn(seed: int, hostnames: list, duration_s: float,
                   events_per_agent: float = 1.0,
                   kill_fraction: float = 0.15,
                   restart_down_s: tuple = (2.0, 8.0),
                   flap_down_s: tuple = (0.2, 1.0),
                   partition_down_s: tuple = (2.0, 10.0),
                   weights: dict = None) -> ChurnSchedule:
    """Deterministic churn for a fleet: ~``events_per_agent`` faults
    per agent spread uniformly over ``duration_s``, drawn from the
    (seed, "agent.churn") stream so the N-th event is a pure function
    of the inputs. ``kill_fraction`` of agents (at most all-but-one —
    the fleet must not churn itself to zero capacity) get a permanent
    kill as their LAST event; everything before is survivable churn."""
    rng = random.Random(f"{seed}:{SITE}")
    w = {RESTART: 0.4, FLAP: 0.35, PARTITION: 0.25}
    if weights:
        w.update(weights)
    total = sum(w.values())
    events: list[ChurnEvent] = []
    n_kill = min(int(len(hostnames) * kill_fraction),
                 max(0, len(hostnames) - 1))
    # rng.sample keeps the kill set a function of the seed alone
    killed = set(rng.sample(sorted(hostnames), n_kill)) if n_kill else set()
    for hostname in sorted(hostnames):
        n = max(1, round(events_per_agent)) if events_per_agent else 0
        last_t = 0.0
        for _ in range(n):
            t = rng.uniform(0.05 * duration_s, 0.8 * duration_s)
            u = rng.uniform(0.0, total)
            cum = 0.0
            action = RESTART
            for a, p in w.items():
                cum += p
                if u < cum:
                    action = a
                    break
            lo, hi = {RESTART: restart_down_s, FLAP: flap_down_s,
                      PARTITION: partition_down_s}[action]
            events.append(ChurnEvent(t_s=t, action=action,
                                     hostname=hostname,
                                     down_s=rng.uniform(lo, hi)))
            last_t = max(last_t, t)
        if hostname in killed:
            events.append(ChurnEvent(
                t_s=rng.uniform(max(last_t, 0.5 * duration_s),
                                0.9 * duration_s),
                action=KILL, hostname=hostname))
    events.sort(key=lambda e: (e.t_s, e.hostname))
    return ChurnSchedule(seed=seed, duration_s=duration_s, events=events)


def generate_leader_churn(seed: int, duration_s: float,
                          kills: int = 2, partitions: int = 1,
                          partition_down_s: tuple = (0.5, 2.0),
                          min_gap_s: float = 3.0) -> ChurnSchedule:
    """Deterministic coordinator-tier churn for the federation soak:
    ``kills`` SIGKILLs of WHOEVER leads at fire time (the harness
    resolves the target from the lock file, so the schedule names the
    role, not a process) and ``partitions`` freeze windows of the
    current leader. Events are spaced at least ``min_gap_s`` apart so
    every takeover's MTTR is measured from a settled fleet, and sorted
    so the whole schedule is a pure function of (seed, duration)."""
    rng = random.Random(f"{seed}:{LEADER_SITE}")
    events: list[ChurnEvent] = []
    n = kills + partitions
    span = max(duration_s - 0.1 * duration_s, min_gap_s * max(n, 1))
    slots = sorted(rng.uniform(0.1 * duration_s,
                               0.1 * duration_s + span)
                   for _ in range(n))
    for i in range(1, len(slots)):     # enforce the settle gap
        slots[i] = max(slots[i], slots[i - 1] + min_gap_s)
    actions = [LEADER_KILL] * kills + [LEADER_PARTITION] * partitions
    rng.shuffle(actions)
    for t, action in zip(slots, actions):
        down = rng.uniform(*partition_down_s) \
            if action == LEADER_PARTITION else 0.0
        events.append(ChurnEvent(t_s=t, action=action,
                                 hostname="leader", down_s=down))
    return ChurnSchedule(seed=seed, duration_s=duration_s, events=events,
                         site=LEADER_SITE)


def generate_membership_churn(seed: int, duration_s: float,
                              joins: int = 1, leaves: int = 1,
                              kill_mid_reload: bool = False,
                              kill_mid_drain: bool = False,
                              leave_hot: bool = False,
                              stop_departing: bool = False,
                              stop_down_s: tuple = (0.5, 2.0),
                              min_gap_s: float = 5.0) -> ChurnSchedule:
    """Deterministic membership-change schedule for the
    reconfiguration soak: ``joins`` group joins and ``leaves`` group
    leaves spread over ``duration_s``, joins always scheduled before
    leaves (a fleet must grow before it can shrink back without going
    below quorum-of-one-survivor). The flags UPGRADE events in place
    rather than adding more: ``kill_mid_reload`` turns the last join
    into a join whose reloading coordinator is SIGKILLed after the
    ledger's begin record; ``kill_mid_drain`` / ``leave_hot`` /
    ``stop_departing`` upgrade leave events likewise (at most one
    upgrade per event, applied in that priority order). The hostname
    field names the ROLE slot ("join-0", "leave-0", ...) — the
    harness binds it to a concrete group at fire time — and
    ``down_s`` is the SIGSTOP freeze for the stop variant. Sorted and
    gap-enforced like generate_leader_churn, so the whole schedule is
    a pure function of the inputs."""
    rng = random.Random(f"{seed}:{MEMBERSHIP_SITE}")
    n = joins + leaves
    span = max(duration_s - 0.1 * duration_s, min_gap_s * max(n, 1))
    slots = sorted(rng.uniform(0.1 * duration_s,
                               0.1 * duration_s + span)
                   for _ in range(n))
    for i in range(1, len(slots)):     # settle gap between changes
        slots[i] = max(slots[i], slots[i - 1] + min_gap_s)
    join_actions = [MEMBER_JOIN] * joins
    if join_actions and kill_mid_reload:
        join_actions[-1] = MEMBER_JOIN_KILL
    leave_actions = [MEMBER_LEAVE] * leaves
    upgrades = []
    if kill_mid_drain:
        upgrades.append(MEMBER_LEAVE_KILL)
    if leave_hot:
        upgrades.append(MEMBER_LEAVE_HOT)
    if stop_departing:
        upgrades.append(MEMBER_LEAVE_STOP)
    for i, up in enumerate(upgrades[:len(leave_actions)]):
        leave_actions[len(leave_actions) - 1 - i] = up
    events: list[ChurnEvent] = []
    for i, (t, action) in enumerate(
            zip(slots, join_actions + leave_actions)):
        role = (f"join-{i}" if i < joins else f"leave-{i - joins}")
        down = rng.uniform(*stop_down_s) \
            if action == MEMBER_LEAVE_STOP else 0.0
        events.append(ChurnEvent(t_s=t, action=action,
                                 hostname=role, down_s=down))
    return ChurnSchedule(seed=seed, duration_s=duration_s,
                         events=events, site=MEMBERSHIP_SITE)
