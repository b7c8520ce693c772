"""Placement constraints -> boolean forbidden masks for the kernels.

The reference evaluates constraints twice — as Fenzo ConstraintEvaluators
on the match path and as plain fns on the rebalancer path
(constraints.clj:57-311). Here both paths consume the same dense
`forbidden[job, host]` mask; the constraints that couple same-cycle
assignments (group unique host-placement, max-tasks-per-host) are
enforced inside the match kernel itself (ops/match.py).

Implemented constraint kinds:
  novel-host            job never returns to a host a previous instance
                        ran on (constraints.clj:73-100)
  user attr constraints (attribute, EQUALS, pattern)
                        (constraints.clj:171-198)
  rebalancer reservation hosts reserved for a specific job are forbidden
                        to all others (constraints.clj:130-141,
                        rebalancer.clj:413-426)
  gpu-host              enforced in-kernel from cap_gpus
  group attribute-equals all group tasks on hosts with equal attribute
                        value (constraints.clj:453-480)
"""
from __future__ import annotations

import fnmatch
import logging
from typing import Optional

import numpy as np

from cook_tpu_torch.state.model import Job

logger = logging.getLogger(__name__)
_warned_bad_start_times: set = set()


def _warn_bad_start_time(value) -> None:
    key = repr(value)
    if key not in _warned_bad_start_times:
        logger.warning("unparseable host-start-time attribute %r; "
                       "treating host as unconstrained", value)
        if len(_warned_bad_start_times) >= 1000:   # bound the dedupe set
            _warned_bad_start_times.clear()
        _warned_bad_start_times.add(key)


def _matches(op: str, pattern: str, value: Optional[str]) -> bool:
    if value is None:
        return False
    if op == "EQUALS":
        return value == pattern
    if op == "GLOB":
        return fnmatch.fnmatch(value, pattern)
    return False


def build_forbidden(jobs: list[Job], host_names: list[str],
                    host_attrs: list[dict[str, str]],
                    reservations: Optional[dict[str, str]] = None,
                    group_cotask_attr: Optional[dict[str, dict[str, str]]] = None,
                    group_cotask_hosts: Optional[dict[str, set]] = None,
                    host_index: Optional[dict] = None,
                    attr_cache: Optional[dict] = None,
                    ) -> np.ndarray:
    """forbidden[j, h] True => job j may not land on host h.

    reservations: job_uuid -> reserved hostname (other jobs excluded).
    group_cotask_attr: group_uuid -> {attr: required_value} pinned by
    already-running cotasks of an attribute-equals group.
    group_cotask_hosts: group_uuid -> hostnames holding running cotasks
    of a *unique* host-placement group (cross-cycle uniqueness; the
    in-cycle half is enforced by the match kernel's group_occ).

    host_index / attr_cache: optional caller-owned caches (name->index
    and attr->value-array). Per-call rebuilding of these is O(H) —
    fine for one batch call per cycle, but a caller re-masking many
    jobs one at a time (the resident pool's per-job sparse rows) MUST
    share them or the masks cost O(jobs x H) in pure dict building.

    Vectorized per job over hosts: the hot dimension H is handled with
    numpy masks, never a Python loop.
    """
    P, H = len(jobs), len(host_names)
    forb = np.zeros((P, H), bool)
    reservations = reservations or {}
    group_cotask_attr = group_cotask_attr or {}
    group_cotask_hosts = group_cotask_hosts or {}
    host_idx = (host_index if host_index is not None
                else {h: i for i, h in enumerate(host_names)})

    # hosts reserved for some job are forbidden to every other job
    reserved_rows = np.zeros(H, bool)
    reserved_owner = np.full(H, -1, np.int64)
    uuid_to_row = {job.uuid: j for j, job in enumerate(jobs)}
    for owner_uuid, hostname in reservations.items():
        hi = host_idx.get(hostname)
        if hi is not None:
            reserved_rows[hi] = True
            reserved_owner[hi] = uuid_to_row.get(owner_uuid, -1)

    # per-attribute host value arrays, built lazily once (or shared
    # across calls via the caller's attr_cache)
    if attr_cache is None:
        attr_cache = {}

    def attr_values(attr: str) -> np.ndarray:
        vals = attr_cache.get(attr)
        if vals is None:
            vals = np.array([a.get(attr) for a in host_attrs], dtype=object)
            attr_cache[attr] = vals
        return vals

    for j, job in enumerate(jobs):
        # novel-host: exclude hosts of previous instances (5003
        # launch-ack-timeouts don't count — Instance.counts_for_novel_host)
        for inst in job.instances:
            if not inst.counts_for_novel_host:
                continue
            hi = host_idx.get(inst.hostname)
            if hi is not None:
                forb[j, hi] = True
        # user-defined constraints
        for (attr, op, pattern) in job.constraints:
            vals = attr_values(attr)
            if op == "EQUALS":
                forb[j] |= vals != pattern
            else:
                forb[j] |= ~np.array(
                    [_matches(op, pattern, v) for v in vals], bool)
        # reservations
        forb[j] |= reserved_rows & (reserved_owner != j)
        # group attribute-equals pinning
        if job.group and job.group in group_cotask_attr:
            for attr, required in group_cotask_attr[job.group].items():
                forb[j] |= attr_values(attr) != required
        # cross-cycle unique host-placement
        if job.group and job.group in group_cotask_hosts:
            for hostname in group_cotask_hosts[job.group]:
                hi = host_idx.get(hostname)
                if hi is not None:
                    forb[j, hi] = True
    return forb


def explain_forbidden(job: Job, host_names: list[str],
                      host_attrs: list[dict[str, str]],
                      reservations: Optional[dict[str, str]] = None,
                      group_cotask_attr=None, group_cotask_hosts=None,
                      ) -> dict[str, np.ndarray]:
    """Named per-constraint host masks for ONE job: which constraint
    forbade which hosts. The placement-failure explainer's data source
    (summarize-placement-failure fenzo_utils.clj:45-86) — mirrors
    build_forbidden's per-job body, but keeps each contribution separate
    so /unscheduled_jobs can report failed-constraint names with counts.
    Only called for unplaced jobs, so the per-job cost is fine."""
    H = len(host_names)
    reservations = reservations or {}
    group_cotask_attr = group_cotask_attr or {}
    group_cotask_hosts = group_cotask_hosts or {}
    host_idx = {h: i for i, h in enumerate(host_names)}
    out: dict[str, np.ndarray] = {}

    novel = np.zeros(H, bool)
    for inst in job.instances:
        if not inst.counts_for_novel_host:
            continue
        hi = host_idx.get(inst.hostname)
        if hi is not None:
            novel[hi] = True
    if novel.any():
        out["novel-host"] = novel

    for (attr, op, pattern) in job.constraints:
        vals = np.array([a.get(attr) for a in host_attrs], dtype=object)
        if op == "EQUALS":
            mask = vals != pattern
        else:
            mask = ~np.array([_matches(op, pattern, v) for v in vals], bool)
        if mask.any():
            key = f"user-constraint/{attr}"
            out[key] = out[key] | mask if key in out else mask

    reserved = np.zeros(H, bool)
    for owner_uuid, hostname in reservations.items():
        hi = host_idx.get(hostname)
        if hi is not None and owner_uuid != job.uuid:
            reserved[hi] = True
    if reserved.any():
        out["rebalancer-reservation"] = reserved

    if job.group and job.group in group_cotask_attr:
        mask = np.zeros(H, bool)
        for attr, required in group_cotask_attr[job.group].items():
            vals = np.array([a.get(attr) for a in host_attrs], dtype=object)
            mask |= vals != required
        if mask.any():
            out["group-attribute-equals"] = mask

    if job.group and job.group in group_cotask_hosts:
        mask = np.zeros(H, bool)
        for hostname in group_cotask_hosts[job.group]:
            hi = host_idx.get(hostname)
            if hi is not None:
                mask[hi] = True
        if mask.any():
            out["group-unique-host"] = mask
    return out


def group_attr_requirements(group, running_cotask_hosts: list[dict[str, str]]
                            ) -> dict[str, str]:
    """For an attribute-equals group, derive the pinned attribute value
    from any running cotask's host (constraints.clj:453-480)."""
    hp = group.host_placement
    if hp.get("type") != "attribute-equals":
        return {}
    attr = hp.get("parameters", {}).get("attribute")
    if not attr:
        return {}
    for attrs in running_cotask_hosts:
        if attr in attrs:
            return {attr: attrs[attr]}
    return {}


def estimated_completion_forbidden(jobs: list[Job],
                                   host_attrs: list[dict[str, str]],
                                   now_ms: float,
                                   expected_runtime_multiplier: float,
                                   host_lifetime_mins: float,
                                   agent_start_grace_period_mins: float = 0.0,
                                   ) -> Optional[np.ndarray]:
    """estimated-completion-constraint (constraints.clj:200-247): don't
    place a job on a host expected to shut down before the job's
    estimated completion.

    Hosts advertise "host-start-time" (unix seconds); their death time
    is start + host_lifetime_mins. A job's estimated end is now + the
    max of (expected_runtime x multiplier) and the runtimes of prior
    host-lost failures (the reference's :mesos-slave-removed), capped at
    (host_lifetime - grace) so a full-lifetime job can still land on a
    freshly started host. Jobs with no expected runtime signal are
    unconstrained. Returns None when no host advertises a start time.
    """
    H = len(host_attrs)
    death_ms = np.full(H, np.inf)
    any_start = False
    for h, attrs in enumerate(host_attrs):
        start = attrs.get("host-start-time")
        if start is not None:
            try:
                start_s = float(start)
            except (TypeError, ValueError):
                # a malformed attribute must not break every match and
                # rebalance cycle: treat the host as unconstrained
                _warn_bad_start_time(start)
                continue
            any_start = True
            death_ms[h] = start_s * 1000.0 \
                + host_lifetime_mins * 60_000.0
    if not any_start:
        return None

    cap_ms = (host_lifetime_mins - agent_start_grace_period_mins) * 60_000.0
    forb = np.zeros((len(jobs), H), bool)
    for j, job in enumerate(jobs):
        scaled = (job.expected_runtime_ms or 0) * expected_runtime_multiplier
        lost_runtimes = [
            (inst.end_time_ms - inst.start_time_ms)
            for inst in job.instances
            if inst.reason_code == 5000     # host-lost (slave removed)
            and inst.end_time_ms and inst.start_time_ms]
        expected = max([scaled] + lost_runtimes)
        if expected <= 0:
            continue
        est_end = now_ms + min(expected, cap_ms)
        forb[j] = est_end >= death_ms
    return forb


def group_balanced_exclusions(group,
                              running_cotask_hosts: list[dict[str, str]],
                              host_names: list[str],
                              host_attrs: list[dict[str, str]]) -> set:
    """Hostnames a balanced host-placement group may NOT use this cycle
    (balanced-host-placement-group-constraint, constraints.clj:424-450).

    Reference semantics over the running cotasks' attr-value
    frequencies: with minim = 0 when the `minimum` parameter exceeds the
    number of distinct values seen (forcing spread onto new values),
    else min(freqs), a host passes iff no cotasks exist, its value is
    unseen, minim == maxim (already balanced), or its value's frequency
    is below maxim. So the excluded hosts are exactly those whose value
    sits at maxim while the distribution is (or counts as) imbalanced.
    Same-cycle coupling is approximate — the mask is computed against
    running cotasks once per cycle, like the attribute-equals pin.
    """
    hp = group.host_placement
    if hp.get("type") != "balanced":
        return set()
    params = hp.get("parameters", {})
    attr = params.get("attribute")
    if not attr:
        return set()
    minimum = int(params.get("minimum", 0))
    freqs: dict = {}
    for attrs in running_cotask_hosts:
        v = attrs.get(attr)
        freqs[v] = freqs.get(v, 0) + 1
    if not freqs:
        return set()
    minim = 0 if minimum > len(freqs) else min(freqs.values())
    maxim = max(freqs.values())
    if minim == maxim:
        return set()
    # None (attr absent) is a legitimate frequency bucket, matching the
    # reference's nil handling: a host without the attr is excluded iff
    # nil itself sits at maxim.
    maxed = {v for v, n in freqs.items() if n == maxim}
    return {host_names[i] for i, attrs in enumerate(host_attrs)
            if attrs.get(attr) in maxed}
