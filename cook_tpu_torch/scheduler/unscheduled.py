"""\"Why is my job pending?\" explainer (/unscheduled_jobs).

Equivalent of cook.unscheduled (unscheduled.clj:174-202): assembles an
ordered list of [reason-string, data] pairs covering every stage that
can hold a job back — exhausted retries, uncommitted, over quota/share,
launch rate limit, queue position, and the matcher's recorded placement
failures (fenzo_utils.clj:74 → job.last_placement_failure here).
"""
from __future__ import annotations

from typing import Optional

from cook_tpu_torch.state.limits import QuotaStore, ShareStore, UNLIMITED
from cook_tpu_torch.state.model import Job, JobState
from cook_tpu_torch.state.store import JobStore


def how_job_would_exceed_limits(limits: dict, usage: dict,
                                job: Job) -> dict:
    """Per-resource {limit, usage} for each dimension the job would push
    past its cap (unscheduled.clj:38-53)."""
    out = {}
    proposed = {
        "mem": usage.get("mem", 0.0) + job.mem,
        "cpus": usage.get("cpus", 0.0) + job.cpus,
        "gpus": usage.get("gpus", 0.0) + job.gpus,
        "count": usage.get("jobs", 0) + 1,
    }
    for k, would_use in proposed.items():
        limit = limits.get(k, UNLIMITED)
        if limit != UNLIMITED and would_use > limit:
            out[k] = {"limit": limit, "usage": would_use}
    return out


def reasons(store: JobStore, job: Job,
            quotas: QuotaStore, shares: ShareStore,
            user_launch_rl=None,
            queue_position: Optional[int] = None) -> list[list]:
    """Ordered [reason, data] pairs (unscheduled.clj:174-202)."""
    if job.state == JobState.RUNNING:
        return [["The job is running now.", {}]]
    if job.state == JobState.COMPLETED:
        return [["The job already completed.", {}]]

    out: list[list] = []
    if not job.committed:
        out.append(["The job is not committed yet (partial submission).", {}])
    if job.retries_remaining() <= 0:
        out.append(["Job has exhausted its maximum number of retries.",
                    {"max-retries": job.max_retries,
                     "instance-count": len(job.instances)}])

    usage = store.user_usage(job.pool).get(job.user, {})
    quota = quotas.get(job.user, job.pool)
    over_quota = how_job_would_exceed_limits(quota, usage, job)
    if over_quota:
        out.append(["The job would cause you to exceed resource quotas.",
                    over_quota])

    if user_launch_rl is not None and \
            not user_launch_rl.would_allow(job.user):
        out.append(["You are currently rate limited on how many jobs "
                    "you launch per minute.", {}])

    if queue_position:
        out.append([f"You have {queue_position} other jobs ahead in the "
                    "queue.", {"queue-position": queue_position}])

    if job.last_placement_failure:
        pf = job.last_placement_failure
        out.append(["The job couldn't be placed on any available hosts.",
                    {"reasons": pf.get("reasons", []),
                     "resources": pf.get("resources", {}),
                     "constraints": pf.get("constraints", {}),
                     "hosts_considered": pf.get("hosts_considered"),
                     "at_ms": pf.get("at_ms")}])
    elif not out:
        # mark under investigation: next failed match cycle records details
        out.append(["The job is now under investigation. Check back in a "
                    "minute for more details!", {}])
    return out
