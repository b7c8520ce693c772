"""Pool-mover job adjuster: migrate a portion of selected users' jobs
between pools at submission time.

Equivalent of plugins/pool_mover.clj: configured per submission pool
with a destination pool and per-user portions; a job moves when its
uuid hashes under the user's portion — deterministic per job, so
retries and re-submissions of the same uuid land in the same pool.

Config shape (the reference's :pool-mover settings):
    {"<submission-pool>": {
        "destination_pool": "<pool>",
        "users": {"<user>": {"portion": 0.25}, ...}}}
"""
from __future__ import annotations

import logging
import zlib

from cook_tpu_torch.plugins import JobAdjuster
from cook_tpu_torch.utils.metrics import registry as metrics_registry

logger = logging.getLogger(__name__)


def _uuid_percent(uuid: str) -> int:
    """Stable uuid -> [0, 100) bucket (the reference uses Clojure's
    hash mod 100; Python's hash() is salted per process, so use crc32 —
    the same stable-uuid-hash convention as federation.distribute_jobs)."""
    return zlib.crc32(uuid.encode()) % 100


class PoolMoverAdjuster(JobAdjuster):
    def __init__(self, config: dict):
        self.config = config or {}

    def adjust_job(self, job):
        rule = self.config.get(job.pool)
        if not rule:
            return job
        destination = rule.get("destination_pool")
        users = rule.get("users", {})
        portion = (users.get(job.user) or {}).get("portion")
        if destination and isinstance(portion, (int, float)) \
                and portion * 100 > _uuid_percent(job.uuid):
            logger.info("moving job %s (%s) from pool %s to %s "
                        "(pool-mover)", job.uuid, job.user, job.pool,
                        destination)
            metrics_registry.counter("pool_mover_jobs_migrated_total") \
                .inc()
            job.pool = destination
        return job
