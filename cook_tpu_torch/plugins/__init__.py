"""Plugin extension points.

Equivalent of cook.plugins (plugins/definitions.clj:18-59 protocols,
launch.clj age-out caching, submission.clj batching, pool.clj
selection, adjustment.clj, file.clj):

  SubmissionValidator   accept/reject each job at POST /jobs
  LaunchFilter          accept/defer each considerable job at match time,
                        cached with expiry + age-out (launch.clj:59-121)
  CompletionHandler     called on every instance completion
  PoolSelector          choose the pool for a submitted job
  JobAdjuster           rewrite a job before matching
  FileUrlGenerator      build the CLI's sandbox file URL

Resolution mirrors the reference's config-driven factory-fn pattern
(config.clj :plugins → create-plugin-object): `resolve_plugin("pkg.mod:
factory")` imports and calls the named zero-arg factory.
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass
from typing import Optional

ACCEPT = "accept"
REJECT = "reject"
DEFER = "defer"


@dataclass
class PluginStatus:
    status: str               # accept | reject | defer
    message: str = ""
    # cache expiry for launch decisions (launch.clj caching)
    expires_at: float = 0.0


def accepted(message: str = "") -> PluginStatus:
    return PluginStatus(ACCEPT, message)


def rejected(message: str = "") -> PluginStatus:
    return PluginStatus(REJECT, message)


def deferred(message: str = "", for_s: float = 60.0) -> PluginStatus:
    return PluginStatus(DEFER, message,
                        expires_at=time.monotonic() + for_s)


class SubmissionValidator:
    """JobSubmissionValidator (definitions.clj:18-30)."""

    def check_job_submission(self, job_spec: dict, user: str,
                             pool: Optional[str]) -> PluginStatus:
        return accepted()


class LaunchFilter:
    """JobLaunchFilter (definitions.clj:32-40)."""

    def check_job_launch(self, job) -> PluginStatus:
        return accepted()


class CompletionHandler:
    """InstanceCompletionHandler (definitions.clj:42-48)."""

    def on_instance_completion(self, job, instance) -> None:
        pass


class PoolSelector:
    """PoolSelector (plugins/pool.clj): map a submission to a pool."""

    def select_pool(self, job_spec: dict, default_pool: str) -> str:
        return job_spec.get("pool") or default_pool


class JobAdjuster:
    """JobAdjuster (plugins/adjustment.clj): rewrite before matching."""

    def adjust_job(self, job):
        return job


class FileUrlGenerator:
    """FileUrlGenerator (plugins/file.clj)."""

    def file_url(self, instance, path: str) -> str:
        return (f"http://{instance.hostname}:12322/files/download"
                f"?path={instance.sandbox_directory}/{path}")


class CachedLaunchFilter:
    """Wraps a LaunchFilter with the reference's expiring cache + age-out
    semantics (launch.clj:59-121): a defer decision is cached until its
    expiry, but a job deferred for longer than `age_out_s` in total is
    force-accepted so plugins can't starve a job forever."""

    def __init__(self, inner: LaunchFilter, age_out_s: float = 3600.0,
                 clock=time.monotonic):
        self.inner = inner
        self.age_out_s = age_out_s
        self._clock = clock
        self._cache: dict[str, PluginStatus] = {}
        self._first_deferred: dict[str, float] = {}

    def check(self, job) -> bool:
        now = self._clock()
        first = self._first_deferred.get(job.uuid)
        if first is not None and now - first > self.age_out_s:
            return True  # age-out: launch regardless
        cached = self._cache.get(job.uuid)
        if cached is not None and (cached.status != DEFER
                                   or cached.expires_at > now):
            return cached.status == ACCEPT
        status = self.inner.check_job_launch(job)
        self._cache[job.uuid] = status
        if status.status == DEFER:
            self._first_deferred.setdefault(job.uuid, now)
            return False
        self._first_deferred.pop(job.uuid, None)
        return status.status == ACCEPT

    def defer_for(self, uuid: str) -> float:
        """SECONDS until a failed check() should be revalidated — the
        cached defer's remaining life, clamped to the age-out deadline
        (a REJECT or stale entry re-checks within a minute). A duration
        (not a timestamp) so callers on a different clock than this
        filter's injectable one can schedule it safely. The
        device-resident path parks the job's row for this long so the
        kernel stops re-matching a deferred job every cycle."""
        now = self._clock()
        s = self._cache.get(uuid)
        exp = s.expires_at if s is not None and s.status == DEFER else 0.0
        if exp <= now:
            exp = now + 60.0
        first = self._first_deferred.get(uuid)
        if first is not None:
            exp = min(exp, first + self.age_out_s)
        # a floor keeps a pathological plugin from re-running every
        # cycle, scaled down with short age-outs (tests)
        return max(exp, now + min(1.0, self.age_out_s / 4.0)) - now


@dataclass
class PluginRegistry:
    submission: SubmissionValidator = None
    launch: CachedLaunchFilter = None
    completion: CompletionHandler = None
    pool_selector: PoolSelector = None
    adjuster: JobAdjuster = None
    file_url: FileUrlGenerator = None
    # names of the slots actually customized, DERIVED from which fields
    # were passed (not trusted from the caller): the device-resident
    # match path is compatible with every DEFAULT (no-op) plugin but
    # must refuse any registry that hooks the per-cycle launch filter
    # or adjuster — however it was constructed
    custom: frozenset = frozenset()

    def affects_match_cycle(self) -> bool:
        return bool(self.custom & {"launch", "adjuster"})

    def __post_init__(self):
        self.custom = frozenset(
            name for name in ("submission", "launch", "completion",
                              "pool_selector", "adjuster", "file_url")
            if getattr(self, name) is not None)
        self.submission = self.submission or SubmissionValidator()
        self.launch = self.launch or CachedLaunchFilter(LaunchFilter())
        self.completion = self.completion or CompletionHandler()
        self.pool_selector = self.pool_selector or PoolSelector()
        self.adjuster = self.adjuster or JobAdjuster()
        self.file_url = self.file_url or FileUrlGenerator()


def resolve_plugin(spec: str):
    """\"package.module:factory\" → object (the factory-fn pattern,
    config.clj create-plugin-object)."""
    mod_name, _, factory = spec.partition(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, factory or "create")()


def registry_from_config(cfg: dict) -> PluginRegistry:
    kw = {}
    if "submission" in cfg:
        kw["submission"] = resolve_plugin(cfg["submission"])
    if "launch" in cfg:
        kw["launch"] = CachedLaunchFilter(
            resolve_plugin(cfg["launch"]),
            age_out_s=float(cfg.get("launch_age_out_s", 3600.0)))
    if "completion" in cfg:
        kw["completion"] = resolve_plugin(cfg["completion"])
    if "pool_selector" in cfg:
        kw["pool_selector"] = resolve_plugin(cfg["pool_selector"])
    if "adjuster" in cfg:
        kw["adjuster"] = resolve_plugin(cfg["adjuster"])
    elif "pool_mover" in cfg:
        # plugins/pool_mover.clj: config-driven pool migration adjuster
        from cook_tpu_torch.plugins.pool_mover import PoolMoverAdjuster
        kw["adjuster"] = PoolMoverAdjuster(cfg["pool_mover"])
    return PluginRegistry(**kw)
