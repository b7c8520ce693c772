"""Job-level checkpointing materialization for the kube-style backend.

Equivalent of the reference's checkpoint plumbing in
kubernetes/api.clj:598-660: a job's `checkpoint` config (schema.clj:84
`:job/checkpoint` — mode / options / periodic-options) becomes
COOK_CHECKPOINT_* env vars and injected volumes/mounts on the pod;
`max-checkpoint-attempts` disables checkpointing once the job has
accumulated that many failures with checkpoint-countable reasons
(calculate-effective-checkpointing-config api.clj:642-660); and a
`memory-overhead` is added to the pod's memory request
(adjust-job-resources api.clj:573-589, computed-mem :689,:724).

Checkpoint config shape (matches the REST job schema):
  {"mode": "auto" | "periodic" | "preemption",
   "options": {"preserve-paths": [".."]},
   "periodic-options": {"period-sec": N},
   # merged from cluster default-checkpoint-config:
   "volume-name": str, "memory-overhead": MB,
   "max-checkpoint-attempts": N,
   "checkpoint-failure-reasons": [reason names],
   "init-container-volume-mounts": [{"path": p, "sub-path": s}],
   "main-container-volume-mounts": [{"path": p, "sub-path": s}]}
"""
from __future__ import annotations

from decimal import Decimal
from typing import Optional

# failure reason *names* (state.model REASONS) counted against
# max-checkpoint-attempts (default-checkpoint-failure-reasons
# api.clj:633-640)
DEFAULT_CHECKPOINT_FAILURE_REASONS = frozenset({
    "max-runtime-exceeded",
    "command-executor-failed",
    "container-launch-failed",
    "unknown",
    "straggler",
})

VALID_MODES = ("auto", "periodic", "preemption")


def add_as_decimals(a: float, b: float) -> float:
    """Float addition via Decimal so resource quantities keep k8s-legal
    precision (add-as-decimals api.clj:567-571: 0.1 + 0.02 must be 0.12,
    not 0.12000000000000001)."""
    return float(Decimal(str(a)) + Decimal(str(b)))


def effective_checkpoint_config(
        checkpoint: Optional[dict],
        prior_failure_reason_names: list[str],
        default_config: Optional[dict] = None) -> Optional[dict]:
    """Merge cluster defaults under the job's config and apply the
    max-checkpoint-attempts cutoff: once the job has failed with
    countable reasons that many times, checkpointing is disabled for
    later attempts (api.clj:642-660)."""
    if not checkpoint:
        return None
    cfg = {**(default_config or {}), **checkpoint}
    # a config without a valid mode checkpointed nothing in
    # checkpoint_env/checkpoint_volumes; it must not pay the
    # memory-overhead either (the API also rejects it up front)
    if cfg.get("mode") not in VALID_MODES:
        return None
    max_attempts = cfg.get("max-checkpoint-attempts")
    if max_attempts is not None:
        countable = set(cfg.get("checkpoint-failure-reasons") or
                        DEFAULT_CHECKPOINT_FAILURE_REASONS)
        failures = sum(1 for r in prior_failure_reason_names
                       if r in countable)
        if failures >= max_attempts:
            return None
    return cfg


def checkpoint_env(cfg: Optional[dict]) -> dict[str, str]:
    """COOK_CHECKPOINT_* env vars (checkpoint->env api.clj:613-631)."""
    if not cfg or not cfg.get("mode"):
        return {}
    env = {"COOK_CHECKPOINT_MODE": str(cfg["mode"])}
    preserve = (cfg.get("options") or {}).get("preserve-paths")
    if preserve:
        for i, path in enumerate(sorted(preserve)):
            env[f"COOK_CHECKPOINT_PRESERVE_PATH_{i}"] = str(path)
    period = (cfg.get("periodic-options") or {}).get("period-sec")
    if period is not None:
        env["COOK_CHECKPOINT_PERIOD_SEC"] = str(period)
    return env


def checkpoint_volumes(cfg: Optional[dict]) -> list[dict]:
    """Empty-dir tools volume + init/main mounts
    (checkpoint->volume/->volume-mounts api.clj:598-611). Returned as
    plain dicts the pod spec carries."""
    if not cfg or not cfg.get("mode") or not cfg.get("volume-name"):
        return []
    name = cfg["volume-name"]
    vols = [{"name": name, "kind": "empty-dir"}]
    for container_key in ("init-container-volume-mounts",
                          "main-container-volume-mounts"):
        for m in cfg.get(container_key) or []:
            vols.append({"name": name, "kind": "mount",
                         "container": container_key.split("-")[0],
                         "path": m.get("path"),
                         "sub-path": m.get("sub-path")})
    return vols


def adjusted_mem(mem: float, cfg: Optional[dict]) -> float:
    """Memory request incl. checkpoint overhead (computed-mem
    api.clj:689,:724; adjust-job-resources :573-589)."""
    overhead = (cfg or {}).get("memory-overhead")
    if not overhead:
        return mem
    return add_as_decimals(mem, float(overhead))
