"""Host-side federation helpers: job -> cluster and pool -> device
assignment by crc32 (a copy of `distribute_jobs` and `place_pools`
from cook_tpu/parallel/federation.py:61-105). The mesh and the
federated cycle are not ported yet.
"""
from __future__ import annotations

import zlib


def distribute_jobs(uuids, n_slices: int) -> list[int]:
    """Stable uuid-hash -> slice/cluster assignment
    (distribute-jobs-to-compute-clusters scheduler.clj:816-826).
    crc32: process-independent (a job keeps its assignment across
    scheduler restarts, no flapping) and cheap enough to run over the
    whole unmatched queue every match cycle."""
    return [zlib.crc32(u.encode()) % n_slices for u in uuids]


def place_pools(pools, devices) -> dict[str, int]:
    """pool -> device index over a leader group's claimed devices —
    the placement map that lets group ownership pick which chip a
    pool's resident cycle runs on (scheduler/federation.py wires this
    through rest/server's enable_resident loop).

    Same crc32 idiom as distribute_jobs: the assignment is a pure
    function of (pool name, device claim), so a pool keeps its chip
    across leader restarts and failovers — no resident-state rebuild
    churn from placement flapping — and a migrated pool lands on a
    deterministic device in its NEW group's claim. Host-side only:
    indices index into jax.devices(); the caller resolves them (and
    falls back to the default device when the claim exceeds the
    visible device count)."""
    devices = list(devices)
    if not devices:
        return {}
    return {p: devices[zlib.crc32(p.encode()) % len(devices)]
            for p in pools}
