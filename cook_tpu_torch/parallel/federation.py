"""Multi-slice federation: pool-sharded cycles over a 2-D (slice x
pools) device mesh (a port of cook_tpu/parallel/federation.py).

The reference federates N compute clusters behind the ComputeCluster
protocol: offers from every cluster merge into each pool's match cycle
(scheduler.clj:977-985) and jobs are distributed across clusters by
uuid-hash (distribute-jobs-to-compute-clusters, scheduler.clj:816-826).
Each federation member is a *slice* of devices:

  - mesh axis "slice" spans slices (the slow, scarce link),
  - mesh axis "pools" spans the devices within a slice,
  - each device owns a block of pools and runs the cycle
    (ops/cycle.rank_and_match) for them, exactly like
    parallel.pools.pool_sharded_cycle,
  - cluster-wide aggregates reduce hierarchically: `psum` over "pools"
    inside every slice, then one small `psum` over "slice".

`distribute_jobs` and `place_pools` are host-side helpers, byte-identical
to the reference's.
"""
from __future__ import annotations

import zlib
from typing import NamedTuple

import numpy as np
import torch

from cook_tpu_torch.ops import cycle as cycle_ops
from cook_tpu_torch.parallel import Mesh, psum, visible_devices
from cook_tpu_torch.parallel.pools import (cycle_kernel, run_pools,
                                           stack_results)

SLICE_AXIS = "slice"
POOL_AXIS = "pools"


def make_federation_mesh(n_slices: int, chips_per_slice: int | None = None,
                         devices=None, device="cuda") -> Mesh:
    """(n_slices, chips_per_slice) mesh, slice-major, over the visible
    devices of type `device` or an explicit `devices` list (which may
    repeat a device). Raises when fewer devices are there than asked
    for."""
    devs = (visible_devices(None, device) if devices is None
            else list(devices))
    per = chips_per_slice or len(devs) // n_slices
    n = n_slices * per
    if n > len(devs) or n == 0:
        raise ValueError(f"need {n_slices} x {per} devices, have "
                         f"{len(devs)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(n_slices, per), (SLICE_AXIS, POOL_AXIS))


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


class FederationStats(NamedTuple):
    """Cluster-wide aggregates after one psum over pools and one over
    slices: i32 tensors on the mesh's first device."""

    total_matched: torch.Tensor
    total_considerable: torch.Tensor
    total_pending: torch.Tensor
    per_slice_matched: torch.Tensor   # (n_slices,) — federation members


class FederationCycleOut(NamedTuple):
    result: cycle_ops.CycleResult    # leading (slices, pools) axes
    stats: FederationStats


def slice_args(args, n_slices: int):
    """Stacked cycle arguments (tensors, Hosts of tensors or None) with
    their pools axis split into (n_slices, pools per slice): the layout
    federated_cycle takes."""
    def split(x):
        return x.reshape((n_slices, -1) + x.shape[1:])
    return tuple(None if a is None else
                 type(a)(*(split(f) for f in a)) if isinstance(a, tuple)
                 else split(a) for a in args)


def federated_cycle(mesh: Mesh, num_considerable: int = 1024,
                    num_groups: int = 1, sequential: bool = True):
    """Build the federated cycle fn for a 2-D mesh.

    Returns fn(args) where every array in args carries leading
    (n_slices, pools_per_slice) axes, divisible by the respective mesh
    axis sizes (forbidden may be None)."""
    n_slices = mesh.shape[SLICE_AXIS]
    per = mesh.shape[POOL_AXIS]
    kernel = cycle_kernel(num_considerable, num_groups, sequential, None)
    devs = list(mesh.devices.flat)

    def run(args):
        S, Pp = args[0].shape[:2]
        if S % n_slices or Pp % per:
            raise ValueError(f"({S}, {Pp}) pools do not shard over a "
                             f"({n_slices}, {per}) mesh")
        ks, kp = S // n_slices, Pp // per
        # flatten (slices, pools) to one pools axis: device (a, b) owns
        # slices a*ks.. and, within each, pools b*kp..
        flat = [None if a is None else
                (type(a)(*(f.reshape((-1,) + f.shape[2:]) for f in a))
                 if isinstance(a, tuple) else a.reshape((-1,) + a.shape[2:]))
                for a in args]
        results = [None] * (S * Pp)
        counts = []
        for i, d in enumerate(devs):
            a, b = divmod(i, per)
            cnt = None
            for sl in range(a * ks, (a + 1) * ks):
                lo = sl * Pp + b * kp
                res, c = run_pools(flat, lo, lo + kp, d, kernel)
                results[lo:lo + kp] = res
                cnt = c if cnt is None else cnt + c
            counts.append(cnt)
        # hierarchical reduction: over the pools of each slice first,
        # then the slices' totals
        in_slice = psum(counts, mesh, POOL_AXIS)
        slice_idx = [torch.arange(n_slices, device=d) == i // per
                     for i, d in enumerate(devs)]
        per_slice = psum([oh.to(torch.int32) * c[0]
                          for oh, c in zip(slice_idx, in_slice)],
                         mesh, SLICE_AXIS)
        total = psum(in_slice, mesh, SLICE_AXIS)[0]
        res = stack_results(results, devs[0])
        res = cycle_ops.CycleResult(*(
            x.reshape((S, Pp) + x.shape[1:]) for x in res))
        return FederationCycleOut(result=res, stats=FederationStats(
            total_matched=total[0], total_considerable=total[1],
            total_pending=total[2], per_slice_matched=per_slice[0]))

    return run
