"""Pool-sharded scheduling cycles over a device mesh (a port of
cook_tpu/parallel/pools.py).

The reference runs one independent Fenzo + match loop per pool
(scheduler.clj:1557-1578). Here each mesh device owns a block of the
pools and runs the full cycle (ops/cycle.rank_and_match, through the
port's kernels on a card) for each of them on its device; the
cluster-wide aggregates (total matched, considered and pending: the
inputs to global launch-rate limiting and the monitor counters) are
`psum`s of i32 counts, so every shard sees the same totals.

All inputs carry a leading pools axis whose length is a multiple of the
mesh size (pad with empty pools).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from cook_tpu_torch.ops import cycle as cycle_ops
from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.parallel import Mesh, psum, visible_devices

POOL_AXIS = "pools"
PEND_VALID = 14     # position of pend_valid in a cycle's arguments


def make_pool_mesh(n_devices: int | None = None, devices=None,
                   device="cuda") -> Mesh:
    """A 1-D pool mesh over the first `n_devices` visible devices of type
    `device`, or over an EXPLICIT device list (a federated leader
    group's placement claim, parallel/federation.place_pools; it may
    repeat a device). Raises when fewer than `n_devices` are visible."""
    if devices is None:
        devices = visible_devices(n_devices, device)
    return Mesh(list(devices), (POOL_AXIS,))


class PoolCycleStats(NamedTuple):
    """Cluster-wide (psum'd) per-cycle aggregates: 0-d i32 tensors on the
    mesh's first device."""

    total_matched: torch.Tensor
    total_considerable: torch.Tensor
    total_pending: torch.Tensor


class PoolCycleOut(NamedTuple):
    result: cycle_ops.CycleResult  # leading pools axis, first device
    stats: PoolCycleStats


def _pick(x, sl, device):
    """Pools `sl` of a stacked argument (a tensor, a Hosts of tensors or
    None), on `device`."""
    if x is None:
        return None
    if isinstance(x, match_ops.Hosts):
        return match_ops.Hosts(*(f[sl].to(device) for f in x))
    return x[sl].to(device)


def run_pools(args, lo: int, hi: int, device, kernel):
    """Run `kernel` (a rank_and_match partial) on pools lo..hi-1 of the
    stacked `args`, on `device`. Returns the per-pool results and this
    shard's (matched, considerable, pending) i32 counts."""
    results = []
    for p in range(lo, hi):
        results.append(kernel(*(_pick(a, p, device) for a in args)))
    pend_valid = _pick(args[PEND_VALID], slice(lo, hi), device)
    counts = torch.stack([
        sum((r.job_host >= 0).sum(dtype=torch.int32) for r in results),
        sum(r.considerable.sum(dtype=torch.int32) for r in results),
        pend_valid.sum(dtype=torch.int32)])
    return results, counts


def stack_results(results, device) -> cycle_ops.CycleResult:
    """Per-pool CycleResults stacked field by field on `device`."""
    return cycle_ops.CycleResult(*(
        torch.stack([getattr(r, f).to(device) for r in results])
        for f in cycle_ops.CycleResult._fields))


def cycle_kernel(num_considerable, num_groups, sequential, match_kw):
    """The per-pool cycle: rank_and_match with the kernels on (a CUDA
    tensor launches them, a CPU tensor takes their plain versions)."""
    return functools.partial(
        cycle_ops.rank_and_match, num_considerable=num_considerable,
        num_groups=num_groups, sequential=sequential, use_kernel=True,
        match_kw=match_kw)


def pool_sharded_cycle(mesh: Mesh, num_considerable: int = 1024,
                       num_groups: int = 1, sequential: bool = True,
                       match_kw=None):
    """Build the pool-sharded cycle fn for `mesh`.

    Returns fn(args): args are rank_and_match's 24 positional arguments
    (run..., pend..., hosts, forbidden, quotas), each with a leading
    pools axis divisible by the mesh size (forbidden may be None).
    Shard s runs pools s*k .. s*k+k-1 on its device."""
    kernel = cycle_kernel(num_considerable, num_groups, sequential,
                          match_kw)
    devs = list(mesh.devices.flat)
    D = len(devs)

    def run(args):
        n = args[0].shape[0]
        if n % D:
            raise ValueError(f"{n} pools do not shard evenly over {D} "
                             f"devices; pad with empty pools")
        k = n // D
        results, counts = [], []
        for s, d in enumerate(devs):
            res, cnt = run_pools(args, s * k, (s + 1) * k, d, kernel)
            results += res
            counts.append(cnt)
        total = psum(counts, mesh)[0]
        return PoolCycleOut(
            result=stack_results(results, devs[0]),
            stats=PoolCycleStats(total_matched=total[0],
                                 total_considerable=total[1],
                                 total_pending=total[2]))

    return run
