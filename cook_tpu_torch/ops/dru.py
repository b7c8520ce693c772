"""DRU (dominant resource usage) fair-share ranking in PyTorch (a port of
cook_tpu/ops/dru.py:33-194).

  * every user's tasks are ordered by (-priority, start-time, id),
  * each task's DRU score is the user's cumulative dominant resource
    share up to and including that task:
        dru_i = max(sum(mem_0..i)/mem_share, sum(cpus_0..i)/cpus_share)
    or cumulative gpus/gpu_share in GPU pools,
  * all users' lists are merged into one global queue sorted by DRU
    ascending, preserving each user's internal order.

Two stable sorts and a segmented cumsum over padded 1-D tensors of
length N (`valid` masks the real entries; `user` is a dense int id).
`jnp.lexsort` becomes `lexsort` below: chained stable argsorts, last
key first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from cook_tpu_torch.ops.segments import (cumsum0, segment_rank,
                                         segment_start_index, segment_starts)

# Sentinel DRU for padded slots: sorts after every real task.
PAD_DRU = float(torch.finfo(torch.float32).max)
I32_MAX = torch.iinfo(torch.int32).max


class RankedTasks(NamedTuple):
    """Result of a rank cycle, in the *original* task order.

    dru:    (N,) f32 cumulative DRU score (PAD_DRU on invalid slots)
    order:  (N,) i32 permutation yielding the global fair queue
    rank:   (N,) i32 inverse permutation: rank[i] is task i's position
    """

    dru: torch.Tensor
    order: torch.Tensor
    rank: torch.Tensor


def lexsort(keys) -> torch.Tensor:
    """Stable lexicographic argsort (int64); the LAST key is primary,
    as in numpy/jax lexsort."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _scatter_arange(order: torch.Tensor) -> torch.Tensor:
    """rank with rank[order[i]] = i (i32)."""
    n = order.shape[0]
    rank = torch.empty(n, dtype=torch.int32, device=order.device)
    rank[order.long()] = torch.arange(n, dtype=torch.int32,
                                      device=order.device)
    return rank


def user_task_sort(user, priority, start_time, valid) -> torch.Tensor:
    """Permutation (int64) grouping tasks by user, each user's tasks
    ordered by (-priority, start-time, index). Invalid slots sort last."""
    n = user.shape[0]
    big_user = torch.where(valid, user, I32_MAX)
    return lexsort((torch.arange(n, device=user.device), start_time,
                    -priority, big_user))


def dru_rank(user, mem, cpus, priority, start_time, valid, mem_share,
             cpus_share) -> RankedTasks:
    """Default (cpu/mem) DRU ranking. mem_share / cpus_share are
    per-task divisors (the owning user's share gathered onto each task;
    unset shares are F32_MAX)."""
    perm = user_task_sort(user, priority, start_time, valid)
    s_user = user[perm]
    s_valid = valid[perm]
    s_mem = torch.where(s_valid, mem[perm], 0.0)
    s_cpus = torch.where(s_valid, cpus[perm], 0.0)
    cum, within = _sorted_segment_cumsum(
        torch.stack([s_mem, s_cpus], dim=-1), s_user, s_valid)
    s_dru = torch.maximum(cum[:, 0] / mem_share[perm],
                          cum[:, 1] / cpus_share[perm])
    s_dru = torch.where(s_valid, s_dru, PAD_DRU)
    return _merge(perm, s_user, s_dru, within)


def gpu_dru_rank(user, gpus, priority, start_time, valid,
                 gpu_share) -> RankedTasks:
    """GPU-pool DRU ranking: score is cumulative gpus / gpu-share."""
    perm = user_task_sort(user, priority, start_time, valid)
    s_user = user[perm]
    s_valid = valid[perm]
    s_gpus = torch.where(s_valid, gpus[perm], 0.0)
    cum, within = _sorted_segment_cumsum(s_gpus, s_user, s_valid)
    s_dru = torch.where(s_valid, cum / gpu_share[perm], PAD_DRU)
    return _merge(perm, s_user, s_dru, within)


def _sorted_segment_cumsum(values, s_user, s_valid):
    """Per-user inclusive cumsum + within-user rank (i32) for task
    tensors already in user_task_sort order; one segment-start pass
    serves both."""
    s_key = torch.where(s_valid, s_user, I32_MAX)
    start_idx = segment_start_index(segment_starts(s_key))
    total = cumsum0(values)
    base = total[start_idx] - values[start_idx]
    idx = torch.arange(s_user.shape[0], device=s_user.device)
    return total - base, (idx - start_idx).to(torch.int32)


def _merge(perm, s_user, s_dru, within) -> RankedTasks:
    """Global k-way merge: sort by (dru, user, within-user position)."""
    merge_perm = lexsort((within, s_user, s_dru))
    order = perm[merge_perm]
    dru = torch.empty_like(s_dru)
    dru[perm] = s_dru
    return RankedTasks(dru=dru, order=order.to(torch.int32),
                       rank=_scatter_arange(order))


def limit_over_quota(rank_order_user, valid, user_quota_count,
                     user_running_count, over_quota_allowance: int = 100):
    """Keep-mask (queue order) capping how far past their count quota a
    user's pending jobs may rank: at most quota - running + allowance."""
    pos_in_user = segment_rank_unsorted(rank_order_user)
    cap = user_quota_count - user_running_count + over_quota_allowance
    return valid & (pos_in_user < torch.clamp(cap, min=0))


def segment_rank_unsorted(seg_ids: torch.Tensor) -> torch.Tensor:
    """0-based occurrence count (i32) of each element's segment id seen
    so far (segments need not be contiguous)."""
    n = seg_ids.shape[0]
    perm = lexsort((torch.arange(n, device=seg_ids.device), seg_ids))
    out = torch.empty(n, dtype=torch.int32, device=seg_ids.device)
    out[perm] = segment_rank(seg_ids[perm])
    return out
