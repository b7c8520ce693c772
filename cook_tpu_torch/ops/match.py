"""Job <-> offer bin-packing match, sequential half (a port of
cook_tpu/ops/match.py:80-348, 811-909).

For each considerable job in fair-queue order, pick the host with the
best cpuMemBinPacker fitness among hosts that fit and satisfy all hard
constraints, depleting host resources as it goes (Fenzo's
`scheduleOnce`). Ties break toward the lowest host index.

`_scan_core` runs the whole walk as one hand-written CUDA kernel
(`fused_match.exact_scan`) when `use_kernel` is set, the batch has a
single placement group and no fitness bonus — the reference's own
branching (match.py:304-321) — and the plain `_scan_assign` loop
otherwise. The batched `match_rounds` half is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device
from cook_tpu_torch.ops import fused_match

NO_HOST = -1


class Jobs(NamedTuple):
    """Considerable jobs in fair-queue order (padded to N)."""

    mem: torch.Tensor        # (N,) f32
    cpus: torch.Tensor       # (N,) f32
    gpus: torch.Tensor       # (N,) f32, 0 = no gpu request
    valid: torch.Tensor      # (N,) bool
    group: torch.Tensor      # (N,) i32 dense group id, -1 = ungrouped
    unique_group: torch.Tensor  # (N,) bool: group has unique placement


class Hosts(NamedTuple):
    """Offers aggregated per host (padded to H)."""

    mem: torch.Tensor        # (H,) f32 available
    cpus: torch.Tensor       # (H,) f32 available
    gpus: torch.Tensor       # (H,) f32 available
    cap_mem: torch.Tensor    # (H,) f32 total capacity (for fitness)
    cap_cpus: torch.Tensor   # (H,) f32
    cap_gpus: torch.Tensor   # (H,) f32 — >0 marks a GPU host
    valid: torch.Tensor      # (H,) bool
    task_slots: torch.Tensor  # (H,) i32 remaining task slots


class MatchResult(NamedTuple):
    job_host: torch.Tensor   # (N,) i32 assigned host index or -1
    mem_left: torch.Tensor   # (H,) f32 host resources after assignment
    cpus_left: torch.Tensor
    gpus_left: torch.Tensor
    slots_left: torch.Tensor  # (H,) i32 task slots after assignment


def _fitness(job_mem, job_cpus, mem_left, cpus_left, cap_mem, cap_cpus):
    """cpuMemBinPacker: mean post-assignment utilization fraction."""
    used_mem = cap_mem - mem_left
    used_cpus = cap_cpus - cpus_left
    f_mem = torch.where(cap_mem > 0, (used_mem + job_mem) / cap_mem, 0.0)
    f_cpu = torch.where(cap_cpus > 0, (used_cpus + job_cpus) / cap_cpus, 0.0)
    return 0.5 * (f_mem + f_cpu)


def _feasible(job_mem, job_cpus, job_gpus, mem_left, cpus_left, gpus_left,
              cap_gpus, host_valid, slots_left, forbidden_row):
    eps = 1e-6
    ok = host_valid & (slots_left > 0) & ~forbidden_row
    ok = ok & (mem_left + eps >= job_mem) & (cpus_left + eps >= job_cpus)
    # gpu jobs only land on gpu hosts, non-gpu jobs never do; gpu-ness
    # is the static capacity, not remaining headroom
    is_gpu_host = cap_gpus > 0
    return ok & torch.where(job_gpus > 0,
                            is_gpu_host & (gpus_left + eps >= job_gpus),
                            ~is_gpu_host)


def _scan_assign(jobs: Jobs, hosts: Hosts, forbidden, bonus,
                 num_groups: int, carry):
    """Sequential greedy core: one Python-loop step per job over carry
    (mem_left, cpus_left, gpus_left, slots_left, group_occ). The plain
    path for num_groups > 1 or a fitness bonus. Returns (carry, job_host)."""
    mem_left, cpus_left, gpus_left, slots_left, group_occ = carry
    group_occ = group_occ.clone()
    S = jobs.mem.shape[0]
    H = hosts.mem.shape[0]
    dev = hosts.mem.device
    ar = torch.arange(H, device=dev)
    gclip = torch.clamp(jobs.group, 0, num_groups - 1).long()
    job_host = torch.empty(S, dtype=torch.int32, device=dev)
    for s in range(S):
        j_mem, j_cpus, j_gpus = jobs.mem[s], jobs.cpus[s], jobs.gpus[s]
        j_unique, g = jobs.unique_group[s], gclip[s]
        ok = _feasible(j_mem, j_cpus, j_gpus, mem_left, cpus_left,
                       gpus_left, hosts.cap_gpus, hosts.valid, slots_left,
                       forbidden[s])
        ok = ok & ~(j_unique & group_occ[g]) & jobs.valid[s]
        fit = _fitness(j_mem, j_cpus, mem_left, cpus_left, hosts.cap_mem,
                       hosts.cap_cpus) + bonus[s]
        fit = torch.where(ok, fit, -1.0)
        best = torch.argmax(fit)            # first maximum = lowest index
        assigned = fit[best] > -0.5
        job_host[s] = torch.where(assigned, best, NO_HOST)
        onehot = (ar == best) & assigned
        mem_left = mem_left - torch.where(onehot, j_mem, 0.0)
        cpus_left = cpus_left - torch.where(onehot, j_cpus, 0.0)
        gpus_left = gpus_left - torch.where(onehot, j_gpus, 0.0)
        slots_left = slots_left - onehot.to(torch.int32)
        group_occ[g] = group_occ[g] | (onehot & j_unique)
    return (mem_left, cpus_left, gpus_left, slots_left, group_occ), job_host


def _scan_core(jobs: Jobs, hosts: Hosts, forbidden, bonus,
               num_groups: int, carry, use_kernel: bool = False,
               bonus_zero: bool = False):
    """Exact sequential greedy (the Fenzo walk). With `use_kernel`,
    single-group coupling and no fitness bonus, the whole walk is ONE
    launch of the hand-written exact_scan kernel (its plain PyTorch
    version for CPU tensors); everything else takes `_scan_assign`."""
    S = jobs.mem.shape[0]
    H = hosts.mem.shape[0]
    if use_kernel and bonus_zero and fused_match.exact_scan_ok(
            S, H, num_groups):
        mem0, cpus0, gpus0, slots0, occ = carry
        jp = fused_match.pack_jobs(jobs.mem, jobs.cpus, jobs.gpus,
                                   jobs.valid, jobs.unique_group)
        hp = fused_match.pack_hosts(mem0, cpus0, gpus0, hosts.cap_mem,
                                    hosts.cap_cpus, hosts.cap_gpus, slots0,
                                    hosts.valid, occ[0])
        jh, hout = fused_match.exact_scan(jp, hp, forbidden)
        new_carry = (hout[fused_match.H_MEM], hout[fused_match.H_CPUS],
                     hout[fused_match.H_GPUS],
                     hout[fused_match.H_SLOTS].to(torch.int32),
                     hout[fused_match.H_OCC0:fused_match.H_OCC0 + 1] > 0)
        return new_carry, jh
    if bonus is None:
        bonus = torch.zeros(forbidden.shape, dtype=torch.float32,
                            device=forbidden.device)
    return _scan_assign(jobs, hosts, forbidden, bonus, num_groups, carry)


def match_scan(jobs: Jobs, hosts: Hosts, forbidden: torch.Tensor,
               num_groups: int = 1, bonus: torch.Tensor | None = None,
               use_kernel: bool = False) -> MatchResult:
    """Exact sequential greedy assignment (Fenzo semantics).

    forbidden: (N, H) bool per-(job, host) hard-constraint exclusions.
    num_groups: upper bound on dense group ids in this batch.
    bonus: optional (N, H) f32 >= 0 additive fitness term.
    use_kernel: route through the exact_scan CUDA kernel when eligible
    (num_groups == 1, no bonus); the reference's `use_pallas`.
    """
    H = hosts.mem.shape[0]
    group_occ = torch.zeros((num_groups, H), dtype=torch.bool,
                            device=hosts.mem.device)
    carry = (hosts.mem, hosts.cpus, hosts.gpus, hosts.task_slots, group_occ)
    (mem_left, cpus_left, gpus_left, slots_left, _), job_host = _scan_core(
        jobs, hosts, forbidden, bonus, num_groups, carry,
        use_kernel=use_kernel, bonus_zero=bonus is None)
    return MatchResult(job_host, mem_left, cpus_left, gpus_left, slots_left)


def inversion_positions_np(jobs: Jobs, hosts: Hosts, forbidden, job_host):
    """Queue positions of head-of-line inversions in a finished
    assignment (host-side audit, numpy; a copy of the reference's): a
    valid unmatched job that would fit on some allowed host if only
    HIGHER-ranked matched jobs consumed capacity. The sequential walk
    produces zero by construction. Unique-group jobs are skipped."""
    def a(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    mem, cpus, gpus = a(jobs.mem), a(jobs.cpus), a(jobs.gpus)
    valid = a(jobs.valid)
    jh = a(job_host)
    forb = a(forbidden)
    h_mem, h_cpus, h_gpus = a(hosts.mem), a(hosts.cpus), a(hosts.gpus)
    H = h_mem.shape[0]
    h_slots = a(hosts.task_slots).astype(np.int64)
    h_capg = a(hosts.cap_gpus)
    h_valid = a(hosts.valid)

    matched = valid & (jh >= 0)
    m_idx = np.flatnonzero(matched)
    m_host = jh[m_idx]
    unmatched = np.flatnonzero(valid & (jh < 0) & ~a(jobs.unique_group))
    inversions = []
    for i in unmatched:
        before = m_idx < i
        bh = m_host[before]
        used_mem = np.bincount(bh, weights=mem[m_idx[before]], minlength=H)
        used_cpus = np.bincount(bh, weights=cpus[m_idx[before]],
                                minlength=H)
        used_gpus = np.bincount(bh, weights=gpus[m_idx[before]],
                                minlength=H)
        used_slots = np.bincount(bh, minlength=H)
        # f32 accumulation in the kernel vs f64 here
        tol = 1e-2
        ok = (h_valid
              & ~forb[i]
              & (h_mem - used_mem >= mem[i] + tol)
              & (h_cpus - used_cpus >= cpus[i] + tol)
              & (h_slots - used_slots > 0))
        if gpus[i] > 0:
            ok &= (h_capg > 0) & (h_gpus - used_gpus >= gpus[i] + tol)
        else:
            ok &= h_capg <= 0
        if ok.any():
            inversions.append(int(i))
    return np.asarray(inversions, np.int64)


def _t(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def make_jobs(mem, cpus, gpus=None, valid=None, group=None,
              unique_group=None, device="cuda") -> Jobs:
    """Convenience constructor with sensible defaults."""
    dev = resolve_device(device)
    mem = _t(mem, torch.float32, dev)
    n = mem.shape[0]
    return Jobs(
        mem=mem,
        cpus=_t(cpus, torch.float32, dev),
        gpus=(torch.zeros(n, dtype=torch.float32, device=dev)
              if gpus is None else _t(gpus, torch.float32, dev)),
        valid=(torch.ones(n, dtype=torch.bool, device=dev)
               if valid is None else _t(valid, torch.bool, dev)),
        group=(torch.full((n,), -1, dtype=torch.int32, device=dev)
               if group is None else _t(group, torch.int32, dev)),
        unique_group=(torch.zeros(n, dtype=torch.bool, device=dev)
                      if unique_group is None
                      else _t(unique_group, torch.bool, dev)),
    )


def make_hosts(mem, cpus, gpus=None, valid=None, cap_mem=None,
               cap_cpus=None, cap_gpus=None, task_slots=None,
               max_tasks: int = 10_000, device="cuda") -> Hosts:
    dev = resolve_device(device)
    mem = _t(mem, torch.float32, dev)
    cpus = _t(cpus, torch.float32, dev)
    h = mem.shape[0]
    gpus = (torch.zeros(h, dtype=torch.float32, device=dev)
            if gpus is None else _t(gpus, torch.float32, dev))
    return Hosts(
        mem=mem,
        cpus=cpus,
        gpus=gpus,
        cap_mem=mem if cap_mem is None else _t(cap_mem, torch.float32, dev),
        cap_cpus=cpus if cap_cpus is None
        else _t(cap_cpus, torch.float32, dev),
        cap_gpus=gpus if cap_gpus is None
        else _t(cap_gpus, torch.float32, dev),
        valid=(torch.ones(h, dtype=torch.bool, device=dev)
               if valid is None else _t(valid, torch.bool, dev)),
        task_slots=(torch.full((h,), max_tasks, dtype=torch.int32,
                               device=dev)
                    if task_slots is None
                    else _t(task_slots, torch.int32, dev)),
    )
