"""Job <-> offer bin-packing match (a port of cook_tpu/ops/match.py).

For each considerable job in fair-queue order, pick the host with the
best cpuMemBinPacker fitness among hosts that fit and satisfy all hard
constraints, depleting host resources as it goes (Fenzo's
`scheduleOnce`). Ties break toward the lowest host index.

  match_scan    the exact sequential walk. `_scan_core` runs it as one
                hand-written CUDA kernel (`fused_match.exact_scan`) when
                `use_kernel` is set, the batch has a single placement
                group and no fitness bonus — the reference's own
                branching (match.py:304-321) — and the plain
                `_scan_assign` loop otherwise.
  match_rounds  the batched matcher for large batches: an exact head
                through `_scan_core`, water-fill window rounds, pairing
                rounds, and dense rounds whose (D, H) score + argmax is
                the `fused_match.best_host` kernel when `use_kernel` is
                set and the batch has a single placement group.

The reference's pure, jitted closures become eager PyTorch: `.at[].set(
mode="drop")` scatters write into a buffer with one sink slot, and each
`lax.while_loop` runs on the host, reading its predicate back once per
iteration (an idle round is a no-op, so the runtime skip changes cost,
not the result).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops.segments import (cumsum0, segment_cumsum,
                                         segment_sum_scan)

NO_HOST = -1
BIG = 3.4e38        # sort key that puts unusable hosts / jobs last


def scatter_sink(n, fill, idx, values):
    """out[idx] = values over a (n + 1,)-slot buffer whose last slot
    absorbs the dropped writes (idx == n); returns out[:n]."""
    out = torch.full((n + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out[idx.long()] = values
    return out[:n]


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


# ---- batched matcher (match.py:351-808) --------------------------------

def _host_sums(acc_host, vals, H):
    """Per-host sums (H, k) of the rows of `vals` (n, k) f32 at acc_host
    (n,) in [0, H] (H = dropped). Each host's rows are added in one fixed
    order, whatever the device and the magnitudes: rows stably sorted by
    host, `segment_sum_scan` over them, read at each host's last row.
    (`index_add_` of floats on CUDA adds in no fixed order: the kernel
    run and the plain replay could deplete a host differently, and a
    later round then choose another host.)"""
    perm = torch.argsort(acc_host, stable=True)
    seg = acc_host[perm]
    sums = segment_sum_scan(vals[perm], seg)
    last = torch.ones_like(seg, dtype=torch.bool)
    last[:-1] = seg[:-1] != seg[1:]
    out = torch.zeros((H + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out[torch.where(last, seg, H)] = sums
    return out[:H]


def compute_accept(state, choice, bids, jmem, jcpus, jgpus, jgroup,
                   junique, num_groups):
    """Which bids hosts accept (match.py:431-476): claimants in queue
    order while they still fit — bidders stably sorted by host, a
    segmented cumsum of their demands — and at most the first member of
    each unique (group, host) pair, never onto a host that already holds
    one. Works on any queue-ordered row set; returns the accept mask."""
    _, mem_left, cpus_left, gpus_left, slots_left, group_occ = state
    n = jmem.shape[0]
    H = mem_left.shape[0]
    sort_host = torch.where(bids, choice, H)       # non-bidders last
    perm = torch.argsort(sort_host, stable=True)
    p_host = sort_host[perm]
    p_bids = bids[perm]
    vals = torch.stack([jmem[perm], jcpus[perm], jgpus[perm],
                        torch.ones(n, dtype=torch.float32,
                                   device=jmem.device)], -1)
    cums = segment_cumsum(torch.where(p_bids[:, None], vals, 0.0), p_host)
    ph = torch.clamp(p_host, 0, H - 1)
    fits_prefix = ((cums[:, 0] <= mem_left[ph] + 1e-6)
                   & (cums[:, 1] <= cpus_left[ph] + 1e-6)
                   & (cums[:, 2] <= gpus_left[ph] + 1e-6)
                   & (cums[:, 3] <= slots_left[ph]))
    p_group = jgroup[perm].long()
    p_unique = junique[perm]
    gh_key = torch.where(p_unique, p_group * (H + 1) + ph, -1)
    gperm = torch.argsort(gh_key, stable=True)
    sk = gh_key[gperm]
    first_sorted = torch.ones(n, dtype=torch.bool, device=sk.device)
    first_sorted[1:] = sk[1:] != sk[:-1]
    first_of_gh = torch.empty_like(first_sorted)
    first_of_gh[gperm] = first_sorted
    occupied = group_occ[torch.clamp(p_group, 0, num_groups - 1), ph]
    accept_sorted = (p_bids & fits_prefix & (first_of_gh | ~p_unique)
                     & ~(p_unique & occupied))
    accept = torch.empty_like(accept_sorted)
    accept[perm] = accept_sorted
    return accept


def apply_accept(state, choice, accept, jmem, jcpus, jgpus, jgroup,
                 junique, num_groups, row_idx=None):
    """Commit accepted assignments (match.py:478-504): record hosts,
    deplete host resources, fold unique-group occupancy. row_idx maps
    compact rows to batch rows (None = rows ARE batch rows)."""
    job_host, mem_left, cpus_left, gpus_left, slots_left, group_occ = state
    N = job_host.shape[0]
    H = mem_left.shape[0]
    choice32 = choice.to(torch.int32)
    if row_idx is None:
        new_host = torch.where(accept, choice32, job_host)
    else:
        buf = torch.cat([job_host, job_host.new_full((1,), NO_HOST)])
        buf[torch.where(accept, row_idx, N).long()] = choice32
        new_host = buf[:N]
    acc_host = torch.where(accept, choice, H).long()
    used = _host_sums(acc_host, torch.where(
        accept[:, None], torch.stack([jmem, jcpus, jgpus], -1), 0.0), H)
    slots = torch.zeros(H + 1, dtype=torch.int32, device=accept.device)
    slots.index_add_(0, acc_host, accept.to(torch.int32))
    G = group_occ.shape[0]
    flat = torch.where(accept & junique,
                       torch.clamp(jgroup.long(), 0, G - 1) * H
                       + torch.clamp(choice.long(), 0, H - 1), G * H)
    occ = torch.cat([group_occ.reshape(-1), group_occ.new_zeros(1)])
    occ.index_fill_(0, flat, True)      # no host-staged scalar, no sync
    return (new_host, mem_left - used[:, 0], cpus_left - used[:, 1],
            gpus_left - used[:, 2], slots_left - slots[:H],
            occ[:G * H].view(G, H))


def match_rounds(jobs: Jobs, hosts: Hosts, forbidden: torch.Tensor,
                 rounds: int = 4, num_groups: int = 1,
                 bonus: torch.Tensor | None = None,
                 use_kernel: bool = False, dense_rounds: int = 6,
                 spread: float = 0.2, head_exact: int = 256,
                 dense_cap: int = 1024) -> MatchResult:
    """Batched greedy approximation with an exact head (the reference's
    `match_rounds`, same knobs and defaults): the first `head_exact`
    jobs run the sequential scan, then one water-fill window round, up
    to `rounds` gpu window rounds, up to `rounds - 1` pairing rounds and
    up to max(dense_rounds, ceil(N / D) + 2) dense rounds over the
    compact first D = min(dense_cap, N) candidates, hosts accepting the
    feasible queue-order prefix of their bidders after every round. A
    head job the exact scan refused is unservable this cycle and sits
    out the window and pairing rounds.

    use_kernel: the reference's `use_pallas` — the head is the
    exact_scan kernel (single group, no bonus) and each dense round's
    (D, H) score + argmax is the best_host kernel (single group). Off,
    the head is `_scan_assign` and the dense round the reference's XLA
    formula in plain PyTorch. A bonus forces spread to 0.
    """
    N = jobs.mem.shape[0]
    H = hosts.mem.shape[0]
    dev = hosts.mem.device
    G = num_groups
    kernel_dense = use_kernel and fused_match.best_host_ok(num_groups)

    # water-fill serves cpu/mem-only jobs with no per-host exclusions;
    # gpu jobs take the gpu window; constrained jobs, and all jobs under
    # a locality bonus, only the dense rounds
    unconstrained = jobs.valid & ~forbidden.any(dim=1)
    plain = unconstrained & (jobs.gpus <= 0)
    gpu_plain = unconstrained & (jobs.gpus > 0)
    if bonus is not None:
        plain = torch.zeros_like(plain)
        gpu_plain = torch.zeros_like(gpu_plain)
        spread = 0.0   # a real preference; noise would override it

    def accept_bids(state, choice, bids):
        accept = compute_accept(state, choice, bids, jobs.mem, jobs.cpus,
                                jobs.gpus, jobs.group, jobs.unique_group, G)
        return apply_accept(state, choice, accept, jobs.mem, jobs.cpus,
                            jobs.gpus, jobs.group, jobs.unique_group, G)

    def usable_hosts(mem_left, cpus_left, slots_left):
        # non-gpu jobs never land on gpu hosts
        return (hosts.valid & (slots_left > 0) & (hosts.cap_gpus <= 0)
                & (mem_left > 1e-6) & (cpus_left > 1e-6))

    def fill_order(usable, mem_left, cpus_left):
        """Hosts by utilization descending (the cpuMemBinPacker's
        direction), unusable last."""
        util = _fitness(0.0, 0.0, mem_left, cpus_left, hosts.cap_mem,
                        hosts.cap_cpus)
        return torch.argsort(torch.where(usable, -util, BIG), stable=True)

    def window_bid(state, unassigned, usable, lanes):
        """Each unassigned job bids on the host whose cumulative-capacity
        window covers its cumulative queue-order demand on every
        (job demand, host room) lane."""
        order = fill_order(usable, state[1], state[2])
        o_usable = usable[order]
        slot = None
        for demand, room in lanes:
            s = torch.searchsorted(
                cumsum0(torch.where(o_usable, room[order], 0.0)),
                cumsum0(torch.where(unassigned, demand, 0.0)), right=False)
            slot = s if slot is None else torch.maximum(slot, s)
        sc = torch.clamp(slot, 0, H - 1)
        bids = unassigned & (slot < H) & o_usable[sc]
        return accept_bids(state, order[sc], bids)

    def window_round(state):
        # round 0 — mass placement of the plain jobs
        job_host, mem_left, cpus_left, _, slots_left, _ = state
        unassigned = plain & (job_host == NO_HOST) & ~hopeless0
        usable = usable_hosts(mem_left, cpus_left, slots_left)
        return window_bid(state, unassigned, usable,
                          [(jobs.mem, mem_left), (jobs.cpus, cpus_left)])

    def gpu_window_round(state):
        # mass placement of unconstrained gpu jobs: a third window
        job_host, mem_left, cpus_left, gpus_left, slots_left, _ = state
        unassigned = gpu_plain & (job_host == NO_HOST) & ~hopeless0
        usable = (hosts.valid & (slots_left > 0) & (hosts.cap_gpus > 0)
                  & (mem_left > 1e-6) & (cpus_left > 1e-6)
                  & (gpus_left > 1e-6))
        return window_bid(state, unassigned, usable,
                          [(jobs.mem, mem_left), (jobs.cpus, cpus_left),
                           (jobs.gpus, gpus_left)])

    def pairing_round(state, round_i):
        # stragglers: the k-th largest job of the queue-head window bids
        # the k-th roomiest host, alternating the pairing resource
        job_host, mem_left, cpus_left, _, slots_left, _ = state
        unassigned = plain & (job_host == NO_HOST) & ~hopeless0
        usable = usable_hosts(mem_left, cpus_left, slots_left)
        n_usable = usable.sum()
        upos = cumsum0(unassigned.to(torch.int32)) - 1
        window = unassigned & (upos < n_usable)
        jdemand, hroom = ((jobs.mem, mem_left) if round_i % 2 == 1
                          else (jobs.cpus, cpus_left))
        jrank_perm = torch.argsort(torch.where(window, -jdemand, BIG),
                                   stable=True)
        jrank = torch.empty(N, dtype=torch.int64, device=dev)
        jrank[jrank_perm] = torch.arange(N, device=dev)
        hperm = torch.argsort(torch.where(usable, -hroom, BIG), stable=True)
        choice = hperm[torch.clamp(jrank, 0, H - 1)]
        return accept_bids(state, choice, window)

    D = min(dense_cap, N)
    arD = torch.arange(D, device=dev)

    def dense_round(state, hopeless):
        # mop-up: the full score -> argmax -> accept round over the
        # compact first D candidates in queue order (not yet proven
        # infeasible: a failed dense argmax is a proof)
        job_host, mem_left, cpus_left, gpus_left, slots_left, group_occ = \
            state
        candidates = jobs.valid & (job_host == NO_HOST) & ~hopeless
        cpos = cumsum0(candidates.to(torch.int32)) - 1
        slot = torch.where(candidates, torch.clamp(cpos, max=D), D)
        src = scatter_sink(D, N, slot,
                           torch.arange(N, dtype=torch.int32, device=dev))
        in_use = src < N
        srcc = torch.clamp(src, 0, N - 1).long()
        c_mem, c_cpus, c_gpus = jobs.mem[srcc], jobs.cpus[srcc], \
            jobs.gpus[srcc]
        c_group = jobs.group[srcc]
        c_unique = jobs.unique_group[srcc] & in_use
        # fairness window within the prefix, sized to what the remaining
        # capacity could plausibly absorb plus one slot per usable host
        dense_usable = (hosts.valid & (slots_left > 0)
                        & ((mem_left > 1e-6) | (cpus_left > 1e-6)
                           | (gpus_left > 1e-6)))
        K = dense_usable.sum(dtype=torch.int32)
        n_cand = torch.clamp(in_use.sum(dtype=torch.int32), min=1)
        mean_mem = torch.clamp(torch.where(in_use, c_mem, 0.0).sum()
                               / n_cand, min=1e-6)
        mean_cpus = torch.clamp(torch.where(in_use, c_cpus, 0.0).sum()
                                / n_cand, min=1e-6)
        absorb = torch.where(dense_usable,
                             torch.minimum(mem_left / mean_mem,
                                           cpus_left / mean_cpus),
                             0.0).sum()
        W = K + torch.clamp(absorb, max=float(N)).to(torch.int32)
        window = in_use & (arD < W)

        c_forb = forbidden[srcc] | ~in_use[:, None]
        c_bonus = None if bonus is None else bonus[srcc]
        if kernel_dense:
            jp = fused_match.pack_jobs(c_mem, c_cpus, c_gpus, in_use,
                                       c_unique)
            hp = fused_match.pack_hosts(
                mem_left, cpus_left, gpus_left, hosts.cap_mem,
                hosts.cap_cpus, hosts.cap_gpus, slots_left, hosts.valid,
                group_occ[0])
            best_fit, best = fused_match.best_host(jp, hp, c_forb, c_bonus,
                                                   spread=spread)
            choice = torch.clamp(best.long(), 0, H - 1)
            has_feasible = best_fit > -0.5
        else:
            ok = _feasible(c_mem[:, None], c_cpus[:, None], c_gpus[:, None],
                           mem_left[None, :], cpus_left[None, :],
                           gpus_left[None, :], hosts.cap_gpus[None, :],
                           hosts.valid[None, :], slots_left[None, :],
                           c_forb)
            ok = ok & in_use[:, None] & ~(
                c_unique[:, None]
                & group_occ[torch.clamp(c_group.long(), 0, G - 1)])
            fit = _fitness(c_mem[:, None], c_cpus[:, None],
                           mem_left[None, :], cpus_left[None, :],
                           hosts.cap_mem[None, :], hosts.cap_cpus[None, :])
            if c_bonus is not None:
                fit = fit + c_bonus
            # per-(job, host) jitter keyed on the compact slot, as in the
            # kernel: spreads bids within `spread` of each job's best
            fit = torch.where(ok, fit + fused_match.jitter(D, H, spread,
                                                           dev), -1.0)
            choice = torch.argmax(fit, dim=1)
            has_feasible = fit.gather(1, choice[:, None])[:, 0] > -0.5
        hopeless = torch.cat([hopeless, hopeless.new_zeros(1)])
        hopeless.index_fill_(
            0, torch.where(in_use & ~has_feasible, src, N).long(), True)
        hopeless = hopeless[:N]
        bids = window & has_feasible
        accept = compute_accept(state, choice, bids, c_mem, c_cpus, c_gpus,
                                c_group, c_unique, G)
        state = apply_accept(state, choice, accept, c_mem, c_cpus, c_gpus,
                             c_group, c_unique, G, row_idx=src)
        return state, hopeless

    state = (torch.full((N,), NO_HOST, dtype=torch.int32, device=dev),
             hosts.mem, hosts.cpus, hosts.gpus, hosts.task_slots,
             torch.zeros((G, H), dtype=torch.bool, device=dev))
    hopeless0 = torch.zeros(N, dtype=torch.bool, device=dev)
    S = min(head_exact, N)
    if S > 0:
        # exact sequential head: no inversion at the first S positions
        head = Jobs(*(f[:S] for f in jobs))
        carry, head_hosts = _scan_core(
            head, hosts, forbidden[:S], None if bonus is None else bonus[:S],
            G, state[1:], use_kernel=use_kernel, bonus_zero=bonus is None)
        head_hosts = head_hosts.to(torch.int32)
        state = (torch.cat([head_hosts, state[0][S:]]), *carry)
        hopeless0[:S] = head.valid & (head_hosts == NO_HOST)

    def pending(mask, st, hopeless):
        # the while-loop predicate: one device -> host read
        return bool((mask & (st[0] == NO_HOST) & ~hopeless).any())

    if rounds > 0:
        state = window_round(state)
        i = 0
        while i < rounds and pending(gpu_plain, state, hopeless0):
            state = gpu_window_round(state)
            i += 1
    if rounds > 1:
        i = 1
        while i < rounds and pending(plain, state, hopeless0):
            state = pairing_round(state, i)
            i += 1
    if dense_rounds > 0:
        # non-plain jobs place only through the head and these rounds,
        # each resolving at most D candidates: cover ceil(N / D) passes
        max_dense = max(dense_rounds, -(-N // D) + 2)
        hopeless = hopeless0
        i = 0
        while i < max_dense and pending(jobs.valid, state, hopeless):
            state, hopeless = dense_round(state, hopeless)
            i += 1
    job_host, mem_left, cpus_left, gpus_left, slots_left, _ = state
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
