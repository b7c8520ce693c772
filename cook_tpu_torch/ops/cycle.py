"""One full scheduling cycle: rank, considerable filter, match,
compaction/provenance epilogue (a port of cook_tpu/ops/cycle.py:37-347).

  1. rank: DRU-score the union of running tasks and pending jobs
     (pending jobs are scored as hypothetical next tasks of their user),
  2. considerable filter: walk pending jobs in fair-queue order and keep
     those whose user stays under their resource/count quota given
     running usage plus the queue prefix ahead of them, capped at
     `num_considerable` and the dynamic `considerable_limit`,
  3. match: greedy assignment of the considerable jobs onto hosts
     (ops/match.py): the sequential walk (the exact_scan kernel with
     `use_kernel`) or, with `sequential=False`, the batched
     `match_rounds` (its exact head and dense rounds through the
     exact_scan and best_host kernels with `use_kernel`), whatever the
     groups and the bonus,
  4. epilogue: matched slots packed to the front in queue order, and a
     reason code per fair-queue position.

PyTorch runs eagerly: the reference's single jit becomes a sequence of
kernels on the inputs' device. `jnp .at[idx].set(..., mode="drop")`
becomes a scatter into a buffer with one extra sink slot.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from cook_tpu_torch.obs import decisions as why_codes
from cook_tpu_torch.ops import dru as dru_ops
from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.ops import segments

I32_MAX = torch.iinfo(torch.int32).max


def _block(x, s):
    """Shard s's block of a host-axis input of sharded hosts: the s-th
    of a list of per-shard blocks, or of the rows of a (rows, slot_of)
    pair."""
    if x is None:
        return None
    blocks = x[0] if isinstance(x, tuple) else x
    if not isinstance(blocks, list):
        raise TypeError("with sharded hosts, every host-axis input is a "
                        "list of per-shard blocks")
    return (blocks[s], x[1]) if isinstance(x, tuple) else blocks[s]


def _host_columns(C, H, dev, pend_idx, in_use, forbidden, pend_ports,
                  host_ports, pend_est_s, host_death_s, now_s, bonus):
    """The compact batch's (C, H) forbidden mask and bonus (or None) over
    H host columns on `dev`: all of them, or one shard's. The job-side
    inputs live on the pending lanes' device."""
    idx = pend_idx.to(dev, non_blocking=True)
    use = in_use.to(dev, non_blocking=True)
    if forbidden is None:
        forb = torch.zeros((C, H), dtype=torch.bool, device=dev)
    elif isinstance(forbidden, tuple):
        rows, slot_of = forbidden
        Kc = rows.shape[0]
        fslot = slot_of[pend_idx].to(dev, non_blocking=True)
        forb = rows[torch.clamp(fslot, 0, Kc - 1).long()] \
            & ((fslot >= 0) & use)[:, None]
    else:
        forb = forbidden[idx] & use[:, None]
    if pend_ports is not None and host_ports is not None:
        want = pend_ports[pend_idx].to(dev, non_blocking=True)
        forb = forb | (want[:, None] > host_ports[None, :])
    if pend_est_s is not None and host_death_s is not None:
        # est_end >= death forbids the host; est <= 0 = unconstrained
        est = pend_est_s[pend_idx].to(dev, non_blocking=True)
        now = torch.as_tensor(now_s, dtype=torch.int32, device=dev)
        forb = forb | ((est > 0)[:, None]
                       & ((now + est)[:, None] >= host_death_s[None, :]))
    if bonus is None:
        bonusc = None
    elif isinstance(bonus, tuple):
        brows, bslot = bonus
        Kb = brows.shape[0]
        bs = bslot[pend_idx].to(dev, non_blocking=True)
        bonusc = torch.where((bs >= 0)[:, None],
                             brows[torch.clamp(bs, 0, Kb - 1).long()], 0.0) \
            * use[:, None]
    else:
        bonusc = bonus[idx] * use[:, None]
    return forb, bonusc


class CycleResult(NamedTuple):
    pending_dru: torch.Tensor     # (P,) dru score of each pending job
    queue_rank: torch.Tensor      # (P,) i32 fair-queue position among pending
    considerable: torch.Tensor    # (P,) bool — survived quota/cap filters
    job_host: torch.Tensor        # (P,) i32 assigned host or -1
    mem_left: torch.Tensor        # (H,); the four host lanes are lists of
    cpus_left: torch.Tensor       # (H,)  per-shard blocks with sharded hosts
    gpus_left: torch.Tensor       # (H,)
    slots_left: torch.Tensor      # (H,) i32
    cons_idx: torch.Tensor        # (C,) i32 pending row per compact slot, -1
    cons_host: torch.Tensor       # (C,) i32 assigned host per slot, -1
    head_matched: torch.Tensor    # () bool — queue-head considerable placed
    n_matched: torch.Tensor       # () i32
    n_considerable: torch.Tensor  # () i32
    mat_idx: torch.Tensor         # (C,) i32 pending row, matched prefix
    mat_host: torch.Tensor        # (C,) i32 assigned host, matched prefix
    why_idx: torch.Tensor         # (W,) i32 pending row at queue pos, -1
    why_code: torch.Tensor        # (W,) i32 reason code (0 = pad)
    why_amt: torch.Tensor         # (W,) f32 code-specific datum


def exact_overage(over, demand, start_idx, room):
    """The quota filter's overage of the mem and cpus lanes, `over` (n, k)
    as the reference computes it (f32: usage + running demand - quota),
    with its sign set by exact arithmetic. The reference reads each
    row's running demand from an f32 cumsum over every row less its
    segment's base; behind a large prefix (100,000 jobs of 1-4 GB, ~2.5e8
    MB, where an f32 step is 16) the difference is off by several MB and
    can refuse a job that fits its quota exactly, every cycle. Here the
    demands `demand` (n, k), each row's segment starting at `start_idx`,
    count in int64 units of 2^-24 rounded up (`segments.fixed_units`),
    summed by `segments.cumsum_from_starts`: the global prefix less the
    base is exact (a total past 2^63 wraps and cancels in the
    difference) while a segment's own sum stays below 2^39. `room` (n,
    k) is each row's floor((quota - usage) * 2^24), taken in float64
    (exact for two f32 within 2^28 of each other; an unset quota clamps
    to 2^62). Rounding up over-counts, by under 2^-24 a row whose demand
    is below 0.5 and off that grid, so the exact test never admits a row
    past its quota, and may refuse a row of such small demands that fits
    to within those units.

    The f32 datum (provenance's why_amt) keeps its value wherever its
    sign agrees with the exact test; where they disagree it is the exact
    overage rounded to f32 instead, at least 2^-24 when over and at most
    0 when within, so its sign never contradicts the decision."""
    exact = segments.cumsum_from_starts(
        segments.fixed_units(demand, up=True), start_idx) - room
    agree = (exact <= 0) == (over <= 0)
    return torch.where(agree, over,
                       exact.float() * (1.0 / segments.FIT_SCALE))


def rank_and_match(
    # running tasks (R slots)
    run_user, run_mem, run_cpus, run_prio, run_start, run_valid,
    run_mem_share, run_cpus_share,
    # pending jobs (P slots)
    pend_user, pend_mem, pend_cpus, pend_gpus, pend_prio, pend_start,
    pend_valid, pend_mem_share, pend_cpus_share, pend_group,
    pend_unique_group,
    # hosts
    hosts: match_ops.Hosts,    # or a list of per-shard Hosts (a pool
                               # sharded over devices; needs `matcher`,
                               # and every host-axis input below as a
                               # list of per-shard blocks, rows included)
    forbidden,                 # None | (P, H) bool dense | tuple
                               # (rows (K, H) bool, slot_of (P,) i32):
                               # row p's mask is rows[slot_of[p]] when
                               # slot_of[p] >= 0, all-allowed otherwise
    # per-user quotas (U,)
    user_quota_mem, user_quota_cpus, user_quota_count,
    num_considerable: int = 1024,
    num_groups: int = 1,
    sequential: bool = True,
    considerable_limit=None,   # dynamic scaleback cap (int or 0-d tensor)
    bonus=None,                # None | (P, H) f32 | tuple (rows (Kb, H)
                               # f32, slot_of (P,) i32), like `forbidden`
    use_kernel: bool = False,  # the match kernels: the sequential walk
                               # and match_rounds' head as exact_scan,
                               # its dense rounds as best_host, any
                               # groups, any bonus
    dru_mode: str = "default",  # "default" (cpu/mem) | "gpu"
    run_gpus=None,             # (R,) — required in gpu mode
    run_gpu_share=None,        # (R,) — required in gpu mode
    pend_gpu_share=None,       # (P,) — required in gpu mode
    pend_ports=None,           # (P,) i32 requested port count, with
    host_ports=None,           # (H,) i32 free ports: ports feasibility
    pend_est_s=None,           # (P,) i32 capped expected-runtime seconds
    host_death_s=None,         # (H,) i32 host death time (relative s)
    now_s=None,                # () i32 wall clock, same epoch
    matcher=None,              # match-step override: callable
                               # (jobs, hosts, forb, bonus) -> MatchResult
    match_kw=None,             # extra match_rounds knobs (head_exact,
                               # dense_rounds, rounds, ...) as a mapping
                               # or (name, value) pairs; ignored on the
                               # sequential path
) -> CycleResult:
    R = run_user.shape[0]
    P = pend_user.shape[0]
    U = user_quota_mem.shape[0]
    dev = pend_user.device

    # ---- 1. rank union of running + pending --------------------------
    user = torch.cat([run_user, pend_user])
    prio = torch.cat([run_prio, pend_prio])
    start = torch.cat([run_start, pend_start])
    valid = torch.cat([run_valid, pend_valid])
    if dru_mode == "gpu":
        gpus = torch.cat([run_gpus, pend_gpus])
        gshare = torch.cat([run_gpu_share, pend_gpu_share])
        ranked = dru_ops.gpu_dru_rank(user, gpus, prio, start, valid, gshare)
    else:
        mem = torch.cat([run_mem, pend_mem])
        cpus = torch.cat([run_cpus, pend_cpus])
        mshare = torch.cat([run_mem_share, pend_mem_share])
        cshare = torch.cat([run_cpus_share, pend_cpus_share])
        ranked = dru_ops.dru_rank(user, mem, cpus, prio, start, valid,
                                  mshare, cshare)
    pending_dru = ranked.dru[R:]
    # fair-queue position among pending jobs only
    pend_global_rank = ranked.rank[R:]
    queue_perm = torch.argsort(
        torch.where(pend_valid, pend_global_rank, I32_MAX), stable=True)
    arP = torch.arange(P, dtype=torch.int32, device=dev)
    queue_rank = torch.empty(P, dtype=torch.int32, device=dev)
    queue_rank[queue_perm] = arP

    # ---- 2. considerable filter (quota + cap) ------------------------
    # running usage per user: the reference's three segment_sums (each
    # user's tasks added in row order), one column each; segment U, the
    # invalid rows, is dropped
    usage = segments.scatter_add_ordered_(
        torch.zeros((U, 3), device=dev), torch.where(run_valid, run_user, U),
        torch.stack([torch.where(run_valid, run_mem, 0.0),
                     torch.where(run_valid, run_cpus, 0.0),
                     run_valid.to(torch.float32)], -1))
    u_mem, u_cpus, u_cnt = usage[:, 0], usage[:, 1], usage[:, 2]

    # cumulative pending demand per user in queue order
    q_user = pend_user[queue_perm]
    q_valid = pend_valid[queue_perm]
    sort_user = torch.where(q_valid, q_user, U)
    uperm = torch.argsort(sort_user, stable=True)
    su = sort_user[uperm]
    demand = torch.stack(
        [torch.where(q_valid, pend_mem[queue_perm], 0.0)[uperm],
         torch.where(q_valid, pend_cpus[queue_perm], 0.0)[uperm],
         q_valid[uperm].to(torch.float32)], -1)
    start_idx = segments.segment_start_index(segments.segment_starts(su))
    cum = segments.cumsum_from_starts(demand, start_idx)
    uid = torch.clamp(su, 0, U - 1).long()
    # signed per-dimension overage (positive = over quota)
    over = torch.stack(
        [u_mem[uid] + cum[:, 0] - user_quota_mem[uid],
         u_cpus[uid] + cum[:, 1] - user_quota_cpus[uid],
         u_cnt[uid] + cum[:, 2] - user_quota_count[uid]], -1)
    # the mem and cpus lanes decide on the exact running demand (a
    # difference from the reference: exact_overage)
    room = segments.fixed_units(
        torch.stack([user_quota_mem, user_quota_cpus], -1).double()
        - usage[:, :2].double(), up=False)
    over = torch.cat([exact_overage(over[:, :2], demand[:, :2], start_idx,
                                    room[uid]), over[:, 2:]], -1)
    within = (over[:, 0] <= 0) & (over[:, 1] <= 0) & (over[:, 2] <= 0)
    within_q = torch.empty(P, dtype=torch.bool, device=dev)
    within_q[uperm] = within                                # queue order
    over_q = torch.empty((P, 3), dtype=torch.float32, device=dev)
    over_q[uperm] = over
    considerable_q = q_valid & within_q
    cap = torch.tensor(num_considerable, dtype=torch.int32, device=dev)
    if considerable_limit is not None:
        cap = torch.minimum(cap, torch.as_tensor(
            considerable_limit, dtype=torch.int32, device=dev))
    taken = torch.cumsum(considerable_q.to(torch.int32), 0,
                         dtype=torch.int32)
    considerable_q = considerable_q & (taken <= cap)
    considerable = torch.empty(P, dtype=torch.bool, device=dev)
    considerable[queue_perm] = considerable_q

    # ---- 3. compact the considerable head, then match ----------------
    C = num_considerable
    cons_pos = torch.cumsum(considerable_q.to(torch.int32), 0,
                            dtype=torch.int32) - 1
    slot = torch.where(considerable_q, torch.clamp(cons_pos, max=C), C)
    # src[c] = queue position feeding compact slot c (P = empty slot)
    src = match_ops.scatter_sink(C, P, slot, arP)
    in_use = src < P
    pend_idx = queue_perm[torch.clamp(src, 0, P - 1).long()]

    def gq(arr):  # gather: original pending order -> compact batch
        return arr[pend_idx]

    jobs = match_ops.Jobs(
        mem=gq(pend_mem), cpus=gq(pend_cpus), gpus=gq(pend_gpus),
        valid=in_use, group=gq(pend_group),
        unique_group=gq(pend_unique_group))
    if isinstance(hosts, match_ops.Hosts):
        forb, bonusc = _host_columns(
            C, hosts.mem.shape[0], dev, pend_idx, in_use, forbidden,
            pend_ports, host_ports, pend_est_s, host_death_s, now_s, bonus)
    else:
        # hosts sharded over devices (a list of per-shard Hosts, the
        # host-axis inputs lists of per-shard blocks): each shard's
        # columns of the mask and bonus built on its device
        if matcher is None:
            raise ValueError("sharded hosts need a sharded matcher")
        forb, bonusc = [], []
        for s, hs in enumerate(hosts):
            f, b = _host_columns(
                C, hs.mem.shape[0], hs.mem.device, pend_idx, in_use,
                _block(forbidden, s), pend_ports, _block(host_ports, s),
                pend_est_s, _block(host_death_s, s), now_s,
                _block(bonus, s))
            forb.append(f)
            bonusc.append(b)
        if bonus is None:
            bonusc = None
    if matcher is not None:
        res = matcher(jobs, hosts, forb, bonusc)
    elif sequential:
        res = match_ops.match_scan(jobs, hosts, forb, num_groups=num_groups,
                                   bonus=bonusc, use_kernel=use_kernel)
    else:
        kw = {"rounds": 4, **dict(match_kw or ())}
        res = match_ops.match_rounds(jobs, hosts, forb,
                                     num_groups=num_groups, bonus=bonusc,
                                     use_kernel=use_kernel, **kw)
    res_host = res.job_host.to(torch.int32)
    # scatter back: compact -> original pending order (empty slots -> P)
    scatter_idx = torch.where(in_use, pend_idx, P)
    job_host = match_ops.scatter_sink(P, match_ops.NO_HOST, scatter_idx,
                                      res_host)

    # compact outputs: slot order IS queue order
    cons_idx = torch.where(in_use, pend_idx, -1).to(torch.int32)
    matched_slot = in_use & (res_host >= 0)
    head_matched = ~in_use[0] | (res_host[0] >= 0)
    # compaction epilogue: matched slots packed to the front, queue order
    mat_pos = torch.cumsum(matched_slot.to(torch.int32), 0,
                           dtype=torch.int32) - 1
    mslot = torch.where(matched_slot, torch.clamp(mat_pos, max=C), C)
    mat_idx = match_ops.scatter_sink(C, -1, mslot, cons_idx)
    mat_host = match_ops.scatter_sink(C, -1, mslot, res_host)

    # ---- 4. decision provenance over W = min(C, P) queue positions ----
    W = min(C, P)
    wqp = queue_perm[:W]
    wvalid = q_valid[:W]
    whost = job_host[wqp]
    wcons = considerable_q[:W]
    wwithin = within_q[:W]
    wtaken = taken[:W]
    wover = over_q[:W]
    # first-failing quota dimension, mem -> cpus -> count priority
    quota_code = torch.where(
        wover[:, 0] > 0, why_codes.QUOTA_MEM,
        torch.where(wover[:, 1] > 0, why_codes.QUOTA_CPUS,
                    why_codes.QUOTA_COUNT))
    quota_amt = torch.where(
        wover[:, 0] > 0, wover[:, 0],
        torch.where(wover[:, 1] > 0, wover[:, 1], wover[:, 2]))
    why_code = torch.where(
        ~wvalid, why_codes.INVALID,
        torch.where(wcons,
                    torch.where(whost >= 0, why_codes.MATCHED,
                                why_codes.NO_HOST_FIT),
                    torch.where(~wwithin, quota_code,
                                why_codes.RANK_CUTOFF))).to(torch.int32)
    why_amt = torch.where(
        ~wvalid, 0.0,
        torch.where(wcons,
                    torch.where(whost >= 0, whost.to(torch.float32), 0.0),
                    torch.where(~wwithin, quota_amt,
                                wtaken.to(torch.float32))))
    why_idx = torch.where(wvalid, wqp, -1).to(torch.int32)

    return CycleResult(pending_dru=pending_dru, queue_rank=queue_rank,
                       considerable=considerable, job_host=job_host,
                       mem_left=res.mem_left, cpus_left=res.cpus_left,
                       gpus_left=res.gpus_left, slots_left=res.slots_left,
                       cons_idx=cons_idx, cons_host=res_host,
                       head_matched=head_matched,
                       n_matched=matched_slot.sum().to(torch.int32),
                       n_considerable=in_use.sum().to(torch.int32),
                       mat_idx=mat_idx, mat_host=mat_host,
                       why_idx=why_idx, why_code=why_code,
                       why_amt=why_amt)
