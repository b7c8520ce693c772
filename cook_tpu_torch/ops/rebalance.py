"""Preemption (the rebalancer) in PyTorch: a port of
cook_tpu/ops/rebalance.py:1-342.

Per cycle, for up to `max_preemption` pending jobs in fair-queue order
(Cook's rebalancer.clj):

  1. the pending job's DRU: the DRU of its user's nearest running task
     (the latest that sorts before it) plus the job's own dominant share,
  2. candidate victims: running tasks with dru >= safe_dru_threshold and
     dru - pending_dru > min_dru_diff; only the user's own tasks when the
     user is over quota,
  3. on each host, prefixes of its candidates in dru-descending order,
     seeded with the host's spare resources as a dru=+inf pseudo-task;
     the first prefix that covers the job is the host's decision,
  4. across hosts, the decision with the largest minimum preempted DRU
     (ties to the last host),
  5. the victims leave, the job starts on the chosen host, DRUs are
     recomputed.

The structure is the reference's: every pending job owns a trailing fill
slot (job j -> slot T-P+j), the (user, -priority, start, id) sort runs
once, and each step recomputes the DRUs as a masked segmented cumsum over
that static frame. The reference's `lax.scan` is a Python loop over the P
steps that reads nothing back to the host: every per-step value stays a
(1,)-shaped tensor on the device (a 0-d integer index would be read back
by PyTorch's indexing), so a sweep is one stream of launches and one
readback at the end.

Every f32 reduction takes the order of jax 0.9.0's XLA-CPU, called
through the `segments` module so that a caller can route the kernels to
their plain versions: the per-user DRU cumsum and the per-host prefix
sums through `segments.cumsum0` (blocked_cumsum), the per-user usage
through `segments.scatter_add_ordered_` (ordered_scatter), the freed
resources through `segments.sum_ordered`, and the axis-0 sum of the extra
lanes column by column through `segments.sum_ordered` too (XLA-CPU
reduces each column in the 1-D tree order: tests/test_torch_sum.py).

Shapes: T task slots (running tasks padded, plus P trailing slots that
hold the pending jobs' resources with valid=False until placed), H hosts,
P pending candidates, U users, E extra feasibility lanes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from cook_tpu_torch.ops import dru as dru_ops
from cook_tpu_torch.ops import segments

INF = float(torch.finfo(torch.float32).max)
# the id a pending job compares with in the nearest-task key
PENDING_KEY_ID = 2 ** 30


class TaskState(NamedTuple):
    """Running tasks. Length T. Integer lanes keep the caller's dtype (the
    JAX package runs with 64-bit types off, so its start times are i32)."""

    user: torch.Tensor        # i32
    mem: torch.Tensor         # f32
    cpus: torch.Tensor        # f32
    priority: torch.Tensor    # i32
    start_time: torch.Tensor  # i32
    host: torch.Tensor        # i32
    valid: torch.Tensor       # bool (False once preempted / empty slot)
    mem_share: torch.Tensor   # f32 per-task user share divisors
    cpus_share: torch.Tensor
    # Optional (T, E) feasibility-only lanes: a prefix is feasible only
    # when its sums cover the job in every lane (gpu-mode pools put gpus
    # in the mem lane and the real mem/cpus here).
    extra: torch.Tensor | None = None


class PendingJobs(NamedTuple):
    """Pending jobs to make room for, in fair-queue order. Length P."""

    user: torch.Tensor
    mem: torch.Tensor
    cpus: torch.Tensor
    priority: torch.Tensor
    start_time: torch.Tensor
    valid: torch.Tensor
    mem_share: torch.Tensor
    cpus_share: torch.Tensor
    extra: torch.Tensor | None = None   # (P, E), pairs TaskState.extra


class RebalanceResult(NamedTuple):
    job_placed: torch.Tensor   # (P,) bool
    job_host: torch.Tensor     # (P,) i32, -1 when not placed
    preempted: torch.Tensor    # (T,) bool: tasks chosen for preemption
    spare_mem: torch.Tensor    # (H,) f32 final spare view
    spare_cpus: torch.Tensor


def _key_leq(p1, s1, i1, p2, s2, i2):
    """Lexicographic (-priority, start_time, id) <= comparison."""
    return (p1 > p2) | ((p1 == p2) & ((s1 < s2) | ((s1 == s2) & (i1 <= i2))))


def _f32_scalar(v, dev) -> torch.Tensor:
    """A 0-d f32 tensor on `dev` (the reference's jnp.float32(v)), built
    by a fill, not copied from the host."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=dev)


def _topk_order(x: torch.Tensor) -> torch.Tensor:
    """Indices of `lax.top_k(x, n)` for f32 x: descending in the total
    order of XLA's TopK comparator (+0.0 above -0.0; the bits, sign
    folded), equal values lowest index first."""
    b = x.view(torch.int32)
    key = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return torch.sort(key, descending=True, stable=True).indices


def sum_cols_ordered(x: torch.Tensor) -> torch.Tensor:
    """(E,) f32 column sums of a (T, E) f32 tensor in the order of
    XLA-CPU's `jnp.sum(x, 0)`: each column in the 1-D tree order
    (segments.sum_ordered)."""
    cols = x.t().contiguous()
    if cols.shape[0] == 0:
        return cols.new_zeros((0,))
    return torch.stack([segments.sum_ordered(c) for c in cols.unbind(0)])


def rebalance(tasks: TaskState,
              pending: PendingJobs,
              spare_mem: torch.Tensor,
              spare_cpus: torch.Tensor,
              host_forbidden: torch.Tensor,
              user_quota_mem: torch.Tensor,
              user_quota_cpus: torch.Tensor,
              user_quota_count: torch.Tensor,
              safe_dru_threshold,
              min_dru_diff,
              candidate_cap: int | None = None,
              spare_extra: torch.Tensor | None = None) -> RebalanceResult:
    """Run one rebalancer cycle on the tensors' device.

    host_forbidden: (P, H) bool, hosts each pending job may NOT use.
    user_quota_*: (U,) per-user quota, +inf / INT_MAX when unset.
    The `tasks` tensors must have at least P trailing invalid slots:
    placed pending jobs are materialized there so later decisions see
    them.

    candidate_cap: when set below T, each step's per-host prefix search
    runs over only the top-K candidate victims by DRU (lax.top_k's
    order: ties lowest index first) instead of all T task slots. None =
    exact.

    One difference from the reference: whether a host's spare plus a
    prefix of its candidates covers the job. The reference reads the
    prefix from an f32 cumsum over the whole host-major sequence less
    the host's base, which far from the start loses the low bits (in
    bench_rebalance's pool a host ~1e4 MB in read its spare plus one
    victim 2e-4 MB short of a job they cover, which then stayed
    unplaced). The port sums in int64 units of 2^-24
    (`segments.fixed_units`): the supply rounded down, the demand up, so
    a prefix covers the job only when its exact sum does (exact for
    values >= 0.5 and a host's sum below 2^39; a value below 0.5 off
    that grid can under-count by under 2^-24).
    """
    T = tasks.user.shape[0]
    H = spare_mem.shape[0]
    P = pending.user.shape[0]
    extra_given = [tasks.extra is not None, pending.extra is not None,
                   spare_extra is not None]
    if any(extra_given) and not all(extra_given):
        raise ValueError(
            "extra feasibility lanes must be given on all of tasks, "
            f"pending, and spare_extra, or none (got tasks={extra_given[0]}, "
            f"pending={extra_given[1]}, spare={extra_given[2]})")
    if P > T:
        raise ValueError(f"rebalance: {P} pending jobs need as many "
                         f"trailing task slots, got T={T}")
    dev = spare_mem.device
    safe_dru_threshold = _f32_scalar(safe_dru_threshold, dev)
    min_dru_diff = _f32_scalar(min_dru_diff, dev)
    U = user_quota_mem.shape[0]
    f32 = torch.float32

    # -- materialize every pending job in its dedicated fill slot -------
    def filled(t, p):
        return torch.cat([t[:T - P], p.to(t.dtype)])

    t_user = filled(tasks.user, pending.user)
    t_mem = filled(tasks.mem, pending.mem)
    t_cpus = filled(tasks.cpus, pending.cpus)
    t_extra = (torch.zeros((T, 0), dtype=f32, device=dev)
               if tasks.extra is None else filled(tasks.extra, pending.extra))
    p_extra = (torch.zeros((P, 0), dtype=f32, device=dev)
               if pending.extra is None else pending.extra)
    sp_extra = (torch.zeros((H, 0), dtype=f32, device=dev)
                if spare_extra is None else spare_extra)
    E = t_extra.shape[1]
    t_prio = filled(tasks.priority, pending.priority)
    t_start = filled(tasks.start_time, pending.start_time)
    t_mshare = filled(tasks.mem_share, pending.mem_share)
    t_cshare = filled(tasks.cpus_share, pending.cpus_share)
    t_valid0 = filled(tasks.valid, torch.zeros(P, dtype=torch.bool,
                                               device=dev))

    # -- the one sort: (user, -priority, start, id), validity-free ------
    ids = torch.arange(T, dtype=torch.int32, device=dev)
    perm0 = dru_ops.lexsort((ids, t_start, -t_prio, t_user))
    s_user = t_user[perm0]
    s_mem = t_mem[perm0]
    s_cpus = t_cpus[perm0]
    s_prio = t_prio[perm0]
    s_start = t_start[perm0]
    s_mshare = t_mshare[perm0]
    s_cshare = t_cshare[perm0]
    s_extra = t_extra[perm0]
    s_ids = ids[perm0]                  # original slot id of each row
    # static per-user segment starts for the per-step masked cumsum
    start_idx = segments.segment_start_index(segments.segment_starts(s_user))
    # sorted position of each fill slot (for the validity flip)
    sidx = torch.arange(T, device=dev)
    inv0 = torch.empty(T, dtype=torch.long, device=dev).scatter_(
        0, perm0, sidx)
    fill_pos = inv0[T - P:]

    capped = candidate_cap is not None and candidate_cap < T
    K = candidate_cap if capped else T
    n_seq = H + K
    host_ids = torch.arange(H, dtype=tasks.host.dtype, device=dev)
    spare_dru = torch.full((H,), INF, dtype=f32, device=dev)
    spare_user = torch.full((H,), -1, dtype=s_user.dtype, device=dev)
    pos = torch.arange(n_seq, device=dev)
    key_id = torch.full((1,), PENDING_KEY_ID, dtype=s_ids.dtype, device=dev)

    # the cover test's supply and demand in int64 units of 2^-24, one
    # row a lane (see above): the tasks' once, rounded down, and the
    # jobs' once, rounded up
    s_units = segments.fixed_units(torch.cat(
        [s_mem[None], s_cpus[None], s_extra.t()], 0), up=False)
    need_all = segments.fixed_units(torch.cat(
        [pending.mem[None], pending.cpus[None], p_extra.t()], 0), up=True)

    s_valid = t_valid0[perm0]
    s_host = tasks.host[perm0]
    preempted = torch.zeros(T, dtype=torch.bool, device=dev)
    sp_mem, sp_cpus = spare_mem, spare_cpus
    placed_steps, host_steps = [], []
    for j in range(P):
        one = slice(j, j + 1)           # this step's inputs, shape (1,)
        j_user, j_mem, j_cpus = pending.user[one], pending.mem[one], \
            pending.cpus[one]
        j_prio, j_start, j_valid = pending.priority[one], \
            pending.start_time[one], pending.valid[one]
        j_mshare, j_cshare = pending.mem_share[one], pending.cpus_share[one]
        j_forbidden = host_forbidden[j]
        j_fill_pos = fill_pos[one]
        j_extra = p_extra[one]

        # -- DRUs: masked per-user cumsum over the static frame --------
        vals = torch.stack([torch.where(s_valid, s_mem, 0.0),
                            torch.where(s_valid, s_cpus, 0.0)], -1)
        total = segments.cumsum0(vals)
        cum = total - (total[start_idx] - vals[start_idx])
        dru = torch.maximum(cum[:, 0] / s_mshare, cum[:, 1] / s_cshare)

        # -- pending job dru (rebalancer.clj:183-207) ------------------
        same_user = s_valid & (s_user == j_user)
        leq = _key_leq(s_prio, s_start, s_ids, j_prio, j_start, key_id)
        nearest = torch.amax(torch.where(same_user & leq, dru, 0.0), 0,
                             keepdim=True)
        own_share = torch.maximum(j_mem / j_mshare, j_cpus / j_cshare)
        pending_dru = nearest + own_share

        # -- quota test (job-below-quota, rebalancer.clj:209-219) ------
        seg_id = torch.where(s_valid, s_user, U)
        usage = segments.scatter_add_ordered_(
            torch.zeros((U + 1, 2), dtype=f32, device=dev), seg_id, vals)
        u_cnt = torch.zeros(U + 1, dtype=torch.int32, device=dev).index_add_(
            0, seg_id, s_valid.to(torch.int32))
        uid = torch.clamp(j_user, 0, U - 1).long()
        u_j = usage[uid]
        below_quota = ((u_j[:, 0] + j_mem <= user_quota_mem[uid])
                       & (u_j[:, 1] + j_cpus <= user_quota_cpus[uid])
                       & (u_cnt[uid] + 1 <= user_quota_count[uid]))

        # -- candidate victims ----------------------------------------
        cand = (s_valid
                & (dru >= safe_dru_threshold)
                & (dru - pending_dru > min_dru_diff)
                & (below_quota | (s_user == j_user)))

        # -- per-host prefix feasibility ------------------------------
        # one spare pseudo-entry per host (dru=+inf) followed by its
        # candidates, sorted by (host, -dru, user, index)
        if capped:
            topi = _topk_order(torch.where(cand, dru, -INF))[:K]
            k_keep = cand[topi]
            c_host = torch.where(k_keep, s_host[topi], H)
            c_dru = torch.where(k_keep, dru[topi], 0.0)
            c_user = s_user[topi]
            c_units = torch.where(k_keep[None], s_units[:, topi], 0)
        else:
            c_host = torch.where(cand, s_host, H)
            c_dru = torch.where(cand, dru, 0.0)
            c_user = s_user
            c_units = torch.where(cand[None], s_units, 0)
        seq_host = torch.cat([host_ids, c_host])
        seq_dru = torch.cat([spare_dru, c_dru])
        seq_user = torch.cat([spare_user, c_user])
        sp_units = segments.fixed_units(torch.cat(
            [sp_mem[None], sp_cpus[None], sp_extra.t()], 0), up=False)
        # the reference's last key, the index, is the order a stable
        # sort keeps anyway
        perm = dru_ops.lexsort((seq_user, -seq_dru, seq_host))
        p_host = seq_host[perm]
        # a difference from the reference: a prefix covers the job when
        # its exact sum does (see `rebalance`); each lane a row, scanned
        # along it, the global prefix less each host's base
        units = torch.cat([sp_units, c_units], 1)[:, perm]
        total = torch.cumsum(units, 1)
        start = segments.segment_start_index(segments.segment_starts(p_host))
        cums = total - (total[:, start] - units[:, start])
        feas = (cums >= need_all[:, j, None]).all(0) & (p_host < H)
        feas &= ~j_forbidden[torch.clamp(p_host, 0, H - 1).long()]
        # first feasible position per host == the prefix with max min-dru
        first_pos = torch.full((H + 1,), n_seq, device=dev).scatter_reduce_(
            0, torch.clamp(p_host, 0, H).long(),
            torch.where(feas, pos, n_seq), "amin")[:H]
        has_decision = first_pos < n_seq
        decision_dru = torch.where(
            has_decision,
            seq_dru[perm][torch.clamp(first_pos, 0, n_seq - 1)], -INF)

        # -- choose host: max decision dru, ties -> last host ----------
        best_host = torch.where(
            has_decision.any(0, keepdim=True),
            (H - 1) - torch.argmax(torch.flip(decision_dru, (0,)), 0,
                                   keepdim=True), -1)
        placed = j_valid & (best_host >= 0)
        best_host = torch.where(placed, best_host, -1)
        bh = torch.clamp(best_host, 0, H - 1)
        cut = torch.where(placed, first_pos[bh], -1)

        # victims: candidates on best_host at sorted position <= cut
        sorted_pos_of = torch.empty(n_seq, dtype=torch.long,
                                    device=dev).scatter_(0, perm, pos)
        victim_k = (c_host == best_host) & (sorted_pos_of[H:] <= cut) \
            & placed
        if capped:
            victim = torch.zeros(T, dtype=torch.bool, device=dev).scatter_(
                0, topi, victim_k)
        else:
            victim = cand & victim_k

        freed_mem = segments.sum_ordered(torch.where(victim, s_mem, 0.0)) \
            + torch.where(placed, sp_mem[bh], 0.0)
        freed_cpus = segments.sum_ordered(torch.where(victim, s_cpus, 0.0)) \
            + torch.where(placed, sp_cpus[bh], 0.0)
        freed_extra = sum_cols_ordered(
            torch.where(victim[:, None], s_extra, 0.0)) \
            + torch.where(placed[:, None], sp_extra[bh], 0.0)

        # -- state update (next-state, rebalancer.clj:269-308) ---------
        s_valid = s_valid & ~victim
        preempted = preempted | victim
        sp_mem = sp_mem.scatter(
            0, bh, torch.where(placed, freed_mem - j_mem, sp_mem[bh]))
        sp_cpus = sp_cpus.scatter(
            0, bh, torch.where(placed, freed_cpus - j_cpus, sp_cpus[bh]))
        if E:
            sp_extra = sp_extra.index_copy(0, bh, torch.where(
                placed[:, None], freed_extra - j_extra, sp_extra[bh]))

        # flip the job's fill slot live (its values were preset; only
        # validity and the host are dynamic)
        s_valid = s_valid.scatter(0, j_fill_pos,
                                  placed | s_valid[j_fill_pos])
        s_host = s_host.scatter(0, j_fill_pos, torch.where(
            placed, best_host.to(s_host.dtype), s_host[j_fill_pos]))
        placed_steps.append(placed)
        host_steps.append(best_host)

    # map the preempted mask back from the sorted frame
    preempted = torch.zeros(T, dtype=torch.bool, device=dev).scatter_(
        0, perm0, preempted)
    if P:
        job_placed = torch.cat(placed_steps)
        job_host = torch.cat(host_steps).to(torch.int32)
    else:
        job_placed = torch.zeros(0, dtype=torch.bool, device=dev)
        job_host = torch.zeros(0, dtype=torch.int32, device=dev)
    return RebalanceResult(job_placed=job_placed, job_host=job_host,
                           preempted=preempted, spare_mem=sp_mem,
                           spare_cpus=sp_cpus)
