"""The port's rebalancer (cook_tpu_torch/ops/rebalance.py::rebalance)
against the JAX package's (cook_tpu/ops/rebalance.py::rebalance), on the
CPU: the same numpy-seeded inputs go to both, the JAX function under
JAX_PLATFORMS=cpu, the port on CPU tensors (every kernel wrapper then runs
its plain version).

Tolerance: none. `job_placed`, `job_host` and `preempted` are equal, and
`spare_mem` / `spare_cpus` bit-equal (as int32, so signed zeros count):
every f32 reduction of the port takes XLA-CPU's order (the cumsums,
the per-user usage scatter, the freed-resource sums, the axis-0 sum of
the extra lanes).

Cases: the five scenarios of tests/test_rebalance.py (with their
expected outcomes), its randomized seeds against
tests/oracles.py::rebalance_oracle, its candidate_cap-covers-all seeds,
a tie-heavy pool where more candidates than candidate_cap share the DRU
at the cut, gpu-mode pools with two extra lanes (shaped as the
coordinator's rebalance_cycle builds them), a tie in the hosts'
decision DRU (the last host wins), quota-blocked users with the count
quota in f32 and in i32, and seeded pools of up to 4,096 task slots.
Start times are i32 throughout: the JAX package runs with 64-bit types
off.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.ops import rebalance as jrb
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import rebalance as trb
from tests.oracles import Task
from tests.test_rebalance import PENDING_ID_BASE, sequential_oracle

F32_BIG = np.float32(3.4e38)
FIELDS_T = ("user", "mem", "cpus", "priority", "start_time", "host",
            "valid", "mem_share", "cpus_share")
FIELDS_P = ("user", "mem", "cpus", "priority", "start_time", "valid",
            "mem_share", "cpus_share")


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _from_tasks(tasks, pend, shares, spare, n_hosts, n_users, safe=0.0,
                min_diff=0.0, forbidden=None):
    """numpy inputs of one call, built as tests/test_rebalance.py's
    run_kernel builds them (T = running + pending slots)."""
    P = len(pend)
    T = len(tasks) + P
    t = dict(user=np.zeros(T, np.int32), mem=np.zeros(T, np.float32),
             cpus=np.zeros(T, np.float32), priority=np.zeros(T, np.int32),
             start_time=np.zeros(T, np.int32), host=np.full(T, -1, np.int32),
             valid=np.zeros(T, bool),
             mem_share=np.full(T, F32_BIG, np.float32),
             cpus_share=np.full(T, F32_BIG, np.float32))
    for i, x in enumerate(tasks):
        t["user"][i], t["mem"][i], t["cpus"][i] = x.user, x.mem, x.cpus
        t["priority"][i], t["start_time"][i] = x.priority, x.start_time
        t["host"][i], t["valid"][i] = x.host, True
        ms, cs = shares.get(x.user, (math.inf, math.inf))
        t["mem_share"][i], t["cpus_share"][i] = min(ms, 3.4e38), \
            min(cs, 3.4e38)
    p = dict(user=np.zeros(P, np.int32), mem=np.zeros(P, np.float32),
             cpus=np.zeros(P, np.float32), priority=np.zeros(P, np.int32),
             start_time=np.zeros(P, np.int32), valid=np.ones(P, bool),
             mem_share=np.full(P, F32_BIG, np.float32),
             cpus_share=np.full(P, F32_BIG, np.float32))
    for i, x in enumerate(pend):
        p["user"][i], p["mem"][i], p["cpus"][i] = x.user, x.mem, x.cpus
        p["priority"][i], p["start_time"][i] = x.priority, x.start_time
        ms, cs = shares.get(x.user, (math.inf, math.inf))
        p["mem_share"][i], p["cpus_share"][i] = min(ms, 3.4e38), \
            min(cs, 3.4e38)
    sp_mem = np.zeros(n_hosts, np.float32)
    sp_cpus = np.zeros(n_hosts, np.float32)
    for h, (m, c) in spare.items():
        sp_mem[h], sp_cpus[h] = m, c
    return dict(
        tasks=t, pending=p, spare_mem=sp_mem, spare_cpus=sp_cpus,
        forb=(np.zeros((P, n_hosts), bool) if forbidden is None
              else forbidden),
        qm=np.full(n_users, F32_BIG), qc=np.full(n_users, F32_BIG),
        qn=np.full(n_users, 2 ** 30, np.int32), safe=safe,
        min_diff=min_diff)


def _run_jax(a, **kw):
    ex = a.get("extra")
    ts = jrb.TaskState(**{k: jnp.asarray(a["tasks"][k]) for k in FIELDS_T},
                       extra=None if ex is None else jnp.asarray(ex[0]))
    pj = jrb.PendingJobs(**{k: jnp.asarray(a["pending"][k])
                            for k in FIELDS_P},
                         extra=None if ex is None else jnp.asarray(ex[1]))
    return jrb.rebalance(
        ts, pj, jnp.asarray(a["spare_mem"]), jnp.asarray(a["spare_cpus"]),
        jnp.asarray(a["forb"]), jnp.asarray(a["qm"]), jnp.asarray(a["qc"]),
        jnp.asarray(a["qn"]), a["safe"], a["min_diff"],
        spare_extra=None if ex is None else jnp.asarray(ex[2]), **kw)


def _run_port(a, **kw):
    t = lambda x: None if x is None else torch.from_numpy(x)
    ex = a.get("extra")
    ts = trb.TaskState(**{k: t(a["tasks"][k]) for k in FIELDS_T},
                       extra=None if ex is None else t(ex[0]))
    pj = trb.PendingJobs(**{k: t(a["pending"][k]) for k in FIELDS_P},
                         extra=None if ex is None else t(ex[1]))
    fused_match.reset_launches()
    res = trb.rebalance(
        ts, pj, t(a["spare_mem"]), t(a["spare_cpus"]), t(a["forb"]),
        t(a["qm"]), t(a["qc"]), t(a["qn"]), a["safe"], a["min_diff"],
        spare_extra=None if ex is None else t(ex[2]), **kw)
    assert not any(fused_match.LAUNCHES.values())   # CPU: plain versions
    return res


def _assert_same(got, want):
    np.testing.assert_array_equal(got.job_placed.numpy(),
                                  np.asarray(want.job_placed))
    np.testing.assert_array_equal(got.job_host.numpy(),
                                  np.asarray(want.job_host))
    np.testing.assert_array_equal(got.preempted.numpy(),
                                  np.asarray(want.preempted))
    np.testing.assert_array_equal(_bits(got.spare_mem.numpy()),
                                  _bits(want.spare_mem))
    np.testing.assert_array_equal(_bits(got.spare_cpus.numpy()),
                                  _bits(want.spare_cpus))
    assert got.job_host.dtype == torch.int32
    assert got.job_placed.dtype == torch.bool


def _both(a, **kw):
    got, want = _run_port(a, **kw), _run_jax(a, **kw)
    _assert_same(got, want)
    return got


# -- the five scenarios of tests/test_rebalance.py:72-121 ---------------

def _scenario(name):
    pend1 = lambda m, c: [Task(id=PENDING_ID_BASE, user=1, mem=m, cpus=c,
                               start_time=9)]
    one_task = [Task(id=0, user=0, mem=10, cpus=10, host=0)]
    even = {0: (10.0, 10.0), 1: (10.0, 10.0)}
    if name == "prefers_highest_dru_host":
        tasks = [Task(id=0, user=0, mem=10, cpus=10, host=0, start_time=0),
                 Task(id=1, user=0, mem=10, cpus=10, host=0, start_time=1),
                 Task(id=2, user=1, mem=2, cpus=2, host=1, start_time=0)]
        pend = [Task(id=PENDING_ID_BASE, user=2, mem=5, cpus=5,
                     start_time=9)]
        shares = {0: (10.0, 10.0), 1: (10.0, 10.0), 2: (10.0, 10.0)}
        return _from_tasks(tasks, pend, shares, {}, 2, 3), (True, 0,
                                                            [0, 1, 0])
    if name == "spare_avoids_preemption":
        return _from_tasks(one_task, pend1(5, 5), even, {1: (8.0, 8.0)}, 2,
                           2), (True, 1, [0])
    if name == "min_dru_diff_blocks":
        return _from_tasks(one_task, pend1(10, 10), even, {}, 1, 2), \
            (False, -1, [0])
    if name == "safe_dru_threshold_blocks":
        return _from_tasks(one_task, pend1(1, 1),
                           {0: (100.0, 100.0), 1: (10.0, 10.0)}, {}, 1, 2,
                           safe=0.5), (False, -1, [0])
    assert name == "host_forbidden"
    return _from_tasks(one_task, pend1(5, 5), even, {}, 1, 2,
                       forbidden=np.ones((1, 1), bool)), (False, -1, [0])


@pytest.mark.parametrize("name", [
    "prefers_highest_dru_host", "spare_avoids_preemption",
    "min_dru_diff_blocks", "safe_dru_threshold_blocks", "host_forbidden"])
def test_scenario_equals_jax(name):
    a, (placed, host, preempted) = _scenario(name)
    got = _both(a)
    assert bool(got.job_placed[0]) is placed
    assert int(got.job_host[0]) == host
    assert got.preempted[:len(preempted)].int().tolist() == preempted


# -- tests/test_rebalance.py's randomized pools --------------------------

def _random_pool(seed, n_users=5, n_hosts=6, n_tasks=40, n_pend=6,
                 varied_shares=True, start=None):
    rng = np.random.default_rng(seed)
    shares = ({u: (float(rng.uniform(20, 60)), float(rng.uniform(5, 15)))
               for u in range(n_users)} if varied_shares
              else {u: (30.0, 10.0) for u in range(n_users)})
    tasks = [Task(id=i, user=int(rng.integers(0, n_users)),
                  mem=float(rng.integers(1, 20)),
                  cpus=float(rng.integers(1, 8)),
                  priority=int(rng.integers(0, 3)),
                  start_time=(int(rng.integers(0, 30)) if start is None
                              else i),
                  host=int(rng.integers(0, n_hosts)))
             for i in range(n_tasks)]
    pend = [Task(id=PENDING_ID_BASE + i, user=int(rng.integers(0, n_users)),
                 mem=float(rng.integers(1, 25)),
                 cpus=float(rng.integers(1, 10)),
                 priority=int(rng.integers(0, 3)), start_time=int(100 + i))
            for i in range(n_pend)]
    spare = {h: (float(rng.integers(0, 6)), float(rng.integers(0, 3)))
             for h in range(n_hosts)}
    return tasks, pend, shares, spare


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_equals_jax_and_oracle(seed):
    tasks, pend, shares, spare = _random_pool(seed)
    got = _both(_from_tasks(tasks, pend, shares, spare, 6, 5, safe=0.1,
                            min_diff=0.05))
    placements, victims = sequential_oracle(tasks, pend, shares, spare,
                                            0.1, 0.05, 6)
    assert [int(h) if p else None for p, h in
            zip(got.job_placed.tolist(), got.job_host.tolist())] \
        == placements
    placed_ids = [pend[i].id for i, h in enumerate(placements)
                  if h is not None]
    pre = got.preempted.numpy()
    got_victims = {i for i, v in enumerate(pre[:len(tasks)]) if v}
    got_victims |= {placed_ids[k] for k, v in enumerate(pre[len(tasks):])
                    if v and k < len(placed_ids)}
    assert got_victims == victims


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_candidate_cap_covering_all_equals_jax(seed):
    """candidate_cap = T - 1 engages the top-K path but keeps every
    candidate: equal to the exact sweep, and to JAX's capped one."""
    tasks, pend, shares, spare = _random_pool(
        seed, n_users=4, n_hosts=5, varied_shares=False, start="index")
    a = _from_tasks(tasks, pend, shares, spare, 5, 4, safe=0.1,
                    min_diff=0.05)
    T = len(tasks) + len(pend)
    capped = _both(a, candidate_cap=T - 1)
    _assert_same(capped, _run_jax(a))
    _both(a, candidate_cap=8)


# -- ties ----------------------------------------------------------------

def _tie_pool(U=20, per_user=50, H=16, P=6, seed=3):
    """U users with `per_user` identical tasks each and one share: the
    k-th task of every user has the same DRU, so each DRU value is shared
    by U candidates; pending jobs of a fresh user."""
    rng = np.random.default_rng(seed)
    tasks = [Task(id=u * per_user + k, user=u, mem=2.0, cpus=1.0,
                  priority=0, start_time=k,
                  host=int(rng.integers(0, H)))
             for u in range(U) for k in range(per_user)]
    shares = {u: (100.0, 50.0) for u in range(U + 1)}
    pend = [Task(id=PENDING_ID_BASE + i, user=U, mem=float(3 + i % 3),
                 cpus=float(1 + i % 2), priority=0, start_time=1000 + i)
            for i in range(P)]
    spare = {h: (0.5, 0.25) for h in range(H)}
    return _from_tasks(tasks, pend, shares, spare, H, U + 1, safe=0.1,
                       min_diff=0.05)


@pytest.mark.parametrize("cap", [30, 50, 64])
def test_candidate_cap_ties_at_the_cut_equal_jax(cap):
    """More candidates than candidate_cap share the DRU at the cut (20
    share each value; the caps fall inside a tie group): the kept set is
    lax.top_k's, lowest index first, and so are the placements."""
    a = _tie_pool()
    # at the first step every valid task is a candidate; its DRUs in
    # descending order tie across the cut
    mem = a["tasks"]["mem"][:1000].reshape(20, 50)
    dru = np.cumsum(mem, 1, dtype=np.float32) / np.float32(100.0)
    ranked = np.sort(dru.ravel())[::-1]
    assert (ranked == ranked[cap - 1]).sum() > 1
    assert ranked[cap - 1] == ranked[cap]
    got = _both(a, candidate_cap=cap)
    assert got.job_placed.any()


def test_topk_order_equals_lax_top_k():
    """The capped path's order: lax.top_k's (descending, ties lowest
    index first, +0.0 above -0.0), not torch.topk's."""
    import jax

    x = np.array([0.0, -0.0, 0.0, -0.0, 1.0, -np.inf, 1.0, -0.0, np.inf,
                  -3.4e38, 5.0, 1.0], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(x), x.shape[0])
    got = trb._topk_order(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decision_dru_tie_goes_to_last_host():
    """Three hosts each hold one task of DRU 1.0 (three users, equal
    shares): every host's decision ties, and the last host wins."""
    shares = {u: (10.0, 10.0) for u in range(4)}
    tasks = [Task(id=h, user=h, mem=10, cpus=10, host=h) for h in range(3)]
    pend = [Task(id=PENDING_ID_BASE, user=3, mem=5, cpus=5, start_time=9)]
    got = _both(_from_tasks(tasks, pend, shares, {}, 3, 4))
    assert bool(got.job_placed[0]) and int(got.job_host[0]) == 2
    assert got.preempted[:3].tolist() == [False, False, True]


# -- gpu mode: two extra lanes -------------------------------------------

def _gpu_pool(seed, T0=600, P=12, H=24, U=12):
    """A gpu-mode pool as coordinator.rebalance_cycle builds it: gpus in
    the mem lane, a zero cpus lane, the gpu share as the mem divisor, and
    the real (mem, cpus) as two feasibility lanes on tasks, pending jobs
    and spare."""
    rng = np.random.default_rng(seed)
    T = T0 + P
    gpus = np.concatenate([rng.integers(1, 4, T0), np.zeros(P)]) \
        .astype(np.float32)
    real = np.concatenate([
        np.stack([rng.uniform(1, 64, T0), rng.uniform(0.5, 16, T0)], -1),
        np.zeros((P, 2))]).astype(np.float32)
    t = dict(user=np.concatenate([rng.integers(0, U, T0),
                                  np.zeros(P)]).astype(np.int32),
             mem=gpus, cpus=np.zeros(T, np.float32),
             priority=rng.integers(0, 3, T).astype(np.int32),
             start_time=np.arange(T, dtype=np.int32),
             host=np.concatenate([rng.integers(0, H, T0),
                                  np.zeros(P)]).astype(np.int32),
             valid=np.arange(T) < T0,
             mem_share=rng.choice(np.float32([8, 16, 24]), T),
             cpus_share=np.full(T, 20.0, np.float32))
    p = dict(user=rng.integers(0, U, P).astype(np.int32),
             mem=rng.integers(1, 4, P).astype(np.float32),
             cpus=np.zeros(P, np.float32),
             priority=rng.integers(0, 3, P).astype(np.int32),
             start_time=(np.arange(P) + T).astype(np.int32),
             valid=rng.random(P) < 0.9,
             mem_share=rng.choice(np.float32([8, 16, 24]), P),
             cpus_share=np.full(P, 20.0, np.float32))
    p_real = np.stack([rng.uniform(1, 64, P), rng.uniform(0.5, 16, P)],
                      -1).astype(np.float32)
    spare_x = np.stack([rng.uniform(0, 16, H), rng.uniform(0, 4, H)],
                       -1).astype(np.float32)
    return dict(tasks=t, pending=p,
                spare_mem=rng.integers(0, 2, H).astype(np.float32),
                spare_cpus=np.zeros(H, np.float32),
                forb=rng.random((P, H)) < 0.1,
                qm=np.full(U, F32_BIG), qc=np.full(U, F32_BIG),
                qn=np.full(U, 2 ** 30, np.int32), safe=0.05, min_diff=0.01,
                extra=(real, p_real, spare_x))


@pytest.mark.parametrize("cap", [None, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_gpu_mode_extra_lanes_equal_jax(seed, cap):
    a = _gpu_pool(seed)
    got = _both(a, candidate_cap=cap)
    assert got.job_placed.any()


def test_extra_lanes_all_or_none():
    a = _gpu_pool(0)
    a["extra"] = (a["extra"][0], a["extra"][1], None)
    with pytest.raises(ValueError, match="extra feasibility lanes"):
        _run_port(a)


# -- quotas, and seeded pools at scale ----------------------------------

def _seeded_pool(seed, T0, P, H, U, quota_dtype=None):
    """bench.py::bench_rebalance's draws at a smaller size, with mixed
    priorities and start times; `quota_dtype` caps a third of the users'
    running count (f32 or i32 counts) and half their memory."""
    rng = np.random.default_rng(seed)
    T = T0 + P
    t = dict(user=np.concatenate([rng.integers(0, U, T0),
                                  np.zeros(P)]).astype(np.int32),
             mem=np.concatenate([rng.uniform(1, 10, T0),
                                 np.zeros(P)]).astype(np.float32),
             cpus=np.concatenate([rng.uniform(0.5, 4, T0),
                                  np.zeros(P)]).astype(np.float32),
             priority=rng.integers(0, 3, T).astype(np.int32),
             start_time=rng.integers(0, 500, T).astype(np.int32),
             host=np.concatenate([rng.integers(0, H, T0),
                                  np.zeros(P)]).astype(np.int32),
             valid=np.concatenate([rng.random(T0) < 0.95,
                                   np.zeros(P, bool)]),
             mem_share=np.full(T, 100.0, np.float32),
             cpus_share=np.full(T, 20.0, np.float32))
    p = dict(user=rng.integers(0, U, P).astype(np.int32),
             mem=rng.uniform(1, 10, P).astype(np.float32),
             cpus=rng.uniform(0.5, 4, P).astype(np.float32),
             priority=rng.integers(0, 3, P).astype(np.int32),
             start_time=(np.arange(P) + 600).astype(np.int32),
             valid=np.ones(P, bool),
             mem_share=np.full(P, 100.0, np.float32),
             cpus_share=np.full(P, 20.0, np.float32))
    qm = np.full(U, F32_BIG)
    qn = np.full(U, 2.0 ** 31, np.float32)
    if quota_dtype is not None:
        running = np.bincount(t["user"][:T0][t["valid"][:T0]], minlength=U)
        capped = rng.random(U) < 1 / 3
        qn = np.where(capped, running, 2 ** 30).astype(quota_dtype)
        usage = np.bincount(t["user"][:T0][t["valid"][:T0]],
                            t["mem"][:T0][t["valid"][:T0]], minlength=U)
        qm = np.where(rng.random(U) < 0.5, usage * 0.5, F32_BIG) \
            .astype(np.float32)
    return dict(tasks=t, pending=p,
                spare_mem=rng.uniform(0, 4, H).astype(np.float32),
                spare_cpus=rng.uniform(0, 2, H).astype(np.float32),
                forb=rng.random((P, H)) < 0.05, qm=qm,
                qc=np.full(U, F32_BIG), qn=qn, safe=0.5, min_diff=0.1)


@pytest.mark.parametrize("quota_dtype", [np.float32, np.int32])
def test_quota_blocked_users_equal_jax(quota_dtype):
    """A third of the users sit at their count quota (and half at half
    their memory): their jobs may only preempt their own tasks. The count
    quota as f32 (bench.py's) and as i32 (the coordinator's)."""
    a = _seeded_pool(5, T0=800, P=16, H=32, U=12, quota_dtype=quota_dtype)
    got = _both(a)
    free = _both(_seeded_pool(5, T0=800, P=16, H=32, U=12))
    assert not (torch.equal(got.job_host, free.job_host)
                and torch.equal(got.preempted, free.preempted))


@pytest.mark.parametrize("seed,T0,P,H,U,cap", [
    (0, 4000, 24, 64, 40, None), (1, 4000, 24, 64, 40, 512),
    (2, 2048, 32, 200, 100, None), (3, 1000, 8, 16, 500, 128)])
def test_seeded_pool_equals_jax(seed, T0, P, H, U, cap):
    """bench_rebalance's mix at up to 4,096 task slots, non-dyadic
    resources, exact and capped."""
    got = _both(_seeded_pool(seed, T0, P, H, U), candidate_cap=cap)
    assert got.job_placed.any()


def test_no_pending_jobs():
    a = _seeded_pool(0, T0=50, P=0, H=4, U=3)
    a["forb"] = np.zeros((0, 4), bool)
    _both(a)


@pytest.mark.parametrize("gpu", [False, True])
def test_bench_workload_equals_jax(gpu):
    """entry.rebalance_arrays, the workload bench_torch.py and
    chip_smoke.py run at T0=50k (bench.py::bench_rebalance's draws, and
    its gpu-mode layout), at a reduced size: exact and capped equal the
    JAX package's."""
    from cook_tpu_torch.entry import rebalance_arrays

    arrays, spare_x = rebalance_arrays(T0=3000, P=12, H=100, U=60, gpu=gpu)
    tasks, pend = dict(arrays[0]), dict(arrays[1])
    a = dict(tasks=tasks, pending=pend, spare_mem=arrays[2],
             spare_cpus=arrays[3], forb=arrays[4], qm=arrays[5],
             qc=arrays[6], qn=arrays[7], safe=0.5, min_diff=0.1)
    if gpu:
        a["extra"] = (tasks.pop("extra"), pend.pop("extra"), spare_x)
    assert _both(a).job_placed.any()
    _both(a, candidate_cap=256)
