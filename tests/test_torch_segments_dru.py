"""The port's segment scans and DRU ranking (cook_tpu_torch/ops/segments.py,
ops/dru.py) against the JAX package and tests/oracles.py, on the CPU.

Tolerances: `order`/`rank` and integer outputs exact; `dru` within
rtol=1e-6 (XLA-CPU's cumsum may associate differently from
torch.cumsum). The exact-rank tests also run on dyadic inputs
(multiples of 1/8, small magnitudes), where every summation order is
exact, so the orders must agree there whatever the association.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cook_tpu.ops import dru as jdru
from cook_tpu.ops import segments as jseg
from cook_tpu_torch.ops import dru as tdru
from cook_tpu_torch.ops import segments as tseg
from tests.oracles import Task, dru_rank_oracle, gpu_dru_rank_oracle


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_ops_equal_jax(seed):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, 12, 200)).astype(np.int32)
    vals = rng.uniform(0, 5, (200, 2)).astype(np.float32)
    ivals = rng.integers(0, 9, 200).astype(np.int32)
    np.testing.assert_array_equal(_n(tseg.segment_starts(_t(seg))),
                                  _n(jseg.segment_starts(jnp.asarray(seg))))
    np.testing.assert_array_equal(
        _n(tseg.segment_cumsum(_t(ivals), _t(seg))),
        _n(jseg.segment_cumsum(jnp.asarray(ivals), jnp.asarray(seg))))
    # global cumsum minus the sum before the segment: the error of a
    # differently associated f32 cumsum is a few ulps of the GLOBAL
    # running total (~500 here, ulp 3.1e-5), not of the segment's sum
    np.testing.assert_allclose(
        _n(tseg.segment_cumsum(_t(vals), _t(seg))),
        _n(jseg.segment_cumsum(jnp.asarray(vals), jnp.asarray(seg))),
        rtol=0, atol=2e-4)
    dy = (vals * 8).round() / 8    # dyadic: every order is exact
    np.testing.assert_array_equal(
        _n(tseg.segment_cumsum(_t(dy), _t(seg))),
        _n(jseg.segment_cumsum(jnp.asarray(dy), jnp.asarray(seg))))
    np.testing.assert_array_equal(
        _n(tseg.segment_rank(_t(seg))),
        _n(jseg.segment_rank(jnp.asarray(seg))))
    assert tseg.segment_rank(_t(seg)).dtype == torch.int32


@pytest.mark.parametrize("n,nseg,k", [(1, 1, 1), (7, 3, 2), (200, 12, 2),
                                      (1000, 40, 3), (4096, 1, 1)])
def test_segment_sum_scan_is_a_segmented_inclusive_sum(n, nseg, k):
    """segment_sum_scan against JAX's segment_cumsum on dyadic inputs
    (exact in every order), and within rtol 1e-6 of f64 segmented sums
    otherwise: its error is a few ulps of the segment's own sum (at most
    ceil(log2 n) roundings of positive terms), not of the global total."""
    rng = np.random.default_rng(n)
    seg = np.sort(rng.integers(0, nseg, n)).astype(np.int64)
    vals = rng.uniform(0, 5, (n, k)).astype(np.float32)
    if k == 1:
        vals = vals[:, 0]
    dy = (vals * 8).round() / 8
    np.testing.assert_array_equal(
        _n(tseg.segment_sum_scan(_t(dy), _t(seg))),
        _n(jseg.segment_cumsum(jnp.asarray(dy), jnp.asarray(seg))))
    ref = np.zeros(vals.shape, np.float64)
    for s in np.unique(seg):
        m = seg == s
        ref[m] = np.cumsum(vals[m].astype(np.float64), axis=0)
    got = tseg.segment_sum_scan(_t(vals), _t(seg))
    assert got.dtype == torch.float32 and got.shape == vals.shape
    np.testing.assert_allclose(_n(got), ref, rtol=1e-6)


def _rank_inputs(seed, n=400, U=9, dyadic=False):
    rng = np.random.default_rng(seed)
    if dyadic:
        mem = (rng.integers(1, 64, n) / 8).astype(np.float32)
        cpus = (rng.integers(1, 32, n) / 8).astype(np.float32)
        gpus = (rng.integers(0, 4, n) / 2).astype(np.float32)
        ms = np.full(n, 64.0, np.float32)
        cs = np.full(n, 16.0, np.float32)
        gs = np.full(n, 8.0, np.float32)
    else:
        mem = rng.uniform(1, 10, n).astype(np.float32)
        cpus = rng.uniform(0.5, 4, n).astype(np.float32)
        gpus = rng.uniform(0, 2, n).astype(np.float32)
        ms = rng.uniform(50, 150, U).astype(np.float32)
        cs = rng.uniform(10, 30, U).astype(np.float32)
        gs = rng.uniform(2, 8, U).astype(np.float32)
    user = rng.integers(0, U, n).astype(np.int32)
    if not dyadic:
        ms, cs, gs = ms[user], cs[user], gs[user]
    prio = rng.integers(0, 3, n).astype(np.int32)
    start = rng.integers(0, 50, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return dict(user=user, mem=mem, cpus=cpus, gpus=gpus, prio=prio,
                start=start, valid=valid, ms=ms, cs=cs, gs=gs)


def _check_ranked(ref, got, exact_dru, total=0.0, share=1.0):
    np.testing.assert_array_equal(_n(got.order), _n(ref.order))
    np.testing.assert_array_equal(_n(got.rank), _n(ref.rank))
    if exact_dru:
        np.testing.assert_array_equal(_n(got.dru), _n(ref.dru))
    else:
        # a user's cumulative sum is a difference of two GLOBAL running
        # totals, so a differently associated f32 cumsum moves it by a
        # few ulps of the global total, divided by the share
        atol = 8 * np.spacing(np.float32(total)) / share
        np.testing.assert_allclose(_n(got.dru), _n(ref.dru), rtol=1e-6,
                                   atol=atol)
    assert got.order.dtype == torch.int32 and got.rank.dtype == torch.int32


@pytest.mark.parametrize("seed,dyadic", [(0, True), (1, True), (2, False)])
def test_dru_rank_equals_jax(seed, dyadic):
    d = _rank_inputs(seed, dyadic=dyadic)
    args = [d[k] for k in ("user", "mem", "cpus", "prio", "start", "valid",
                           "ms", "cs")]
    ref = jdru.dru_rank(*[jnp.asarray(a) for a in args])
    got = tdru.dru_rank(*[_t(a) for a in args])
    _check_ranked(ref, got, exact_dru=dyadic, total=d["mem"].sum(),
                  share=min(d["ms"].min(), d["cs"].min()))


def test_dru_rank_at_scale_differs_only_at_near_ties():
    """At the size of a real backlog (22,000 tasks of 100 users, the
    resident workload's shares) the differently associated f32 cumsum
    flips the queue order of jobs whose scores tie to within a few ulps
    of the global totals: the port's order is then still a sort of the
    reference's scores up to that tolerance, and vice versa."""
    rng = np.random.default_rng(12)
    n, U = 22_000, 100
    user = rng.integers(0, U, n).astype(np.int32)
    mem = rng.uniform(1, 10, n).astype(np.float32)
    cpus = rng.uniform(0.5, 4, n).astype(np.float32)
    args = [user, mem, cpus, rng.integers(0, 3, n).astype(np.int32),
            rng.integers(0, 200, n).astype(np.int32), rng.random(n) < 0.95,
            np.full(n, 1000.0, np.float32), np.full(n, 200.0, np.float32)]
    ref = jdru.dru_rank(*[jnp.asarray(a) for a in args])
    got = tdru.dru_rank(*[_t(a) for a in args])
    tol = 8 * max(np.spacing(np.float32(mem.sum())) / 1000.0,
                  np.spacing(np.float32(cpus.sum())) / 200.0)
    rd, gd = _n(ref.dru), _n(got.dru)
    valid = args[5]
    np.testing.assert_allclose(gd[valid], rd[valid], rtol=0, atol=tol)
    for order, scores in ((_n(got.order), rd), (_n(ref.order), gd)):
        s = scores[order][valid[order]]
        assert (np.maximum.accumulate(s) - s).max() <= tol


@pytest.mark.parametrize("seed,dyadic", [(3, True), (4, False)])
def test_gpu_dru_rank_equals_jax(seed, dyadic):
    d = _rank_inputs(seed, dyadic=dyadic)
    args = [d[k] for k in ("user", "gpus", "prio", "start", "valid", "gs")]
    ref = jdru.gpu_dru_rank(*[jnp.asarray(a) for a in args])
    got = tdru.gpu_dru_rank(*[_t(a) for a in args])
    _check_ranked(ref, got, exact_dru=dyadic, total=d["gpus"].sum(),
                  share=d["gs"].min())


def _oracle_tasks(seed, n=120, U=6):
    rng = np.random.default_rng(seed)
    tasks = [Task(id=i, user=int(rng.integers(0, U)),
                  mem=float(rng.integers(1, 64)) / 8,
                  cpus=float(rng.integers(1, 16)) / 8,
                  gpus=float(rng.integers(0, 3)),
                  priority=int(rng.integers(0, 3)),
                  start_time=int(rng.integers(0, 20)))
             for i in range(n)]
    shares = {u: (64.0, 8.0) for u in range(U)}
    return tasks, shares


def _task_tensors(tasks, shares, pad_to):
    n = len(tasks)
    user = np.zeros(pad_to, np.int32)
    mem, cpus, gpus = (np.zeros(pad_to, np.float32) for _ in range(3))
    prio, start = np.zeros(pad_to, np.int32), np.zeros(pad_to, np.int32)
    valid = np.zeros(pad_to, bool)
    ms = np.full(pad_to, np.float32(3.4e38))
    cs = np.full(pad_to, np.float32(3.4e38))
    for i, t in enumerate(tasks):
        user[i], mem[i], cpus[i], gpus[i] = t.user, t.mem, t.cpus, t.gpus
        prio[i], start[i], valid[i] = t.priority, t.start_time, True
        ms[i], cs[i] = shares[t.user]
    assert n <= pad_to
    return user, mem, cpus, gpus, prio, start, valid, ms, cs


@pytest.mark.parametrize("seed", [0, 1])
def test_dru_rank_matches_oracle(seed):
    tasks, shares = _oracle_tasks(seed)
    user, mem, cpus, _, prio, start, valid, ms, cs = _task_tensors(
        tasks, shares, 128)
    got = tdru.dru_rank(_t(user), _t(mem), _t(cpus), _t(prio), _t(start),
                        _t(valid), _t(ms), _t(cs))
    oracle = dru_rank_oracle(tasks, shares)
    # dyadic inputs: the f32 kernel and the f64 oracle agree exactly
    assert [t.id for t, _ in oracle] == _n(got.order)[:len(tasks)].tolist()
    for t, d in oracle:
        assert float(got.dru[t.id]) == pytest.approx(d, rel=1e-6)
    assert set(_n(got.order)[len(tasks):]) == set(range(len(tasks), 128))


def test_gpu_dru_rank_matches_oracle():
    tasks, _ = _oracle_tasks(7)
    gshares = {u: 4.0 for u in range(6)}
    user, _, _, gpus, prio, start, valid, _, _ = _task_tensors(
        tasks, {u: (64.0, 8.0) for u in range(6)}, len(tasks))
    gs = np.full(len(tasks), 4.0, np.float32)
    got = tdru.gpu_dru_rank(_t(user), _t(gpus), _t(prio), _t(start),
                            _t(valid), _t(gs))
    oracle = gpu_dru_rank_oracle(tasks, gshares)
    assert [t.id for t, _ in oracle] == _n(got.order).tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_limit_over_quota_and_unsorted_rank_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    qu = rng.integers(0, 7, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    quota = rng.integers(0, 60, n).astype(np.int32)
    running = rng.integers(0, 30, n).astype(np.int32)
    np.testing.assert_array_equal(
        _n(tdru.segment_rank_unsorted(_t(qu))),
        _n(jdru.segment_rank_unsorted(jnp.asarray(qu))))
    ref = jdru.limit_over_quota(jnp.asarray(qu), jnp.asarray(valid),
                                jnp.asarray(quota), jnp.asarray(running),
                                over_quota_allowance=5)
    got = tdru.limit_over_quota(_t(qu), _t(valid), _t(quota), _t(running),
                                over_quota_allowance=5)
    np.testing.assert_array_equal(_n(got), _n(ref))


def test_lexsort_equals_numpy():
    rng = np.random.default_rng(4)
    keys = [rng.integers(0, 4, 500), rng.integers(0, 3, 500),
            rng.uniform(0, 1, 500).round(1)]
    np.testing.assert_array_equal(
        _n(tdru.lexsort([_t(k) for k in keys])), np.lexsort(keys))
