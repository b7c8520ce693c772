"""Where the port sums demand exactly and the JAX package does not: the
quota filter of the fused cycle (cook_tpu_torch/ops/cycle.py::
exact_overage) and the rebalancer's cover test (cook_tpu_torch/ops/
rebalance.py::rebalance), both differences from the reference on
purpose.

The reference reads a running per-segment demand from an f32 cumsum
over every row less the segment's base. Far from the start of the scan
that difference loses the low bits: a user sorted behind 100,000 jobs
of 1-4 GB (~2.5e8 MB, where an f32 step is 16) reads its demand several
MB off, and a job that fits its quota exactly is refused, every cycle;
a host late in the rebalancer's host-major sequence reads its spare
plus a victim short of a job they cover. The port sums in int64 units
of 2^-24 (segments.fixed_units), so these cases decide as exact
arithmetic does, and everywhere the two tests agree the port equals the
reference (here, at the same scales, and in test_torch_cycle.py,
test_torch_rebalance.py and the e2e and server parity files).

Tolerances: none. The exact sums are checked against fractions.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from cook_tpu.ops import cycle as jcycle
from cook_tpu_torch import entry
from cook_tpu_torch.obs import decisions as why
from cook_tpu_torch.ops import cycle as tcycle
from cook_tpu_torch.ops import segments
from tests.test_torch_cycle import _jax_args, _torch_args, compare
from tests.test_torch_rebalance import _assert_same, _run_jax, _run_port

# -- the quota filter ----------------------------------------------------

N_OWN = 8


def quota_case(seed, P=100_000, U=500):
    """bench.py's headline backlog shape: P pending jobs of 1,024-4,096 MB
    (whole MB) over U users. The last user owns the last N_OWN rows,
    ranked first (a share of 1e9), and its mem quota is exactly the sum
    of its first six jobs; the filter's user-sorted scan puts the other
    users' ~2.5e8 MB ahead of it. Returns (arrays, its rows)."""
    arrays, _ = entry.cycle_arrays(R=64, Pn=P, H=64, U=U, seed=seed)
    rng = np.random.default_rng(seed)
    t = U - 1
    pu = arrays[8]
    pu[pu == t] = rng.integers(0, t, int((pu == t).sum()))
    own = np.arange(P - N_OWN, P)
    pu[own] = t
    arrays[0][arrays[0] == t] = 0          # no running task of its own
    arrays[9] = rng.integers(1024, 4097, P).astype(np.float32)
    arrays[14][:] = True
    arrays[12][own] = 0
    arrays[13][own] = np.arange(N_OWN)
    arrays[15][own] = arrays[16][own] = 1e9
    arrays[21][t] = arrays[9][own[:6]].astype(np.float64).sum()
    return arrays, own


def _cycle_both(arrays):
    ref = jcycle.rank_and_match(*_jax_args(arrays), num_considerable=256,
                                use_pallas=False)
    got = tcycle.rank_and_match(*_torch_args(arrays), num_considerable=256,
                                use_kernel=False)
    return ref, got


def _why(res, rows):
    idx = list(np.asarray(res.why_idx))
    code, amt = np.asarray(res.why_code), np.asarray(res.why_amt)
    return [int(code[idx.index(r)]) for r in rows], \
        [float(amt[idx.index(r)]) for r in rows]


def test_quota_filter_considers_an_exact_fit_behind_a_long_prefix():
    """Seed 1: the reference's f32 running demand puts the user's sixth
    job over a quota it meets exactly (QUOTA_MEM, a positive datum); the
    port considers it, and refuses the seventh with QUOTA_MEM and the
    reference's datum (the two tests agree there)."""
    arrays, own = quota_case(1)
    quota = Fraction(float(arrays[21][-1]))
    mem = [Fraction(float(m)) for m in arrays[9][own]]
    assert sum(mem[:6]) == quota
    ref, got = _cycle_both(arrays)
    assert np.asarray(ref.considerable)[own].tolist() == [True] * 5 + \
        [False] * 3
    assert got.considerable.numpy()[own].tolist() == [True] * 6 + \
        [False] * 2
    rcode, ramt = _why(ref, own)
    gcode, gamt = _why(got, own)
    assert rcode[5] == why.QUOTA_MEM and ramt[5] > 0
    assert gcode[5] in (why.MATCHED, why.NO_HOST_FIT)
    assert gcode[6:] == [why.QUOTA_MEM] * 2
    assert gamt[6] == ramt[6] > 0
    # the other users' jobs decide alike
    rest = ~np.isin(np.asarray(got.why_idx), own)
    np.testing.assert_array_equal(got.why_code.numpy()[rest],
                                  np.asarray(ref.why_code)[rest])


def test_quota_filter_equals_the_reference_where_the_sums_agree():
    """Seed 0, the same shape: the f32 reading errs on the safe side,
    both filters consider the first six jobs, and every field of the
    cycle equals the reference's."""
    arrays, own = quota_case(0)
    ref, got = _cycle_both(arrays)
    compare(ref, got)
    assert got.considerable.numpy()[own].tolist() == [True] * 6 + \
        [False] * 2


def _starts(seg):
    return segments.segment_start_index(
        segments.segment_starts(torch.from_numpy(seg)))


def _room(quota, usage):
    """Each row's floor((quota - usage) * 2^24), as rank_and_match gives
    it to exact_overage."""
    return segments.fixed_units(torch.from_numpy(quota).double()
                                - torch.from_numpy(usage).double(),
                                up=False)


def _segments(rng, n_seg, size, prefix):
    """Run-contiguous segment ids: a first segment of `prefix` rows, then
    n_seg segments of 1..size rows."""
    lens = [prefix] + rng.integers(1, size + 1, n_seg).tolist()
    return np.repeat(np.arange(len(lens)), lens).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_exact_overage_is_exact_arithmetic(seed):
    """exact_overage's sign against Fraction sums, for quotas set to the
    exact running demand of a row (a tie), one unit of 2^-24 either side
    of it, and at random, behind a prefix of ~1.6e8 MB; its datum keeps
    the f32 value where the signs agree and never contradicts the
    decision."""
    rng = np.random.default_rng(seed)
    seg = _segments(rng, 200, 12, 60_000)
    n = len(seg)
    dem = np.stack([rng.integers(1024, 4097, n),
                    rng.integers(1, 64, n) / 4], -1).astype(np.float32)
    dem[rng.random(n) < 0.1] = 0.0
    usage = (rng.integers(0, 64, (n, 2)) / 2).astype(np.float32)
    usage = usage[np.searchsorted(seg, seg)]        # one per segment
    run = np.zeros((n, 2), object)
    for i in range(n):
        prev = run[i - 1] if i and seg[i] == seg[i - 1] else (0, 0)
        run[i] = [prev[k] + Fraction(float(dem[i, k])) for k in range(2)]
    quota = np.zeros((n, 2), np.float32)
    for s in np.unique(seg)[1:]:
        rows = np.flatnonzero(seg == s)
        r = rng.choice(rows)
        for k in range(2):
            # whole MB and quarter cpus: every tie is an f32
            tie = np.float32(run[r, k] + Fraction(float(usage[r, k])))
            quota[rows, k] = rng.choice([
                tie, np.nextafter(tie, np.float32(np.inf)),
                np.nextafter(tie, np.float32(-np.inf)),
                tie + np.float32(rng.uniform(-50, 50))])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    cum = segments.segment_cumsum(t(dem), t(seg))
    over = t(usage) + cum - t(quota)
    got = tcycle.exact_overage(over, t(dem), _starts(seg),
                               _room(quota, usage)).numpy()
    f32 = over.numpy()
    want_over = np.array([[run[i, k] + Fraction(float(usage[i, k]))
                           > Fraction(float(quota[i, k]))
                           for k in range(2)] for i in range(n)])
    np.testing.assert_array_equal(got > 0, want_over)
    agree = (f32 > 0) == want_over
    np.testing.assert_array_equal(got[agree], f32[agree])
    # the f32 reading disagrees somewhere behind the prefix
    assert not agree[seg > 0].all()


def test_exact_overage_over_counts_small_off_grid_demands():
    """A demand below 0.5 off the 2^-24 grid counts as the next unit up
    (f32(0.1) as 1,677,722 units): three such jobs fit a quota a hair
    above their exact sum and an unset one (3.4e38, +inf), but are
    refused at the third against f32(0.3) and at the second against
    f32(0.2), which their exact sums meet (the over-count the rounding
    up accepts so that no job is admitted past its quota)."""
    d = np.float32(0.1)
    dem = np.full((3, 1), d, np.float32)
    seg = np.zeros(3, np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    exact = 3 * Fraction(float(d))
    assert exact <= Fraction(float(np.float32(0.3)))
    for q, want in ((np.float32(float(exact) + 1e-7), [False] * 3),
                    (np.float32(3.4e38), [False] * 3),
                    (np.float32(np.inf), [False] * 3),
                    (np.float32(0.3), [False, False, True]),
                    (np.float32(0.2), [False, True, True])):
        quota = np.full((3, 1), q, np.float32)
        usage = np.zeros((3, 1), np.float32)
        over = t(usage) + segments.segment_cumsum(t(dem), t(seg)) - t(quota)
        got = tcycle.exact_overage(over, t(dem), _starts(seg),
                                   _room(quota, usage))
        assert (got[:, 0] > 0).tolist() == want, (q, got)


# -- the rebalancer's cover test -----------------------------------------

REB_SEED, REB_P, REB_HOST = 0, 4, 1995
# job 0's mem: the f32 just below host 1995's spare plus its one
# candidate victim at step 0
REB_MEM_BITS = 1087935667


def rebalance_case(constructed):
    """bench.py::bench_rebalance's pool (entry.rebalance_arrays: 50,000
    running tasks, 2,000 hosts, 500 users) with REB_P pending jobs (the
    reference's sweep compiles a step a job: 64 take minutes on the
    CPU), as test_torch_rebalance.py's inputs. `constructed`: job 0 asks
    for REB_MEM_BITS of mem and 0.5 cpus, and may use host REB_HOST
    only."""
    arrays, _ = entry.rebalance_arrays(50_000, REB_P, 2_000, 500, REB_SEED)
    tasks, pending, sm, sc, forb, qm, qc, qn = arrays
    if constructed:
        pending["mem"][0] = np.int32(REB_MEM_BITS).view(np.float32)
        pending["cpus"][0] = 0.5
        forb[0] = True
        forb[0, REB_HOST] = False
    return dict(tasks=tasks, pending=pending, spare_mem=sm, spare_cpus=sc,
                forb=forb, qm=qm, qc=qc, qn=qn, safe=0.5, min_diff=0.1)


def test_rebalancer_places_a_job_its_victims_cover_exactly():
    """Host 1995 sits ~2,400 entries into the host-major sequence (~1e4
    MB in, where an f32 step is 2^-10). Its spare plus its one candidate
    cover job 0's mem with under 2^-21 to spare, but the reference's f32
    prefix reads them short, so it leaves the job unplaced; the port
    places it there, preempting that one task."""
    a = rebalance_case(True)
    want, got = _run_jax(a), _run_port(a)
    assert not bool(np.asarray(want.job_placed)[0])
    assert bool(got.job_placed[0]) and int(got.job_host[0]) == REB_HOST
    t, jmem = a["tasks"], Fraction(float(a["pending"]["mem"][0]))
    first = (got.preempted.numpy() & ~np.asarray(want.preempted)
             & (t["host"] == REB_HOST))
    assert first.sum() == 1
    cover = Fraction(float(a["spare_mem"][REB_HOST])) + \
        Fraction(float(t["mem"][first][0]))
    assert 0 <= cover - jmem < Fraction(1, 2 ** 21)


def test_rebalancer_equals_the_reference_on_bench_rebalance_pool():
    """The same pool as drawn: every cover test agrees with exact
    arithmetic, and the sweep equals the reference's bit for bit."""
    a = rebalance_case(False)
    got = _run_port(a)
    _assert_same(got, _run_jax(a))
    assert got.job_placed.any()
