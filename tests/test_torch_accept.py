"""The batched matcher's accept step (cook_tpu_torch/ops/match.py::
compute_accept) where the port differs from the JAX package on purpose.

The reference tests a bid's running demand on its host with an f32
cumsum over every bidder less the segment's base (cook_tpu/ops/match.py
compute_accept_g, segments.segment_cumsum); at a large running total
the difference loses the low bits and a host can take a bid that does
not fit. The port keeps that test, bit for bit (its segment_cumsum is
held to JAX's here), and also demands `fits_exact`: the running demand
counted exactly in int64. So the port accepts a subset of what the
reference accepts, and only drops bids that overcommit a host by more
than 1e-6. tests/test_torch_rounds.py, test_torch_cycle.py and the
e2e/server parity files hold the two equal on their data, where no bid
sits in that margin.

Tolerances: none; every sum here is exact or compared exactly.
"""
import json
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cook_tpu.ops import segments as jsegments
from cook_tpu_torch.ops import match as tmatch
from cook_tpu_torch.ops import segments as tsegments


def accept_state(mem_left, cpus_left, gpus_left=None, slots=1000):
    H = len(mem_left)
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    return (torch.full((1,), -1, dtype=torch.int32), f(mem_left),
            f(cpus_left), f(np.zeros(H) if gpus_left is None else gpus_left),
            torch.full((H,), slots, dtype=torch.int32),
            torch.zeros((1, H), dtype=torch.bool))


def accept(state, choice, cpus, mem=None):
    n = len(choice)
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    return tmatch.compute_accept(
        state, torch.tensor(choice, dtype=torch.int64),
        torch.ones(n, dtype=torch.bool),
        f(np.ones(n) if mem is None else mem), f(cpus), f(np.zeros(n)),
        torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
        1)


def cancellation_case():
    """8,192 bids of 2 cpus on host 0 (a running total of 16,384, where
    an f32 step is 2^-9), then two bids on host 1, which has 1 cpu left:
    0.5 and 0.5 + 2^-12. Together they overcommit host 1 by 2^-12, but
    16,384.5 + (0.5 + 2^-12) rounds to 16,385 and the base is 16,384."""
    n0 = 8192
    cpus = np.concatenate([np.full(n0, 2.0), [0.5, 0.5 + 2.0 ** -12]])
    choice = [0] * n0 + [1, 1]
    state = accept_state(mem_left=[1e9, 1e9], cpus_left=[1.0, 1.0])
    return state, choice, cpus.astype(np.float32)


def test_reference_prefix_lets_the_overcommit_through():
    """Both packages' segment_cumsum put the second bid on host 1 at
    exactly 1.0 cpus, its capacity, bit for bit: the reference's fit
    test passes it."""
    _, choice, cpus = cancellation_case()
    seg = np.asarray(choice, np.int32)
    want = np.asarray(jsegments.segment_cumsum(jnp.asarray(cpus),
                                               jnp.asarray(seg)))
    got = tsegments.segment_cumsum(torch.tensor(cpus),
                                   torch.tensor(seg)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == np.float32(1.0)
    assert math.fsum(float(c) for c in cpus[-2:]) > 1.0 + 1e-6


def test_port_refuses_the_overcommitting_bid():
    state, choice, cpus = cancellation_case()
    acc = accept(state, choice, cpus).numpy()
    assert acc[-2] and not acc[-1]
    # the host-0 bids that fit (half a cpu of capacity: none) stay out
    assert not acc[:-2].any()


def test_port_accepts_an_exact_fill():
    """Bids that fill a host exactly, dyadic or not, are accepted."""
    state = accept_state(mem_left=[1e9, 1e9], cpus_left=[1.0, 3.3])
    cpus = np.asarray([0.5, 0.5, 1.1, 1.1, 1.1], np.float32)
    acc = accept(state, [0, 0, 1, 1, 1], cpus).numpy()
    assert acc.all()


@pytest.mark.parametrize("seed", range(6))
def test_fits_exact_equals_an_exact_sum(seed):
    """fits_exact against math.fsum of the f32 demands, segment by
    segment, on demands spread over [0.5, 64] and [0, 2^-10] (off the
    2^-24 grid, where rounding up may count one unit too many a row)."""
    rng = np.random.default_rng(seed)
    n, H = 600, 23
    host = np.sort(rng.integers(0, H, n))
    small = rng.random(n) < 0.2
    v = np.where(small[:, None], rng.random((n, 2)) * 2.0 ** -10,
                 rng.uniform(0.5, 64, (n, 2))).astype(np.float32)
    left_h = rng.uniform(0, 400, (H, 2)).astype(np.float32)
    # some hosts' mem capacity is a running sum of their own bids
    run = np.zeros(2)
    for i in range(n):
        run = run + v[i] if i and host[i] == host[i - 1] else v[i].astype(
            np.float64)
        if rng.random() < 0.1:
            left_h[host[i], 0] = np.float32(run[0])
    left = left_h[host]
    got = tmatch.fits_exact(torch.tensor(v), torch.tensor(host),
                            torch.tensor(left)).numpy()
    want = np.empty(n, bool)
    slack = np.zeros(n, bool)
    for i in range(n):
        seg = [j for j in range(i + 1) if host[j] == host[i]]
        ok, near = True, False
        for k in range(2):
            total = math.fsum(float(v[j, k]) for j in seg)
            cap = float(left[i, k]) + 1e-6
            ok &= total <= cap
            near |= abs(total - cap) <= len(seg) * 2.0 ** -24
        want[i], slack[i] = ok, near
    assert 50 < want.sum() < n - 50 and slack.sum() < n // 10
    assert (got == want)[~slack].all()
    # rounding up never lets a sum past its capacity through
    assert not (got & ~want).any()


def test_accept_check_runs_both_arms(capsys):
    """`python -m cook_tpu_torch.accept_check` at a toy shape on the CPU:
    a line per run, the pair's first differing cycle, and the jobs
    launched twice per arm; the batched matcher at 3,000 x 200 launches
    the same in both arms, no job twice."""
    from cook_tpu_torch import accept_check

    accept_check.main(["--device", "cpu", "--pairs", "1", "--mode",
                       "inline", "--cycles", "3", "--P0", "3000", "--H",
                       "200", "--U", "40"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r["arm"] for r in lines[:2]] == ["exact", "prefix_only"]
    assert lines[0]["launched"] == lines[1]["launched"] > 0
    assert lines[2] == {"first_differing_cycle": None, "cycles": 4}
    assert lines[3] == {"launched_twice": {"exact": [0],
                                           "prefix_only": [0]}}
