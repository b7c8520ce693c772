"""The port's f32 sum (cook_tpu_torch/ops/segments.py::sum_ordered) against
`jax.jit(jnp.sum)` on XLA-CPU, and the dense round's window size
(cook_tpu_torch/ops/match.py::window_size) against the reference's
expression (cook_tpu/ops/match.py:636-649), on the CPU.

Tolerance: none. Every f32 result is compared bit for bit (as uint32, so
signed zeros count): this pins the association the port copies, jax
0.9.0's XLA-CPU reduction: the tree-reduction rewrite into windows of 32
(padding split evenly, the odd one at the end), each summed left to
right from 0, level after level until <= 32 values remain, summed the
same way; one element is returned as it is. If jax is upgraded, run this
file first: it says whether XLA's association moved. The CUDA kernel's
checks (bit-equal to the plain version, run to run) need the card:
tests/test_torch_isolation.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import match as tmatch
from cook_tpu_torch.ops import segments as tseg

# D at the batched cell (1,024), H (16,384), the test sizes, odd sizes,
# sizes around one window and one vector, a size with three levels
SIZES = [1, 2, 7, 8, 15, 16, 31, 32, 33, 63, 64, 65, 100, 300, 1000, 1023,
         1024, 1025, 4097, 16000, 16383, 16384, 16385, 100000]

_sum = jax.jit(lambda x: jnp.sum(x))
_sum_where = jax.jit(lambda m, x: jnp.sum(jnp.where(m, x, 0.0)))


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def mixed(rng, n):
    """f32 of magnitudes spread over 1e-3..1e3, both signs, a few -0.0."""
    x = (10.0 ** rng.uniform(-3, 3, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[::97] = -0.0
    return x


@pytest.mark.parametrize("form", ["sum", "sum_where"])
@pytest.mark.parametrize("n", SIZES)
def test_sum_ordered_bit_equal_to_jax(n, form):
    rng = np.random.default_rng(n * 3 + len(form))
    x = mixed(rng, n)
    if form == "sum":
        want = np.asarray(_sum(x))
        arg = torch.from_numpy(x)
    else:
        m = rng.random(n) < 0.8
        want = np.asarray(_sum_where(m, x))
        arg = torch.where(torch.from_numpy(m), torch.from_numpy(x), 0.0)
    fused_match.reset_launches()
    got = tseg.sum_ordered(arg)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert fused_match.LAUNCHES["sum_ordered"] == 0      # CPU: plain


def test_sum_ordered_signed_zeros_and_empty():
    """One element is returned as it is; a sum of several starts from
    +0.0; no element sums to +0.0 — as XLA."""
    for x in ([-0.0], [-0.0, -0.0], [-0.0] * 40, [0.0, -0.0]):
        a = np.asarray(x, np.float32)
        np.testing.assert_array_equal(
            bits(tseg.sum_ordered(torch.from_numpy(a)).numpy()),
            bits(np.asarray(_sum(a))))
    assert bits(tseg.sum_ordered(torch.zeros(0)).numpy()) == 0


@pytest.mark.parametrize("n,windows", [
    (32, []), (33, [(2, 15)]), (1000, [(32, 12)]), (1024, [(32, 0)]),
    (1025, [(33, 15), (2, 15)]), (16384, [(512, 0), (16, 0)]),
    (16385, [(513, 15), (17, 15)]),
    (100000, [(3125, 0), (98, 5), (4, 15)])])
def test_sum_windows(n, windows):
    """The tree levels (windows, front padding) match the reduce_window
    ops of the HLO XLA-CPU compiles for jnp.sum at these sizes."""
    assert tseg.sum_windows(n) == windows


def test_sum_ordered_rejects():
    with pytest.raises(TypeError, match="1-D float32"):
        tseg.sum_ordered(torch.ones(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="1-D float32"):
        tseg.sum_ordered(torch.ones((4, 2)))
    with pytest.raises(ValueError, match="unsupported device"):
        tseg.sum_ordered(torch.zeros(40, device="meta"))


@jax.jit
def _ref_window(in_use, c_mem, c_cpus, dense_usable, mem_left, cpus_left,
                N):
    """cook_tpu/ops/match.py:637-649, the reference's expression."""
    K = jnp.sum(dense_usable.astype(jnp.int32))
    n_cand = jnp.maximum(jnp.sum(in_use.astype(jnp.int32)), 1)
    mean_mem = jnp.maximum(
        jnp.sum(jnp.where(in_use, c_mem, 0.0)) / n_cand, 1e-6)
    mean_cpus = jnp.maximum(
        jnp.sum(jnp.where(in_use, c_cpus, 0.0)) / n_cand, 1e-6)
    absorb = jnp.sum(jnp.where(
        dense_usable,
        jnp.minimum(mem_left / mean_mem, cpus_left / mean_cpus), 0.0))
    W = K + jnp.minimum(absorb, N.astype(jnp.float32)).astype(jnp.int32)
    return mean_mem, mean_cpus, absorb, W


def _window_inputs(seed, near_integer):
    """D = 1,024 candidates x H = 16,384 hosts. `near_integer`: unit
    demands (mean 1.0 exactly) and memory-bound hosts of 0.1-0.7 free, so
    absorb is a sum of those values lying within ulps of an integer (the
    seeds are ones where PyTorch's CPU sum truncated to another W);
    otherwise a mixed workload."""
    rng = np.random.default_rng(seed)
    D, H = 1024, 16384
    in_use = rng.random(D) < 0.85
    usable = rng.random(H) < 0.9
    if near_integer:
        c_mem = np.ones(D, np.float32)
        c_cpus = np.ones(D, np.float32)
        mem_left = rng.choice(np.array([0.1, 0.2, 0.3, 0.7], np.float32), H)
        cpus_left = np.full(H, 100.0, np.float32)
    else:
        c_mem = rng.uniform(1, 48, D).astype(np.float32)
        c_cpus = rng.uniform(0.5, 12, D).astype(np.float32)
        mem_left = (rng.uniform(64, 256, H)
                    * rng.uniform(0, 1, H)).astype(np.float32)
        cpus_left = (rng.uniform(16, 64, H)
                     * rng.uniform(0, 1, H)).astype(np.float32)
    return in_use, c_mem, c_cpus, usable, mem_left, cpus_left


WINDOW_CASES = [(6, True), (9, True), (29, True), (142, True), (1, False),
                (2, False)]


@pytest.mark.parametrize("seed,near_integer", WINDOW_CASES)
def test_window_size_equals_reference(seed, near_integer):
    """mean_mem, mean_cpus, absorb bit-equal and W equal to the
    reference's on inputs where PyTorch's `sum` (the port's order before
    sum_ordered) gives other bits, and at the near-integer seeds another
    W (on the CPU this suite was written on, the old expression gave W =
    19,622 against the reference's 19,621 at seed 6, and differed at all
    four near-integer seeds)."""
    args = _window_inputs(seed, near_integer)
    N = 8192
    want = _ref_window(*[jnp.asarray(a) for a in args], jnp.int32(N))
    got = tmatch.window_size(*[torch.from_numpy(a) for a in args], N)
    for g, w, name in zip(got[:3], want[:3],
                          ("mean_mem", "mean_cpus", "absorb")):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w),
                                      err_msg=name)
    assert int(got[3]) == int(want[3])


def test_window_size_inputs_show_the_order():
    """The window cases are ones where the order matters: PyTorch's own
    f32 `sum` of absorb's terms differs from XLA's in its bits on most of
    them."""
    differ = 0
    for seed, near in WINDOW_CASES:
        in_use, c_mem, c_cpus, usable, mem_left, cpus_left = \
            _window_inputs(seed, near)
        mean_mem, mean_cpus, absorb, _ = _ref_window(
            in_use, c_mem, c_cpus, usable, mem_left, cpus_left,
            jnp.int32(8192))
        terms = torch.where(torch.from_numpy(usable), torch.minimum(
            torch.from_numpy(mem_left) / torch.tensor(np.array(mean_mem)),
            torch.from_numpy(cpus_left) / torch.tensor(
                np.array(mean_cpus))), 0.0)
        differ += bits(terms.sum().numpy()) != bits(np.asarray(absorb))
    assert differ >= 1


# the axis-0 sum of a (T, E) f32 array (the rebalancer's freed extra
# lanes, cook_tpu/ops/rebalance.py:308): T across the window and level
# boundaries and past the one-CTA kernel's 262,144
AXIS0_T = [1, 2, 31, 32, 33, 1000, 1024, 1025, 16385, 50064, 100000,
           262145, 300000]
_sum0 = jax.jit(lambda x: jnp.sum(x, 0))
_sum0_where = jax.jit(lambda m, x: jnp.sum(jnp.where(m[:, None], x, 0.0),
                                           0))


@pytest.mark.parametrize("E", [1, 2, 3])
@pytest.mark.parametrize("T", AXIS0_T)
def test_axis0_sum_is_the_1d_order_per_column(T, E):
    """XLA-CPU reduces each column of `jnp.sum(x, 0)` in the 1-D tree
    order (its HLO: reduce_window of 32x1 with the 1-D padding, level by
    level), so the port sums column by column with sum_ordered
    (rebalance.sum_cols_ordered), bit for bit; the `where` form as the
    rebalancer writes it too."""
    from cook_tpu_torch.ops import rebalance as trb

    rng = np.random.default_rng(T * 5 + E)
    x = mixed(rng, T * E).reshape(T, E)
    m = rng.random(T) < 0.7
    got = trb.sum_cols_ordered(torch.from_numpy(x))
    np.testing.assert_array_equal(bits(got.numpy()), bits(_sum0(x)))
    got = trb.sum_cols_ordered(torch.where(torch.from_numpy(m)[:, None],
                                           torch.from_numpy(x), 0.0))
    np.testing.assert_array_equal(bits(got.numpy()), bits(_sum0_where(m, x)))


def test_axis0_sum_no_columns():
    from cook_tpu_torch.ops import rebalance as trb

    assert trb.sum_cols_ordered(torch.zeros((7, 0))).shape == (0,)


@pytest.mark.parametrize("n", [262145, 300000, 1048577, 8388609])
def test_sum_ordered_past_the_one_cta_limit(n):
    """Past SUM_MAX (262,144, the one-CTA kernel's first level on chip)
    the plain version still takes XLA's order. Up to SUM_CLUSTER_MAX
    the CUDA route is one cluster launch (sum_ordered_plan names no
    level); beyond it sum_ordered_plan names the levels the "levels"
    route reduces over many CTAs first, and the rest of the tree is
    that of the last level's windows, summed by one launch."""
    rng = np.random.default_rng(n)
    x = mixed(rng, n)
    np.testing.assert_array_equal(
        bits(tseg.sum_ordered(torch.from_numpy(x)).numpy()),
        bits(np.asarray(_sum(x))))
    plan = tseg.sum_ordered_plan(n)
    windows = tseg.sum_windows(n)
    if n <= tseg.SUM_CLUSTER_MAX:
        assert plan == [] and tseg.sum_ordered_route(n) == \
            "sum_ordered/cluster"
        return
    assert plan and plan[0][0] == n and \
        tseg.SUM_MAX < plan[-1][1] <= tseg.SUM_CLUSTER_MAX
    assert [(nb, lo) for _, nb, lo in plan] == windows[:len(plan)]
    assert tseg.sum_windows(plan[-1][1]) == windows[len(plan):]
    assert tseg.sum_ordered_route(plan[-1][1]) == "sum_ordered/cluster"


def test_sum_ordered_plan_edges():
    assert tseg.sum_ordered_plan(tseg.SUM_MAX) == []
    assert tseg.sum_ordered_route(tseg.SUM_MAX) == "sum_ordered"
    # one cluster launch past the one-CTA kernel, up to SUM_CLUSTER_MAX
    assert tseg.sum_ordered_plan(tseg.SUM_MAX + 1) == []
    assert tseg.sum_ordered_route(tseg.SUM_MAX + 1) == "sum_ordered/cluster"
    assert tseg.SUM_CLUSTER_MAX == 32 * tseg.SUM_MAX
    assert tseg.sum_ordered_plan(tseg.SUM_CLUSTER_MAX) == []
    assert tseg.sum_ordered_route(tseg.SUM_CLUSTER_MAX) == \
        "sum_ordered/cluster"
    # beyond it a level launch first, then the cluster
    assert tseg.sum_ordered_plan(tseg.SUM_CLUSTER_MAX + 1) == [
        (tseg.SUM_CLUSTER_MAX + 1, tseg.SUM_MAX + 1, 15)]
    # two level launches once the first level's windows exceed
    # SUM_CLUSTER_MAX
    n = 32 * tseg.SUM_CLUSTER_MAX + 1
    assert [m for m, _, _ in tseg.sum_ordered_plan(n)] == \
        [n, tseg.SUM_CLUSTER_MAX + 1]


# the cluster route's lengths: the first past the one-CTA kernel, the
# 300k rebalance pool's T, the route's largest
CLUSTER_N = [tseg.SUM_MAX + 1, 300064, tseg.SUM_CLUSTER_MAX]


@pytest.mark.parametrize("ctas", tseg.SUM_CLUSTER_CTAS)
@pytest.mark.parametrize("n", CLUSTER_N)
def test_sum_cluster_ranges_cover_every_level1_window(n, ctas):
    """The cluster's CTAs own contiguous level-1 windows that cover
    every window of sum_windows' second level once, in order (CTA 0's
    shared memory then holds every level-1 sum: at most 8,192, and at
    most 1,024 a CTA)."""
    nb1 = tseg.sum_windows(n)[1][0]
    ranges = tseg.sum_cluster_ranges(n, ctas)
    assert len(ranges) == ctas and ranges[0][0] == 0
    assert ranges[-1][1] == nb1 <= 8192
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert a <= b == c
    assert max(b - a for a, b in ranges) <= 8192 // 8


def _cluster_sum_model(x, ctas):
    """The cluster kernel's order in numpy f32, step for step: level-0
    window sums of 32 elements (the padding split as sum_windows says),
    each CTA's level-1 windows summed from its range of level-0 sums
    (padding windows count as -0.0), the level-1 sums gathered in CTA
    0, which sums the levels above them a window at a time and the last
    <= 32 values left to right, each from +0.0."""
    def level(v, lo, nb):
        pad = np.full(nb * 32, -0.0, np.float32)
        pad[lo:lo + len(v)] = v
        w = pad.reshape(nb, 32)
        acc = np.zeros(nb, np.float32)
        for j in range(32):
            acc = (acc + w[:, j]).astype(np.float32)
        return acc

    n = len(x)
    (nb0, lo0), (nb1, lo1) = tseg.sum_windows(n)[:2]
    s0 = level(x, lo0, nb0)
    l1 = np.empty(nb1, np.float32)
    for a, b in tseg.sum_cluster_ranges(n, ctas):
        for b1 in range(a, b):
            acc = np.float32(0.0)
            for i in range(32):
                b0 = 32 * b1 - lo1 + i
                acc = np.float32(acc + (s0[b0] if 0 <= b0 < nb0
                                        else np.float32(-0.0)))
            l1[b1] = acc
    v = l1
    for nb, lo in tseg.sum_windows(nb1):
        v = level(v, lo, nb)
    acc = np.float32(0.0)
    for e in v:
        acc = np.float32(acc + e)
    return acc


@pytest.mark.parametrize("ctas", tseg.SUM_CLUSTER_CTAS)
@pytest.mark.parametrize("n", CLUSTER_N)
def test_cluster_sum_model_equals_plain(n, ctas):
    """The cluster kernel's order (modelled above, 8 or 16 CTAs) is the
    plain version's, bit for bit: the split over CTAs changes no
    addition."""
    x = mixed(np.random.default_rng(n + ctas), n)
    want = tseg.sum_ordered_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(_cluster_sum_model(x, ctas)),
                                  bits(want))
