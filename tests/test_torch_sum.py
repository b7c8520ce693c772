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


@pytest.mark.parametrize("n", [262145, 300000, 1048577])
def test_sum_ordered_past_the_one_cta_limit(n):
    """Past SUM_MAX (262,144, the one-CTA kernel's first level on chip)
    the plain version still takes XLA's order, and sum_ordered_plan names
    the levels the CUDA route reduces over many CTAs before the one-CTA
    kernel: the rest of the tree is that of the last level's windows."""
    rng = np.random.default_rng(n)
    x = mixed(rng, n)
    np.testing.assert_array_equal(
        bits(tseg.sum_ordered(torch.from_numpy(x)).numpy()),
        bits(np.asarray(_sum(x))))
    plan = tseg.sum_ordered_plan(n)
    assert plan and plan[0][0] == n and plan[-1][1] <= tseg.SUM_MAX
    windows = tseg.sum_windows(n)
    assert [(nb, lo) for _, nb, lo in plan] == windows[:len(plan)]
    assert tseg.sum_windows(plan[-1][1]) == windows[len(plan):]


def test_sum_ordered_plan_edges():
    assert tseg.sum_ordered_plan(tseg.SUM_MAX) == []
    assert tseg.sum_ordered_plan(tseg.SUM_MAX + 1) == [
        (tseg.SUM_MAX + 1, 8193, 15)]
    # two level launches once the first level's windows exceed SUM_MAX
    n = 32 * tseg.SUM_MAX + 1
    assert [m for m, _, _ in tseg.sum_ordered_plan(n)] == \
        [n, tseg.SUM_MAX + 1]
