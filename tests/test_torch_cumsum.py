"""The port's f32 prefix sum (cook_tpu_torch/ops/segments.py::cumsum0,
`blocked_cumsum`) against `jax.jit(jnp.cumsum)` on XLA-CPU, on the CPU.

Tolerance: none. Every f32 result is compared bit for bit (as uint32,
so signed zeros count): this pins the association the port copies,
jax 0.9.0's XLA-CPU `reduce_window` cumsum, a blocked scan with base 16.
Integer inputs keep torch.cumsum (exact in any order); any other float
dtype raises. The CUDA kernel's checks (bit-equal to the plain version,
and from run to run) need the card: tests/test_torch_isolation.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cook_tpu.ops import segments as jseg
from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import segments as tseg

SIZES = [1, 15, 16, 17, 255, 256, 257, 4097, 22000, 262144]
COLS = [None, 2, 3]     # None: 1-D

_jax_cumsum = jax.jit(lambda a: jnp.cumsum(a, axis=0))


def mixed(rng, shape):
    """f32 of magnitudes spread over 1e-3..1e3, both signs, and a few
    negative zeros."""
    x = (10.0 ** rng.uniform(-3, 3, shape)
         * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    x.reshape(-1)[::97] = -0.0
    return x


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("cols", COLS)
@pytest.mark.parametrize("n", SIZES)
def test_cumsum0_bit_equal_to_jax(n, cols):
    rng = np.random.default_rng(n * 10 + (cols or 1))
    x = mixed(rng, (n,) if cols is None else (n, cols))
    want = np.asarray(_jax_cumsum(x))
    fused_match.reset_launches()
    got = tseg.cumsum0(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    assert fused_match.LAUNCHES["blocked_cumsum"] == 0   # CPU: plain


def test_blocked_cumsum_strided_and_segmented():
    """A strided column view scans like its contiguous copy, and
    segment_cumsum (global scan minus the sum before the segment) is
    bit-equal to the reference's at a real backlog's size."""
    rng = np.random.default_rng(5)
    x = mixed(rng, (22000, 4))
    view = torch.from_numpy(x)[:, 1:3]
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        bits(tseg.blocked_cumsum(view).numpy()),
        bits(tseg.blocked_cumsum(view.contiguous()).numpy()))
    seg = np.sort(rng.integers(0, 300, 22000)).astype(np.int32)
    vals = np.abs(x[:, :2])
    np.testing.assert_array_equal(
        bits(tseg.segment_cumsum(torch.from_numpy(vals),
                                 torch.from_numpy(seg)).numpy()),
        bits(np.asarray(jseg.segment_cumsum(jnp.asarray(vals),
                                            jnp.asarray(seg)))))


@pytest.mark.parametrize("n,levels", [(1, []), (16, []), (17, [2]),
                                      (262144, [16384, 1024, 64, 4])])
def test_blocked_cumsum_scratch(n, levels):
    """The kernel's per-column scratch holds each level's block totals."""
    assert tseg.blocked_cumsum_scratch(n) == sum(levels)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("cols", [None, 3])
def test_cumsum0_integers_unchanged(dtype, cols):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(-5, 9, (300,) if cols is None
                                      else (300, cols))).to(dtype)
    got = tseg.cumsum0(x)
    assert got.dtype == dtype
    assert torch.equal(got, torch.cumsum(x, dim=0, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16,
                                   torch.bfloat16])
def test_cumsum0_other_floats_raise(dtype):
    with pytest.raises(TypeError, match="float32 only"):
        tseg.cumsum0(torch.ones(40, dtype=dtype))
