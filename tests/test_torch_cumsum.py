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


@pytest.mark.parametrize("n,plan", [
    (1, ("one_cta", 1, 1)), (8192, ("one_cta", 1, 8192)),
    (16384, ("one_cta", 1, 16384)), (16385, ("cluster", 5, 4096)),
    (131072, ("cluster", 8, 16384)), (262144, ("cluster", 8, 32768)),
    (262145, ("cluster", 8, 36864)), (327680, ("cluster", 8, 40960)),
    (327681, ("global", 1, 327681))])
def test_blocked_cumsum_plan(n, plan):
    """The kernel's routes: one CTA a column on chip up to 16,384 rows, a
    cluster of <= 8 CTAs with chunks of whole 4,096-row blocks (<= 40,960
    rows, ~180 KB of shared memory) up to 327,680, device memory beyond;
    every chunk but the last is full and the last is not empty."""
    assert tseg.blocked_cumsum_plan(n) == plan
    route, ctas, chunk = plan
    if route == "cluster":
        assert chunk % 4096 == 0 and (ctas - 1) * chunk < n <= ctas * chunk


def _np_totals(a):
    """Block totals of a level: each 16 left to right from 0 (float32)."""
    nb = -(-len(a) // 16)
    pad = np.zeros(nb * 16, np.float32)
    pad[:len(a)] = a
    s = np.zeros(nb, np.float32)
    for j in range(16):
        s = s + pad[j::16]
    return s


def _np_down(a, prefix, has):
    """Each block's running sums from 0, plus its prefix where it has one
    (the running sum first)."""
    nb = -(-len(a) // 16)
    pad = np.zeros(nb * 16, np.float32)
    pad[:len(a)] = a
    run = np.zeros(nb, np.float32)
    out = np.zeros((nb, 16), np.float32)
    for j in range(16):
        run = run + pad[j::16]
        out[:, j] = np.where(has, run + prefix, run)
    return out.reshape(-1)[:len(a)]


def _np_scan(a):
    """The whole blocked scan of a level (the kernel's smem_scan)."""
    if len(a) <= 16:
        return _np_down(a, np.float32(0), False)
    up = _np_scan(_np_totals(a))
    nb = len(up)
    has = np.arange(nb) > 0
    prefix = np.concatenate([[np.float32(0)], up[:-1]]).astype(np.float32)
    return _np_down(a, prefix, has)


def _cluster_model(x, ctas, chunk):
    """The cluster route in numpy, step for step: CTA r's chunk, its local
    levels 1-2, every CTA's level-3 totals scanned as one top array, then
    levels 2, 1, 0 down with the previous CTA's last value of the level
    above as the first block's prefix."""
    q3 = chunk // 4096
    a = [x[r * chunk:(r + 1) * chunk] for r in range(ctas)]
    L1 = [_np_totals(v) for v in a]
    L2 = [_np_totals(v) for v in L1]
    top = _np_scan(np.concatenate([_np_totals(v) for v in L2]))
    out2, out1, out0 = [], [], []
    for r in range(ctas):
        B = r * q3 + np.arange(-(-len(L2[r]) // 16))
        prefix = np.where(B > 0, top[np.maximum(B - 1, 0)], 0)
        out2.append(_np_down(L2[r], prefix.astype(np.float32), B > 0))
    for lvl, above, dst in ((L1, out2, out1), (a, out1, out0)):
        for r in range(ctas):
            nb = -(-len(lvl[r]) // 16)
            prev = above[r - 1][-1] if r > 0 else np.float32(0)
            prefix = np.concatenate([[prev], above[r][:nb - 1]])
            has = (np.arange(nb) > 0) | (r > 0)
            dst.append(_np_down(lvl[r], prefix.astype(np.float32), has))
    return np.concatenate(out0)


@pytest.mark.parametrize("n", [16385, 20479, 20481, 131072, 262144, 262145])
def test_cluster_route_model_equals_plain(n):
    """The cluster route's split of the work (modelled above with the
    plan's CTAs and chunk) is bit-equal to blocked_cumsum_plain: a chunk
    edge moves where a value is computed, never its adds."""
    _, ctas, chunk = tseg.blocked_cumsum_plan(n)
    x = mixed(np.random.default_rng(n), (n,))
    want = tseg.blocked_cumsum_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(_cluster_model(x, ctas, chunk)),
                                  bits(want))
