"""The port's f32 scatter-add (cook_tpu_torch/ops/segments.py::
scatter_add_ordered_, the ordered_scatter kernel's function) against
XLA-CPU's, bit for bit: `jax.ops.segment_sum` (the batched matcher's host
depletion and the quota usage sums of the JAX package) and
`.at[idx].add(mode="drop")` (its resident credit scatter).

XLA-CPU adds each update to its target one at a time in update order;
the port adds in that order on every device. Inputs are non-dyadic, of
mixed signs and magnitudes 10**U(-3, 3), so any other order shows in the
last bits. Half the updates go to three hot targets; indices fall
outside [0, T) on both sides (segment_sum drops them; `.at[]` wraps a
negative index, so its cases use none). If jax is upgraded, run this
file first: it says whether XLA's scatter order moved.

Tolerance: none (bit-equal).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cook_tpu_torch.ops import fused_match
from cook_tpu_torch.ops import segments as tseg

NS = (1, 7, 2048, 8192, 32768)
TS = (1, 300, 500, 16384)


def _inputs(n, T, k, low, seed):
    rng = np.random.default_rng(seed)
    shape = (n,) if k == 1 else (n, k)
    vals = (10.0 ** rng.uniform(-3, 3, shape)
            * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    hot = rng.integers(0, T, 3)
    idx = np.where(rng.random(n) < 0.5, rng.choice(hot, n),
                   rng.integers(low, T + 3, n)).astype(np.int32)
    return idx, vals


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("n", NS)
def test_segment_sum_order_equals_xla(n, T):
    """scatter_add_ordered_ from zeros == jax.ops.segment_sum, 1-D and
    (n, 3) values, negative and >= T indices dropped."""
    for k in (1, 3):
        idx, vals = _inputs(n, T, k, -2, seed=n * 7 + T + k)
        ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx),
                                  num_segments=T)
        got = tseg.scatter_add_ordered_(
            torch.zeros(ref.shape), torch.from_numpy(idx),
            torch.from_numpy(vals))
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref),
                                      err_msg=f"k={k}")


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("n", NS)
def test_at_add_order_equals_xla(n, T):
    """scatter_add_ordered_ onto a base == base.at[idx].add(v,
    mode="drop"), 1-D and (n, 3), indices >= T dropped; -0.0 in the base
    survives where nothing lands."""
    for k in (1, 3):
        idx, vals = _inputs(n, T, k, 0, seed=n * 11 + T + k)
        rng = np.random.default_rng(n + T + k)
        base = (rng.uniform(-50, 50, (T,) if k == 1 else (T, k))
                .astype(np.float32))
        base.reshape(-1)[::7] = -0.0
        ref = jnp.asarray(base).at[jnp.asarray(idx)].add(jnp.asarray(vals),
                                                         mode="drop")
        got = tseg.scatter_add_ordered_(torch.from_numpy(base.copy()),
                                        torch.from_numpy(idx),
                                        torch.from_numpy(vals))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref),
                                      err_msg=f"k={k}")


def test_in_place_on_a_view_and_cpu_launches_nothing():
    """scatter_add_ordered_ adds into the tensor it is given (the
    resident credit lanes pass a view without their sink slot); on CPU
    tensors it runs the plain version and counts no launch."""
    idx, vals = _inputs(2048, 300, 1, 0, seed=3)
    lane = torch.zeros(301)
    fused_match.reset_launches()
    out = tseg.scatter_add_ordered_(lane[:-1], torch.from_numpy(idx),
                                    torch.from_numpy(vals))
    assert out.data_ptr() == lane.data_ptr()
    assert float(lane[-1]) == 0.0          # idx == 300 dropped, not sunk
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx),
                              num_segments=300)
    np.testing.assert_array_equal(_bits(lane[:-1].numpy()), _bits(ref))
    assert fused_match.LAUNCHES["ordered_scatter"] == 0


def test_scatter_checks():
    z = torch.zeros(4)
    with pytest.raises(TypeError):
        tseg.scatter_add_ordered_(z.double(), torch.zeros(2, dtype=torch.long),
                                  torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        tseg.scatter_add_ordered_(z, torch.zeros(3, dtype=torch.long),
                                  torch.zeros(2))
    with pytest.raises(TypeError):
        tseg.scatter_add_ordered_(z, torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="unsupported device"):
        tseg.scatter_add_ordered_(torch.zeros(4, device="meta"),
                                  torch.zeros(2, dtype=torch.long,
                                              device="meta"),
                                  torch.zeros(2, device="meta"))
    # nothing to add: the tensor comes back as it was
    out = tseg.scatter_add_ordered_(z, torch.zeros(0, dtype=torch.long),
                                    torch.zeros(0))
    assert torch.equal(out, torch.zeros(4))


@pytest.mark.parametrize("n,T,route,jbits,digits", [
    (8192, 16384, "ordered_scatter", 13, (8, 7)),      # the bids
    (32768, 500, "ordered_scatter", 15, (9,)),         # the quota usage
    (16384, 500, "ordered_scatter", 14, (9,)),
    (2048, 16384, "ordered_scatter", 11, (8, 7)),      # the credits
    (1, 1, "ordered_scatter", 1, (1,)),
    (7, 300, "ordered_scatter", 3, (9,)),
    (32768, 65535, "ordered_scatter", 15, (8, 8)),
    # past one CTA: the usage (T = 500), the rebalancer's usage at 50k
    # and 300k tasks (T = 501), one cluster launch
    (32769, 500, "ordered_scatter/cluster", 0, (9,)),
    (50064, 501, "ordered_scatter/cluster", 0, (9,)),
    (300064, 501, "ordered_scatter/cluster", 0, (9,)),
    # the cluster's capacity edges at T = 501, 1,023 and 1,024
    (301824, 501, "ordered_scatter/cluster", 0, (9,)),
    (301825, 501, "ordered_scatter/sorted", 0, ()),
    (151552, 1023, "ordered_scatter/cluster", 0, (10,)),
    (151553, 1023, "ordered_scatter/sorted", 0, ()),
    (32769, 1024, "ordered_scatter/sorted", 0, ()),
    (100, 65536, "ordered_scatter/sorted", 0, ())])
def test_scatter_plan(n, T, route, jbits, digits):
    """The shape rule and the radix plan of the one-launch route: every
    main-path call takes it; a word (key << jbits | j) holds 0..T and
    0..n-1 in 31 bits; one or two passes of <= 9-bit digits cover the
    key's bits. The cluster route sorts by all the key's bits (0..T) in
    one pass and fits a CTA's shared memory at 8 CTAs."""
    assert tseg.scatter_plan(n, T) == (route, jbits, digits)
    if route == "ordered_scatter":
        assert (1 << jbits) >= n and sum(digits) == T.bit_length()
        assert jbits + sum(digits) <= 31 and max(digits) <= 9
    if route == "ordered_scatter/cluster":
        assert (1 << digits[0]) > T and digits[0] <= 10
        assert n <= tseg.scatter_cluster_max_n(T)
        assert tseg.SCATTER_CLUSTER_ROW_WORDS * (T + 1) \
            + tseg.SCATTER_CLUSTER_STAGE_WORDS \
            + tseg.scatter_cluster_slots(n, 8) \
            <= tseg.SCATTER_CLUSTER_SMEM_WORDS
    elif n > tseg.SCATTER_ONE_MAX_N or T > tseg.SCATTER_ONE_MAX_T:
        assert n > tseg.scatter_cluster_max_n(T)


def _radix_model(idx, T, warps=32):
    """The one-launch kernel's sort in numpy, step for step: words
    (key << jbits | j) with dropped keys as T; per pass, each warp's
    slice of the words in their current order, a (digit, warp) histogram
    scanned digit-major, then each warp's words placed in order."""
    n = len(idx)
    _, jbits, digits = tseg.scatter_plan(n, T)
    key = np.where((idx < 0) | (idx >= T), T, idx).astype(np.int64)
    words = key << jbits | np.arange(n)
    per = -(-(-(-n // warps)) // 32) * 32
    shift = jbits
    for d in digits:
        dig = (words >> shift) & ((1 << d) - 1)
        hist = np.zeros((1 << d, warps), np.int64)
        for w in range(warps):
            np.add.at(hist[:, w], dig[w * per:(w + 1) * per], 1)
        cursor = (np.cumsum(hist.reshape(-1)) - hist.reshape(-1)).reshape(
            hist.shape)
        out = np.empty_like(words)
        for i in range(n):
            w = i // per
            out[cursor[dig[i], w]] = words[i]
            cursor[dig[i], w] += 1
        words, shift = out, shift + d
    return words >> jbits, words & ((1 << jbits) - 1)


@pytest.mark.parametrize("n,T", [(8192, 16384), (2048, 16384), (3000, 500),
                                 (1, 1), (37, 5)])
def test_radix_model_is_a_stable_sort(n, T):
    """The kernel's sort (modelled above) equals a stable argsort of the
    keys, dropped keys last: the walk then sees each target's updates in
    update order. Half the updates hit one target, some keys fall
    outside [0, T) on both sides."""
    rng = np.random.default_rng(n + T)
    idx = np.where(rng.random(n) < 0.5, T // 2,
                   rng.integers(-3, T + 3, n)).astype(np.int64)
    key, j = _radix_model(idx, T)
    clamped = np.where((idx < 0) | (idx >= T), T, idx)
    order = np.argsort(clamped, kind="stable")
    np.testing.assert_array_equal(j, order)
    np.testing.assert_array_equal(key, clamped[order])


def _cluster_model(idx, T, ctas, clusters, warps=32):
    """The cluster kernel's sort in numpy, step for step: cluster g owns
    targets [g tq, g tq + tq) (tq = ceil(T / clusters)); in each, CTA r's
    slice of the updates (scatter_cluster_slots a CTA), each warp's part
    of it, per-warp histograms of the keys in the cluster's range, the
    exclusive scan of the (key, CTA, warp) cells in that order, then each
    warp's update indices placed in order (the cluster's m places spread
    evenly: p in CTA p // pq, pq = scatter_cluster_slots(m) and at least
    32). Returns each cluster's sorted update indices, in cluster order,
    and each kept key's first place among them."""
    n = len(idx)
    per = tseg.scatter_cluster_slots(n, ctas)
    tq = -(-T // clusters)
    parts = []
    for r in range(ctas):
        c0, c1 = min(n, r * per), min(n, (r + 1) * per)
        pw = -(-(-(-(c1 - c0) // warps)) // 32) * 32
        for w in range(warps):
            w0 = min(c1, c0 + w * pw)
            parts.append((r, w, w0, min(c1, w0 + pw)))
    out, starts, done = [], [], 0
    for t0 in range(0, T, tq):
        R = min(T, t0 + tq) - t0
        row = np.where((idx >= t0) & (idx < t0 + R), idx - t0, -1)
        hist = np.zeros((R, ctas, warps), np.int64)
        for r, w, a, b in parts:
            k = row[a:b]
            hist[:, r, w] = np.bincount(k[k >= 0], minlength=R)
        flat = hist.reshape(-1)
        cursor = (np.cumsum(flat) - flat).reshape(hist.shape)
        kept = int(flat.sum())
        pq = max(32, tseg.scatter_cluster_slots(kept, ctas))
        assert pq <= per
        places = np.full((ctas, pq), -1, np.int64)
        for r, w, a, b in parts:
            j = np.arange(a, b)[row[a:b] >= 0]
            k = row[j]
            order = np.argsort(k, kind="stable")
            ks = k[order]
            rank = np.empty(len(k), np.int64)
            rank[order] = np.arange(len(k)) - np.searchsorted(ks, ks)
            p = cursor[k, r, w] + rank
            places[p // pq, p % pq] = j
        out.append(places.reshape(-1)[:kept])
        starts.append(done + cursor[:, 0, 0])
        done += kept
    return np.concatenate(out), np.concatenate(starts)


@pytest.mark.parametrize("ctas,clusters", [(8, 16), (16, 8), (16, 1)])
@pytest.mark.parametrize("n,T", [(32769, 500), (50064, 501), (300064, 501),
                                 (301824, 501), (151552, 1023)])
def test_cluster_model_is_a_stable_sort(n, T, ctas, clusters):
    """The cluster kernel's sort (modelled above: 8 or 16 CTAs a
    cluster, as many clusters as run at once) equals a stable argsort of
    the kept keys, and each key's first place is where its run starts: a
    warp walking places [start[t], start[t + 1]) sees target t's updates
    in update order. A tenth of the updates are one heavy user's (a run
    across CTAs); some keys fall outside [0, T) on both sides."""
    rng = np.random.default_rng(n + T + ctas)
    idx = np.where(rng.random(n) < 0.1, T // 3,
                   rng.integers(-3, T + 3, n)).astype(np.int64)
    j, start = _cluster_model(idx, T, ctas, clusters)
    kept = np.flatnonzero((idx >= 0) & (idx < T))
    order = kept[np.argsort(idx[kept], kind="stable")]
    np.testing.assert_array_equal(j, order)
    np.testing.assert_array_equal(
        start, np.searchsorted(idx[order], np.arange(T)))


def test_cluster_model_every_key_dropped_and_one_target():
    """Edges of the cluster's sort: every key dropped (nothing placed),
    every update on one target (one run over every CTA's places)."""
    n, T = 50064, 501
    j, start = _cluster_model(np.full(n, -1, np.int64), T, 16, 8)
    assert len(j) == 0 and not start.any()
    j, start = _cluster_model(np.full(n, 7, np.int64), T, 16, 8)
    np.testing.assert_array_equal(j, np.arange(n))
    np.testing.assert_array_equal(start, np.where(np.arange(T) > 7, n, 0))


def test_rebalance_usage_shape_equals_segment_sum():
    """At the rebalancer's usage shape (50,064 task slots over 501
    targets, k=2: the cluster route's main-path call) the port's scatter
    equals jax.ops.segment_sum bit for bit."""
    rng = np.random.default_rng(21)
    n, T = 50064, 501
    idx = np.concatenate([rng.integers(0, T - 1, n - 64),
                          np.full(64, T - 1)]).astype(np.int32)
    vals = (10.0 ** rng.uniform(-3, 3, (n, 2))
            * rng.choice([-1.0, 1.0], (n, 2))).astype(np.float32)
    assert tseg.scatter_plan(n, T)[0] == "ordered_scatter/cluster"
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(idx),
                              num_segments=T)
    got = tseg.scatter_add_ordered_(torch.zeros((T, 2)),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(vals))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("name", ["ordered_scatter", "blocked_cumsum",
                                  "sum_ordered"])
def test_kernel_phases_stamps_every_barrier(name):
    """kernel_phases' instrumented copy of a kernel source stamps after
    every barrier of the functions it names and leaves the rest of the
    source as it was (its stamps are what PERF.md's phase cycles read)."""
    from cook_tpu_torch import kernel_phases
    from cook_tpu_torch.kernels import build

    src = (build.CSRC / f"{name}.cu").read_text()
    inst = kernel_phases.instrumented(name)
    assert "extern \"C\" int read_stamps" in inst
    regions = kernel_phases._REGIONS[name]
    assert inst.count("STAMP0();") == sum(k for _, _, k in regions)
    stamped = inst.count("__syncthreads(); STAMP();") \
        + inst.count("cluster_barrier(); STAMP();") \
        + inst.count("cluster_exit(); STAMP();")
    barriers = 0
    for start, end, _ in regions:
        a = src.index(start)
        body = src[a:src.index(end, a)]
        barriers += body.count("__syncthreads();") \
            + body.count("  cluster_barrier();") \
            + body.count("  cluster_exit();")
    assert stamped == barriers + (name == "ordered_scatter")
    back = inst.replace(kernel_phases._HEAD, "", 1)[:-len(kernel_phases._TAIL)]
    if name == "ordered_scatter":       # the stamp at the kernel's end
        k = back.rindex("\n  __syncthreads(); STAMP();\n}\n")
        back = back[:k] + back[k + len("\n  __syncthreads(); STAMP();"):]
    assert back.replace(" STAMP0();", "").replace(" STAMP();", "") == src
