"""Segment-scan helpers shared by the ranking kernels (a port of
cook_tpu/ops/segments.py:13-54).

The per-user running sums are a segmented cumulative sum over arrays
sorted so each segment is contiguous. The algorithm is the reference's:
one global cumsum minus the sum before each segment's start, not a
per-segment reset, so the f32 rounding matches it.
"""
from __future__ import annotations

import torch


def segment_starts(seg_ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask marking the first element of each contiguous segment.
    (`fill_`, not `starts[0] = True`: a Python scalar stored into a CUDA
    tensor is staged on the host and synchronises the stream.)"""
    starts = seg_ids != torch.roll(seg_ids, 1)
    starts[:1].fill_(True)
    return starts


def segment_start_index(starts: torch.Tensor) -> torch.Tensor:
    """Index (int64) of the start of each element's segment, propagated
    forward with a running max (`lax.associative_scan(max)` in the
    reference, `torch.cummax` here)."""
    idx = torch.arange(starts.shape[0], device=starts.device)
    return torch.cummax(torch.where(starts, idx, -1), dim=0).values


def cumsum0(values: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum along dim 0 of a 1-D or 2-D tensor, keeping the
    dtype.

    float32 takes `blocked_cumsum`: the association of jax 0.9.0's
    XLA-CPU `reduce_window` cumsum (a blocked scan with base 16), so
    every f32 prefix sum of the port is bit-equal to the JAX package's
    on the CPU at any size, and the same from run to run on CUDA;
    tests/test_torch_cumsum.py pins it. Integers take `torch.cumsum`,
    exact in any order; a 2-D integer input is scanned column by column
    on a transposed contiguous copy (PyTorch's CUDA scan along an OUTER
    dim walks each column sequentially, ~9 ms for 147k rows on an H100).
    Any other float dtype raises: the reference only scans f32."""
    if values.dtype == torch.float32:
        return blocked_cumsum(values)
    if values.is_floating_point() or values.is_complex():
        raise TypeError(f"cumsum0: float prefix sums are float32 only, got "
                        f"{values.dtype}")
    if values.dim() == 1:
        return torch.cumsum(values, dim=0, dtype=values.dtype)
    return torch.cumsum(values.t().contiguous(), dim=1,
                        dtype=values.dtype).t()


BLOCK = 16     # XLA-CPU's cumsum block
# blocked_cumsum's routes (see blocked_cumsum_plan)
CUMSUM_ONE_CTA_MAX = 16384      # rows one CTA scans on chip
CUMSUM_CLUSTER = 8              # CTAs a column at most (a portable cluster)
CUMSUM_CHUNK_ALIGN = BLOCK ** 3  # a CTA's chunk: whole level-3 blocks
CUMSUM_CHUNK_MAX = 40960        # rows a CTA holds on chip (~180 KB)


def blocked_cumsum(values: torch.Tensor) -> torch.Tensor:
    """f32 inclusive prefix sum along dim 0 (1-D, or 2-D column by
    column) in XLA-CPU's association: runs of BLOCK elements summed left
    to right from 0, the block totals scanned the same way recursively,
    each block's exclusive prefix added to its running sums. CUDA
    tensors launch csrc/blocked_cumsum.cu; CPU tensors run the plain
    version; anything else raises."""
    dev = values.device
    if dev.type == "cpu":
        return blocked_cumsum_plain(values)
    if dev.type != "cuda":
        raise ValueError(f"blocked_cumsum: unsupported device {dev}")
    return _blocked_cumsum_cuda(values)


def _check_cumsum(values):
    if values.dtype != torch.float32 or values.dim() not in (1, 2):
        raise TypeError(f"blocked_cumsum: 1-D or 2-D float32, got "
                        f"{values.dtype} {tuple(values.shape)}")


def blocked_cumsum_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the same f32
    additions in the same order, one elementwise op per step (~17
    launches per level)."""
    _check_cumsum(values)
    if values.shape[0] == 1:    # XLA: a window of one is the identity
        return values.clone()
    x = values if values.dim() == 2 else values[:, None]
    out = _blocked_scan(x)
    return out if values.dim() == 2 else out[:, 0]


def _blocked_scan(x: torch.Tensor) -> torch.Tensor:
    n, k = x.shape
    nb = -(-n // BLOCK)
    xb = x.new_zeros((nb * BLOCK, k))
    xb[:n] = x
    xb = xb.view(nb, BLOCK, k)
    run = [xb[:, 0] + 0.0]      # from 0, as XLA: -0.0 sums to +0.0
    for j in range(1, BLOCK):
        run.append(run[-1] + xb[:, j])
    local = torch.stack(run, dim=1)
    if nb > 1:
        prefix = _blocked_scan(local[:, -1])
        local[1:] = local[1:] + prefix[:-1, None]
    return local.view(nb * BLOCK, k)[:n]


def blocked_cumsum_scratch(n: int) -> int:
    """Floats of level totals the "global" route keeps per column in
    device memory: n/16 + n/256 + ... down to the first level of <= 16
    values."""
    total = 0
    while n > BLOCK:
        n = -(-n // BLOCK)
        total += n
    return total


def blocked_cumsum_plan(n: int) -> tuple[str, int, int]:
    """(route, CTAs a column, rows a CTA) of blocked_cumsum's kernel:
    - "one_cta": n <= CUMSUM_ONE_CTA_MAX; one CTA a column scans every
      level in shared memory;
    - "cluster": up to CUMSUM_CLUSTER * CUMSUM_CHUNK_MAX rows; a cluster
      of CTAs a column, each holding a chunk of whole level-3 blocks
      (4,096 rows), so only the levels from 3 up cross CTAs;
    - "global": beyond; one CTA a column walks the levels through a
      scratch in device memory (blocked_cumsum_scratch)."""
    if n <= CUMSUM_ONE_CTA_MAX:
        return "one_cta", 1, n
    per = -(-n // CUMSUM_CLUSTER)
    chunk = -(-per // CUMSUM_CHUNK_ALIGN) * CUMSUM_CHUNK_ALIGN
    if chunk > CUMSUM_CHUNK_MAX:
        return "global", 1, n
    return "cluster", -(-n // chunk), chunk


def _blocked_cumsum_cuda(values: torch.Tensor) -> torch.Tensor:
    from cook_tpu_torch.kernels import build
    from cook_tpu_torch.ops.fused_match import LAUNCHES, count

    _check_cumsum(values)
    n = values.shape[0]
    k = 1 if values.dim() == 1 else values.shape[1]
    if n == 0 or k == 0:
        return torch.empty(values.shape, dtype=torch.float32,
                           device=values.device)
    if n >= 2 ** 31:
        raise ValueError(f"blocked_cumsum: {n} rows out of range")
    route, ctas, chunk = blocked_cumsum_plan(n)
    # the global route's level totals follow the output in one
    # allocation (host time matters: a batched cycle makes ~33 calls)
    per_col = blocked_cumsum_scratch(n) if route == "global" else 0
    buf = torch.empty(n * k + per_col * k, dtype=torch.float32,
                      device=values.device)
    lib = build.load("blocked_cumsum")
    dev = values.device
    args = (values.data_ptr(), buf.data_ptr(), n, k, values.stride(0),
            0 if values.dim() == 1 else values.stride(1))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "global":
            rc = lib.blocked_cumsum_global_launch(
                *args, buf.data_ptr() + 4 * n * k, per_col, stream)
        else:
            rc = lib.blocked_cumsum_launch(*args, ctas, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"blocked_cumsum kernel launch failed: CUDA "
                           f"error {rc}")
    count(LAUNCHES, "blocked_cumsum" if route != "global"
          else "blocked_cumsum/global")
    return buf[:n * k].view(values.shape)


SUM_WINDOW = 32           # XLA-CPU's tree reduction window
SUM_MAX = SUM_WINDOW * 8192   # the one-CTA kernel keeps its first level
                              # on chip
# the cluster route: CTA 0 keeps every level-1 sum (<= 8,192) on chip
SUM_CLUSTER_MAX = SUM_WINDOW * SUM_MAX
SUM_CLUSTER_CTAS = (8, 16)    # its CTAs: 16 where the card co-schedules
                              # them, else 8


def sum_ordered(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a 1-D tensor (a 0-d tensor on x's device) in the
    association of jax 0.9.0's XLA-CPU `jnp.sum`, which
    tests/test_torch_sum.py pins bit for bit: XLA's tree-reduction
    rewrite cuts a reduction of more than 32 elements into windows of 32
    (the padding split evenly, one more at the end), each summed left to
    right from 0, and reduces the window sums the same way until at most
    32 remain, which are summed left to right from 0; one element is
    returned as it is (-0.0 stays). CUDA tensors launch
    csrc/sum_ordered.cu at any length, one launch up to SUM_CLUSTER_MAX
    (sum_ordered_route; beyond it the "levels" route first:
    sum_ordered_plan); CPU tensors run the plain version; anything else
    raises."""
    dev = x.device
    if dev.type == "cpu":
        return sum_ordered_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"sum_ordered: unsupported device {dev}")
    return _sum_ordered_cuda(x)


def _check_sum(x):
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"sum_ordered: 1-D float32, got {x.dtype} "
                        f"{tuple(x.shape)}")


def sum_windows(n: int) -> list[tuple[int, int]]:
    """(windows, padding in front) of each tree level of a sum of n
    elements, bottom up; the last level of <= 32 values is not listed."""
    out = []
    while n > SUM_WINDOW:
        nb = -(-n // SUM_WINDOW)
        out.append((nb, (nb * SUM_WINDOW - n) // 2))
        n = nb
    return out


def sum_ordered_plan(n: int) -> list[tuple[int, int, int]]:
    """(values, windows, padding in front) of each tree level that
    sum_ordered's "levels" route reduces over many CTAs, bottom up: the
    levels while more than SUM_CLUSTER_MAX values remain (none for n <=
    SUM_CLUSTER_MAX). One launch of sum_ordered_route's kernel then
    reduces the last level's windows, whose tree (sum_windows) is the
    rest of n's."""
    out = []
    for nb, lo in sum_windows(n):
        if n <= SUM_CLUSTER_MAX:
            break
        out.append((n, nb, lo))
        n = nb
    return out


def sum_ordered_route(m: int) -> str:
    """The kernel that sums m <= SUM_CLUSTER_MAX values in one launch:
    - "sum_ordered": m <= SUM_MAX; one CTA, its first level's window
      sums on chip;
    - "sum_ordered/cluster": beyond; one cluster, each CTA owning a
      contiguous range of level-1 windows (sum_cluster_ranges), which
      it sums from device memory and writes to CTA 0 over DSMEM; CTA 0
      finishes the tree as the one-CTA kernel does."""
    return "sum_ordered" if m <= SUM_MAX else "sum_ordered/cluster"


def sum_cluster_ranges(n: int, ctas: int) -> list[tuple[int, int]]:
    """[first, last) level-1 windows (32 level-0 windows of 32 elements,
    sum_windows' second level) of each CTA of the cluster route, for n
    values: ceil(windows / ctas) a CTA, in order."""
    nb1 = sum_windows(n)[1][0]
    q = -(-nb1 // ctas)
    return [(min(nb1, r * q), min(nb1, (r + 1) * q)) for r in range(ctas)]


def sum_ordered_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the same f32
    additions in the same order (a padding zero added to a running sum
    that started at +0.0 changes nothing)."""
    _check_sum(x)
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(())
    if n == 1:
        return x[0].clone()
    for nb, lo in sum_windows(n):
        xp = torch.nn.functional.pad(x, (lo, nb * SUM_WINDOW - x.shape[0]
                                         - lo)).view(nb, SUM_WINDOW)
        acc = xp[:, 0] + 0.0
        for j in range(1, SUM_WINDOW):
            acc = acc + xp[:, j]
        x = acc
    acc = x[0] + 0.0
    for j in range(1, x.shape[0]):
        acc = acc + x[j]
    return acc


def _sum_ordered_cuda(x: torch.Tensor) -> torch.Tensor:
    from cook_tpu_torch.kernels import build
    from cook_tpu_torch.ops.fused_match import LAUNCHES, count

    _check_sum(x)
    n = x.shape[0]
    if n == 0:
        return x.new_zeros(())
    if n >= 2 ** 31:
        raise ValueError(f"sum_ordered: {n} elements out of range")
    x = x.contiguous()
    levels = sum_ordered_plan(n)
    # the result, then each level's window sums, in one allocation
    buf = torch.empty(1 + sum(nb for _, nb, _ in levels),
                      dtype=torch.float32, device=x.device)
    lib = build.load("sum_ordered")
    dev = x.device
    src, m, off = x.data_ptr(), n, 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for m, nb, lo in levels:
            dst = buf.data_ptr() + 4 * off
            rc = lib.sum_ordered_levels_launch(src, dst, m, nb, lo, stream)
            if rc != 0:
                raise RuntimeError(f"sum_ordered/levels kernel launch "
                                   f"failed: CUDA error {rc}")
            count(LAUNCHES, "sum_ordered/levels")
            src, m, off = dst, nb, off + nb
        route = sum_ordered_route(m)
        launch = lib.sum_ordered_launch if route == "sum_ordered" \
            else lib.sum_ordered_cluster_launch
        rc = launch(src, buf.data_ptr(), m, stream)
    if rc != 0:
        raise RuntimeError(f"{route} kernel launch failed: CUDA error {rc}")
    count(LAUNCHES, route)
    return buf[0]


def segment_cumsum(values: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum that restarts at each segment boundary.

    `seg_ids` must be run-contiguous. Works on float or int tensors (the
    result keeps `values`' dtype); the leading axis is the scan axis.
    """
    return cumsum_from_starts(
        values, segment_start_index(segment_starts(seg_ids)))


def cumsum_from_starts(values: torch.Tensor,
                       start_idx: torch.Tensor) -> torch.Tensor:
    """`segment_cumsum` given each element's segment start
    (`segment_start_index`), for callers that scan several value sets
    over one segmentation."""
    total = cumsum0(values)
    base = total[start_idx] - values[start_idx]
    return total - base


# fixed-point units a unit of demand in the port's exact running sums
# (match.fits_exact, the quota filter's `exact_overage`, the
# rebalancer's cover test): every f32 of magnitude >= 0.5 is on this
# grid. A limit (an unset quota is +inf) is clamped to +-FIT_LIMIT, far
# past any sum it is compared with.
FIT_SCALE = 2.0 ** 24
FIT_LIMIT = 2.0 ** 62


def fixed_units(x: torch.Tensor, up: bool) -> torch.Tensor:
    """`x` (float32 or float64) in int64 units of 2^-24, rounded up
    (`up`) or down, clamped to +-2^62. Scaling by a power of two, the
    rounding to an integer and the conversion are exact in x's own
    dtype, so an f32 of magnitude >= 0.5 converts exactly; one below
    that is off the grid by under one unit, which the rounding puts on
    the side the caller asks for."""
    y = x * FIT_SCALE
    y = torch.ceil(y) if up else torch.floor(y)
    return torch.clamp(y, -FIT_LIMIT, FIT_LIMIT).to(torch.int64)


def _check_scatter(out, idx, vals):
    if out.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"scatter_add_ordered: float32 only, got "
                        f"{out.dtype} += {vals.dtype}")
    if idx.dim() != 1 or vals.shape[:1] != idx.shape or \
            out.shape[1:] != vals.shape[1:] or out.dim() not in (1, 2):
        raise ValueError(
            f"scatter_add_ordered shapes: out {tuple(out.shape)}, idx "
            f"{tuple(idx.shape)}, vals {tuple(vals.shape)}")
    if idx.is_floating_point() or idx.dtype == torch.bool:
        raise TypeError(f"scatter_add_ordered: integer indices, got "
                        f"{idx.dtype}")


SCATTER_ONE_MAX_N = 32768   # updates one CTA sorts in shared memory
SCATTER_ONE_MAX_T = 65535   # targets: a key and the drop bucket in 16 bits
SCATTER_DIGIT_MAX = 9       # radix digit bits (512 bins x 32 warps)
# the cluster route: G clusters of C CTAs, cluster g owning a contiguous
# range of targets, whose keys it sorts in one pass of <= 10 bits; a
# CTA's shared memory (226 KB, in 4-byte words) holds 36 words a row (its
# 32 warps' cursors and a pad word, its total, its base, its run's
# start; at most T + 1 rows counted here), the walking warps' staging
# (16 warps x 32 updates x 4 floats) and its share of the cluster's
# sorted update indices, up to ceil(n / C) rounded up to 32 (every key
# may fall in one cluster's range), at C = 8 CTAs (the fewest a cluster
# has: 16 where the card co-schedules them), so the route does not
# depend on the card
SCATTER_CLUSTER_MAX_T = 1023
SCATTER_CLUSTER_ROW_WORDS = 36
SCATTER_CLUSTER_STAGE_WORDS = 16 * 32 * 4
SCATTER_CLUSTER_SMEM_WORDS = 226 * 1024 // 4
SCATTER_CLUSTER_CTAS = (8, 16)


def scatter_cluster_slots(n: int, ctas: int) -> int:
    """Sorted places (update indices) each CTA of the cluster route
    holds: ceil(n / ctas), rounded up to whole warps."""
    return -(-(-(-n // ctas)) // 32) * 32


def scatter_cluster_max_n(T: int) -> int:
    """The largest n the cluster route takes onto T targets (0 for T
    beyond SCATTER_CLUSTER_MAX_T)."""
    if T > SCATTER_CLUSTER_MAX_T:
        return 0
    free = SCATTER_CLUSTER_SMEM_WORDS - SCATTER_CLUSTER_ROW_WORDS * (T + 1) \
        - SCATTER_CLUSTER_STAGE_WORDS
    return SCATTER_CLUSTER_CTAS[0] * (free // 32 * 32)


def scatter_plan(n: int, T: int) -> tuple[str, int, tuple[int, ...]]:
    """(route, update-index bits, radix digit bits by pass) of
    scatter_add_ordered_'s kernel for n updates onto T targets:
    - "ordered_scatter": n <= SCATTER_ONE_MAX_N and T <=
      SCATTER_ONE_MAX_T; one launch of one CTA sorts (key << jbits | j)
      words by key with a stable LSD radix sort over the bits of 0..T
      (T is the drop bucket), one or two passes of at most
      SCATTER_DIGIT_MAX bits, then walks each target's run in order;
    - "ordered_scatter/cluster": n up to scatter_cluster_max_n(T) (T <=
      SCATTER_CLUSTER_MAX_T: the rebalancer's and the usage's calls past
      32,768 updates); one launch of G thread-block clusters, each
      owning a contiguous range of targets: it sorts the indices of the
      updates whose key falls there in one counting pass (digits: the
      bits of T, bounding a range's; no words: jbits 0), the sorted
      places spread over its CTAs' shared memory, then walks each
      target's run in order, a warp a run;
    - "ordered_scatter/sorted": beyond; a stable torch.sort of the int32
      keys, then a kernel that walks each run."""
    if n > SCATTER_ONE_MAX_N or T > SCATTER_ONE_MAX_T:
        if n <= scatter_cluster_max_n(T):
            return "ordered_scatter/cluster", 0, (T.bit_length(),)
        return "ordered_scatter/sorted", 0, ()
    jbits = max(1, (n - 1).bit_length())
    kbits = T.bit_length()
    passes = -(-kbits // SCATTER_DIGIT_MAX)
    d0 = -(-kbits // passes)
    return "ordered_scatter", jbits, (d0,) if passes == 1 \
        else (d0, kbits - d0)


def scatter_add_ordered_(out: torch.Tensor, idx: torch.Tensor,
                         vals: torch.Tensor) -> torch.Tensor:
    """In place: out[t] += vals[j] for every j with idx[j] == t, one
    round-to-nearest f32 add at a time in increasing j (update order),
    for t in [0, T = out.shape[0]); other indices are dropped. This is
    the order of XLA-CPU's scatter-add (`jax.ops.segment_sum`,
    `.at[].add`), which tests/test_torch_scatter.py pins bit for bit:
    from zeros it is `jax.ops.segment_sum(vals, idx, T)` (a negative
    index dropped too), onto a lane `lane.at[idx].add(vals, mode="drop")`
    for indices >= 0. out (T,) or (T, k), vals (n,) or (n, k), idx (n,)
    integer. CUDA tensors launch csrc/ordered_scatter.cu (float
    `index_add_` on CUDA adds in whatever order its atomics land) by the
    route scatter_plan names; CPU tensors run the plain version;
    anything else raises. Returns out."""
    dev = out.device
    if dev.type == "cpu":
        return scatter_add_ordered_plain_(out, idx, vals)
    if dev.type != "cuda":
        raise ValueError(f"scatter_add_ordered: unsupported device {dev}")
    return _scatter_add_ordered_cuda(out, idx, vals)


def scatter_add_ordered_plain_(out: torch.Tensor, idx: torch.Tensor,
                               vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the same adds
    in the same order. A stable sort makes each target's updates one run
    in update order; step r then adds the r-th update of every target
    (each target at most once a step, so no float accumulation order is
    left to the device). It reads the run lengths back to the host (two
    syncs on CUDA) and takes one step per update of the longest run."""
    _check_scatter(out, idx, vals)
    T = out.shape[0]
    if idx.shape[0] == 0 or T == 0:
        return out
    skey, perm = torch.sort(idx.long(), stable=True)
    rank = torch.arange(idx.shape[0], device=idx.device) \
        - segment_start_index(segment_starts(skey))
    ok = (skey >= 0) & (skey < T)
    rank, tgt, v = rank[ok], skey[ok], vals[perm[ok]]
    by_rank = torch.argsort(rank, stable=True)
    tgt, v = tgt[by_rank], v[by_rank]
    s = 0
    for c in torch.bincount(rank).tolist():
        t = tgt[s:s + c]
        out[t] = out[t] + v[s:s + c]
        s += c
    return out


def _scatter_add_ordered_cuda(out, idx, vals):
    from cook_tpu_torch.kernels import build
    from cook_tpu_torch.ops.fused_match import LAUNCHES, count

    _check_scatter(out, idx, vals)
    if idx.device != out.device or vals.device != out.device:
        raise ValueError("scatter_add_ordered: all inputs must be on one "
                         "device")
    if not (out.is_contiguous() and vals.is_contiguous()):
        raise ValueError("scatter_add_ordered: out and vals must be "
                         "contiguous")
    n, T = idx.shape[0], out.shape[0]
    k = 1 if out.dim() == 1 else out.shape[1]
    if n == 0 or T == 0 or k == 0:
        return out
    if not (n < 2 ** 31 and T < 2 ** 31 and k <= 4):
        raise ValueError(f"scatter_add_ordered: n={n}, T={T}, k={k} out of "
                         f"range")
    route, jbits, digits = scatter_plan(n, T)
    lib = build.load("ordered_scatter")
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route != "ordered_scatter/sorted":
            if idx.dtype not in (torch.int32, torch.int64):
                idx = idx.to(torch.int32)
            idx = idx.contiguous()
        if route == "ordered_scatter/cluster":
            rc = lib.ordered_scatter_cluster_launch(
                idx.data_ptr(), vals.data_ptr(), out.data_ptr(), n, T, k,
                int(idx.dtype == torch.int64), stream)
        elif route == "ordered_scatter":
            # the first of two radix passes writes its words here where
            # the kernel cannot keep them on chip (n above ~16,000)
            ping = torch.empty(n if len(digits) == 2 else 0,
                               dtype=torch.int32, device=dev)
            rc = lib.ordered_scatter_launch(
                idx.data_ptr(), vals.data_ptr(), out.data_ptr(),
                ping.data_ptr(), n, T, k, int(idx.dtype == torch.int64),
                jbits, digits[0], digits[1] if len(digits) == 2 else 0,
                stream)
        else:
            # int32 keys (half the radix passes of int64); wider indices
            # are clamped into [-1, T] first, which drops the same updates
            key = torch.clamp(idx, -1, T) if idx.dtype == torch.int64 \
                else idx
            skey, perm = torch.sort(key.to(torch.int32), stable=True)
            rc = lib.ordered_scatter_sorted_launch(
                skey.data_ptr(), perm.data_ptr(), vals.data_ptr(),
                out.data_ptr(), n, T, k, stream)
    if rc != 0:
        raise RuntimeError(f"{route} kernel launch failed: CUDA error "
                           f"{rc}")
    count(LAUNCHES, route)
    return out


def scatter_cluster_grid() -> tuple[int, int]:
    """(CTAs a cluster, clusters at most) of the cluster scatter's
    launches on this card: 16 CTAs where it co-schedules a cluster of 16
    at the route's most shared memory, else 8; as many clusters as run at
    once, at most 16. Needs a CUDA device."""
    from cook_tpu_torch.kernels import build
    lib = build.load("ordered_scatter")
    return lib.ordered_scatter_cluster_ctas(), lib.ordered_scatter_clusters()


def sum_cluster_ctas() -> int:
    """CTAs of the cluster sum's launches on this card (16, else 8).
    Needs a CUDA device."""
    from cook_tpu_torch.kernels import build
    return build.load("sum_ordered").sum_ordered_cluster_ctas()


def noop_launch(kind: str = "one_cta") -> None:
    """Launch an empty kernel on the current stream: one CTA of 32
    threads ("one_cta") or one cluster of the cluster sum's CTAs of
    1,024 threads ("cluster"); the launch floor the segment kernels'
    times are read against. Counted nowhere. Needs a CUDA device."""
    from cook_tpu_torch.kernels import build
    rc = build.load("sum_ordered").sum_ordered_noop_launch(
        int(kind == "cluster"), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


def segment_rank(seg_ids: torch.Tensor) -> torch.Tensor:
    """0-based position (int32) of each element within its segment."""
    ones = torch.ones(seg_ids.shape[0], dtype=torch.int32,
                      device=seg_ids.device)
    return segment_cumsum(ones, seg_ids) - 1
