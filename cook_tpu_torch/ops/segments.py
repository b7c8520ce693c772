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
    """Floats of level totals the kernel keeps per column: n/16 +
    n/256 + ... down to the first level of <= 16 values."""
    total = 0
    while n > BLOCK:
        n = -(-n // BLOCK)
        total += n
    return total


def _blocked_cumsum_cuda(values: torch.Tensor) -> torch.Tensor:
    from cook_tpu_torch.kernels import build
    from cook_tpu_torch.ops.fused_match import LAUNCHES

    _check_cumsum(values)
    n = values.shape[0]
    k = 1 if values.dim() == 1 else values.shape[1]
    if n == 0 or k == 0:
        return torch.empty(values.shape, dtype=torch.float32,
                           device=values.device)
    if n >= 2 ** 31:
        raise ValueError(f"blocked_cumsum: {n} rows out of range")
    # one allocation: the output, then the level totals (host time
    # matters: a batched cycle makes ~33 of these calls)
    per_col = blocked_cumsum_scratch(n)
    buf = torch.empty(n * k + per_col * k, dtype=torch.float32,
                      device=values.device)
    lib = build.load("blocked_cumsum")
    dev = values.device
    with torch.cuda.device(dev):
        rc = lib.blocked_cumsum_launch(
            values.data_ptr(), buf.data_ptr(),
            buf.data_ptr() + 4 * n * k, n, k, values.stride(0),
            0 if values.dim() == 1 else values.stride(1), per_col,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"blocked_cumsum kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["blocked_cumsum"] += 1
    return buf[:n * k].view(values.shape)


def segment_cumsum(values: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum that restarts at each segment boundary.

    `seg_ids` must be run-contiguous. Works on float or int tensors (the
    result keeps `values`' dtype); the leading axis is the scan axis.
    """
    total = cumsum0(values)
    start_idx = segment_start_index(segment_starts(seg_ids))
    base = total[start_idx] - values[start_idx]
    return total - base


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
    `index_add_` on CUDA adds in whatever order its atomics land); CPU
    tensors run the plain version; anything else raises. Returns out."""
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
    from cook_tpu_torch.ops.fused_match import LAUNCHES

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
    # int32 keys (half the radix passes of int64); wider indices are
    # clamped into [-1, T] first, which drops the same updates
    key = torch.clamp(idx, -1, T) if idx.dtype == torch.int64 else idx
    skey, perm = torch.sort(key.to(torch.int32), stable=True)
    lib = build.load("ordered_scatter")
    dev = out.device
    with torch.cuda.device(dev):
        rc = lib.ordered_scatter_launch(
            skey.data_ptr(), perm.data_ptr(), vals.data_ptr(),
            out.data_ptr(), n, T, k,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ordered_scatter kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["ordered_scatter"] += 1
    return out


def segment_rank(seg_ids: torch.Tensor) -> torch.Tensor:
    """0-based position (int32) of each element within its segment."""
    ones = torch.ones(seg_ids.shape[0], dtype=torch.int32,
                      device=seg_ids.device)
    return segment_cumsum(ones, seg_ids) - 1
