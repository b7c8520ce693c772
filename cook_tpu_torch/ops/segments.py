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


def segment_sum_scan(values: torch.Tensor,
                     seg_ids: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum over run-contiguous `seg_ids`, added in
    one fixed order on every device: a doubling scan in which each step
    adds to every row the partial sum `off` rows back when that row lies
    in the same segment (off = 1, 2, 4, ...; log2 n steps of elementwise
    ops). The last row of each segment holds the segment's sum. Unlike
    `segment_cumsum` it does not cancel across segments, and it does not
    rest on a float cumsum, which PyTorch does not order
    deterministically on CUDA. The leading axis is the scan axis."""
    n = values.shape[0]
    off = 1
    while off < n:
        same = seg_ids[off:] == seg_ids[:-off]
        if values.dim() > 1:
            same = same[:, None]
        values = torch.cat([values[:off], torch.where(
            same, values[off:] + values[:-off], values[off:])])
        off *= 2
    return values


def segment_rank(seg_ids: torch.Tensor) -> torch.Tensor:
    """0-based position (int32) of each element within its segment."""
    ones = torch.ones(seg_ids.shape[0], dtype=torch.int32,
                      device=seg_ids.device)
    return segment_cumsum(ones, seg_ids) - 1
