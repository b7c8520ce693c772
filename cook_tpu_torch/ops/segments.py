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
    """Inclusive cumsum along dim 0, keeping the dtype. A 2-D input is
    scanned column by column on a transposed contiguous copy: PyTorch's
    CUDA scan along an OUTER dim walks each column sequentially (~9 ms
    for 147k rows on an H100), its innermost-dim scan is parallel."""
    if values.dim() == 1:
        return torch.cumsum(values, dim=0, dtype=values.dtype)
    return torch.cumsum(values.t().contiguous(), dim=1,
                        dtype=values.dtype).t()


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
