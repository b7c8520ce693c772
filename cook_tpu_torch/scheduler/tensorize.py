"""Shape bucketing and the f32 "unset" sentinel (a copy of
cook_tpu/scheduler/tensorize.py:21-27)."""
from __future__ import annotations

import math

import numpy as np

F32_MAX = np.float32(3.4e38)
MIN_BUCKET = 64


def bucket(n: int) -> int:
    """Next power-of-two >= n (>= MIN_BUCKET) so tensor shapes are stable."""
    return max(MIN_BUCKET, 1 << max(0, math.ceil(math.log2(max(n, 1)))))
