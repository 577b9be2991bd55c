"""Shape buckets (counterpart of ``paddle_tpu/io/bucketing.py``).

The serving engine pads prompts to a small set of bucket lengths and
prefill groups to power-of-two sizes, so the shapes its device work
sees stay few.
"""

from __future__ import annotations

import bisect
from typing import Sequence


def shape_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (last bucket if n exceeds them all)."""
    buckets = sorted(buckets)
    i = bisect.bisect_left(buckets, n)
    return buckets[min(i, len(buckets) - 1)]
