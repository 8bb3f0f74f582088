"""Batch-size bucket ladder (the port's own copy of
``sav_tpu/serve/bucketing.py``; stdlib only).

Every dynamic batch is padded up to the smallest rung that holds it, so the
engine runs a small fixed set of batch shapes, each warmed at startup.
"""

from __future__ import annotations

from typing import Sequence


def default_ladder(max_batch: int) -> list:
    """Powers of two up to and including ``max_batch`` (always a rung)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    rungs = []
    b = 1
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch)
    return rungs


class BucketLadder:
    """Sorted, validated batch-size rungs and the padding lookup."""

    def __init__(self, buckets: Sequence[int]):
        rungs = sorted(set(int(b) for b in buckets))
        if not rungs:
            raise ValueError("bucket ladder must have at least one rung")
        if rungs[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {rungs[0]}")
        self.buckets = tuple(rungs)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= ``n``."""
        if n < 1:
            raise ValueError(f"need at least one request, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds the top bucket {self.max_batch}")
