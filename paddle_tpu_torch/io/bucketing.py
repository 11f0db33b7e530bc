"""Length bucketing (counterpart of ``paddle_tpu/io/bucketing.py``):
samples grouped by length into a few buckets and each batch padded to its
bucket's boundary, so a run meets a bounded set of shapes.  A batch
sampler, so it drops into ``DataLoader(batch_sampler=...)``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from .sampler import Sampler

__all__ = ["BucketedBatchSampler", "pad_to_bucket", "default_buckets"]


def default_buckets(max_len: int, n_buckets: int = 8) -> List[int]:
    """Geometric bucket boundaries up to max_len, multiples of 8 — e.g.
    max_len=2048, n=8 → [16, 32, 64, ..., 2048]."""
    out = []
    b = max(8, max_len >> (n_buckets - 1))
    b = int(np.ceil(b / 8) * 8)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(int(np.ceil(max_len / 8) * 8))
    return out


def pad_to_bucket(seq, buckets: Sequence[int], pad_value=0):
    """Pad a 1-D/2-D numpy array (or list) along its last axis to the
    smallest bucket >= its length.  Returns (padded, true_length)."""
    arr = np.asarray(seq)
    length = arr.shape[-1]
    for b in sorted(buckets):
        if length <= b:
            width = [(0, 0)] * (arr.ndim - 1) + [(0, b - length)]
            return np.pad(arr, width, constant_values=pad_value), length
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket "
        f"{max(buckets)}")


class BucketedBatchSampler(Sampler):
    """Batches indices whose sample lengths share a bucket, so every
    batch pads to one static shape (bounded recompiles).

    ``lengths``: per-sample lengths (list/array) or a callable
    ``idx -> length``.  Partial bucket remainders are emitted as smaller
    final batches unless drop_last.
    """

    def __init__(self, lengths, buckets: Sequence[int], batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: Optional[int] = None, num_samples: Optional[int]
                 = None):
        if callable(lengths):
            if num_samples is None:
                raise ValueError(
                    "num_samples is required when lengths is a callable")
            self._lengths = [int(lengths(i)) for i in range(num_samples)]
        else:
            self._lengths = [int(l) for l in lengths]
        self.buckets = sorted(int(b) for b in buckets)
        if self._lengths and max(self._lengths) > self.buckets[-1]:
            raise ValueError(
                f"max sample length {max(self._lengths)} exceeds the "
                f"largest bucket {self.buckets[-1]}")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def bucket_of(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        raise ValueError(f"length {length} exceeds buckets")

    def _make_batches(self) -> List[List[int]]:
        per_bucket = {b: [] for b in self.buckets}
        order = np.arange(len(self._lengths))
        if self.shuffle:
            rng = np.random.RandomState(
                None if self.seed is None else self.seed + self._epoch)
            rng.shuffle(order)
        for idx in order:
            per_bucket[self.bucket_of(self._lengths[idx])].append(int(idx))
        batches = []
        for b in self.buckets:
            ids = per_bucket[b]
            for i in range(0, len(ids), self.batch_size):
                chunk = ids[i:i + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                batches.append(chunk)
        if self.shuffle:
            rng = np.random.RandomState(
                None if self.seed is None else self.seed + self._epoch)
            rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        self._epoch += 1
        return iter(self._make_batches())

    def __len__(self) -> int:
        # O(buckets): batch count is shuffle-invariant, so no need to
        # rebuild (and reshuffle) the batch list just to count it
        per_bucket = {b: 0 for b in self.buckets}
        for length in self._lengths:
            per_bucket[self.bucket_of(length)] += 1
        total = 0
        for n in per_bucket.values():
            total += n // self.batch_size
            if n % self.batch_size and not self.drop_last:
                total += 1
        return total
