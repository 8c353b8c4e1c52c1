"""Host-side in-memory batcher.

A copy of ``graph_wavenet_tpu/data/loader.py``'s ``DataLoader`` (without
the per-sample-graph variant): the tail is padded with copies of the last
sample so the count divides the batch size, ``shuffle()`` permutes from a
seeded numpy Generator, and iteration yields numpy slices. ``num_real``
keeps the unpadded count.
"""

from __future__ import annotations

import numpy as np


def pad_with_last(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad the leading axis with copies of the last entry so
    ``len % batch_size == 0``."""
    pad = (-len(arr)) % batch_size
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)],
                             axis=0)
    return arr


class DataLoader:
    """Batcher over (xs, ys) arrays."""

    def __init__(self, xs: np.ndarray, ys: np.ndarray, batch_size: int,
                 rng: np.random.Generator):
        self.batch_size = batch_size
        self.num_real = len(xs)
        self.rng = rng
        xs = pad_with_last(xs, batch_size)
        ys = pad_with_last(ys, batch_size)
        self.size = len(xs)
        self.num_batch = self.size // batch_size
        self.xs = xs
        self.ys = ys

    def shuffle(self):
        perm = self.rng.permutation(self.size)
        self.xs = self.xs[perm]
        self.ys = self.ys[perm]

    def get_iterator(self):
        for i in range(self.num_batch):
            lo, hi = i * self.batch_size, (i + 1) * self.batch_size
            yield self.xs[lo:hi], self.ys[lo:hi]
