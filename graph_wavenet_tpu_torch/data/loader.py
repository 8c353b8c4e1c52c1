"""Host-side batchers.

A copy of ``graph_wavenet_tpu/data/loader.py``'s ``DataLoader``, and
``data.native_loader``'s ``WindowDataLoader`` and ``gather_windows`` (the
window gather of the native library, numpy without it). Both pad the
tail with copies of the last sample so the count divides the batch size,
shuffle from a seeded numpy Generator, and yield numpy batches; ``num_real``
keeps the unpadded count. Given ``adj_idx`` (a graph index per sample, the
per-sample-graph datasets), ``DataLoader`` pads and shuffles it with the
samples and yields ``(x, y, adj_idx)`` triples. ``data.device_loader``
holds their device-resident counterparts; under a mesh both hold a rank's
node range and yield global batches (``data.device_loader``).
"""

from __future__ import annotations

import numpy as np

from graph_wavenet_tpu_torch.data.native_loader import (  # noqa: F401
    WindowDataLoader,
    gather_windows,
)


def pad_with_last(arr: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad the leading axis with copies of the last entry so
    ``len % batch_size == 0``."""
    pad = (-len(arr)) % batch_size
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)],
                             axis=0)
    return arr


class DataLoader:
    """Batcher over (xs, ys[, adj_idx]) arrays."""

    def __init__(self, xs: np.ndarray, ys: np.ndarray, batch_size: int,
                 rng: np.random.Generator,
                 adj_idx: np.ndarray | None = None):
        self.batch_size = batch_size
        self.num_real = len(xs)
        self.rng = rng
        xs = pad_with_last(xs, batch_size)
        ys = pad_with_last(ys, batch_size)
        if adj_idx is not None:
            adj_idx = pad_with_last(np.asarray(adj_idx), batch_size)
        self.size = len(xs)
        self.num_batch = self.size // batch_size
        self.xs = xs
        self.ys = ys
        self.adj_idx = adj_idx

    def shuffle(self):
        perm = self.rng.permutation(self.size)
        self.xs = self.xs[perm]
        self.ys = self.ys[perm]
        if self.adj_idx is not None:
            self.adj_idx = self.adj_idx[perm]

    def get_iterator(self):
        for i in range(self.num_batch):
            lo, hi = i * self.batch_size, (i + 1) * self.batch_size
            if self.adj_idx is None:
                yield self.xs[lo:hi], self.ys[lo:hi]
            else:
                yield self.xs[lo:hi], self.ys[lo:hi], self.adj_idx[lo:hi]

    def __len__(self):
        return self.num_batch
