"""Host-side batchers.

Copies of ``graph_wavenet_tpu/data/loader.py``'s ``DataLoader`` and
``data/native_loader.py``'s ``WindowDataLoader`` with its numpy gather (the
reference's threaded native library is not carried over). Both pad the
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


def gather_windows(series: np.ndarray, anchors: np.ndarray,
                   window: int) -> np.ndarray:
    """series (T, N, F), anchors (B,) window-start rows -> (B, window, N, F)
    float32."""
    series = np.asarray(series, dtype=np.float32)
    anchors = np.asarray(anchors, dtype=np.int64)
    t = series.shape[0]
    if len(anchors) and (anchors.min() < 0 or anchors.max() > t - window):
        raise ValueError(
            f"window anchors out of range: starts must lie in "
            f"[0, {t - window}] for a {window}-row window over {t} rows "
            f"(got [{anchors.min()}, {anchors.max()}])")
    return series[anchors[:, None] + np.arange(window)[None, :]]


class WindowDataLoader:
    """Batcher over a raw feature series: ``(x, y)`` = (the ``window``
    rows ending at an anchor, the rows ``y_start .. horizon`` after it),
    assembled per batch, the samples of the materialized windows without
    the windowed copy. ``horizon`` is the last y offset, so y has ``horizon
    - y_start + 1`` rows; ``anchors`` selects a split; ``y_series`` gives
    the targets their own series (raw units while x is standardized)."""

    def __init__(self, series: np.ndarray, window: int, horizon: int,
                 batch_size: int, y_start: int = 1,
                 anchors: np.ndarray | None = None,
                 y_series: np.ndarray | None = None,
                 rng: np.random.Generator | None = None):
        self.series = np.ascontiguousarray(series, dtype=np.float32)
        self.y_series = (self.series if y_series is None else
                         np.ascontiguousarray(y_series, dtype=np.float32))
        self.window = window
        self.horizon = horizon
        self.batch_size = batch_size
        self.y_start = y_start
        self.y_len = horizon - y_start + 1
        self.rng = rng if rng is not None else np.random.default_rng()
        if anchors is None:
            anchors = self.valid_anchors(series.shape[0], window, horizon)
        anchors = np.asarray(anchors, dtype=np.int64)
        self.num_real = len(anchors)
        self.anchors = pad_with_last(anchors, batch_size)
        self.size = len(self.anchors)
        self.num_batch = self.size // batch_size

    @staticmethod
    def valid_anchors(t: int, window: int, horizon: int) -> np.ndarray:
        """Every anchor (the last observed row) with a full window before it
        and ``horizon`` rows after it."""
        return np.arange(window - 1, t - horizon, dtype=np.int64)

    def shuffle(self):
        self.anchors = self.anchors[self.rng.permutation(self.size)]

    def get_iterator(self):
        for i in range(self.num_batch):
            a = self.anchors[i * self.batch_size:(i + 1) * self.batch_size]
            x = gather_windows(self.series, a - (self.window - 1),
                               self.window)
            y = gather_windows(self.y_series, a + self.y_start, self.y_len)
            yield x, y
