"""Device-resident batchers: the dataset stays on the engine's device and
every batch is a gather there.

Counterpart of ``graph_wavenet_tpu/data/device_loader.py``. The host
batchers (``data.loader``) copy every batch from the host; here the series
or the sample arrays go to the device once, and a step sends only its
``batch_size`` int32 indices (a superbatch of the fused train steps sends
one (S, B) index matrix for S steps):

- :class:`DeviceWindowLoader`: the raw series resident, the x and y
  windows of each batch gathered from it (the device counterpart of
  ``data.native_loader.WindowDataLoader``);
- :class:`DeviceArrayLoader`: prebuilt sample arrays resident, each batch
  an ``index_select`` by sample index (the counterpart of
  ``data.loader.DataLoader``); with ``adj_idx`` (per-sample graphs) its
  batches are ``(x, y, adj_idx)`` triples, the graph indices on the host,
  and ``resident_adj_idx()`` is their device copy for the fused diff-G
  steps (``Engine.train_steps_syn_resident``).

:func:`array_loader` picks the host or the device batcher for a residency.

Both shuffle on the host, over the anchors or the sample indices, with the
host batchers' seeded numpy Generator, so a seed gives the same batches in
the same order on both; padding repeats the last sample by index, not by
copying data. ``superbatches(S)`` and ``remainder_batches(S)`` split an
epoch for ``train.engine.Engine.train_steps_windows`` / ``..._resident``,
which gather each step's batch inside the fused call from
``resident_series()`` / ``resident_arrays()``.

Under a mesh (``parallel.mesh``) every rank builds its loaders from the
same seed, over its node range only (``data.metr.load_dataset(...,
nodes=)``), so the ranks shuffle alike and each holds its node range of every
sample: the global dataset (its node range) on every rank's card. A batch
is the global batch's rows, of which the engine takes the rank's share
(``Mesh.batch_rows``); a superbatch is the global (S, B) index matrix, of
whose columns the engine keeps the rank's inside the fused call
(``Mesh.index_share``).
"""

from __future__ import annotations

import numpy as np
import torch

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.data.loader import DataLoader, pad_with_last
from graph_wavenet_tpu_torch.data.native_loader import WindowDataLoader


def gather_window_rows(src: torch.Tensor, starts: torch.Tensor,
                       length: int) -> torch.Tensor:
    """(T, ...) resident series and (B,) start rows -> (B, length, ...):
    the device form of ``data.native_loader.gather_windows`` (no range check: the
    loaders validate their anchors when they are built)."""
    idx = starts[:, None] + torch.arange(length, device=starts.device,
                                         dtype=starts.dtype)[None, :]
    return src.index_select(0, idx.reshape(-1)).reshape(
        starts.shape[0], length, *src.shape[1:])


def gather_xy_windows(series_x: torch.Tensor, series_y: torch.Tensor,
                      anchors: torch.Tensor, window: int, y_start: int,
                      y_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A batch (x, y) of (B,) anchors: the ``window`` rows of ``series_x``
    ending at each anchor, and the ``y_len`` rows of ``series_y`` from
    anchor + ``y_start``."""
    return (gather_window_rows(series_x, anchors - (window - 1), window),
            gather_window_rows(series_y, anchors + y_start, y_len))


def resident(a, device: torch.device) -> torch.Tensor:
    """``a`` as a contiguous float32 tensor on ``device``; a tensor already
    there is used as it is, so splits can share one upload."""
    if (torch.is_tensor(a) and a.device == device
            and a.dtype == torch.float32):
        return a.contiguous()
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32),
                           device=device)


class DeviceWindowLoader:
    """Windows-on-demand batcher over a series resident on ``device``.

    ``series_x``: the standardized features (T, N, C); ``y_series``: the
    targets' series in raw units (default ``series_x``); either may be a
    tensor already on ``device``. ``anchors``: the last observed row of each
    sample (default every valid one); ``horizon`` the last y offset, so y
    has ``horizon - y_start + 1`` rows."""

    def __init__(self, series_x, window: int, horizon: int,
                 batch_size: int, y_start: int = 1,
                 anchors: np.ndarray | None = None, y_series=None,
                 rng: np.random.Generator | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.window = window
        self.horizon = horizon
        self.batch_size = batch_size
        self.y_start = y_start
        self.y_len = horizon - y_start + 1
        self.rng = rng if rng is not None else np.random.default_rng()
        t_x = series_x.shape[0]
        t_y = t_x if y_series is None else y_series.shape[0]
        if anchors is None:
            anchors = WindowDataLoader.valid_anchors(t_x, window, horizon)
        anchors = np.asarray(anchors, dtype=np.int32)
        # an index_select past the series raises on the CPU but reads
        # garbage or faults on the card: refuse bad anchors here
        first, last = window - 1, min(t_x - 1, t_y - horizon - 1)
        if len(anchors) and (anchors.min() < first or anchors.max() > last):
            raise ValueError(
                f"window anchors out of range: anchors must lie in "
                f"[{first}, {last}] (x reads anchor-{window - 1}..anchor "
                f"over {t_x} rows, y reads anchor+{y_start}..anchor+"
                f"{horizon} over {t_y} rows); got "
                f"[{anchors.min()}, {anchors.max()}]")
        self._dev_x = resident(series_x, self.device)
        self._dev_y = (self._dev_x if y_series is None
                       else resident(y_series, self.device))
        self.num_real = len(anchors)
        self.anchors = pad_with_last(anchors, batch_size)
        self.size = len(self.anchors)
        self.num_batch = self.size // batch_size

    def shuffle(self):
        self.anchors = self.anchors[self.rng.permutation(self.size)]

    def _batch(self, a: np.ndarray):
        return gather_xy_windows(self._dev_x, self._dev_y,
                                 torch.as_tensor(a, device=self.device),
                                 self.window, self.y_start, self.y_len)

    def get_iterator(self):
        b = self.batch_size
        for i in range(self.num_batch):
            yield self._batch(self.anchors[i * b:(i + 1) * b])

    def resident_series(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The resident (x series, y series)."""
        return self._dev_x, self._dev_y

    def superbatches(self, scan_steps: int):
        """(scan_steps, batch_size) int32 anchor matrices: the epoch's full
        chunks in the current shuffle order."""
        b = self.batch_size
        for c in range(self.num_batch // scan_steps):
            lo = c * scan_steps * b
            yield self.anchors[lo:lo + scan_steps * b].reshape(scan_steps, b)

    def remainder_batches(self, scan_steps: int):
        """(x, y) of the batches :meth:`superbatches` leaves over."""
        b = self.batch_size
        for i in range((self.num_batch // scan_steps) * scan_steps,
                       self.num_batch):
            yield self._batch(self.anchors[i * b:(i + 1) * b])

    def __len__(self):
        return self.num_batch


class DeviceArrayLoader:
    """Batcher over (xs, ys) sample arrays resident on ``device`` (numpy
    arrays, or tensors already there). The tail pads to a whole batch
    with the last sample, by index. ``adj_idx``: the graph index of every
    sample (per-sample-graph datasets); batches then carry theirs."""

    def __init__(self, xs, ys, batch_size: int,
                 rng: np.random.Generator | None = None,
                 device: torch.device | str = "cuda",
                 adj_idx: np.ndarray | None = None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.rng = rng if rng is not None else np.random.default_rng()
        n = len(xs)
        self.num_real = n
        self._index = pad_with_last(np.arange(n, dtype=np.int32), batch_size)
        self.size = len(self._index)
        self.num_batch = self.size // batch_size
        self._dev_x = resident(xs, self.device)
        self._dev_y = resident(ys, self.device)
        self.adj_idx = None
        self._dev_adj = None
        if adj_idx is not None:
            self.adj_idx = np.asarray(adj_idx, dtype=np.int32)
            if self.adj_idx.shape != (n,):
                raise ValueError(f"adj_idx must be ({n},), one graph per "
                                 f"sample; got {self.adj_idx.shape}")
            self._dev_adj = torch.as_tensor(self.adj_idx, device=self.device)

    def shuffle(self):
        self._index = self._index[self.rng.permutation(self.size)]

    def _batch(self, sel: np.ndarray):
        dev_sel = torch.as_tensor(sel, device=self.device)
        x = self._dev_x.index_select(0, dev_sel)
        y = self._dev_y.index_select(0, dev_sel)
        if self.adj_idx is None:
            return x, y
        return x, y, self.adj_idx[sel]

    def get_iterator(self):
        b = self.batch_size
        for i in range(self.num_batch):
            yield self._batch(self._index[i * b:(i + 1) * b])

    def resident_arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The resident (xs, ys) sample arrays."""
        return self._dev_x, self._dev_y

    def resident_adj_idx(self) -> torch.Tensor:
        """The graph index of every sample, int32 on the device."""
        if self._dev_adj is None:
            raise ValueError("this loader was built without adj_idx")
        return self._dev_adj

    def superbatches(self, scan_steps: int):
        """(scan_steps, batch_size) int32 sample-index matrices: the
        epoch's full chunks in the current shuffle order."""
        b = self.batch_size
        for c in range(self.num_batch // scan_steps):
            lo = c * scan_steps * b
            yield self._index[lo:lo + scan_steps * b].reshape(scan_steps, b)

    def remainder_batches(self, scan_steps: int):
        """The batches :meth:`superbatches` leaves over, as
        :meth:`get_iterator` yields them."""
        b = self.batch_size
        for i in range((self.num_batch // scan_steps) * scan_steps,
                       self.num_batch):
            yield self._batch(self._index[i * b:(i + 1) * b])

    def __len__(self):
        return self.num_batch


def array_loader(resident: str, xs, ys, batch_size: int,
                 rng: np.random.Generator, *,
                 adj_idx: np.ndarray | None = None,
                 device: torch.device | str = "cuda"):
    """The batcher of a residency: ``"host"`` (numpy batches,
    :class:`data.loader.DataLoader`) or ``"device"``
    (:class:`DeviceArrayLoader` on ``device``)."""
    if resident == "host":
        return DataLoader(xs, ys, batch_size, rng, adj_idx=adj_idx)
    if resident == "device":
        return DeviceArrayLoader(xs, ys, batch_size, rng=rng, device=device,
                                 adj_idx=adj_idx)
    raise ValueError(f"resident must be 'host' or 'device', got "
                     f"{resident!r}")
