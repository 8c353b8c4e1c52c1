"""Traffic benchmark dataset loading (METR-LA, PEMS-BAY and the city data).

Counterpart of ``graph_wavenet_tpu/data/metr.py``, host resident:

- :func:`load_dataset`: prebuilt ``train/val/test.npz`` windows (``x``,
  ``y`` of shape (S, T, N, F)) -> a scaler fitted on ``x_train[..., 0]``
  (or the one given) -> feature 0 of every split standardized (targets stay
  in raw units) -> a city node layout applied -> three batchers sharing one
  seeded numpy Generator;
- :func:`load_dataset_streaming`: the same samples, splits and scaler
  straight from the raw (T, N) readings, windows assembled per batch
  (:class:`data.native_loader.WindowDataLoader`, the native window
  gather); the scaler equals the materialized fit through
  window-multiplicity weights.

``resident="device"`` keeps the splits on ``device`` instead and gathers
every batch there (``data.device_loader``): the same batches in the same
order as the host batchers for a seed, and the form the fused train steps
(``Engine.train_steps_resident`` / ``train_steps_windows``) read.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.data.device_loader import (
    DeviceArrayLoader,
    DeviceWindowLoader,
    resident as to_resident,
)
from graph_wavenet_tpu_torch.data.loader import DataLoader
from graph_wavenet_tpu_torch.data.native_loader import (
    WindowDataLoader,
    gather_windows,
)
from graph_wavenet_tpu_torch.data.scaler import (
    StandardScaler,
    apply_feature0_scaling,
)


def _check_resident(resident: str) -> None:
    if resident not in ("host", "device"):
        raise ValueError(f"resident must be 'host' or 'device', got "
                         f"{resident!r}")


def load_dataset(dataset_dir: str, batch_size: int, seed: int = 0,
                 resident: str = "host",
                 scaler: StandardScaler | None = None,
                 node_layout: dict | None = None,
                 device: torch.device | str = "cuda",
                 nodes: tuple[int, int] | None = None) -> dict:
    """``scaler``: standardize with this one instead of fitting on this
    directory's ``x_train`` (evaluating a checkpoint takes its training
    statistics). ``node_layout`` (``graphs.city``): the node axis of every
    split is permuted into model order and zero-padded after the scaler
    fit, so pad zeros do not bias the statistics. ``device``: where
    ``resident="device"`` keeps the splits (the host arrays ``x_*``,
    ``y_*`` stay in the dict either way). ``nodes``: a node-TP rank's
    ``[lo, hi)`` in model order (``parallel.mesh.Mesh.node_range``): every
    split keeps only those nodes, after the scaler fit and the layout, so
    the loaders and the test targets hold the rank's range (uneven where
    the model axis does not divide the nodes). ``num_nodes``: the nodes of
    the data (in model order) before that cut."""
    _check_resident(resident)
    rng = np.random.default_rng(seed)
    data: dict = {}
    for category in ("train", "val", "test"):
        with np.load(os.path.join(dataset_dir, category + ".npz")) as cat:
            data["x_" + category] = cat["x"].astype(np.float32)
            data["y_" + category] = cat["y"].astype(np.float32)
    if scaler is None:
        scaler = StandardScaler.fit(data["x_train"][..., 0])
    apply_feature0_scaling(data, scaler)
    if node_layout is not None:
        from graph_wavenet_tpu_torch.graphs.city import apply_layout_to_data

        apply_layout_to_data(data, node_layout)
    data["num_nodes"] = int(data["x_train"].shape[2])
    if nodes is not None:
        lo, hi = nodes
        for k in [k for k in data if k.startswith(("x_", "y_"))]:
            data[k] = np.ascontiguousarray(data[k][:, :, lo:hi])
    for category in ("train", "val", "test"):
        xs, ys = data["x_" + category], data["y_" + category]
        data[category + "_loader"] = (
            DataLoader(xs, ys, batch_size, rng) if resident == "host" else
            DeviceArrayLoader(xs, ys, batch_size, rng=rng, device=device))
    data["scaler"] = scaler
    return data


def _window_multiplicity(anchors: np.ndarray, window: int,
                         t_total: int) -> np.ndarray:
    """count[t]: how many x-windows over ``anchors`` contain row t."""
    delta = np.zeros(t_total + 1, dtype=np.int64)
    np.add.at(delta, anchors - window + 1, 1)     # +1 at window starts
    np.add.at(delta, anchors + 1, -1)             # -1 past window ends
    return np.cumsum(delta[:-1])


def weighted_feature0_scaler(series: np.ndarray, anchors: np.ndarray,
                             window: int) -> StandardScaler:
    """The scaler a fit on the materialized train windows' feature 0 would
    give: each raw row weighted by how many train windows hold it."""
    w = _window_multiplicity(np.asarray(anchors), window, series.shape[0])
    f0 = series[..., 0].astype(np.float64)          # (T, N)
    total = float((w * series.shape[1]).sum())
    mean = float((f0.sum(axis=1) * w).sum() / total)
    var = float((((f0 - mean) ** 2).sum(axis=1) * w).sum() / total)
    return StandardScaler(mean=mean, std=float(np.sqrt(var)))


def load_dataset_streaming(values: np.ndarray, index=None,
                           batch_size: int = 64, seq_length_x: int = 12,
                           seq_length_y: int = 12, y_start: int = 1,
                           add_time_in_day: bool = True,
                           add_day_in_week: bool = False,
                           seed: int = 0, resident: str = "host",
                           device: torch.device | str = "cuda") -> dict:
    """Raw (T, N) readings -> window loaders with the ETL's samples, its
    chronological 70/10/20 split over anchors and its scaler. Returns
    :func:`load_dataset`'s surface (three loaders, ``scaler``, ``y_test``)
    for the runner. Under ``resident="device"`` the three splits share one
    upload of each series to ``device``."""
    from graph_wavenet_tpu_torch.data.traffic_etl import build_features

    _check_resident(resident)
    rng = np.random.default_rng(seed)
    series = build_features(values, index, add_time_in_day,
                            add_day_in_week).astype(np.float32)
    anchors = WindowDataLoader.valid_anchors(series.shape[0], seq_length_x,
                                             seq_length_y)
    n = len(anchors)
    if n == 0:
        raise ValueError(
            f"series of length {series.shape[0]} is too short for "
            f"window {seq_length_x} + horizon {seq_length_y}: no valid "
            "samples")
    n_test = round(n * 0.2)
    n_train = round(n * 0.7)
    n_val = n - n_test - n_train
    if min(n_train, n_val, n_test) < 1:
        # anchors[-0:] would make the test split every anchor
        raise ValueError(
            f"series yields only {n} windowed samples, too few for the "
            f"70/10/20 chronological split "
            f"(train/val/test = {n_train}/{n_val}/{n_test})")
    splits = {"train": anchors[:n_train],
              "val": anchors[n_train:n_train + n_val],
              "test": anchors[-n_test:]}
    scaler = weighted_feature0_scaler(series, splits["train"], seq_length_x)
    x_series = series.copy()
    x_series[..., 0] = scaler.transform(x_series[..., 0])
    data: dict = {"scaler": scaler}
    if resident == "host":
        window_cls, kw, xs, ys = WindowDataLoader, {}, x_series, series
    else:
        dev = resolve_device(device)
        window_cls, kw = DeviceWindowLoader, {"device": dev}
        xs, ys = to_resident(x_series, dev), to_resident(series, dev)
    for name, a in splits.items():
        data[name + "_loader"] = window_cls(
            xs, seq_length_x, seq_length_y, batch_size, y_start=y_start,
            anchors=a, y_series=ys, rng=rng, **kw)
    # the per-horizon test needs the test targets; the rest stays windows
    # assembled per batch
    data["y_test"] = gather_windows(series, splits["test"] + y_start,
                                    seq_length_y - y_start + 1)
    return data
