"""Offline traffic ETL: raw readings -> windowed train/val/test npz splits.

A copy of ``graph_wavenet_tpu/data/traffic_etl.py`` (numpy; pandas only
inside :func:`load_hdf_readings`, imported there): features are [reading,
time of day in [0, 1)] (+ day of week on request), x offsets -(L-1)..0, y
offsets y_start..L, stride-1 windows by fancy indexing, a chronological
70/10/20 split.
"""

from __future__ import annotations

import os

import numpy as np


def build_features(values: np.ndarray, index=None, add_time_in_day=True,
                   add_day_in_week=False) -> np.ndarray:
    """(T, N) readings + optional datetime64 index -> (T, N, F) features."""
    num_samples, num_nodes = values.shape
    feats = [values[..., None]]
    if add_time_in_day:
        if index is None:
            raise ValueError("time-in-day feature needs a datetime index")
        idx = np.asarray(index)
        time_ind = (idx - idx.astype("datetime64[D]")) / np.timedelta64(1, "D")
        feats.append(np.tile(time_ind[:, None, None], (1, num_nodes, 1)))
    if add_day_in_week:
        if index is None:
            raise ValueError("day-of-week feature needs a datetime index")
        idx = np.asarray(index)
        # pandas' dayofweek (Monday = 0): epoch day 0, 1970-01-01, was a
        # Thursday (3)
        dow = ((idx.astype("datetime64[D]").view("int64") + 3) % 7)
        feats.append(np.tile(dow[:, None, None].astype(np.float64),
                             (1, num_nodes, 1)))
    return np.concatenate(feats, axis=-1)


def make_windows(data: np.ndarray, x_offsets: np.ndarray,
                 y_offsets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(T, N, F) -> x (n, len(x_offsets), N, F), y (n, len(y_offsets), N, F)
    over every valid anchor t."""
    num_samples = data.shape[0]
    min_t = abs(min(x_offsets))
    max_t = abs(num_samples - abs(max(y_offsets)))
    anchors = np.arange(min_t, max_t)
    x = data[anchors[:, None] + x_offsets[None, :]]
    y = data[anchors[:, None] + y_offsets[None, :]]
    return x, y


def generate_train_val_test(values: np.ndarray, output_dir: str, index=None,
                            seq_length_x: int = 12, seq_length_y: int = 12,
                            y_start: int = 1, add_time_in_day: bool = True,
                            add_day_in_week: bool = False) -> dict:
    """Write {train,val,test}.npz (``x``, ``y``, ``x_offsets``,
    ``y_offsets``) with a chronological 70/10/20 split; returns each split's
    x shape."""
    x_offsets = np.arange(-(seq_length_x - 1), 1)
    y_offsets = np.arange(y_start, seq_length_y + 1)
    data = build_features(values, index, add_time_in_day, add_day_in_week)
    x, y = make_windows(data, x_offsets, y_offsets)

    num_samples = x.shape[0]
    num_test = round(num_samples * 0.2)
    num_train = round(num_samples * 0.7)
    num_val = num_samples - num_test - num_train
    if min(num_train, num_val, num_test) < 1:
        # x[-0:] would write test.npz = every sample, the train split too
        raise ValueError(
            f"series yields only {num_samples} windowed samples, too few "
            f"for the 70/10/20 split (train/val/test = "
            f"{num_train}/{num_val}/{num_test})")
    splits = {
        "train": (x[:num_train], y[:num_train]),
        "val": (x[num_train:num_train + num_val],
                y[num_train:num_train + num_val]),
        "test": (x[-num_test:], y[-num_test:]),
    }
    os.makedirs(output_dir, exist_ok=True)
    for cat, (xs, ys) in splits.items():
        np.savez_compressed(
            os.path.join(output_dir, f"{cat}.npz"), x=xs, y=ys,
            x_offsets=x_offsets.reshape(-1, 1),
            y_offsets=y_offsets.reshape(-1, 1))
    return {k: v[0].shape for k, v in splits.items()}


def load_hdf_readings(path: str):
    """Read a pandas h5 of traffic readings -> (values, datetime index).
    Needs pandas (and PyTables), imported here only."""
    import pandas as pd

    df = pd.read_hdf(path)
    return df.values, df.index.values
