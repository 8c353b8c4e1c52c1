"""Traffic dataset loading from prebuilt window splits.

Counterpart of ``graph_wavenet_tpu/data/metr.py:load_dataset``, host
resident: ``train/val/test.npz`` (``x``, ``y`` of shape (S, T, N, F)) ->
scaler fitted on ``x_train[..., 0]`` -> feature 0 of every split
standardized (targets stay in raw units) -> the node layout applied ->
three batchers sharing one seeded numpy Generator.
"""

from __future__ import annotations

import os

import numpy as np

from graph_wavenet_tpu_torch.data.loader import DataLoader
from graph_wavenet_tpu_torch.data.scaler import StandardScaler


def load_dataset(dataset_dir: str, batch_size: int, seed: int = 0,
                 node_layout: dict | None = None) -> dict:
    """``node_layout`` (``graphs.city``): the node axis of every split is
    permuted into model order and zero-padded after the scaler fit, so pad
    zeros do not bias the statistics."""
    rng = np.random.default_rng(seed)
    data: dict = {}
    for category in ("train", "val", "test"):
        with np.load(os.path.join(dataset_dir, category + ".npz")) as cat:
            data["x_" + category] = cat["x"].astype(np.float32)
            data["y_" + category] = cat["y"].astype(np.float32)
    scaler = StandardScaler.fit(data["x_train"][..., 0])
    for category in ("train", "val", "test"):
        x = data["x_" + category]
        x[..., 0] = scaler.transform(x[..., 0])
    if node_layout is not None:
        from graph_wavenet_tpu_torch.graphs.city import apply_layout_to_data

        apply_layout_to_data(data, node_layout)
    for category in ("train", "val", "test"):
        data[category + "_loader"] = DataLoader(
            data["x_" + category], data["y_" + category], batch_size, rng)
    data["scaler"] = scaler
    return data
