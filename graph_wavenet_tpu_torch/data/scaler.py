"""Standardization of input features (copy of the reference package's
``data/scaler.py``): fit on the raw signal channel, transform feature 0
of every split in place (C-contiguous float32 arrays through the native
library's threaded kernel, ``data.native_loader``; numpy otherwise, bit
for bit the same)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StandardScaler:
    mean: float
    std: float

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return (data * self.std) + self.mean

    @classmethod
    def fit(cls, x: np.ndarray) -> "StandardScaler":
        """Fit on the raw signal channel, e.g. ``x_train[..., 0]``."""
        return cls(mean=float(x.mean()), std=float(x.std()))


def apply_feature0_scaling(data: dict, scaler: StandardScaler) -> None:
    """Standardize feature 0 of ``x_train``/``x_val``/``x_test`` in place;
    the targets stay in raw units."""
    from graph_wavenet_tpu_torch.data.native_loader import (
        standardize_feature0,
    )

    for category in ("train", "val", "test"):
        key = "x_" + category
        if key in data and not standardize_feature0(
                data[key], scaler.mean, scaler.std):
            data[key][..., 0] = scaler.transform(data[key][..., 0])
