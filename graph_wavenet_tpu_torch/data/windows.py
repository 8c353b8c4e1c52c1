"""Sliding windows over a time axis, and their inverse.

A copy of ``graph_wavenet_tpu/data/windows.py`` (numpy only):

- :func:`sliding_windows`: every stride-1 window of a width along an axis,
  by stride tricks (the traffic ETL's and the synthetic generator's
  windowing);
- :func:`reverse_sliding_window`: stride-1 windows back to one series, the
  overlapping entries averaged (test-time sequence reconstruction).
"""

from __future__ import annotations

import numpy as np


def sliding_windows(data: np.ndarray, width: int,
                    axis: int = 0) -> np.ndarray:
    """All stride-1 windows of ``width`` along ``axis``; the window axis is
    inserted right after ``axis``."""
    axis = axis % data.ndim
    out = np.lib.stride_tricks.sliding_window_view(data, width, axis=axis)
    # the window axis arrives last; move it after ``axis``
    return np.moveaxis(out, -1, axis + 1)


def reverse_sliding_window(windows_list: list[np.ndarray]) -> list[np.ndarray]:
    """Each input: (num_window, num_nodes, width) stride-1 windows. Returns
    (num_nodes, num_window + width - 1) with overlaps averaged."""
    out = []
    for a in windows_list:
        if a.ndim != 3:
            raise ValueError(f"windows must be (num_window, num_nodes, "
                             f"width), got shape {a.shape}")
        num_window, num_nodes, width = a.shape
        num_t = num_window + width - 1
        total = np.zeros((num_nodes, num_t))
        count = np.zeros(num_t)
        for w in range(num_window):
            total[:, w:w + width] += a[w]
            count[w:w + width] += 1
        out.append(total / count[None, :])
    return out
