"""The native (C++) host-side batch assembly, through ctypes, and the
memory-lean :class:`WindowDataLoader`.

Counterpart of ``graph_wavenet_tpu/data/native_loader.py``. The raw ``(T,
N, F)`` series stays as it is and shuffled batches are assembled on
demand: each window is one contiguous row-range ``memcpy``, threaded over
the batch, in ``csrc/windowloader.cpp`` (the JAX package's
``native/windowloader.cpp``). The library is built with ``g++`` at first use
into ``graph_wavenet_tpu_torch/_build/`` (git-ignored), named by a digest of
the source, so an edited source never loads a stale build, and published
by an atomic rename, so processes that start together never load a
half-written file. Without a compiler every function takes numpy, with
the same results bit for bit: this is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "windowloader.cpp"
BUILD_DIR = PKG / "_build"
_THREADS = min(os.cpu_count() or 1, 8)
_LIB = None
_LIB_TRIED = False


def _lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:10]
    return BUILD_DIR / f"libwindowloader-{digest}.so"


def _load_library():
    """The loaded library, built once if missing; None where it cannot be
    built or loaded (numpy takes over)."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if not SOURCE.exists():
        return None
    so_path = _lib_path()
    if not so_path.exists():
        tmp = so_path.with_suffix(f".tmp.{os.getpid()}")
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 str(SOURCE), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except (OSError, subprocess.SubprocessError):
            if tmp.exists():
                tmp.unlink()
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.gather_windows_f32.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int64, f32p, ctypes.c_int]
    lib.gather_batch_f32.argtypes = [
        f32p, ctypes.c_int64, i64p, ctypes.c_int64, f32p, ctypes.c_int]
    lib.standardize_feature0_f32.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_float, ctypes.c_int]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the C++ library is built and loaded."""
    return _load_library() is not None


def gather_windows(series: np.ndarray, anchors: np.ndarray,
                   window: int) -> np.ndarray:
    """series (T, N, F), anchors (B,) window-start rows -> (B, window, N, F)
    float32; refuses an anchor whose window leaves the series."""
    series = np.ascontiguousarray(series, dtype=np.float32)
    anchors = np.ascontiguousarray(anchors, dtype=np.int64)
    t = series.shape[0]
    if len(anchors) and (anchors.min() < 0 or anchors.max() > t - window):
        # the native copy would read out of bounds, numpy would wrap a
        # negative index
        raise ValueError(
            f"window anchors out of range: starts must lie in "
            f"[0, {t - window}] for a {window}-row window over {t} rows "
            f"(got [{anchors.min()}, {anchors.max()}])")
    out = np.empty((len(anchors), window) + series.shape[1:],
                   dtype=np.float32)
    lib = _load_library()
    if lib is not None:
        row = int(np.prod(series.shape[1:]))
        lib.gather_windows_f32(series, t, row, anchors, len(anchors),
                               window, out, _THREADS)
    else:
        out[...] = series[anchors[:, None] + np.arange(window)[None, :]]
    return out


def gather_batch(samples: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """samples (S, ...) float32, idx (B,) -> the (B, ...) rows, copied."""
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx),) + samples.shape[1:], dtype=np.float32)
    lib = _load_library()
    if lib is not None:
        elems = int(np.prod(samples.shape[1:]))
        lib.gather_batch_f32(samples, elems, idx, len(idx), out, _THREADS)
    else:
        out[...] = samples[idx]
    return out


def standardize_feature0(arr: np.ndarray, mean: float, std: float) -> bool:
    """``arr[..., 0] = (arr[..., 0] - mean) / std`` in place through the
    library; False (the caller takes numpy) where the library is missing
    or ``arr`` is not C-contiguous float32. The library divides, so the
    result is numpy's bit for bit."""
    lib = _load_library()
    if (lib is None or arr.dtype != np.float32
            or not arr.flags["C_CONTIGUOUS"] or arr.ndim < 1):
        return False
    f = arr.shape[-1]
    rows = arr.size // f
    lib.standardize_feature0_f32(arr.reshape(rows, f), rows, f,
                                 float(mean), float(std), _THREADS)
    return True


class WindowDataLoader:
    """Batcher over a raw feature series: ``(x, y)`` = (the ``window``
    rows ending at an anchor, the rows ``y_start .. horizon`` after it),
    assembled per batch by :func:`gather_windows`, the samples of the
    materialized windows without the windowed copy. ``horizon`` is the
    last y offset, so y has ``horizon - y_start + 1`` rows; ``anchors``
    selects a split; ``y_series`` gives the targets their own series (raw
    units while x is standardized). The tail is padded with the last
    anchor and the anchors shuffle from a seeded numpy Generator."""

    def __init__(self, series: np.ndarray, window: int, horizon: int,
                 batch_size: int, y_start: int = 1,
                 anchors: np.ndarray | None = None,
                 y_series: np.ndarray | None = None,
                 rng: np.random.Generator | None = None):
        from graph_wavenet_tpu_torch.data.loader import pad_with_last

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

    def __len__(self):
        return self.num_batch
