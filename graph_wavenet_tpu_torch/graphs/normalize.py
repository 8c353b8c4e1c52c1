"""Adjacency normalizers and the ``adjtype`` dispatch.

A copy of ``graph_wavenet_tpu/graphs/normalize.py`` (numpy only): the
reference's ``sym_adj``, ``asym_adj``, normalized and scaled Laplacians,
``mod_adj`` and ``load_adj``, dense numpy, run once on the host when the
data loads. Every function takes a dense ``(N, N)`` array and returns
float32.
"""

from __future__ import annotations

import pickle

import numpy as np


def sym_adj(adj: np.ndarray) -> np.ndarray:
    """Symmetric normalization D^-1/2 A D^-1/2. The reference computes
    ``(A D^-1/2)^T D^-1/2 = D^-1/2 A^T D^-1/2``, which equals it for the
    undirected matrices it is applied to; the transpose is kept so directed
    inputs match too."""
    adj = np.asarray(adj, dtype=np.float64)
    rowsum = adj.sum(axis=1)
    d_inv_sqrt = np.power(rowsum, -0.5, where=rowsum > 0,
                          out=np.zeros_like(rowsum))
    d_inv_sqrt[~np.isfinite(d_inv_sqrt)] = 0.0
    return ((adj * d_inv_sqrt[None, :]).T * d_inv_sqrt[None, :]).astype(
        np.float32)


def asym_adj(adj: np.ndarray) -> np.ndarray:
    """Random-walk transition matrix D^-1 A."""
    adj = np.asarray(adj, dtype=np.float64)
    rowsum = adj.sum(axis=1)
    d_inv = np.power(rowsum, -1.0, where=rowsum > 0, out=np.zeros_like(rowsum))
    d_inv[~np.isfinite(d_inv)] = 0.0
    return (d_inv[:, None] * adj).astype(np.float32)


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """L = I - D^-1/2 A D^-1/2 (with :func:`sym_adj`'s transpose)."""
    adj = np.asarray(adj, dtype=np.float64)
    return (np.eye(adj.shape[0]) - sym_adj(adj)).astype(np.float32)


def scaled_laplacian(adj: np.ndarray, lambda_max: float | None = 2.0,
                     undirected: bool = True) -> np.ndarray:
    """2 L / lambda_max - I."""
    adj = np.asarray(adj, dtype=np.float64)
    if undirected:
        adj = np.maximum(adj, adj.T)
    lap = normalized_laplacian(adj).astype(np.float64)
    if lambda_max is None:
        lambda_max = float(np.max(np.linalg.eigvalsh((lap + lap.T) / 2)))
    n = lap.shape[0]
    return ((2.0 / lambda_max) * lap - np.eye(n)).astype(np.float32)


def mod_adj(adj_mx: np.ndarray, adjtype: str) -> list[np.ndarray]:
    """The supports of an ``adjtype``: "doubletransition" (``[D^-1 A,
    D^-1 A^T-normalized]``, the reference's training command), "transition",
    "symnadj", "normlap", "scalap" or "identity"."""
    if adjtype == "scalap":
        return [scaled_laplacian(adj_mx)]
    if adjtype == "normlap":
        return [normalized_laplacian(adj_mx)]
    if adjtype == "symnadj":
        return [sym_adj(adj_mx)]
    if adjtype == "transition":
        return [asym_adj(adj_mx)]
    if adjtype == "doubletransition":
        return [asym_adj(adj_mx), asym_adj(np.transpose(adj_mx))]
    if adjtype == "identity":
        return [np.eye(adj_mx.shape[0], dtype=np.float32)]
    raise ValueError(f"adj type not defined: {adjtype!r}")


def load_pickle(path: str):
    """Unpickle, with the latin1 fallback for python2-era pickles. Read
    only files from a trusted source: unpickling can run code."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except UnicodeDecodeError:
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")


def load_adj(pkl_filename: str, adjtype: str):
    """A DCRNN-format ``(sensor_ids, id_to_ind, adj_mx)`` pickle ->
    ``(sensor_ids, id_to_ind, mod_adj(adj_mx, adjtype))``."""
    sensor_ids, sensor_id_to_ind, adj_mx = load_pickle(pkl_filename)
    return sensor_ids, sensor_id_to_ind, mod_adj(np.asarray(adj_mx), adjtype)
