"""Spatial (road-network-like) graphs on edge lists, and the
doubletransition support pair in block-sparse form.

A copy of ``graph_wavenet_tpu/graphs/spatial.py``: a k-NN graph on sensor
coordinates with Gaussian kernel weights (kd-tree, O(N k log N)),
normalized directly on the edge list, in any of the reference's four
block-sparse forms: flat (kernels 1-3) or padded (kernels 4 and 5).
"""

from __future__ import annotations

import numpy as np
import torch

from graph_wavenet_tpu_torch.ops import block_sparse


def knn_graph_edges(pos: np.ndarray, k: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed k-NN edges ``(src, dst, weight)`` on point coordinates
    ``pos (N, d)`` with Gaussian kernel weights ``exp(-d^2 / sigma^2)``,
    sigma = the std of all k-NN distances. The self match is dropped by
    index wherever the kd-tree put it; a row whose k+1 nearest are all
    coincident drops its last tied column instead."""
    from scipy.spatial import cKDTree

    n = pos.shape[0]
    d, nbr = cKDTree(pos).query(pos, k=k + 1)
    self_col = np.argmax(nbr == np.arange(n)[:, None], axis=1)
    self_col = np.where((nbr == np.arange(n)[:, None]).any(axis=1),
                        self_col, k)
    keep = np.ones((n, k + 1), bool)
    keep[np.arange(n), self_col] = False
    src = np.repeat(np.arange(n), k)
    dst = nbr[keep].reshape(-1)
    dist = d[keep].reshape(-1)
    sigma = max(float(dist.std()), 1e-12)
    w = np.exp(-(dist ** 2) / (sigma ** 2)).astype(np.float32)
    return src, dst, w


def random_spatial_graph(n: int, k: int, rng: np.random.Generator
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k-NN graph on uniform random 2-D points: the synthetic road-network
    stand-in."""
    return knn_graph_edges(rng.random((n, 2)), k)


def transition_edge_weights(src: np.ndarray, dst: np.ndarray,
                            w: np.ndarray, n: int) -> np.ndarray:
    """Row-normalized random-walk weights on the edge list:
    ``A[s, d] / sum_d A[s, :]``. Rows with no out-edges keep weight 0."""
    deg = np.bincount(src, weights=w, minlength=n)
    out = np.zeros_like(w, np.float32)
    nz = deg[src] > 0
    out[nz] = w[nz] / deg[src[nz]]
    return out


def doubletransition_block_supports(src: np.ndarray, dst: np.ndarray,
                                    w: np.ndarray, n: int,
                                    perm: np.ndarray | None = None,
                                    form: str = "flat",
                                    block_size: int = 128, *,
                                    device: torch.device | str = "cuda"
                                    ) -> list:
    """The doubletransition pair ``[asym_adj(A), asym_adj(A^T)]`` in
    block-sparse form, straight from the edge list, under node ordering
    ``perm`` (``new = perm[old]``).

    form: "flat" (square live blocks; banded layouts are upgraded to the
    fused order-2 kernel by ``as_fused2``), "flat-rect" (block_size x
    4*block_size rectangular destination blocks; N must divide by both),
    "block" or "pallas" (blocks padded per block-row to the row maximum).
    The two padded forms run the same kernels in the port (in the
    reference, "block" is an XLA gather-and-einsum); each keeps its class
    name so a layout records the form it was asked for.
    """
    if form not in ("flat", "flat-rect", "block", "pallas"):
        raise ValueError(f"unknown support form {form!r}")
    sup = []
    for s, d in ((src, dst), (dst, src)):        # A and A^T transitions
        wt = transition_edge_weights(s, d, w, n)
        if form == "flat":
            sup.append(block_sparse.as_fused2(block_sparse.from_edges_flat(
                s, d, wt, n, block_size, block_size, perm=perm,
                device=device)))
        elif form == "flat-rect":
            sup.append(block_sparse.from_edges_flat(
                s, d, wt, n, block_size, 4 * block_size, perm=perm,
                device=device))
        else:
            sp = block_sparse.from_edges_blocked(
                s, d, wt, n, block_size=block_size, perm=perm, device=device)
            sup.append(block_sparse.as_pallas(sp) if form == "pallas"
                       else sp)
    return sup
