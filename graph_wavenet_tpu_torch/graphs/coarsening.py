"""Graph coarsening (Defferrard-style) and the spline basis, on the host.

Counterpart of ``graph_wavenet_tpu/graphs/coarsening.py``, a numpy copy:
``spline_basis`` (Cox-de Boor B-splines over a uniform open knot vector),
``coarsen`` (multilevel normalized heavy-edge matching), ``compute_perm``
(the binary-tree order, with fake nodes, that makes pooling a 1-D stride-2
op), ``perm_adjacency`` and ``perm_coarsening``: the reference's
pooling-support functions, which its training path does not use. The
``spline_basis`` recursion follows mdeff/cnn_graph (MIT license), as the
reference's does.
"""

from __future__ import annotations

import numpy as np


def spline_basis(K: int, x: np.ndarray, degree: int = 3) -> np.ndarray:
    """B-spline basis matrix: len(x) x K Cox-de-Boor basis evaluations over
    a uniform open knot vector on [x.min(), x.max()]."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = float(x.min()), float(x.max())
    kv1 = lo * np.ones(degree)
    kv2 = np.linspace(lo, hi, K - degree + 1)
    kv3 = hi * np.ones(degree)
    kv = np.concatenate((kv1, kv2, kv3))

    def cox_deboor(k: int, d: int) -> np.ndarray:
        if d == 0:
            return ((x - kv[k] >= 0) & (x - kv[k + 1] < 0)).astype(float)
        denom1 = kv[k + d] - kv[k]
        term1 = 0.0
        if denom1 > 0:
            term1 = ((x - kv[k]) / denom1) * cox_deboor(k, d - 1)
        denom2 = kv[k + d + 1] - kv[k + 1]
        term2 = 0.0
        if denom2 > 0:
            term2 = ((-(x - kv[k + d + 1]) / denom2) *
                     cox_deboor(k + 1, d - 1))
        return term1 + term2

    basis = np.column_stack([cox_deboor(k, degree) for k in range(K)])
    # the half-open interval test zeroes every basis function AT the last
    # knot; points equal to x.max() belong to the final basis function
    # (the reference patches only basis[-1, -1], assuming sorted input —
    # this generalizes to arbitrary evaluation order, `graphTools.py`)
    end = x == hi
    basis[end] = 0.0
    basis[end, -1] = 1.0
    return basis


def _heavy_edge_matching(W, rid):
    """One level of normalized heavy-edge matching; returns cluster ids —
    deterministic given ``rid`` (the caller's random visit order supplies
    all the randomness)."""
    N = W.shape[0]
    degree = W.sum(1)
    cluster_id = -np.ones(N, dtype=np.int64)
    marked = np.zeros(N, dtype=bool)
    next_id = 0
    for i in rid:
        if marked[i]:
            continue
        marked[i] = True
        # normalized cut weight to unmarked neighbors
        nbrs = np.nonzero((W[i] > 0) & ~marked)[0]
        best = -1
        if len(nbrs):
            with np.errstate(divide="ignore"):
                score = W[i, nbrs] * (1.0 / np.maximum(degree[i], 1e-12) +
                                      1.0 / np.maximum(degree[nbrs], 1e-12))
            best = nbrs[score.argmax()]
        cluster_id[i] = next_id
        if best >= 0:
            marked[best] = True
            cluster_id[best] = next_id
        next_id += 1
    return cluster_id, next_id


def coarsen(W: np.ndarray, levels: int,
            rng: np.random.Generator | None = None
            ) -> tuple[list[np.ndarray], list[list[int]]]:
    """Multilevel heavy-edge-matching coarsening.

    Returns (graphs, parents): ``graphs[l]`` is the adjacency at level l
    (graphs[0] = W), ``parents[l]`` maps level-l nodes to their level-(l+1)
    cluster.
    """
    rng = rng if rng is not None else np.random.default_rng(0)
    W = np.asarray(W, dtype=np.float64).copy()
    np.fill_diagonal(W, 0)
    graphs = [W]
    parents = []
    for _ in range(levels):
        N = W.shape[0]
        rid = rng.permutation(N)
        cluster_id, n_new = _heavy_edge_matching(W, rid)
        parents.append(cluster_id.tolist())
        # build the coarse graph by summing merged edges
        onehot = np.zeros((N, n_new))
        onehot[np.arange(N), cluster_id] = 1.0
        Wc = onehot.T @ W @ onehot
        np.fill_diagonal(Wc, 0)
        graphs.append(Wc)
        W = Wc
    return graphs, parents


def compute_perm(parents: list[list[int]]) -> list[list[int]]:
    """Binary-tree node ordering for pooling: produce per-level orderings
    (with fake nodes) such that each coarse node's children occupy
    consecutive slots, enabling stride-2 1-D pooling."""
    indices = []
    if parents:
        m_last = max(parents[-1]) + 1
        indices.append(list(range(m_last)))
    for parent in parents[::-1]:
        parent = np.asarray(parent)
        pool_singletons = len(parent)
        indices_layer = []
        for i in indices[-1]:
            indices_node = list(np.nonzero(parent == i)[0])
            # pad with fake nodes to exactly 2 children
            while len(indices_node) < 2:
                indices_node.append(pool_singletons)
                pool_singletons += 1
            indices_layer.extend(indices_node)
        indices.append(indices_layer)
    return indices[::-1]


def perm_adjacency(A: np.ndarray, indices: list[int]) -> np.ndarray:
    """Pad A with disconnected fake nodes and permute per ``indices``."""
    N = A.shape[0]
    M = len(indices)
    if M > N:
        Ap = np.zeros((M, M), dtype=A.dtype)
        Ap[:N, :N] = A
    else:
        Ap = A.copy()
    order = np.asarray(indices)
    return Ap[np.ix_(order, order)]


def perm_coarsening(x: np.ndarray, indices: list[int]) -> np.ndarray:
    """Permute/pad a data matrix (samples x nodes) to the pooling order;
    fake nodes are zero-filled."""
    n_samples, N = x.shape
    M = len(indices)
    out = np.zeros((n_samples, M), dtype=x.dtype)
    for new_pos, old in enumerate(indices):
        if old < N:
            out[:, new_pos] = x[:, old]
    return out
