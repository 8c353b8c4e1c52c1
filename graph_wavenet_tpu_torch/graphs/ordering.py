"""Node orderings: the reference's graphTools orderings and community
source nodes, and the block-locality orderings for the flat block-sparse
supports.

A copy of ``graph_wavenet_tpu/graphs/ordering.py``, host-side numpy:

- ``computeSourceNodes`` and the ``perm*`` orderings of the reference's
  ``Utils/graphTools.py``: :func:`spectral_clustering`
  (normalized-Laplacian eigenvectors and a seeded Lloyd :func:`_kmeans`),
  :func:`compute_source_nodes`, :func:`perm_identity`, :func:`perm_degree`,
  :func:`perm_spectral_proxies` and :func:`perm_eds`. Each ``perm*`` returns ``(S_permuted, order)``, the
  order applied to the GSO's rows and columns. One seed gives the reference
  package's labels and orders bit for bit: the same numpy calls consume the
  ``np.random.Generator`` in the same order. They are the reference's
  graphTools API, kept for parity with it: nothing in the package calls
  them;
- the block-locality orderings (:func:`rcm_order_edges`,
  :func:`hilbert_order_points`, :func:`best_block_ordering`, ``_fusable``,
  :func:`block_locality_stats`). The ordering decides how many 128x128
  blocks are live, which is what the diffusion kernels' work is
  proportional to, and whether a layout's band is narrow enough for the
  fused order-2 kernel.
"""

from __future__ import annotations

import numpy as np

from graph_wavenet_tpu_torch.graphs.generate import (
    adjacency_to_laplacian,
    normalize_laplacian,
)
from graph_wavenet_tpu_torch.ops.cuda.block_diffusion import fused2_schedule


# ---------------------------------------------------------------------------
# graphTools orderings and source nodes (graphTools.py:364-393, 829-1000)
# ---------------------------------------------------------------------------

def _kmeans(points: np.ndarray, k: int, rng: np.random.Generator,
            iters: int = 100) -> np.ndarray:
    """Plain Lloyd k-means; returns per-point labels."""
    n = len(points)
    centers = points[rng.choice(n, size=k, replace=False)]
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(iters):
        d = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new_labels = d.argmin(1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        for c in range(k):
            mask = labels == c
            if mask.any():
                centers[c] = points[mask].mean(0)
            else:  # re-seed an empty cluster at the farthest point
                centers[c] = points[d.min(1).argmax()]
    return labels


def spectral_clustering(W: np.ndarray, k: int,
                        rng: np.random.Generator | None = None
                        ) -> np.ndarray:
    """Normalized spectral clustering: bottom-k eigenvectors of the
    normalized Laplacian, row-normalized, k-means. Returns labels (N,)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    W = np.asarray(W, dtype=np.float64)
    Wsym = 0.5 * (W + W.T)
    L = normalize_laplacian(adjacency_to_laplacian(Wsym))
    _, vecs = np.linalg.eigh(L)
    emb = vecs[:, :k]
    norms = np.linalg.norm(emb, axis=1, keepdims=True)
    emb = emb / np.where(norms > 0, norms, 1.0)
    return _kmeans(emb, k, rng)


def compute_source_nodes(A: np.ndarray, C: int,
                         rng: np.random.Generator | None = None
                         ) -> list[int]:
    """Cluster the graph into C communities and pick the highest-degree node
    of each. Always returns exactly C distinct nodes: an empty cluster
    (k-means degeneracy on tiny graphs) is backfilled with the
    highest-degree node not yet chosen, so a C-class source-localization
    label space stays complete."""
    A = np.asarray(A, dtype=np.float64)
    labels = spectral_clustering(A, C, rng)
    degree = A.sum(axis=1)
    sources: list[int] = []
    for c in range(C):
        idx = np.nonzero(labels == c)[0]
        if len(idx):
            sources.append(int(idx[degree[idx].argmax()]))
    for n in np.argsort(-degree, kind="stable"):
        if len(sources) >= C:
            break
        if int(n) not in sources:
            sources.append(int(n))
    return sources


def perm_identity(S: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """No-op ordering."""
    return S.copy(), list(range(S.shape[0]))


def _permute(S: np.ndarray, order: np.ndarray) -> np.ndarray:
    return S[np.ix_(order, order)]


def perm_degree(S: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Decreasing-degree ordering; degree summed over symmetrized |S|."""
    Ssym = 0.5 * (np.abs(S) + np.abs(S).T)
    order = np.argsort(-Ssym.sum(axis=1), kind="stable")
    return _permute(S, order), order.tolist()


def perm_spectral_proxies(S: np.ndarray, k: int = 8
                          ) -> tuple[np.ndarray, list[int]]:
    """Ordering by the spectral-proxy score |S^k 1| (decreasing), a
    power-iteration proxy for eigenvector centrality (the reference's
    ``permSpectralProxies`` reduced to its score ordering)."""
    v = np.ones(S.shape[0])
    Sk = np.linalg.matrix_power(np.asarray(S, dtype=np.float64), k)
    score = np.abs(Sk @ v)
    order = np.argsort(-score, kind="stable")
    return _permute(S, order), order.tolist()


def perm_eds(S: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Experimentally-designed-sampling ordering: by leverage score
    (squared first-eigenvector magnitude, decreasing)."""
    Ssym = 0.5 * (S + S.T)
    e, V = np.linalg.eigh(np.asarray(Ssym, dtype=np.float64))
    lead = V[:, np.argmax(np.abs(e))]
    order = np.argsort(-(lead ** 2), kind="stable")
    return _permute(S, order), order.tolist()


# ---------------------------------------------------------------------------
# block-locality orderings (the flat block-sparse supports)
# ---------------------------------------------------------------------------


def rcm_order_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int
                    ) -> np.ndarray:
    """Reverse Cuthill-McKee node permutation from an edge list — O(E log E)
    host-side, no dense (N, N) intermediate (city-scale graphs can't afford
    one).

    Returns ``perm`` with ``new_id = perm[old_id]``, the convention
    ``ops.block_sparse.from_edges_flat(..., perm=...)`` consumes. RCM
    concentrates every node's neighbors near the diagonal, so each 128-wide
    destination block-row draws its sources from a few ADJACENT block-rows:
    the count of distinct nonzero blocks per row — which sets the
    block-sparse hop's work — collapses to the band width.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    # symmetrized CSR adjacency, neighbors sorted by degree (classic CM)
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    keep = u != v
    u, v = u[keep], v[keep]
    pairs = np.unique(u * n_nodes + v)
    u, v = pairs // n_nodes, pairs % n_nodes
    degree = np.bincount(u, minlength=n_nodes)
    # order neighbor lists by (u, degree[v]) so each BFS level expands
    # lowest-degree-first without per-node sorts
    order = np.lexsort((degree[v], u))
    u, v = u[order], v[order]
    starts = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n_nodes), out=starts[1:])

    visited = np.zeros(n_nodes, bool)
    result = np.empty(n_nodes, np.int64)
    pos = 0
    # deterministic component seeds: lowest degree first (stable)
    seed_order = np.argsort(degree, kind="stable")
    for seed in seed_order:
        if visited[seed]:
            continue
        visited[seed] = True
        result[pos] = seed
        head, tail = pos, pos + 1
        while head < tail:
            n = result[head]
            head += 1
            for w in v[starts[n]:starts[n + 1]]:
                if not visited[w]:
                    visited[w] = True
                    result[tail] = w
                    tail += 1
        pos = tail
    assert pos == n_nodes
    result = result[::-1]                     # the "reverse" in RCM
    perm = np.empty(n_nodes, np.int64)
    perm[result] = np.arange(n_nodes)
    return perm


def hilbert_order_points(pos: np.ndarray, order: int = 16) -> np.ndarray:
    """Node permutation from a Hilbert space-filling curve over 2-D
    coordinates — the geometric alternative to :func:`rcm_order_edges` for
    graphs that come with positions (road networks, sensor grids).

    Nearby points get nearby curve indices, so chunking the ordered nodes
    into 128-wide blocks yields spatially coherent cells whose k-NN edges
    stay within a few neighboring cells; on k-NN graphs it often has fewer
    live blocks than RCM, whose BFS levels wander in 2-D. Returns ``perm``
    with ``new_id = perm[old_id]`` (the ``from_edges_flat``
    convention).

    pos: (N, 2) coordinates (any scale); ``order``: curve depth (2^order
    cells per axis — 16 is exact for float32 inputs).
    """
    pos = np.asarray(pos, np.float64)
    assert pos.ndim == 2 and pos.shape[1] == 2, "hilbert order needs (N, 2)"
    n = pos.shape[0]
    lo, hi = pos.min(0), pos.max(0)
    span = np.where(hi > lo, hi - lo, 1.0)
    side = 1 << order
    q = np.minimum(((pos - lo) / span * side).astype(np.int64), side - 1)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(n, np.int64)
    s = side >> 1
    while s > 0:                     # classic d2xy inverse, vectorized
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate quadrant so the curve stays continuous
        swap = ry == 0
        flip = swap & (rx == 1)
        x[flip], y[flip] = s - 1 - x[flip], s - 1 - y[flip]
        xs = x[swap].copy()
        x[swap] = y[swap]
        y[swap] = xs
        s >>= 1
    perm = np.empty(n, np.int64)
    perm[np.argsort(d, kind="stable")] = np.arange(n)
    return perm


def best_block_ordering(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                        pos: np.ndarray | None = None,
                        block_size: int = 128,
                        fuse2_discount: float = 0.8
                        ) -> tuple[np.ndarray, str, dict]:
    """Pick the best ordering for the flat block-sparse kernels: RCM
    from the edge list, plus Hilbert when coordinates are available.

    The score is the LIVE nonzero block count (what the kernels' compute
    is proportional to), discounted by ``fuse2_discount`` when the
    layout's band qualifies for the fused order-2 hop-chain kernel
    (``ops.cuda.block_diffusion.fused2_schedule``). The rule and its
    0.8 discount are the reference package's, kept so that both packages
    choose the same layout for a graph (the discount was tuned on the
    TPU; its value on the card is an open question in PERF.md). Pass
    ``fuse2_discount=1.0`` to score purely by block count. Returns
    ``(perm, name, stats)``; stats carries ``fusable``."""
    candidates = {"rcm": rcm_order_edges(src, dst, n_nodes)}
    if pos is not None:
        candidates["hilbert"] = hilbert_order_points(np.asarray(pos))
    best = None
    for name, perm in candidates.items():
        stats = block_locality_stats(src, dst, n_nodes, perm, block_size)
        stats["fusable"] = _fusable(src, dst, n_nodes, perm, block_size)
        score = stats["n_blocks"] * (fuse2_discount if stats["fusable"]
                                     else 1.0)
        if best is None or score < best[3]:
            best = (perm, name, stats, score)
    return best[:3]


def _fusable(src, dst, n_nodes, perm, block_size) -> bool:
    """Would a flat support built under ``perm`` qualify for the fused
    order-2 kernel? Checked on the block-pair band (both transition
    directions — the doubletransition pair shares the symmetric
    pattern's transpose)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        src, dst = perm[src], perm[dst]
    nb = -(-n_nodes // block_size)
    for s, d in ((src, dst), (dst, src)):
        pair = np.unique((d // block_size) * nb + (s // block_size))
        row, sb = pair // nb, pair % nb
        # dummy entries for empty rows, like from_edges_flat
        empty = np.setdiff1d(np.arange(nb), row)
        row = np.concatenate([row, empty])
        sb = np.concatenate([sb, empty])
        order = np.argsort(row, kind="stable")
        if fused2_schedule(row[order], sb[order], nb) is None:
            return False
    return True


def block_locality_stats(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                         perm: np.ndarray | None = None,
                         block_size: int = 128) -> dict:
    """Distinct-source-block statistics of an edge list under a node
    ordering — the quantity the block-sparse hop's HBM traffic is linear
    in. Returns mean/max blocks per destination block-row and the total
    nonzero block count."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        src, dst = perm[src], perm[dst]
    nb = -(-n_nodes // block_size)
    pair = (dst // block_size) * nb + (src // block_size)
    uniq = np.unique(pair)
    per_row = np.bincount(uniq // nb, minlength=nb)
    return {
        "n_blocks": int(len(uniq)),
        "blocks_per_row_mean": float(per_row.mean()),
        "blocks_per_row_max": int(per_row.max()),
    }
