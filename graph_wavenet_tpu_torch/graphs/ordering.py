"""Block-locality node orderings for the flat block-sparse supports.

A copy of the block-locality part of ``graph_wavenet_tpu/graphs/ordering.py``
(``rcm_order_edges``, ``hilbert_order_points``, ``best_block_ordering``,
``_fusable``, ``block_locality_stats``), host-side numpy. The ordering
decides how many 128x128 blocks are live, which is what the diffusion
kernels' work is proportional to, and whether a layout's band is narrow
enough for the fused order-2 kernel.
"""

from __future__ import annotations

import numpy as np

from graph_wavenet_tpu_torch.ops.cuda.block_diffusion import fused2_schedule


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
