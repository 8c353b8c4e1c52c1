"""Graph synthesis and spectral tools, on the host in numpy.

A copy of ``graph_wavenet_tpu/graphs/generate.py``: SBM and small-world
synthesis (rejection-sampled until connected), the GFT eigendecomposition
with its three orderings, the connectivity test, Laplacians,
sparsification, edge-failure sampling, matrix powers and K-hop
neighborhoods, and the ``Graph`` container with its community map. A seed
draws the same graphs as the reference package's copy, bit for bit: every
function consumes its ``np.random.Generator`` in the same order.

These run once when a dataset is built; the model only ever sees the dense
supports normalized from them.
"""

from __future__ import annotations

import numpy as np

ZERO_TOL = 1e-9


# ---------------------------------------------------------------------------
# Laplacians and normalizations (graphTools.py:44-109)
# ---------------------------------------------------------------------------

def adjacency_to_laplacian(W: np.ndarray) -> np.ndarray:
    """L = D - W."""
    return np.diag(W.sum(axis=1)) - W


def normalize_adjacency(W: np.ndarray) -> np.ndarray:
    """D^-1/2 W D^-1/2 (symmetric input assumed)."""
    d = W.sum(axis=1)
    d_inv_sqrt = np.where(d > 0, d ** -0.5, 0.0)
    return d_inv_sqrt[:, None] * W * d_inv_sqrt[None, :]


def normalize_laplacian(L: np.ndarray) -> np.ndarray:
    """D^-1/2 L D^-1/2 where D = diag(L)."""
    d = np.diag(L)
    d_inv_sqrt = np.where(d > 0, d ** -0.5, 0.0)
    return d_inv_sqrt[:, None] * L * d_inv_sqrt[None, :]


# ---------------------------------------------------------------------------
# GFT (graphTools.py:111-150)
# ---------------------------------------------------------------------------

def compute_gft(S: np.ndarray, order: str = "no"):
    """Eigendecomposition of a GSO with eigenvalue ordering.

    order: 'no' | 'increasing' (by |e|) | 'totalVariation' (by |e - e_max|).
    Returns (E, V) where E is the diagonal eigenvalue matrix. Uses ``eigh``
    when S is symmetric, ``eig`` otherwise — as the reference does.
    """
    assert order in ("no", "increasing", "totalVariation")
    assert S.shape[0] == S.shape[1]
    if np.allclose(S, S.T, atol=ZERO_TOL):
        e, V = np.linalg.eigh(S)
    else:
        e, V = np.linalg.eig(S)
    if order == "totalVariation":
        idx = np.argsort(np.abs(e - np.max(e)))
    elif order == "increasing":
        idx = np.argsort(np.abs(e))
    else:
        idx = np.arange(S.shape[0])
    return np.diag(e[idx]), V[:, idx]


def is_connected(W: np.ndarray) -> bool:
    """Connectivity via the multiplicity of the Laplacian zero eigenvalue
    (`graphTools.py:397-424`); directed graphs are symmetrized first."""
    if not np.allclose(W, W.T, atol=ZERO_TOL):
        W = 0.5 * (W + W.T)
    L = adjacency_to_laplacian(W)
    e = np.linalg.eigvalsh(L)
    return int(np.sum(e < ZERO_TOL)) == 1


# ---------------------------------------------------------------------------
# Matrix powers / neighborhoods (graphTools.py:152-362)
# ---------------------------------------------------------------------------

def matrix_powers(S: np.ndarray, K: int) -> np.ndarray:
    """Stack [I, S, S^2, ..., S^(K-1)] along a leading axis."""
    N = S.shape[0]
    out = [np.eye(N, dtype=S.dtype)]
    for _ in range(K - 1):
        out.append(out[-1] @ S)
    return np.stack(out)


def compute_nonzero_rows(S: np.ndarray, n_layers: int = 1) -> list:
    """Per-layer nonzero-column indices of each row of S (sparsity helper,
    `graphTools.py:204-256` semantics): returns a list of length n_layers,
    each a list of per-row index arrays."""
    S = np.asarray(S)
    # fresh lists per layer: callers may mutate one layer's rows without
    # corrupting the others (the reference computes them per layer)
    return [[np.flatnonzero(np.abs(S[r]) > ZERO_TOL).tolist()
             for r in range(S.shape[0])]
            for _ in range(n_layers)]


def k_hop_neighborhood(S: np.ndarray, K: int) -> list[list[int]]:
    """K-hop neighborhoods (incl. self) of each node via boolean BFS on the
    support of S (`graphTools.py:258-362` semantics, simplified)."""
    A = (np.abs(S) > ZERO_TOL)
    np.fill_diagonal(A, True)
    reach = A.copy()
    for _ in range(K - 1):
        reach = reach @ A
    return [np.nonzero(row)[0].tolist() for row in reach]


# ---------------------------------------------------------------------------
# Graph synthesis (graphTools.py:517-825)
# ---------------------------------------------------------------------------

def balanced_communities(N: int, C: int) -> list[np.ndarray]:
    """Contiguous, balanced community index blocks — first ``N % C``
    communities get one extra node (`graphTools.py:598-607`)."""
    sizes = [N // C] * C
    for c in range(N - sum(sizes)):
        sizes[c] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [np.arange(bounds[c], bounds[c + 1]) for c in range(C)]


def create_sbm(N: int, n_communities: int, prob_intra: float,
               prob_inter: float, rng: np.random.Generator | None = None,
               max_tries: int = 1000):
    """Stochastic block model with balanced contiguous communities,
    rejection-sampled until connected (`graphTools.py:582-638`).

    Returns ``(W, assign_dict)`` where ``assign_dict[c]`` is the node-index
    array of community ``c`` — the community map that defines the synthetic
    "E" (EEG-like) modality.
    """
    assert 0 <= prob_intra <= 1 and 0 <= prob_inter <= 1
    rng = rng if rng is not None else np.random.default_rng()
    blocks = balanced_communities(N, n_communities)
    assign_dict = {c: idx for c, idx in enumerate(blocks)}
    comm_of = np.empty(N, dtype=np.int64)
    for c, idx in assign_dict.items():
        comm_of[idx] = c
    prob = np.where(comm_of[:, None] == comm_of[None, :],
                    prob_intra, prob_inter)
    for _ in range(max_tries):
        W = (rng.random((N, N)) < prob).astype(np.float64)
        W = np.triu(W, 1)
        W = W + W.T
        if is_connected(W):
            return W, assign_dict
    raise RuntimeError("SBM rejection sampling failed to produce a connected "
                       f"graph in {max_tries} tries")


def create_small_world(N: int, prob_edge: float, prob_rewiring: float,
                       rng: np.random.Generator | None = None,
                       max_tries: int = 1000) -> np.ndarray:
    """Watts-Strogatz-style small world graph (`graphTools.py:640-697`):
    locally connected ring by distance, then random rewiring, symmetrized and
    rejection-sampled until connected."""
    rng = rng if rng is not None else np.random.default_rng()
    theta = 2 * np.pi * np.arange(N) / N
    pos = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    dist2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    for _ in range(max_tries):
        W = np.zeros((N, N))
        # local connections: each node links to its nn nearest ring neighbors
        for n in range(N):
            nn = rng.binomial(N, prob_edge)
            others = np.concatenate([np.arange(n), np.arange(n + 1, N)])
            order = others[np.argsort(dist2[n, others])]
            W[order[:nn], n] = 1
        # rewiring
        for n in range(N):
            for j in np.nonzero(W[:, n])[0]:
                if rng.random() < prob_rewiring:
                    free = np.nonzero((W[:, n] == 0) &
                                      (np.arange(N) != n))[0]
                    if len(free):
                        W[j, n] = 0
                        W[rng.choice(free), n] = 1
        W = np.triu(W)
        W = W + W.T
        if is_connected(W):
            return W
    raise RuntimeError("small-world sampling failed to connect")


def fuse_edges(adjacency_matrices: np.ndarray, aggregation: str = "sum",
               normalization: str = "no", *,
               isolated_nodes: bool = True,
               force_undirected: bool = False,
               force_connected: bool = False,
               node_list: list | None = None,
               extra_components: list | None = None) -> np.ndarray:
    """Fuse an (E, N, N) stack of edge-feature adjacencies into one graph —
    the reference's full 'fuseEdges' option surface, in its operation order
    (`graphTools.py:698-819`): aggregate (sum/avg) -> row/col normalize ->
    drop isolated nodes (``isolated_nodes=False``) -> symmetrize
    (``force_undirected``) -> keep the largest connected component
    (``force_connected``).

    The output can therefore be SMALLER than N x N. ``node_list``, when a
    list, is extended in place with the surviving original node indices
    (the reference's in/out ``nodeList`` argument, `graphTools.py:714`);
    ``extra_components``, when a list, receives ``[adjacencies,
    node_lists]`` for the non-largest components (`graphTools.py:717-727`).
    """
    A = np.asarray(adjacency_matrices, dtype=np.float64)
    assert A.ndim == 3 and A.shape[1] == A.shape[2]
    N = A.shape[1]
    all_nodes = np.arange(N)
    assert aggregation in ("sum", "avg")
    W = A.sum(axis=0) if aggregation == "sum" else A.mean(axis=0)
    # zero-guard exactly as the reference: sums below tolerance divide by 1
    # (`graphTools.py:738-746`), so isolated rows/cols stay exactly zero
    if normalization == "rows":
        s = W.sum(axis=1, keepdims=True)
        W = W / np.where(np.abs(s) < ZERO_TOL, 1.0, s)
    elif normalization == "cols":
        s = W.sum(axis=0, keepdims=True)
        W = W / np.where(np.abs(s) < ZERO_TOL, 1.0, s)
    if not isolated_nodes:
        keep = np.nonzero(np.abs(W).sum(axis=0) > ZERO_TOL)[0]
        if len(keep) < W.shape[0]:
            W = W[keep][:, keep]
            all_nodes = all_nodes[keep]
    if force_undirected:
        W = 0.5 * (W + W.T)
    if force_connected and not is_connected(W):
        from scipy.sparse import csgraph

        n_comp, labels = csgraph.connected_components(W)
        partial = np.arange(W.shape[0])
        adjs, lists = [], []
        for c in range(n_comp):
            keep = partial[labels == c]
            adjs.append(W[keep][:, keep])
            lists.append(all_nodes[keep])
        # first-largest wins ties, as the reference's strict > scan does
        largest = int(np.argmax([len(li) for li in lists]))
        W = adjs.pop(largest)
        all_nodes = lists.pop(largest)
        assert is_connected(W)
        if extra_components is not None:
            extra_components.append(adjs)
            extra_components.append(lists)
    if node_list is not None:
        node_list.extend(all_nodes.tolist())
    return W


def sparsify_graph(W: np.ndarray, method: str, value) -> np.ndarray:
    """Threshold / kNN sparsification with the reference's connectivity
    repair (`graphTools.py:426-515`): if the input graph is connected, the
    sparsified graph must stay connected — 'threshold' halves the threshold
    until it does (`:474-484`), 'NN' increments k (`:496-511`). kNN keeps
    each row's k largest RAW values (incoming edges) and re-symmetrizes an
    undirected input by averaging (`:512-514`) — some nodes may end with
    more than k neighbors; the effective threshold actually used is
    ``np.min(W[np.nonzero(W)])``."""
    W = np.asarray(W, dtype=np.float64)
    N = W.shape[0]
    connected = is_connected(W)
    undirected = np.allclose(W, W.T, atol=ZERO_TOL)
    if method == "threshold":
        p = float(value)
        Wnew = np.where(np.abs(W) < p, 0.0, W)
        while connected and not is_connected(Wnew):
            p = p / 2.0
            Wnew = np.where(np.abs(W) < p, 0.0, W)
        return Wnew
    if method == "NN":
        p = int(value)
        Wsorted = np.sort(W, axis=1)

        def _keep(k):
            kth_largest = Wsorted[:, -k]
            return W * (W >= kth_largest[:, None]).astype(W.dtype)

        Wnew = _keep(p)
        while connected and not is_connected(Wnew):
            p += 1
            if p > N:
                raise ValueError(
                    "NN sparsification cannot reconnect the graph even at "
                    f"k=N={N} — input connectivity relies on edges the "
                    "row-wise mask cannot keep")
            Wnew = _keep(p)
        if undirected:
            Wnew = 0.5 * (Wnew + Wnew.T)
        return Wnew
    raise ValueError(f"unknown sparsify method {method!r}")


def edge_fail_sampling(W: np.ndarray, p: float,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """Randomly delete each (undirected) edge with probability p — the
    reference's data-level fault injection (`graphTools.py:1002-1029`)."""
    rng = rng if rng is not None else np.random.default_rng()
    undirected = np.allclose(W, W.T, atol=ZERO_TOL)
    mask = rng.random(W.shape) >= p
    if undirected:
        # one Bernoulli draw per undirected edge; self-loops keep their own
        # draw (the reference's triu(k=0) + transpose would DOUBLE surviving
        # diagonal entries, `graphTools.py:1024-1026` — deliberate fix)
        upper = np.triu(mask, 1)
        mask = upper | upper.T | (np.eye(len(W), dtype=bool) & mask)
    return W * mask


# ---------------------------------------------------------------------------
# Graph container (graphTools.py:1032-1135)
# ---------------------------------------------------------------------------

class Graph:
    """Graph container holding W, degree, Laplacian, GSO, optional GFT, and
    (for SBM) the community ``assign_dict``.

    Mirrors the attribute surface of the reference ``Graph``
    (`graphTools.py:1075-1135`): N, M, W, D, A, L, S, E, V, undirected,
    selfLoops, assign_dict; plus snake_case aliases.
    """

    def __init__(self, graph_type: str, N: int, options: dict,
                 rng: np.random.Generator | None = None):
        assert N > 0
        self.assign_dict: dict = {}
        if graph_type == "SBM":
            self.W, self.assign_dict = create_sbm(
                N, options["nCommunities"], options["probIntra"],
                options["probInter"], rng=rng)
        elif graph_type == "SmallWorld":
            self.W = create_small_world(N, options["probEdge"],
                                        options["probRewiring"], rng=rng)
        elif graph_type == "fuseEdges":
            self.W = fuse_edges(
                options["adjacencyMatrices"],
                options.get("aggregationType", "sum"),
                options.get("normalizationType", "no"),
                isolated_nodes=options.get("isolatedNodes", True),
                force_undirected=options.get("forceUndirected", False),
                force_connected=options.get("forceConnected", False),
                node_list=options.get("nodeList"),
                extra_components=options.get("extraComponents"))
        elif graph_type == "adjacency":
            self.W = np.asarray(options["adjacencyMatrix"], dtype=np.float64)
            assert self.W.shape[0] == N
        else:
            raise ValueError(f"unknown graph type {graph_type!r}")

        self.N = self.W.shape[0]
        self.undirected = bool(np.allclose(self.W, self.W.T, atol=ZERO_TOL))
        self.selfLoops = bool(
            np.sum(np.abs(np.diag(self.W)) > ZERO_TOL) > 0)
        self.D = np.diag(self.W.sum(axis=1))
        self.M = int(np.sum(np.triu(self.W)) if self.undirected
                     else np.sum(self.W))
        self.A = (np.abs(self.W) > 0).astype(self.W.dtype)
        self.L = (adjacency_to_laplacian(self.W)
                  if self.undirected and not self.selfLoops else None)
        self.S = self.W
        self.E = None
        self.V = None

    def computeGFT(self):
        if self.S is not None:
            self.E, self.V = compute_gft(self.S, order="totalVariation")

    def setGSO(self, S: np.ndarray, GFT: str = "no"):
        assert S.shape[0] == S.shape[1] == self.N
        assert GFT in ("no", "increasing", "totalVariation")
        self.S = S
        if GFT == "no":
            self.E = None
            self.V = None
        else:
            self.E, self.V = compute_gft(self.S, order=GFT)

    # ---- framework-native helpers -------------------------------------

    @property
    def community_labels(self) -> np.ndarray:
        """Per-node community id vector derived from ``assign_dict``."""
        labels = np.zeros(self.N, dtype=np.int32)
        for c, idx in self.assign_dict.items():
            labels[idx] = c
        return labels

    def lambda_max(self) -> float:
        """Largest eigenvalue of W (used to normalize diffusion signals,
        `dataTools.py:106-109`). Reuses the cached GFT when ``computeGFT``
        has already run on W (eigenvalue max is ordering-invariant)."""
        if self.E is not None and self.S is self.W:
            return float(np.max(np.diag(self.E).real))
        E, _ = compute_gft(self.W, order="totalVariation")
        return float(np.max(np.diag(E).real))
