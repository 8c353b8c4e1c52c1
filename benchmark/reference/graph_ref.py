"""The reference's graphs: k-NN edges, the doubletransition supports, the
reverse Cuthill-McKee order, the 128-node block grid and the adaptive
mask, worked out here in plain NumPy and PyTorch from the raw points or
adjacency that the benchmark makes. Nothing here imports the program.

Conventions (Li et al.'s diffusion convolution, as Graph WaveNet uses it):
an edge ``src -> dst`` of weight w is ``A[src, dst] = w``; a support's
transition matrix is ``D^-1 A`` (rows sum to 1); a diffusion step maps
``x`` to ``out[w] = sum_v x[v] P[v, w]``.
"""

from __future__ import annotations

import numpy as np
import torch


def knn_edges(pos: np.ndarray, k: int):
    """Directed k-NN edges of points ``pos`` (N, 2) with Gaussian weights
    ``exp(-d^2 / sigma^2)``, sigma the std of all k-NN distances; a node's
    own match is dropped."""
    from scipy.spatial import cKDTree

    n = pos.shape[0]
    d, nbr = cKDTree(pos).query(pos, k=k + 1)
    own = nbr == np.arange(n)[:, None]
    col = np.where(own.any(axis=1), np.argmax(own, axis=1), k)
    keep = np.ones((n, k + 1), bool)
    keep[np.arange(n), col] = False
    src = np.repeat(np.arange(n), k)
    dst = nbr[keep].reshape(-1)
    dist = d[keep].reshape(-1)
    sigma = max(float(dist.std()), 1e-12)
    return src, dst, np.exp(-(dist ** 2) / sigma ** 2)


def transition(src, dst, w, n: int) -> np.ndarray:
    """Edge weights of ``D^-1 A``: each divided by its source's out-weight."""
    deg = np.bincount(src, weights=w, minlength=n)
    return np.where(deg[src] > 0, w / np.where(deg[src] > 0, deg[src], 1.0),
                    0.0)


def rcm_order(src, dst, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee order of the symmetrized graph: ``new =
    perm[old]``. Components start from their lowest-degree node (lowest id
    on ties); a node's neighbours are visited lowest degree first."""
    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    keep = u != v
    pairs = np.unique(u[keep] * n + v[keep])
    u, v = pairs // n, pairs % n
    degree = np.bincount(u, minlength=n)
    order = np.lexsort((degree[v], u))
    u, v = u[order], v[order]
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(u, minlength=n), out=starts[1:])
    seen = np.zeros(n, bool)
    out = np.empty(n, np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if seen[seed]:
            continue
        seen[seed] = True
        out[pos] = seed
        head, tail = pos, pos + 1
        while head < tail:
            node = out[head]
            head += 1
            for nb in v[starts[node]:starts[node + 1]]:
                if not seen[nb]:
                    seen[nb] = True
                    out[tail] = nb
                    tail += 1
        pos = tail
    out = out[::-1]
    perm = np.empty(n, np.int64)
    perm[out] = np.arange(n)
    return perm


class BlockSupport:
    """A support stored as its nonzero ``bs x bs`` blocks: block ``l``
    holds ``P[vb*bs + i, wb*bs + j]`` at ``[l, i, j]`` for the pair
    ``(vb[l], wb[l])``."""

    def __init__(self, vb, wb, blocks: torch.Tensor, n: int, bs: int):
        dev = blocks.device
        self.vb = torch.as_tensor(vb, dtype=torch.int64, device=dev)
        self.wb = torch.as_tensor(wb, dtype=torch.int64, device=dev)
        self.blocks = blocks
        self.n, self.bs = n, bs

    @property
    def n_live(self) -> int:
        return int(self.vb.shape[0])

    @classmethod
    def from_edges(cls, v, w, vals, n: int, bs: int, device):
        """Entries ``P[v, w] = vals`` (duplicates add) in node order as
        given."""
        nb = n // bs
        key = (v // bs) * nb + (w // bs)
        uniq, inv = np.unique(key, return_inverse=True)
        blocks = np.zeros((len(uniq), bs, bs), np.float64)
        np.add.at(blocks, (inv, v % bs, w % bs), vals)
        return cls(uniq // nb, uniq % nb,
                   torch.as_tensor(blocks, dtype=torch.float32,
                                   device=device), n, bs)

    def dense(self) -> torch.Tensor:
        """The (N, N) matrix (tests at small sizes)."""
        nb = self.n // self.bs
        out = torch.zeros(nb, nb, self.bs, self.bs, dtype=self.blocks.dtype,
                          device=self.blocks.device)
        out[self.vb, self.wb] = self.blocks
        return out.permute(0, 2, 1, 3).reshape(self.n, self.n)


def doubletransition_blocks(src, dst, w, n: int, perm, bs: int, device
                            ) -> list[BlockSupport]:
    """``[D^-1 A, D^-1 A^T]`` in block form under the node order ``perm``."""
    out = []
    for s, d in ((src, dst), (dst, src)):
        vals = transition(s, d, w, n)
        out.append(BlockSupport.from_edges(perm[s], perm[d], vals, n, bs,
                                           device))
    return out


def adaptive_pairs(supports: list[BlockSupport]):
    """The adaptive mask's live block pairs ``(vb, wb)``: every pair that
    holds an entry of a support, and the diagonal."""
    nb = supports[0].n // supports[0].bs
    keys = [s.vb.cpu().numpy() * nb + s.wb.cpu().numpy() for s in supports]
    keys.append(np.arange(nb) * (nb + 1))
    uniq = np.unique(np.concatenate(keys))
    return uniq // nb, uniq % nb


def doubletransition_dense(adj: np.ndarray, device) -> list[torch.Tensor]:
    """``[D^-1 A, D^-1 A^T]`` of a dense adjacency, rows of zero weight
    left zero."""
    out = []
    for a in (adj, adj.T):
        a = np.asarray(a, np.float64)
        rs = a.sum(axis=1, keepdims=True)
        p = np.where(rs > 0, a / np.where(rs > 0, rs, 1.0), 0.0)
        out.append(torch.as_tensor(p, dtype=torch.float32, device=device))
    return out
