"""Dense node tensor parallelism: a rank's rows of a dense support.

The JAX package row-shards every dense support, ``P(model, None)`` for an
(N, N) one and ``P(data, model, None)`` for a per-sample (B, N, N) stack
(``graph_wavenet_tpu/parallel/mesh.py:support_sharding``), and GSPMD
inserts the collectives of the contraction; it has no module for this.
The port makes them explicit, one process per rank:

- rank m holds the rows ``[lo, hi)`` of A (``Mesh.node_range``), the
  source nodes v of ``nconv``'s ``out[w] = sum_v x[v] A[v, w]``, which
  pair with its own activation rows: a hop computes the rank's partial
  over every destination w in fp32, then one reduce-scatter over the model
  group (``collectives.reduce_scatter_rows``) sums the partials and leaves
  each rank its own range, cast once to the activation dtype as in one
  process. Its backward all-gathers the cotangent;
- uneven counts (S not dividing N) keep JAX's layout: ranks of ceil(N/S)
  nodes, the last ones fewer. Activations hold the real nodes only; the
  partial's destination axis is padded to S * ceil(N/S) (A's columns
  padded with zeros), and a rank drops its block's pad rows;
- the adaptive adjacency's rows, ``softmax(relu(E1[lo:hi] @ E2))``, need
  only E1's rows and all of E2 (the row softmax is local): E1's other rows
  take a zero gradient on the rank, and the world gradient all-reduce sums
  the ranks' parts as it does for every replicated parameter;
- ``stacked`` mode's power stack needs all of A: one all_gather of A's
  rows a forward (its backward a reduce-scatter), then the rank's rows of
  A^k = A[lo:hi] A^(k-1), and all ``order`` hops of a support in one
  reduce-scatter.

Under remat a recomputed layer exchanges again: the exchanges sit inside
the graph convolution, which the checkpoint recomputes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from graph_wavenet_tpu_torch.ops.adaptive import (
    adaptive_adjacency,
    adaptive_adjacency_batched,
)
from graph_wavenet_tpu_torch.parallel import collectives
from graph_wavenet_tpu_torch.parallel.mesh import Mesh


@dataclass(eq=False)
class ShardedDenseSupport:
    """This rank's rows of a dense support: ``rows`` (n_m, N), or (B, n_m,
    N) for a per-sample stack; a power stack (:meth:`powers`) carries a hop
    axis before the rows, (k, n_m, N) or (B, k, n_m, N)."""

    rows: torch.Tensor
    mesh: Mesh
    stacked: bool = False

    @property
    def n_nodes(self) -> int:
        return self.rows.shape[-1]

    @property
    def batched(self) -> bool:
        return self.rows.ndim == 3 + self.stacked

    def _spread(self, x: torch.Tensor, eq: str) -> torch.Tensor:
        """``einsum(eq)`` of x's rows and the support's rows, fp32, its
        destination axis first, summed over the model group: the rank's
        destination nodes."""
        mesh, n = self.mesh, self.n_nodes
        a = self.rows.to(x.dtype).float()
        pad = mesh.model * mesh.node_block(n) - n
        if pad:
            a = F.pad(a, (0, pad))
        part = torch.einsum(eq, x.float(), a).contiguous()
        own = collectives.reduce_scatter_rows(part, mesh.model_group)
        return own[:mesh.node_counts(n)[mesh.model_index]]

    def nconv(self, x: torch.Tensor) -> torch.Tensor:
        """One diffusion hop: the rank's x (B, T, n_m, C) -> (B, T, n_m, C)
        over its destination nodes."""
        eq = "btvc,bvw->wbtc" if self.batched else "btvc,vw->wbtc"
        return self._spread(x, eq).permute(1, 2, 0, 3).to(x.dtype)

    def powers(self, order: int) -> ShardedDenseSupport:
        """The rank's rows of ``[A, ..., A^order]`` (``ops.diffusion.
        support_powers``), in the support's dtype: one all_gather of A."""
        full = gather_nodes(self.rows, self.mesh, self.rows.ndim - 2,
                            self.n_nodes)
        pw = [self.rows]
        for _ in range(order - 1):
            pw.append(pw[-1] @ full)
        return ShardedDenseSupport(torch.stack(pw, dim=-3), self.mesh,
                                   stacked=True)

    def hops(self, x: torch.Tensor) -> torch.Tensor:
        """A power stack's hops in one contraction: (B, T, k, n_m, C) in
        x's dtype."""
        eq = "btvc,bkvw->wbtkc" if self.batched else "btvc,kvw->wbtkc"
        return self._spread(x, eq).permute(1, 2, 3, 0, 4).to(x.dtype)


def shard_dense_support(a: torch.Tensor, mesh: Mesh) -> ShardedDenseSupport:
    """This rank's rows of a global (N, N) support or (B, N, N) stack."""
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"a dense support is (N, N) or (B, N, N), got "
                         f"{tuple(a.shape)}")
    lo, hi = mesh.node_range(a.shape[-1])
    return ShardedDenseSupport(a[..., lo:hi, :], mesh)


def adaptive_rows(nodevec1: torch.Tensor, nodevec2: torch.Tensor,
                  mesh: Mesh) -> ShardedDenseSupport:
    """The rank's rows of the adaptive adjacency from the global
    embeddings, (N, r) x (r, N) or per sample (B, N, r) x (B, r, N)."""
    lo, hi = mesh.node_range(nodevec2.shape[-1])
    if nodevec1.ndim == 3:
        rows = adaptive_adjacency_batched(nodevec1[:, lo:hi], nodevec2)
    else:
        rows = adaptive_adjacency(nodevec1[lo:hi], nodevec2)
    return ShardedDenseSupport(rows, mesh)


def gather_nodes(x: torch.Tensor, mesh: Mesh, dim: int,
                 n: int) -> torch.Tensor:
    """The model group's ranges of ``n`` nodes held along ``dim`` of ``x``
    (this rank's), in node order: each block padded to ceil(n/S) for one
    all_gather, the pads dropped; differentiable (its backward a
    reduce-scatter)."""
    counts = mesh.node_counts(n)
    p = mesh.node_block(n)
    x = x.movedim(dim, 0)
    if x.shape[0] < p:
        x = F.pad(x, (0, 0) * (x.ndim - 1) + (0, p - x.shape[0]))
    blocks = collectives.all_gather_rows(x, mesh.model_group).unflatten(
        0, (mesh.model, p))
    return torch.cat([blocks[m, :c] for m, c in enumerate(counts)]).movedim(
        0, dim)
