"""Learned adaptive adjacency: the node embeddings and the dense adjacency.

Counterpart of ``graph_wavenet_tpu/ops/adaptive.py``: ``adp =
softmax(relu(E1 @ E2), axis=1)`` over low-rank node embeddings, recomputed
every forward, and the SVD initialization of the embeddings on the host in
float64 numpy. At city scale the adjacency is the block-masked one of
:mod:`ops.adaptive_block`.
"""

from __future__ import annotations

import numpy as np
import torch


def adaptive_adjacency(nodevec1: torch.Tensor,
                       nodevec2: torch.Tensor) -> torch.Tensor:
    """softmax(relu(nv1 @ nv2), dim=1) for (N, r) x (r, N) -> (N, N): row v
    (node v's outgoing weights under ``nconv``) sums to 1. The product
    accumulates and the softmax runs in fp32; the result takes the
    embeddings' dtype."""
    logits = torch.relu(nodevec1.float() @ nodevec2.float())
    return torch.softmax(logits, dim=1).to(nodevec1.dtype)


def adaptive_adjacency_batched(nodevec1: torch.Tensor,
                               nodevec2: torch.Tensor) -> torch.Tensor:
    """(B, N, r) x (B, r, N) -> (B, N, N), softmax over the last axis."""
    logits = torch.relu(torch.bmm(nodevec1.float(), nodevec2.float()))
    return torch.softmax(logits, dim=2).to(nodevec1.dtype)


def random_nodevecs(num_nodes: int, rank: int = 10, *,
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal embeddings ``(N, rank)`` and ``(rank, N)``, drawn on
    the CPU from ``generator``."""
    e1 = torch.randn(num_nodes, rank, generator=generator, dtype=dtype)
    e2 = torch.randn(rank, num_nodes, generator=generator, dtype=dtype)
    return e1, e2


def svd_nodevecs(aptinit: np.ndarray, rank: int = 10,
                 dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """SVD init from an adjacency: E1 = U_r sqrt(S_r), E2 = sqrt(S_r)
    V_r^T, factorized in float64 numpy on the host."""
    m, p, nt = np.linalg.svd(np.asarray(aptinit, dtype=np.float64),
                             full_matrices=False)
    sqrt_p = np.sqrt(p[:rank])
    e1 = m[:, :rank] * sqrt_p[None, :]
    e2 = sqrt_p[:, None] * nt[:rank, :]
    return e1.astype(dtype), e2.astype(dtype)
