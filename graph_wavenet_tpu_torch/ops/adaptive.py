"""Learned adaptive adjacency: the node embeddings.

Counterpart of ``graph_wavenet_tpu/ops/adaptive.py:random_nodevecs``. The
SVD initialization and the dense ``softmax(relu(E1 @ E2))`` adjacency wait
for the dense slice (ROADMAP.md); at city scale the adjacency is the
block-masked one of :mod:`ops.adaptive_block`.
"""

from __future__ import annotations

import torch


def random_nodevecs(num_nodes: int, rank: int = 10, *,
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal embeddings ``(N, rank)`` and ``(rank, N)``, drawn on
    the CPU from ``generator``."""
    e1 = torch.randn(num_nodes, rank, generator=generator, dtype=dtype)
    e2 = torch.randn(rank, num_nodes, generator=generator, dtype=dtype)
    return e1, e2
