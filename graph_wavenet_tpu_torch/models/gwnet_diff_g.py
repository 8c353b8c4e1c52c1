"""The per-sample-graph Graph WaveNet (diff-G): every sample carries its
own adjacency.

Counterpart of ``graph_wavenet_tpu/models/gwnet_diff_g.py``
(``apply_gwnet_diff_g``, ``svd_nodevecs_batched``). :class:`GWNetDiffG`
shares the shared-graph model's layers, parameters and state-dict names
(``models.gwnet.GWNet``) and differs where the reference's ``gwnet_diff_G``
does:

- the fixed supports are a ``forward`` argument, per-sample (B, N, N)
  stacks that the batched diffusion contracts per sample;
- dilations start at ``cfg.start_dilation`` (4), and the input is padded
  to the true receptive field of those dilations;
- the adaptive adjacency comes from one of three embeddings: the
  trainable shared ``nodevec1``/``nodevec2`` (the default; one (N, N)
  adjacency serves every sample of the batch, the JAX package's
  per-sample broadcast of the same embeddings), ``aptinit_nodevecs``
  passed in (per-sample ``(B, N, r)``/``(B, r, N)``, e.g. from
  :func:`svd_nodevecs_batched`), or under ``cfg.fresh_nodevec`` (the
  reference's quirk) standard-normal ones drawn every forward from the
  ``generator`` passed in, which then holds no embedding parameters.

``supports=None`` is the temporal-only model; ``[]`` with ``addaptadj`` the
adaptive-only one. The shared-graph model keeps refusing ``fresh_nodevec``.

Under a mesh (``GWNet.mesh``) the per-sample supports and
``aptinit_nodevecs`` arrive as the rank's batch rows, BatchNorm and dropout
are global as in ``GWNet``, and the ``fresh_nodevec`` embeddings are one
draw at the global batch's shape from the generator that every rank holds
alike, of which the rank keeps its rows: a rank's embeddings are the
single process's for the same samples. Under node-TP the supports become
the rank's node rows, and the adaptive adjacency is built as its rows from
the rank's rows of E1 and all of E2 (``parallel.dense_tp``).
"""

from __future__ import annotations

import numpy as np
import torch

from graph_wavenet_tpu_torch.models.gwnet import GWNet
from graph_wavenet_tpu_torch.ops.adaptive import svd_nodevecs


def svd_nodevecs_batched(aptinit: np.ndarray, rank: int = 10
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample SVD embeddings of a (B, N, N) adjacency stack: ``(e1 (B,
    N, r), e2 (B, r, N))``, float32 (the reference's unfinished branch,
    completed)."""
    e1s, e2s = zip(*(svd_nodevecs(a, rank) for a in np.asarray(aptinit)))
    return np.stack(e1s), np.stack(e2s)


class GWNetDiffG(GWNet):
    """The diff-G model; built as :class:`models.gwnet.GWNet` is (no
    embeddings under ``cfg.fresh_nodevec``)."""

    def forward(self, x: torch.Tensor, supports: list | None, *,
                generator: torch.Generator | None = None,
                aptinit_nodevecs=None) -> torch.Tensor:
        """x (B, T, N, in_dim) -> (B, T_out, N, out_dim) fp32. ``supports``:
        (B, N, N) per-sample supports (a shared (N, N) one also diffuses),
        ``[]`` or None. ``generator``: the dropout stream in train mode and,
        under ``fresh_nodevec``, the embeddings' draws (every mode).
        ``aptinit_nodevecs``: per-sample embeddings ``(e1, e2)`` that
        replace the model's own."""
        return self._stack(
            x, self._diffg_supports(supports, x, generator,
                                    aptinit_nodevecs), generator)

    def _diffg_supports(self, supports, x, generator, aptinit_nodevecs):
        cfg = self.cfg
        if supports is None:
            return None
        supports = self._node_rows(supports)
        if not (cfg.gcn_bool and cfg.addaptadj):
            return supports
        if aptinit_nodevecs is not None:
            nv1, nv2 = (torch.as_tensor(e, dtype=torch.float32,
                                        device=x.device)
                        for e in aptinit_nodevecs)
            adp = self._adjacency(nv1, nv2)
        elif cfg.fresh_nodevec:
            if generator is None:
                raise ValueError(
                    "fresh_nodevec draws the adaptive embeddings every "
                    "forward; pass the generator to draw them from")
            b, n, r = x.shape[0], cfg.num_nodes, cfg.adapt_rank
            d = 1 if self.mesh is None else self.mesh.data
            nv1 = torch.randn((b * d, n, r), generator=generator,
                              device=x.device, dtype=x.dtype)
            nv2 = torch.randn((b * d, r, n), generator=generator,
                              device=x.device, dtype=x.dtype)
            if d > 1:
                lo = self.mesh.data_index * b
                nv1, nv2 = nv1[lo:lo + b], nv2[lo:lo + b]
            adp = self._adjacency(nv1, nv2)
        else:
            adp = self._adjacency(self.nodevec1, self.nodevec2)
        return supports + [adp]
