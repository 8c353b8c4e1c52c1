"""Diffusion graph convolution over block-sparse supports.

Counterpart of ``graph_wavenet_tpu/ops/diffusion.py``'s all-sparse path
(``_gcn_apply_sparse``): the node axis moves to the front once for the
whole hop block, ``(B, T, N, C) -> (N, R)`` with ``R = B*T*C``; every hop
is a support's ``mix_2d`` (or both order-2 hops at once through a fused
support's ``mix2_2d``); every hop is projected in place and accumulated in
fp32. The projection weight's row blocks follow the reference concat
order ``[x, s1 hop1, s1 hop2, ..., sS hop1, sS hop2]``. In training the
projected output takes inverted dropout.

Dense supports (the flagship's modes) come with a later slice.
"""

from __future__ import annotations

import torch
from torch import nn

from graph_wavenet_tpu_torch.ops.linear import Linear, channel_matmul


class _Mlp(nn.Module):
    """Holds the projection as ``mlp`` so the state-dict path reads
    ``gconv.i.mlp.mlp.*`` like the reference's gcn -> linear -> Conv2d."""

    def __init__(self, lin: Linear):
        super().__init__()
        self.mlp = lin


class GCN(nn.Module):
    """Projection parameters over the concatenated hops:
    ``(order * n_supports + 1) * c_in -> c_out``."""

    def __init__(self, c_in: int, c_out: int, n_supports: int,
                 order: int = 2, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.order = order
        self.mlp = _Mlp(Linear((order * n_supports + 1) * c_in, c_out,
                               generator=generator, device=device,
                               dtype=dtype))

    def forward(self, x: torch.Tensor, supports: list, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        lin = self.mlp.mlp
        return gcn_apply(lin.weight, lin.bias, x, supports, self.order,
                         dropout=dropout if self.training else 0.0,
                         generator=generator)


def dropout_scale(generator: torch.Generator | None, p: float, shape,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Inverted-dropout mask: {0, 1/(1-p)} in ``dtype``, an element kept
    where a uniform draw from ``generator`` is below 1 - p (the reference's
    ``bernoulli(1 - p)``)."""
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - p
    return keep.to(dtype) / torch.tensor(1.0 - p, dtype=dtype, device=device)


def gcn_apply(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              supports: list, order: int = 2, *, dropout: float = 0.0,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Diffusion conv: x (B, T, N, C) -> (B, T, N, F). weight (F,
    n_hops*C, 1, 1) in the reference Conv2d shape. ``dropout`` > 0 (train
    mode only) multiplies the output by a :func:`dropout_scale` mask drawn
    from ``generator``."""
    if not supports or not all(hasattr(s, "mix_2d") for s in supports):
        raise NotImplementedError(
            "the port runs the all-sparse gcn path only; dense supports "
            "come with the flagship slice (ROADMAP.md)")
    b, t, n, c_in = x.shape
    w = weight[:, :, 0, 0].t()                     # (n_hops*C, F)
    n_hops = len(supports) * order + 1
    if w.shape[0] != n_hops * c_in:
        raise ValueError(
            f"gcn weight expects {w.shape[0] // c_in} hops, got {n_hops}: "
            "n_supports at init must match the supports list")
    xn = x.permute(2, 0, 1, 3).reshape(n, b * t * c_in)

    def project(xk, k):
        return channel_matmul(xk.reshape(n, b * t, c_in),
                              w[k * c_in:(k + 1) * c_in])

    h = project(xn, 0)
    k = 1
    for sp in supports:
        if order == 2 and hasattr(sp, "mix2_2d"):
            x1, x2h = sp.mix2_2d(xn)
            h = h + project(x1, k) + project(x2h, k + 1)
            k += 2
            continue
        xk = xn
        for _ in range(order):
            xk = sp.mix_2d(xk)
            h = h + project(xk, k)
            k += 1
    h = (h + bias.float()).to(x.dtype)             # (N, B*T, F)
    f = h.shape[-1]
    h = h.reshape(n, b, t, f).permute(1, 2, 0, 3).contiguous()
    if dropout > 0.0:
        h = h * dropout_scale(generator, dropout, h.shape, h.dtype, h.device)
    return h
