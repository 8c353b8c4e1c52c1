"""``gwnet_ref.forward`` with every layer recomputed in the backward
(``torch.utils.checkpoint``): the same function, computed layer by layer
in the same order, keeping only each layer's input and the running skip
sum, so that the float32 reference fits one card at a global batch the
program spreads over several. The dropout masks are drawn before the
forward and batch normalization takes the batch's statistics inside the
layer, so a recomputed layer repeats its forward."""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from reference import gwnet_ref as G


def forward(p: dict, x: torch.Tensor, supports: list, cfg: dict, *,
            train: bool, masks: list | None = None, q=G.identity
            ) -> torch.Tensor:
    """:func:`gwnet_ref.forward`, each layer under a checkpoint."""
    rf = G.receptive_field(cfg)
    if x.shape[1] < rf:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, rf - x.shape[1], 0))
    t_final = x.shape[1] - sum(G.dilations(cfg))
    x = G._linear(p, "start_conv", q(x), q)
    skip = None
    for i, d in enumerate(G.dilations(cfg)):
        def layer(x, skip, i=i, d=d):
            res = x
            f = G._conv(p, f"filter_convs.{i}", x, d, q)
            g = G._conv(p, f"gate_convs.{i}", x, d, q)
            x = q(q(torch.tanh(f)) * q(torch.sigmoid(g)))
            s = G._linear(p, f"skip_convs.{i}", x[:, -t_final:], q)
            skip = s if skip is None else q(s + skip)
            hops = [x]
            for a in supports:
                h = x
                for _ in range(cfg["diffusion_order"]):
                    h = q(G.hop(h, a, q))
                    hops.append(h)
            x = G._linear(p, f"gconv.{i}.mlp.mlp", torch.cat(hops, dim=-1),
                          q)
            if train and masks is not None:
                x = q(x * masks[i])
            x = q(x + res[:, -x.shape[1]:])
            return G._batch_norm(p, f"bn.{i}", x, train, q), skip

        x, skip = checkpoint(layer, x, skip, use_reentrant=False)
    out = torch.relu(skip)
    out = torch.relu(G._linear(p, "end_conv_1", out, q))
    return G._linear(p, "end_conv_2", out, q)


@contextlib.contextmanager
def layers_recomputed():
    """``gwnet_ref``'s steps (``loss_of``, ``train_steps``) through
    :func:`forward` inside the block."""
    plain = G.forward
    G.forward = forward
    try:
        yield
    finally:
        G.forward = plain
