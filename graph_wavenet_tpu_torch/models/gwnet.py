"""Graph WaveNet as an ``nn.Module`` over block-sparse supports, with the
block-masked adaptive adjacency; eval and train mode.

Counterpart of ``graph_wavenet_tpu/models/gwnet.py``. Activations stay
channels-last ``(B, T, N, C)``; parameters carry the reference state-dict
names (``start_conv``, ``filter_convs.i``, ``gate_convs.i``,
``residual_convs.i``, ``skip_convs.i``, ``gconv.i.mlp.mlp``, ``bn.i``,
``end_conv_1``, ``end_conv_2``). As in the JAX model: the input is
left-padded to the true receptive field, activations run in ``cfg.dtype``
over fp32 parameters, each layer's skip projection sees only the last
``T_final`` steps, and predictions leave in fp32.

With ``addaptadj`` the model holds ``nodevec1 (N, r)`` and ``nodevec2 (r,
N)`` and, given a :class:`ops.adaptive_block.BlockAdaptiveMask` among the
supports, materializes the learned adjacency on the mask's live blocks
every forward (in ``cfg.dtype``) and appends it to the fixed supports. In
train mode BatchNorm uses batch statistics and the graph convolutions take
dropout, drawn from the generator passed to :meth:`GWNet.forward`. The
dense adaptive adjacency (no mask) waits for the dense slice.
"""

from __future__ import annotations

import torch
from torch import nn

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import ModelConfig
from graph_wavenet_tpu_torch.ops.adaptive import random_nodevecs
from graph_wavenet_tpu_torch.ops.diffusion import GCN
from graph_wavenet_tpu_torch.ops.linear import Linear
from graph_wavenet_tpu_torch.ops.normalization import BatchNorm
from graph_wavenet_tpu_torch.ops.temporal import (
    CausalConv,
    gated_tcn_apply,
    left_pad_time,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GWNet(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device | str =
                 "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device="cpu").manual_seed(seed)
        pdt = _DTYPES[cfg.param_dtype]
        kw = dict(generator=gen, dtype=pdt)
        n_layers = cfg.blocks * cfg.layers
        self.start_conv = Linear(cfg.in_dim, cfg.residual_channels, **kw)
        self.filter_convs = nn.ModuleList()
        self.gate_convs = nn.ModuleList()
        self.residual_convs = nn.ModuleList()
        self.skip_convs = nn.ModuleList()
        self.bn = nn.ModuleList()
        self.gconv = nn.ModuleList()
        for _ in range(n_layers):
            self.filter_convs.append(CausalConv(
                cfg.residual_channels, cfg.dilation_channels,
                cfg.kernel_size, **kw))
            self.gate_convs.append(CausalConv(
                cfg.residual_channels, cfg.dilation_channels,
                cfg.kernel_size, **kw))
            self.residual_convs.append(Linear(
                cfg.dilation_channels, cfg.residual_channels, **kw))
            self.skip_convs.append(Linear(cfg.dilation_channels,
                                          cfg.skip_channels, **kw))
            self.bn.append(BatchNorm(cfg.residual_channels, dtype=pdt))
            if cfg.gcn_bool:
                self.gconv.append(GCN(
                    cfg.dilation_channels, cfg.residual_channels,
                    cfg.supports_len, cfg.diffusion_order, **kw))
        self.end_conv_1 = Linear(cfg.skip_channels, cfg.end_channels, **kw)
        self.end_conv_2 = Linear(cfg.end_channels, cfg.out_dim, **kw)
        if cfg.gcn_bool and cfg.addaptadj and not cfg.fresh_nodevec:
            nv1, nv2 = random_nodevecs(cfg.num_nodes, cfg.adapt_rank, **kw)
            self.nodevec1 = nn.Parameter(nv1)
            self.nodevec2 = nn.Parameter(nv2)
        # parameters are drawn on the CPU from one seeded generator, so a
        # seed gives the same weights on every device
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, supports: list | None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, N, in_dim) -> (B, T_out, N, out_dim) fp32. ``supports``:
        block-sparse supports, with at most one adaptive mask under
        ``addaptadj``, or None for the temporal-only model. ``generator``:
        the dropout stream in train mode."""
        cfg = self.cfg
        x = left_pad_time(x, cfg.receptive_field)
        x = x.to(_DTYPES[cfg.dtype])
        x = self.start_conv(x)
        supports = self._with_adaptive(supports)
        use_gcn = cfg.gcn_bool and supports is not None
        t_final = x.shape[1] - (cfg.kernel_size - 1) * sum(cfg.dilations())
        skip = None
        for i, dilation in enumerate(cfg.dilations()):
            residual = x
            x = gated_tcn_apply(self.filter_convs[i], self.gate_convs[i],
                                residual, dilation)
            s = self.skip_convs[i](x[:, -t_final:])
            skip = s if skip is None else s + skip
            if use_gcn:
                x = self.gconv[i](x, supports, cfg.dropout, generator)
            else:
                x = self.residual_convs[i](x)
            x = x + residual[:, -x.shape[1]:]
            x = self.bn[i](x)
        out = torch.relu(skip)
        out = torch.relu(self.end_conv_1(out))
        out = self.end_conv_2(out)
        return out.float()

    def _with_adaptive(self, supports: list | None) -> list | None:
        """The supports the layers diffuse over: the fixed ones, plus the
        adaptive adjacency materialized from the mask under ``addaptadj``
        (the reference's ``apply_gwnet`` checks, in its order)."""
        cfg = self.cfg
        if supports is None:
            return None
        masks = [s for s in supports if getattr(s, "adaptive_mask", False)]
        use_adapt = cfg.gcn_bool and cfg.addaptadj
        if masks and not use_adapt:
            raise ValueError(
                "supports contain a BlockAdaptiveMask but the adaptive "
                "adjacency is off (gcn_bool and addaptadj must both be set "
                "to materialize it)")
        if not use_adapt:
            return list(supports)
        if cfg.fresh_nodevec:
            raise ValueError(
                "fresh_nodevec=True reproduces the diff-G per-forward "
                "random embeddings; the shared-graph model has no such "
                "mode; unset fresh_nodevec")
        if not masks:
            raise NotImplementedError(
                "addaptadj without a BlockAdaptiveMask needs the dense "
                "adaptive adjacency, which comes with the dense slice "
                "(ROADMAP.md); put ops.adaptive_block.mask_from_supports("
                "fixed) in the supports list")
        if len(masks) > 1:
            raise ValueError(
                f"supports contain {len(masks)} BlockAdaptiveMasks; the "
                "model materializes exactly one learned adjacency; pass a "
                "single mask")
        fixed = [s for s in supports
                 if not getattr(s, "adaptive_mask", False)]
        adp = masks[0].materialize(self.nodevec1, self.nodevec2,
                                   out_dtype=_DTYPES[cfg.dtype])
        return fixed + [adp]
