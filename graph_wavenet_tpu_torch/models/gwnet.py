"""Graph WaveNet as an ``nn.Module``: dense or block-sparse supports, the
adaptive adjacency dense or block-masked; eval and train mode.

Counterpart of ``graph_wavenet_tpu/models/gwnet.py``. Activations stay
channels-last ``(B, T, N, C)``; parameters carry the reference state-dict
names (``start_conv``, ``filter_convs.i``, ``gate_convs.i``,
``residual_convs.i``, ``skip_convs.i``, ``gconv.i.mlp.mlp``, ``bn.i``,
``end_conv_1``, ``end_conv_2``). As in the JAX model: the input is
left-padded to the true receptive field, activations run in ``cfg.dtype``
over fp32 parameters, each layer's skip projection sees only the last
``T_final`` steps, and predictions leave in fp32.

Supports: dense (N, N) tensors, block-sparse supports (``mix_2d``), ``[]``
for the adaptive-only model (``aptonly``) or None for the temporal-only
one. With ``addaptadj`` the model holds ``nodevec1 (N, r)`` and ``nodevec2
(r, N)`` (random, or the SVD of ``aptinit``) and appends the learned
adjacency to the fixed supports every forward: materialized on the live
blocks of a :class:`ops.adaptive_block.BlockAdaptiveMask` among the
supports (in ``cfg.dtype``), else dense, which the model refuses at 16,384
nodes and more. Dense supports take ``cfg.resolved_gcn_mode``; in
``stacked`` mode their power stacks are computed once per forward.

In train mode BatchNorm uses batch statistics and the graph convolutions
take dropout, drawn from the generator passed to :meth:`GWNet.forward`
before each layer runs.

Under a mesh (``GWNet.mesh``, ``parallel.mesh.Mesh``; DP and node-TP) the
model runs on the rank's batch rows and node range, ``cfg.num_nodes``
staying the global count: every BatchNorm takes the statistics of the
whole batch over the world group (divided by the global count, so that
uneven node ranges count each real node once), a layer draws its dropout
mask at the global shape and keeps the rank's slice (so a step equals the
single-process one, at the cost of one global draw per rank and layer).
Under node-TP the dense supports, given whole, become the rank's rows
(``parallel.dense_tp``), the dense adaptive adjacency is built as the
rank's rows, and the flat block-sparse supports and the mask are the
rank's shards (``parallel.sparse_tp``,
:class:`~parallel.sparse_tp.ShardedBlockAdaptiveMask`).

Under time-halo sequence parallelism (``mesh.time`` > 1) the input, padded
to the receptive field as in one process, is left-padded further to a
multiple of the time axis, and each rank of a time group runs the whole
stack on its block of it (``parallel.halo``): a layer's conv takes the
previous rank's last ``dilation*(k-1)`` steps by one exchange before the
layer (zeros on the first rank), the block keeps its width, and the
residual is the rank's own block. The single process's steps of a layer
are the last ones of the global axis; a rank's other steps are garbage,
which BatchNorm leaves out of its statistics (``t_valid``, the global
count), and the dropout mask is the single process's, drawn at its shape
and laid on the global axis. The skip projections read the last
``T_final`` steps, which lie on the last time rank
(``Mesh.holds_output``); every rank still runs the skips and the head,
so that all ranks run one program, and the loss keeps the holder's
output only (``train.engine``).

``cfg.remat`` recomputes every layer but the first in the backward
(``torch.utils.checkpoint``); the dropout masks drawn outside and the
BatchNorm statistics folded in outside the recomputed function keep a
remat step equal to a plain one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import ModelConfig
from graph_wavenet_tpu_torch.ops.adaptive import (
    adaptive_adjacency,
    adaptive_adjacency_batched,
    random_nodevecs,
    svd_nodevecs,
)
from graph_wavenet_tpu_torch.ops.diffusion import (
    GCN,
    dropout_scale,
    is_dense,
    support_powers,
)
from graph_wavenet_tpu_torch.ops.linear import Linear
from graph_wavenet_tpu_torch.ops.normalization import BatchNorm
from graph_wavenet_tpu_torch.ops.temporal import (
    CausalConv,
    gated_tcn_apply,
    left_pad_time,
)
from graph_wavenet_tpu_torch.parallel import dense_tp, sparse_tp
from graph_wavenet_tpu_torch.parallel import halo as time_halo

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference refuses the dense O(N^2) adaptive adjacency from here up
DENSE_ADAPTIVE_MAX_NODES = 16384


class GWNet(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device | str =
                 "cuda", seed: int = 0, aptinit: np.ndarray | None = None):
        """``aptinit``: an (N, N) adjacency whose SVD initializes the
        adaptive embeddings (None: standard-normal ones)."""
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
            if aptinit is None:
                nv1, nv2 = random_nodevecs(cfg.num_nodes, cfg.adapt_rank,
                                           **kw)
            else:
                e1, e2 = svd_nodevecs(aptinit, cfg.adapt_rank)
                nv1, nv2 = (torch.as_tensor(e, dtype=pdt) for e in (e1, e2))
            self.nodevec1 = nn.Parameter(nv1)
            self.nodevec2 = nn.Parameter(nv2)
        # parameters are drawn on the CPU from one seeded generator, so a
        # seed gives the same weights on every device
        self.to(device)
        self.eval()
        self.mesh = None

    def forward(self, x: torch.Tensor, supports: list | None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, N, in_dim) -> (B, T_out, N, out_dim) fp32. ``supports``:
        dense or block-sparse supports, with at most one adaptive mask under
        ``addaptadj``; ``[]`` for the adaptive-only model, None for the
        temporal-only one. ``generator``: the dropout stream in train
        mode."""
        return self._stack(x, self._with_adaptive(supports), generator)

    def _stack(self, x: torch.Tensor, supports: list | None,
               generator: torch.Generator | None) -> torch.Tensor:
        """The forward once the supports are complete (the adaptive one
        appended): pad, start conv, the WaveNet layers and the head. Shared
        with the per-sample-graph model (``models.gwnet_diff_g``)."""
        cfg = self.cfg
        x = left_pad_time(x, cfg.receptive_field)
        # the single process's width, before and after each layer
        t_len = x.shape[1]
        t_final = t_len - (cfg.kernel_size - 1) * sum(cfg.dilations())
        timed = self.mesh is not None and self.mesh.time > 1
        if timed:
            x = self._time_block(x, t_final)
        x = x.to(_DTYPES[cfg.dtype])
        x = self.start_conv(x)
        use_gcn = cfg.gcn_bool and supports is not None
        mode = cfg.resolved_gcn_mode
        stacks = None
        if (use_gcn and mode == "stacked" and supports
                and all(map(is_dense, supports))):
            stacks = [support_powers(a, cfg.diffusion_order)
                      for a in supports]
        draw = self.training and use_gcn and cfg.dropout > 0.0
        skip = None
        for i, dilation in enumerate(cfg.dilations()):
            t_len -= dilation * (cfg.kernel_size - 1)
            drop = halo = None
            if draw:
                drop = self._dropout(generator, x, t_len)
            if timed:
                # exchanged outside the layer, so a remat recompute does
                # not exchange again
                halo = time_halo.halo_from_left(
                    x, dilation * (cfg.kernel_size - 1), self.mesh)
            args = (i, dilation, t_final, t_len, x, skip, supports, stacks,
                    drop, halo)
            if cfg.remat and skip is not None and torch.is_grad_enabled():
                # the layer draws no random numbers (its mask is an
                # argument), so the global RNG is neither saved nor
                # restored: a CUDA graph may capture the step
                x, skip, stats = checkpoint(self._layer, *args,
                                            use_reentrant=False,
                                            preserve_rng_state=False)
            else:
                x, skip, stats = self._layer(*args)
            if stats is not None:
                self.bn[i].track(*stats)
        out = torch.relu(skip)
        out = torch.relu(self.end_conv_1(out))
        out = self.end_conv_2(out)
        return out.float()

    def _time_block(self, x: torch.Tensor, t_final: int) -> torch.Tensor:
        """This rank's block of the input (padded to the receptive field),
        left-padded to a multiple of the time axis; refuses a halo or an
        output wider than a block."""
        cfg, mesh = self.cfg, self.mesh
        total = time_halo.padded_width(x.shape[1], mesh.time)
        width = total // mesh.time
        time_halo.check_halo(max(cfg.dilations()) * (cfg.kernel_size - 1),
                             width, mesh.time, total)
        if t_final > width:
            raise ValueError(
                f"time-halo SP keeps the {t_final} output steps on the last "
                f"time rank, but a block is {total}/{mesh.time} = {width} "
                "steps: use fewer time shards")
        x = left_pad_time(x, total)
        lo = mesh.time_index * width
        return x[:, lo:lo + width]

    def _dropout(self, generator, x: torch.Tensor, t: int) -> torch.Tensor:
        """A layer's dropout mask for the rank's (B, T', N, C) output of
        the single process's width ``t``: drawn at the global shape under a
        mesh (its data rows, all ``cfg.num_nodes`` nodes and ``t`` steps),
        the rank's rows and node range kept; under time SP laid on the
        right of the global time axis (the steps before it are garbage and
        take 0)."""
        cfg = self.cfg
        b, width, n, _ = x.shape
        mesh = self.mesh
        if mesh is None:
            return dropout_scale(generator, cfg.dropout,
                                 (b, t, n, cfg.residual_channels), x.dtype,
                                 x.device)
        drop = dropout_scale(
            generator, cfg.dropout,
            (b * mesh.data, t, cfg.num_nodes, cfg.residual_channels),
            x.dtype, x.device)
        d = mesh.data_index
        lo, hi = mesh.node_range(cfg.num_nodes)
        drop = drop[d * b:(d + 1) * b, :, lo:hi]
        if mesh.time > 1:
            drop = left_pad_time(drop, width * mesh.time)
            lo = mesh.time_index * width
            drop = drop[:, lo:lo + width]
        return drop

    def _layer(self, i: int, dilation: int, t_final: int, t_len: int,
               x: torch.Tensor, skip: torch.Tensor | None,
               supports: list | None, stacks: list | None,
               drop: torch.Tensor | None, halo: torch.Tensor | None):
        """One WaveNet layer: gated TCN, skip projection, graph conv (or the
        residual 1x1 of the temporal-only model), residual, BatchNorm.
        ``t_len``: the single process's width after the layer; ``halo``:
        under time SP the steps before the rank's block. Returns ``(x,
        skip, bn_stats)``; the caller folds ``bn_stats`` into the running
        statistics."""
        residual = x
        if halo is not None:
            x = torch.cat([halo, x], dim=1)
        x = gated_tcn_apply(self.filter_convs[i], self.gate_convs[i], x,
                            dilation)
        s = self.skip_convs[i](x[:, -t_final:])
        skip = s if skip is None else s + skip
        # the dropout mask multiplies the graph conv's output in the tail,
        # with the residual add and BatchNorm
        if supports is not None and self.cfg.gcn_bool:
            h = self.gconv[i](x, supports, mode=self.cfg.resolved_gcn_mode,
                              stacks=stacks)
        else:
            h = self.residual_convs[i](x)
        mesh, t_valid, count = self.mesh, None, None
        if mesh is not None:
            # the global count: every real node once, whatever the ranks'
            # shares of the nodes and steps
            b, width = h.shape[:2]
            steps = width
            if mesh.time > 1:
                t_valid = time_halo.valid_steps(t_len, width, mesh)
                steps = t_len
            count = b * mesh.data * self.cfg.num_nodes * steps
        x, stats = self.bn[i].tail(
            h, residual, drop, None if mesh is None else mesh.world, t_valid,
            count)
        return x, skip, stats

    def _with_adaptive(self, supports: list | None) -> list | None:
        """The supports the layers diffuse over: the fixed ones, plus the
        adaptive adjacency under ``addaptadj`` (the reference's
        ``apply_gwnet`` checks, in its order)."""
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
        supports = self._node_rows(supports)
        if not use_adapt:
            return list(supports)
        if cfg.fresh_nodevec:
            raise ValueError(
                "fresh_nodevec=True reproduces the diff-G per-forward "
                "random embeddings; the shared-graph model has no such "
                "mode; unset fresh_nodevec")
        if len(masks) > 1:
            raise ValueError(
                f"supports contain {len(masks)} BlockAdaptiveMasks; the "
                "model materializes exactly one learned adjacency; pass a "
                "single mask")
        fixed = [s for s in supports
                 if not getattr(s, "adaptive_mask", False)]
        if masks:
            adp = masks[0].materialize(self.nodevec1, self.nodevec2,
                                       out_dtype=_DTYPES[cfg.dtype])
        elif cfg.num_nodes >= DENSE_ADAPTIVE_MAX_NODES:
            raise ValueError(
                "addaptadj without a BlockAdaptiveMask at "
                f"num_nodes={cfg.num_nodes} would materialize the dense "
                "O(N^2) adaptive adjacency; put a mask in the supports list "
                "(ops.adaptive_block.mask_from_supports(fixed), or "
                "mask_from_pairs with a chosen pattern for aptonly)")
        else:
            adp = self._adjacency(self.nodevec1, self.nodevec2)
        return fixed + [adp]

    @property
    def _node_tp(self) -> bool:
        return self.mesh is not None and self.mesh.model > 1

    def _node_rows(self, supports: list) -> list:
        """The supports as the layers take them: under node-TP a dense one,
        given whole, becomes the rank's rows; a block-sparse one must be
        the rank's shard already (``parallel.sparse_tp``)."""
        if not self._node_tp:
            return list(supports)
        out = [dense_tp.shard_dense_support(s, self.mesh)
               if torch.is_tensor(s) else s for s in supports]
        if any(not isinstance(s, sparse_tp.SHARDED
                              + (dense_tp.ShardedDenseSupport,))
               for s in out):
            raise ValueError(
                "node-TP (model axis > 1) takes dense supports whole and "
                "the flat block-sparse supports and mask sharded by "
                "parallel.sparse_tp (shard_flat_support, "
                "shard_adaptive_mask); the padded form has no node-TP")
        return out

    def _adjacency(self, nodevec1: torch.Tensor,
                   nodevec2: torch.Tensor):
        """The dense adaptive adjacency of shared (N, r) x (r, N) or
        per-sample (B, N, r) x (B, r, N) embeddings; under node-TP the
        rank's rows of it."""
        if self._node_tp:
            return dense_tp.adaptive_rows(nodevec1, nodevec2, self.mesh)
        if nodevec1.ndim == 3:
            return adaptive_adjacency_batched(nodevec1, nodevec2)
        return adaptive_adjacency(nodevec1, nodevec2)
