"""Training engine: one module, one optimizer, the real-data steps and the
synthetic two-modality ones.

Counterpart of ``graph_wavenet_tpu/train/engine.py`` (``make_optimizer``,
``horizon_target``, ``gather_window_rows``, ``Engine`` with
``train_step``, ``train_step_accum``, ``train_steps_resident``,
``train_steps_windows``, ``eval_step``, ``eval_steps_resident``,
``eval_steps_windows`` and ``predict_step``), which reproduces the
reference trainer: masked MAE with ``null_val`` 0.0 on
inverse-standardized predictions, global-norm gradient clipping, Adam with
L2 weight decay. The optimizer chain is the same as the reference
package's optax one: ``clip_grad_norm_`` first, then Adam's weight decay
adds ``wd * p`` to the clipped gradient, then the Adam moments (``eps``
1e-8). The one difference is ``clip_grad_norm_``'s ``+1e-6`` in the clip
factor against optax's exact clip.

The synthetic and CRASH tasks (``modality_target``, ``pool_F``, ``pool_E``,
``cluster_mean_projector``; ``train_step_syn``, ``train_step_syn_accum``,
``train_steps_syn_resident``, ``eval_step_syn``) supervise two pooled
views of the predicted K-step sequence: F̂, its block mean over windows of
``F_t`` steps repeated back, and Ê, its community mean through a
cluster-mean projector (shared (N, N), or per-sample (B, N, N) for the
per-sample-graph model, ``Engine(..., diff_g=True)``). As in the reference,
MAPE and RMSE score Ê against both target channels. Under
``fresh_nodevec`` a train step draws the embeddings from the engine's
generator, and eval and predict draw them from a generator seeded 0 per
call (so they are deterministic).

:class:`DCRNNEngine` runs DCRNN's seq2seq step (``models.dcrnn``, which
the reference package does not have) on the same machinery: its fused
steps, clip and Adam, with DCRNN's loss, curriculum and epsilon.

PyTorch's idiom: a step updates the module and the optimizer in place and
returns its metrics as device tensors, which the caller syncs. On a CUDA
device Adam is ``capturable`` (its step count and bias correction live in
device tensors) and the learning rate is a 0-dim device tensor filled
before every step, for every step, eager or not: the fused steps run one
captured step as a CUDA graph (``train.step_graph``), and the two Adam
paths differ in the last bits. On the CPU Adam keeps its host scalars and
a fused call is the eager loop of the same step.

Under a mesh (``Engine(..., mesh=)``, ``parallel.mesh.Mesh``: DP and node-TP
over ``torch.distributed``) a step is the single-process step on the global
batch, as GSPMD keeps a JAX mesh step: every rank is given the global batch
(its node range, or all nodes) and takes its rows (the d-th share of each
micro-batch) and its node range; BatchNorm statistics, the mask's mean and
the metrics are global (``train.metrics``), each rank back-propagates its
part of the loss, and the gradients are summed over the world in one flat
all-reduce before the clip and Adam, which then do the same on every rank:
the parameters stay replicated bit for bit. ``predict_step`` returns the
rank's rows and nodes.

The fused steps run under a mesh too (JAX's ``_constrain`` of the in-scan
gathers): every rank is given the global (S, B) index matrix and keeps its
columns (``Mesh.index_share``, the rows ``batch_rows`` gives the eager
step), so a fused step gathers the rank's rows inside the graph and stays
bit for bit the eager one. On the card the step's collectives are captured
with it, which needs an NCCL group (``parallel.collectives``): a CUDA
engine on a gloo group of more than one rank refuses the fused steps
(:class:`parallel.collectives.GlooCaptureError`) and nothing falls back
to eager steps; on the CPU a fused call is the eager loop under any group.
The two-modality tasks run under a mesh too (the diff-G model included):
each rank takes its rows of x, y and of the per-sample supports and
projectors, and the two-modality loss and metrics follow the global rule.
Under node-TP (``model_axis`` > 1) the model takes the supports' node rows
(``parallel.dense_tp``), and ``pool_E`` contracts the rank's nodes with
its rows of the projector's transpose, summed over the model group.

Under time-halo sequence parallelism (``mesh.time`` > 1: data x time, every
step kind above) every rank of a time group is given the same rows and
runs the whole step on its block of the time axis (``models.gwnet``); the
output steps lie on the group's last rank (``Mesh.holds_output``), whose
loss part and metrics are the rows' own, while the others' are exact zeros
with a zero gradient (``train.metrics``, ``holds``). The world's gradient
sum is then the single process's gradient. ``predict_step`` and
``eval_step_syn``'s pooled predictions hold garbage off the last time
rank.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import (
    DCRNNConfig,
    ModelConfig,
    TrainConfig,
)
from graph_wavenet_tpu_torch.data.device_loader import (
    gather_window_rows,
    gather_xy_windows,
)
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models import dcrnn
from graph_wavenet_tpu_torch.models.gwnet import GWNet
from graph_wavenet_tpu_torch.models.gwnet_diff_g import GWNetDiffG
from graph_wavenet_tpu_torch.ops.diffusion import nconv, nconv_batched
from graph_wavenet_tpu_torch.parallel.collectives import (
    GlooCaptureError,
    all_reduce_grads,
)
from graph_wavenet_tpu_torch.parallel.dense_tp import shard_dense_support
from graph_wavenet_tpu_torch.train import profiling, step_graph
from graph_wavenet_tpu_torch.train.metrics import (
    global_terms,
    masked_terms,
)

__all__ = ["DCRNNEngine", "Engine", "cluster_mean_projector",
           "gather_window_rows", "horizon_target", "learning_rate",
           "modality_target", "pool_E", "pool_F"]

METRICS = ("loss", "mape", "rmse")


def learning_rate(cfg: TrainConfig, step: int, steps_per_epoch: int) -> float:
    """The learning rate of optimizer step ``step`` (0-based): constant, or
    ``lr * lr_decay ** (epoch // lr_decay_every)`` floored at ``min_lr``."""
    if cfg.lr_decay >= 1.0:
        return cfg.learning_rate
    epoch = step // steps_per_epoch
    return max(cfg.learning_rate
               * cfg.lr_decay ** (epoch // cfg.lr_decay_every), cfg.min_lr)


def horizon_target(y: torch.Tensor) -> torch.Tensor:
    """y (B, H, N, F) -> (B, 1, N, H): the speed channel in the layout the
    reference compares against."""
    return y[..., 0].permute(0, 2, 1)[:, None]


def modality_target(y: torch.Tensor) -> torch.Tensor:
    """y (B, K, N, 2) -> (B, 2, N, K): channel 0 the F target, 1 the E
    target."""
    return y.permute(0, 3, 2, 1)


def pool_F(predict: torch.Tensor, F_t: int) -> torch.Tensor:
    """Temporal block mean over windows of ``F_t`` steps, repeated back to
    full rate: (B, C, N, K) -> the same shape."""
    b, c, n, k = predict.shape
    if k % F_t:
        raise ValueError(
            f"F-modality pooling needs seq_length K={k} divisible by "
            f"F_t={F_t} (the reference picks F_t = K//12, util.py:234)")
    f = predict.reshape(b, c, n, k // F_t, F_t).mean(-1, keepdim=True)
    # an expand, not repeat_interleave: its backward is a sum, where the
    # index gather's would be an atomic scatter (not bit-reproducible)
    return f.expand(b, c, n, k // F_t, F_t).reshape(b, c, n, k)


def cluster_mean_projector(labels: np.ndarray,
                           n_communities: int) -> np.ndarray:
    """(N,) community labels -> the (N, N) float32 projector P with P[n, v]
    = 1/|c(n)| where v is in n's community: ``P @ x`` is the community
    mean, the reference's per-cluster scatter loop as one product. Built on
    the host."""
    labels = np.asarray(labels)
    onehot = (labels[:, None] == np.arange(n_communities)[None, :]).astype(
        np.float32)
    counts = onehot.sum(0)
    return (onehot / np.maximum(counts, 1.0)[None, :]) @ onehot.T


def pool_E(predict: torch.Tensor, projector: torch.Tensor,
           mesh=None) -> torch.Tensor:
    """Community-mean pooling of (B, 1, N, K) by a shared (N, N) or
    per-sample (B, N, N) projector: ``out[w] = sum_v P[w, v] x[v]``, the
    diffusion step over the transposed projector. Under a ``mesh`` that
    splits the nodes, ``predict`` holds the rank's nodes and the step is
    the sharded one over its rows of the transpose (the projector
    given whole)."""
    x = predict.permute(0, 3, 2, 1)                 # (B, K, N, 1)
    if mesh is not None and mesh.model > 1:
        out = shard_dense_support(projector.transpose(-1, -2), mesh).nconv(x)
    elif projector.ndim == 3:
        out = nconv_batched(x, projector.transpose(1, 2))
    else:
        out = nconv(x, projector.t())
    return out.permute(0, 3, 2, 1)


def _as_dict(m: torch.Tensor) -> dict:
    """(..., 3) stacked metrics -> {"loss", "mape", "rmse"}."""
    return {k: m[..., i] for i, k in enumerate(METRICS)}


def _identity(k):
    """A graph key's entry for an input: tensors and support objects by
    identity, tuples entry by entry, numbers and None by value."""
    if isinstance(k, tuple):
        return tuple(map(_identity, k))
    if k is None or isinstance(k, (int, float, str)):
        return k
    return id(k)


def _supports_key(supports):
    return None if supports is None else tuple(supports)


class Engine:
    """The model, its optimizer and the dropout generator, on ``device``.
    ``seed`` (default ``train_cfg.seed``) draws the weights and seeds the
    dropout stream; ``steps_per_epoch`` converts the step decay's epochs to
    optimizer steps; ``aptinit``: the adjacency whose SVD initializes the
    adaptive embeddings (:class:`models.gwnet.GWNet`); ``diff_g``: the
    per-sample-graph model (:class:`models.gwnet_diff_g.GWNetDiffG`),
    whose supports are (B, N, N) per batch; ``mesh``: this rank's
    :class:`parallel.mesh.Mesh` (its device is the engine's);
    ``adam_eps``: Adam's epsilon."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 scaler: StandardScaler | None, *,
                 device: torch.device | str = "cuda",
                 seed: int | None = None, steps_per_epoch: int = 0,
                 aptinit=None, diff_g: bool = False, mesh=None,
                 adam_eps: float = 1e-8):
        if train_cfg.lr_decay < 1.0 and steps_per_epoch <= 0:
            raise ValueError(
                f"TrainConfig.lr_decay={train_cfg.lr_decay} < 1 needs "
                "steps_per_epoch to convert epochs to optimizer steps; pass "
                "Engine(..., steps_per_epoch=train_loader.num_batch)")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.scaler = scaler or StandardScaler(0.0, 1.0)
        self.steps_per_epoch = steps_per_epoch
        seed = train_cfg.seed if seed is None else seed
        self.diff_g = diff_g
        self.model = self._make_model(model_cfg, seed, aptinit)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"engine's {self.device}")
        self.mesh = self.model.mesh = mesh
        cuda = self.device.type == "cuda"
        # on the card: one learning-rate tensor for the life of the engine
        # (a captured step reads it by address) and capturable Adam
        self._lr = (torch.full((), train_cfg.learning_rate,
                               dtype=torch.float32, device=self.device)
                    if cuda else None)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(),
            lr=self._lr if cuda else train_cfg.learning_rate,
            weight_decay=train_cfg.weight_decay, eps=adam_eps,
            capturable=cuda)
        # eager steps are capturable on purpose (see the module docstring):
        # silence the optimizer's one-time advice against it
        self.optimizer._warned_capturable_if_run_uncaptured = True
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        # captured steps by their inputs (train.step_graph), and the stream
        # they are warmed up and captured on
        self._graphs: dict = {}
        self._stream = torch.cuda.Stream(self.device) if cuda else None

    def _make_model(self, model_cfg, seed: int, aptinit) -> torch.nn.Module:
        return (GWNetDiffG if self.diff_g else GWNet)(
            model_cfg, device=self.device, seed=seed, aptinit=aptinit)

    def _tensor(self, a, n_micro: int = 1) -> torch.Tensor:
        """A batch array on the device; under a mesh the rank's rows and
        node range of it."""
        a = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        if self.mesh is None:
            return a
        return self.mesh.shard_batch(a, n_micro, self.model_cfg.num_nodes)

    def batch_rows(self, b: int, n_micro: int = 1) -> np.ndarray:
        """The rows of a global batch of ``b`` that this rank computes (the
        d-th share of each of ``n_micro`` micro-batches)."""
        return (np.arange(b) if self.mesh is None
                else self.mesh.batch_rows(b, n_micro))

    def _sample_rows(self, a, b: int, n_micro: int = 1):
        """This rank's rows of a per-sample (b, N, N) stack of a global
        batch of ``b`` rows; a shared (N, N) tensor or None as it is."""
        if a is None or a.ndim != 3:
            return a
        if a.shape[0] != b:
            raise ValueError(
                f"a per-sample stack of {a.shape[0]} rows for a batch of "
                f"{b}: pass the global batch's stacks (the engine takes "
                f"this rank's rows)")
        if self.mesh is None:
            return a
        return a.index_select(0, torch.as_tensor(
            self.mesh.batch_rows(b, n_micro), device=a.device))

    def _local_nodes(self, a: torch.Tensor) -> torch.Tensor:
        """A (B, T, N, C) batch gathered inside a fused step: its rank's
        node range where it holds every node and the model axis splits
        them (a node-TP loader holds the range already)."""
        n = self.model_cfg.num_nodes
        if self.mesh is None or self.mesh.model == 1 or a.shape[2] != n:
            return a
        lo, hi = self.mesh.node_range(n)
        return a[:, :, lo:hi].contiguous()

    @property
    def _world(self):
        return None if self.mesh is None else self.mesh.world

    @property
    def holds_output(self) -> bool:
        """Whether this rank's predictions are the model's output: False
        off the last rank of a time group (time SP)."""
        return self.mesh is None or self.mesh.holds_output

    def _generator(self) -> torch.Generator:
        """What the model draws from: the engine's generator, but in eval
        mode under ``fresh_nodevec`` (the one draw there) a new one seeded
        0, so eval answers are deterministic and leave the stream as it
        is."""
        if self.model.training or not self.model_cfg.fresh_nodevec:
            return self.generator
        return torch.Generator(device=self.device).manual_seed(0)

    def _forward(self, x: torch.Tensor, supports) -> torch.Tensor:
        # the engine left-pads the input by one step, as the reference's
        x = F.pad(x, (0, 0, 0, 0, 1, 0))
        out = self.model(x, supports, generator=self._generator())
        return out * self.scaler.std + self.scaler.mean

    def _metrics(self, loss, predict, real) -> torch.Tensor:
        """(loss, MAPE, RMSE) of ``predict``, global: ``loss`` is this
        rank's part of the loss."""
        parts = masked_terms(predict, real, 0.0, self._world,
                             self.holds_output)
        return global_terms(loss.detach(), parts[1], parts[2], self._world)

    def _set_lr(self) -> None:
        """The schedule's rate for the next step: filled into the device
        tensor on the card (no host copy), a host scalar on the CPU."""
        lr = learning_rate(self.train_cfg, self.step, self.steps_per_epoch)
        if self._lr is not None:
            self._lr.fill_(lr)
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr

    def _loss(self, x: torch.Tensor, y: torch.Tensor, supports):
        """(loss, stacked global metrics) of a batch in the model's mode;
        under a mesh the loss is this rank's part."""
        predict = self._forward(x, supports)
        real = horizon_target(y)
        mae, mape, mse = masked_terms(predict, real, 0.0, self._world,
                                      self.holds_output)
        with torch.no_grad():
            return mae, global_terms(mae, mape, mse, self._world)

    def _update(self) -> None:
        all_reduce_grads(self.model.parameters(), self._world)
        torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                       self.train_cfg.grad_clip)
        self.optimizer.step()

    def _optimize(self, loss_fn, *args) -> torch.Tensor:
        """Forward (``loss_fn(*args)`` -> (loss, stacked metrics)) in train
        mode, backward, clip and Adam; the learning rate is set beforehand.
        Returns the metrics (3,). No host sync, so a CUDA graph can capture
        it."""
        self.model.train()
        loss, m = loss_fn(*args)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._update()
        return m

    def _train_core(self, x: torch.Tensor, y: torch.Tensor,
                    supports) -> torch.Tensor:
        """:meth:`_optimize` on a real-data batch."""
        return self._optimize(self._loss, x, y, supports)

    def _accumulate(self, b: int, n_micro: int, micro_loss) -> dict:
        """One optimizer step over ``n_micro`` equal micro-batches of a
        batch of ``b`` rows, run one after another: ``micro_loss(lo, hi)``
        gives (loss, stacked metrics) of rows lo:hi; the gradients are
        summed and divided by ``n_micro``, then one clip and one Adam step;
        the metrics are the micro-batches' means."""
        if n_micro < 1 or b % n_micro:
            raise ValueError(f"batch {b} must divide by n_micro={n_micro}")
        mb = b // n_micro
        self._set_lr()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        buffers = list(self.model.buffers())
        start = [t.clone() for t in buffers]
        ms = []
        for i in range(n_micro):
            if i:
                # every micro-batch updates the running statistics from
                # the step's starting values: the last update is kept
                for t, t0 in zip(buffers, start):
                    t.copy_(t0)
            loss, m = micro_loss(i * mb, (i + 1) * mb)
            loss.backward()
            ms.append(m)
        with torch.no_grad():
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(n_micro)
        self._update()
        self.step += 1
        return _as_dict(torch.stack(ms).mean(0))

    @torch.no_grad()
    def _eval_core(self, x: torch.Tensor, y: torch.Tensor,
                   supports) -> torch.Tensor:
        self.model.eval()
        return self._loss(x, y, supports)[1]

    def train_step(self, x, y, supports) -> dict:
        """One optimizer step on a batch: x (B, T, N, in_dim) standardized,
        y (B, H, N, F) raw units. Returns loss, MAPE and RMSE as device
        scalars."""
        self._set_lr()
        m = self._train_core(self._tensor(x), self._tensor(y), supports)
        self.step += 1
        return _as_dict(m)

    def train_step_accum(self, x, y, supports, n_micro: int) -> dict:
        """One optimizer step over ``n_micro`` equal micro-batches of the
        batch, run one after another: their gradients summed and divided by
        ``n_micro``, then one clip and one Adam step; the metrics are the
        micro-batches' means. As in the JAX package, not a full-batch step:
        each micro-batch's BatchNorm normalizes with its own statistics,
        and the running statistics take one update, from the last
        micro-batch. Peak activation memory drops about ``n_micro``-fold."""
        x, y = self._tensor(x, n_micro), self._tensor(y, n_micro)
        return self._accumulate(
            x.shape[0], n_micro,
            lambda lo, hi: self._loss(x[lo:hi], y[lo:hi], supports))

    def _fused(self, train: bool, name: str, body, key: tuple, idx) -> dict:
        """S steps over the rows of ``idx`` (S, B): on the card through a
        :class:`step_graph.StepGraph`, on the CPU as the eager loop.
        ``body(sel)`` runs one step (``train``: an optimizer step) on the
        samples ``sel`` and returns its stacked metrics; ``key``: the
        resident inputs and supports it reads and its static arguments."""
        world = self._world
        cuda = self.device.type == "cuda"
        if (cuda and world is not None and self.mesh.world_size > 1
                and dist.get_backend(world) == "gloo"):
            raise GlooCaptureError(
                "the fused steps capture their collectives in a CUDA graph, "
                "and a gloo group of more than one rank stages CUDA tensors "
                "through host memory, which cannot be captured: run the "
                "ranks on an NCCL group (one card each), or scan_steps=1 "
                "(train_step / eval_step) on gloo")
        idx = torch.as_tensor(idx, device=self.device).to(torch.int32)
        if idx.ndim != 2:
            raise ValueError(f"idx must be (S, B), got {tuple(idx.shape)}")
        if self.mesh is not None:
            idx = self.mesh.index_share(idx)

        def after():
            self.step += 1

        if not cuda:
            rows = []
            for sel in idx:
                if train:
                    self._set_lr()
                rows.append(body(sel))
                if train:
                    after()
            return _as_dict(torch.stack(rows))
        # a graph reads its inputs by address: key it by their identity
        # and keep them alive with it
        out = step_graph.run_steps(
            self._graphs, (name, idx.shape[1], *map(_identity, key)), body,
            idx, self._stream, keep=key,
            generator=self.generator if train else None,
            before=self._set_lr if train else None,
            after=after if train else None,
            error_mode="global" if world is None else "thread_local")
        return _as_dict(out)

    def train_steps_resident(self, xs: torch.Tensor, ys: torch.Tensor, idx,
                             supports) -> dict:
        """S optimizer steps in one call, each on the batch of sample
        indices ``idx[k]`` gathered from the resident arrays xs (n, T, N,
        C), ys (n, H, N, F). Returns the metrics as (S,) device tensors.
        The same steps as S :meth:`train_step` calls on the gathered
        batches, bit for bit: on the card one step runs eagerly the first
        time and a CUDA graph of it replays the rest (and every step of a
        later call over the same inputs)."""
        return self._fused(
            True, "train", lambda sel: self._train_core(
                *self._rows_of(xs, ys, sel), supports),
            (xs, ys, _supports_key(supports)), idx)

    def train_steps_windows(self, series: torch.Tensor, anchors,
                            window: int, horizon: int, y_start: int,
                            supports, y_series: torch.Tensor | None = None
                            ) -> dict:
        """Windows-on-demand :meth:`train_steps_resident`: step k gathers
        the x windows ending at ``anchors[k]`` from the resident
        standardized ``series`` (T, N, C) and the y windows (rows
        ``y_start .. horizon`` after each anchor) from ``y_series`` (raw
        units; default ``series``)."""
        gather, key = self._windows(series, window, horizon, y_start,
                                    y_series)
        return self._fused(
            True, "train", lambda a: self._train_core(*gather(a), supports),
            key + (_supports_key(supports),), anchors)

    def eval_steps_resident(self, xs: torch.Tensor, ys: torch.Tensor, idx,
                            supports) -> dict:
        """Eval metrics of every row of ``idx`` (C, B) over resident
        arrays: (C,) device tensors, one sync for the caller per split."""
        return self._fused(
            False, "eval", lambda sel: self._eval_core(
                *self._rows_of(xs, ys, sel), supports),
            (xs, ys, _supports_key(supports)), idx)

    def eval_steps_windows(self, series: torch.Tensor, anchors, window: int,
                           horizon: int, y_start: int, supports,
                           y_series: torch.Tensor | None = None) -> dict:
        """Eval metrics of every row of ``anchors`` (C, B), the windows
        gathered as in :meth:`train_steps_windows`."""
        gather, key = self._windows(series, window, horizon, y_start,
                                    y_series)
        return self._fused(
            False, "eval", lambda a: self._eval_core(*gather(a), supports),
            key + (_supports_key(supports),), anchors)

    def _rows_of(self, xs, ys, sel):
        """The batch ``sel`` of resident sample arrays, in the rank's node
        range."""
        return (self._local_nodes(xs.index_select(0, sel)),
                self._local_nodes(ys.index_select(0, sel)))

    def _windows(self, series, window, horizon, y_start, y_series):
        """(gather, inputs) of the windows-on-demand feed."""
        ys_src = series if y_series is None else y_series
        y_len = horizon - y_start + 1

        def gather(a):
            return tuple(map(self._local_nodes, gather_xy_windows(
                series, ys_src, a, window, y_start, y_len)))

        return gather, (series, ys_src, window, horizon, y_start)

    @torch.no_grad()
    def eval_step(self, x, y, supports) -> dict:
        """Loss, MAPE and RMSE of a batch in eval mode (engine pad kept)."""
        return _as_dict(self._eval_core(self._tensor(x), self._tensor(y),
                                        supports))

    @torch.no_grad()
    def predict_step(self, x, supports) -> torch.Tensor:
        """The raw (standardized) forward for the per-horizon test loop.
        Like the reference's test loop it runs the model with no engine-level
        pad: the model's own receptive-field pad covers the missing step
        (for either model)."""
        self.model.eval()
        return self.model(self._tensor(x), supports,
                          generator=self._generator())

    # ------------------------------------------------------------------
    # the synthetic two-modality steps
    # ------------------------------------------------------------------

    def _check_syn_collapse(self, predict: torch.Tensor) -> None:
        """The F/E supervision needs the dilated stack to collapse time to
        one output step (a shape check on the host)."""
        if predict.shape[1] != 1:
            k = predict.shape[-1]
            raise ValueError(
                f"modality (F/E) supervision requires the dilated conv "
                f"stack to collapse time to one step, but the model "
                f"produced {predict.shape[1]} output steps for seq_length "
                f"K={k} (receptive_field={self.model_cfg.receptive_field}, "
                f"input K+1={k + 1}). Choose blocks/layers/start_dilation "
                f"so receptive_field == K+1, or reduce seq_length.")

    def _syn_outputs(self, x, y, supports, projector, F_t: int):
        """(loss, F̂, Ê, target) of a batch in the model's current mode;
        under a mesh the loss is this rank's part."""
        predict = self._forward(x, supports)
        self._check_syn_collapse(predict)
        real = modality_target(y)
        f_hat = pool_F(predict, F_t)
        e_hat = pool_E(predict, projector, self.mesh)
        loss = masked_terms(torch.cat([f_hat, e_hat], dim=1), real, 0.0,
                            self._world, self.holds_output)[0]
        return loss, f_hat, e_hat, real

    def _syn_loss(self, x, y, supports, projector, F_t: int):
        """(loss, stacked global metrics) of a train-mode batch: MAPE and
        RMSE of Ê against both target channels."""
        loss, _, e_hat, real = self._syn_outputs(x, y, supports, projector,
                                                 F_t)
        with torch.no_grad():
            m = self._metrics(loss, e_hat.detach(), real)
        return loss, m

    def _syn_tensors(self, x, y, supports, projector, n_micro: int = 1):
        """x, y, the supports and the projector of a global batch on the
        device: under a mesh the rank's rows of each (of the per-sample
        stacks, which hold the global batch's rows; shared ones as they
        are)."""
        b = x.shape[0]
        projector = torch.as_tensor(projector, dtype=torch.float32,
                                    device=self.device)
        return (self._tensor(x, n_micro), self._tensor(y, n_micro),
                None if supports is None else
                [self._sample_rows(s, b, n_micro) for s in supports],
                self._sample_rows(projector, b, n_micro))

    def train_step_syn(self, x, y, supports, projector, F_t: int) -> dict:
        """One optimizer step of the two-modality task: x (B, K, N, 2)
        standardized, y (B, K, N, 2) raw, ``supports`` shared (N, N) or
        per-sample (B, N, N) (the diff-G model), ``projector`` the
        cluster-mean projector, shared or per sample."""
        x, y, supports, projector = self._syn_tensors(x, y, supports,
                                                      projector)
        self._set_lr()
        m = self._optimize(self._syn_loss, x, y, supports, projector, F_t)
        self.step += 1
        return _as_dict(m)

    def train_step_syn_accum(self, x, y, supports, projector, F_t: int,
                             n_micro: int) -> dict:
        """:meth:`train_step_accum` of the two-modality step: per-sample
        supports and projectors ((B, N, N), B the batch) are sliced with
        the micro-batches, shared ones serve each."""
        x, y, supports, projector = self._syn_tensors(x, y, supports,
                                                      projector, n_micro)
        b = x.shape[0]

        def part(a, lo, hi):
            return a[lo:hi] if a.ndim == 3 else a

        return self._accumulate(b, n_micro, lambda lo, hi: self._syn_loss(
            x[lo:hi], y[lo:hi],
            None if supports is None else [part(s, lo, hi)
                                           for s in supports],
            part(projector, lo, hi), F_t))

    def train_steps_syn_resident(self, xs: torch.Tensor, ys: torch.Tensor,
                                 idx, adj_of_sample: torch.Tensor,
                                 sup_stack, proj_stack: torch.Tensor,
                                 F_t: int) -> dict:
        """S diff-G optimizer steps in one call (:meth:`train_steps_resident`
        for the per-sample-graph task): step k gathers the samples
        ``idx[k]`` from the resident xs, ys, their graph indices from
        ``adj_of_sample`` (n,), and through those their supports from
        ``sup_stack`` (a list of (n_graphs, N, N); None for the
        temporal-only model) and projectors from ``proj_stack`` (n_graphs,
        N, N). Bit for bit S :meth:`train_step_syn` calls on the gathered
        batches; on the card a CUDA graph replays the step, and every
        resident input keeps its address (the graph's key holds them)."""
        sups = None if sup_stack is None else tuple(sup_stack)

        def body(sel):
            gids = adj_of_sample.index_select(0, sel)
            sup = (None if sups is None
                   else [s.index_select(0, gids) for s in sups])
            return self._optimize(
                self._syn_loss, *self._rows_of(xs, ys, sel), sup,
                proj_stack.index_select(0, gids), F_t)

        return self._fused(True, "train_syn", body,
                           (xs, ys, adj_of_sample, sups, proj_stack, F_t),
                           idx)

    @torch.no_grad()
    def eval_step_syn(self, x, y, supports, projector, F_t: int) -> dict:
        """Loss, MAPE and RMSE of a batch in eval mode, and the pooled
        predictions ``pred_F``/``pred_E`` (B, 1, N, K) in raw units."""
        x, y, supports, projector = self._syn_tensors(x, y, supports,
                                                      projector)
        self.model.eval()
        loss, f_hat, e_hat, real = self._syn_outputs(x, y, supports,
                                                     projector, F_t)
        out = _as_dict(self._metrics(loss, e_hat, real))
        out.update(pred_F=f_hat, pred_E=e_hat)
        return out

    def step_graphs(self) -> list:
        """The captured steps (:class:`step_graph.StepGraph`), for their
        per-replay launch counts."""
        return list(self._graphs.values())

    def train_state(self) -> dict:
        """What a checkpoint needs to continue: optimizer, step count and
        the dropout generator's state."""
        return {"optimizer": self.optimizer.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}

    def load_train_state(self, state: dict) -> None:
        """Restore :meth:`train_state`'s entries (a checkpoint's payload;
        the model's weights load separately). Captured steps are dropped:
        the optimizer's state tensors are new ones."""
        self.optimizer.load_state_dict(state["optimizer"])
        # the groups keep this engine's Adam path whatever device wrote the
        # checkpoint: capturable on the card, reading the one learning-rate
        # tensor that _set_lr fills and the captured steps read
        cuda = self._lr is not None
        for group in self.optimizer.param_groups:
            group["capturable"] = cuda
            group["lr"] = self._lr if cuda else float(group["lr"])
        for st in self.optimizer.state.values():
            if "step" in st:
                st["step"] = st["step"].to(
                    dtype=torch.float32,
                    device=self.device if cuda else "cpu")
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        self._graphs.clear()


class DCRNNEngine(Engine):
    """DCRNN's seq2seq train step (:class:`models.dcrnn.DCRNN`, a
    :class:`config.DCRNNConfig`) on the engine's machinery: the fused
    steps as CUDA graphs, the clip and Adam (DCRNN's epsilon, 1e-3). The
    loss is the masked MAE of the inverse-scaled outputs over the
    horizon; in training the standardized labels go to the decoder,
    each step's curriculum coins drawn on the device from the engine's
    generator against the threshold of the global step, a device tensor
    that the step increments (:meth:`set_global_step` sets it). Predictions
    take the Graph WaveNet engine's (B, 1, N, horizon) layout, so the
    runner's loops and test run unchanged. One process: no mesh."""

    def __init__(self, model_cfg: DCRNNConfig, train_cfg: TrainConfig,
                 scaler: StandardScaler | None, *,
                 device: torch.device | str = "cuda",
                 seed: int | None = None, steps_per_epoch: int = 0,
                 mesh=None):
        if mesh is not None:
            raise ValueError("DCRNN trains in one process: no mesh")
        super().__init__(model_cfg, train_cfg, scaler, device=device,
                         seed=seed, steps_per_epoch=steps_per_epoch,
                         adam_eps=1e-3)
        self._global = torch.zeros((), dtype=torch.int64,
                                   device=self.device)

    def _make_model(self, model_cfg, seed: int, aptinit) -> torch.nn.Module:
        return dcrnn.DCRNN(model_cfg, device=self.device, seed=seed)

    def set_global_step(self, step: int) -> None:
        """The optimizer step count and the curriculum's global step."""
        self.step = int(step)
        self._global.fill_(self.step)

    def _teacher(self) -> torch.Tensor:
        """The step's coins: decoder input t + 1 is the label where True."""
        cfg = self.model_cfg
        coins = torch.rand((cfg.horizon - 1,), generator=self.generator,
                           device=self.device)
        return coins < dcrnn.curriculum_threshold(self._global,
                                                  cfg.cl_decay_steps)

    def _predict(self, x: torch.Tensor, y: torch.Tensor | None,
                 supports) -> torch.Tensor:
        """(B, 1, N, horizon) fp32 in raw units; in train mode the
        decoder takes the labels of ``y`` under the coins."""
        labels = teacher = None
        if self.model.training:
            k = self.model_cfg.output_dim
            labels = self.scaler.transform(y[..., :k])
            teacher = self._teacher()
        out = self.model(x, supports, labels=labels, teacher=teacher)
        return out[..., 0].permute(0, 2, 1)[:, None] * self.scaler.std \
            + self.scaler.mean

    def _loss(self, x: torch.Tensor, y: torch.Tensor, supports):
        mae, mape, mse = masked_terms(self._predict(x, y, supports),
                                      horizon_target(y), 0.0)
        with torch.no_grad():
            return mae, global_terms(mae, mape, mse)

    def _train_core(self, x: torch.Tensor, y: torch.Tensor,
                    supports) -> torch.Tensor:
        m = super()._train_core(x, y, supports)
        self._global.add_(1)
        return m

    def train_steps_resident(self, xs: torch.Tensor, ys: torch.Tensor, idx,
                             supports) -> dict:
        """:meth:`Engine.train_steps_resident`; on the card a call that
        captures the step graph runs inside the span ``dcrnn.capture``
        (``train.profiling``), and every call sets
        ``models.dcrnn.COUNTS["step_launches"]`` to what a replay of the
        graph launches."""
        capture = (self.device.type == "cuda"
                   and not any(k[0] == "train" for k in self._graphs))
        with (profiling.span("dcrnn.capture") if capture
              else contextlib.nullcontext()):
            out = super().train_steps_resident(xs, ys, idx, supports)
        for key, g in self._graphs.items():
            if key[0] == "train":
                dcrnn.COUNTS["step_launches"] = dict(g.launches)
        return out

    @torch.no_grad()
    def predict_step(self, x, supports) -> torch.Tensor:
        """Standardized forecasts (B, 1, N, horizon), the decoder feeding
        back its own outputs."""
        self.model.eval()
        out = self.model(self._tensor(x), supports)
        return out[..., 0].permute(0, 2, 1)[:, None]

    def load_train_state(self, state: dict) -> None:
        super().load_train_state(state)
        self._global.fill_(self.step)
