"""Training engine: one module, one optimizer, and the real-data steps.

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

PyTorch's idiom: a step updates the module and the optimizer in place and
returns its metrics as device tensors, which the caller syncs. On a CUDA
device Adam is ``capturable`` (its step count and bias correction live in
device tensors) and the learning rate is a 0-dim device tensor filled
before every step, for every step, eager or not: the fused steps run one
captured step as a CUDA graph (``train.step_graph``), and the two Adam
paths differ in the last bits. On the CPU Adam keeps its host scalars and
a fused call is the eager loop of the same step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data.device_loader import (
    gather_window_rows,
    gather_xy_windows,
)
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models.gwnet import GWNet
from graph_wavenet_tpu_torch.train import step_graph
from graph_wavenet_tpu_torch.train.metrics import (
    masked_mae,
    masked_mape,
    masked_rmse,
)

__all__ = ["Engine", "gather_window_rows", "horizon_target",
           "learning_rate"]

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


def _as_dict(m: torch.Tensor) -> dict:
    """(..., 3) stacked metrics -> {"loss", "mape", "rmse"}."""
    return {k: m[..., i] for i, k in enumerate(METRICS)}


class Engine:
    """The model, its optimizer and the dropout generator, on ``device``.
    ``seed`` (default ``train_cfg.seed``) draws the weights and seeds the
    dropout stream; ``steps_per_epoch`` converts the step decay's epochs to
    optimizer steps; ``aptinit``: the adjacency whose SVD initializes the
    adaptive embeddings (:class:`models.gwnet.GWNet`)."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 scaler: StandardScaler | None, *,
                 device: torch.device | str = "cuda",
                 seed: int | None = None, steps_per_epoch: int = 0,
                 aptinit=None):
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
        self.model = GWNet(model_cfg, device=self.device, seed=seed,
                           aptinit=aptinit)
        cuda = self.device.type == "cuda"
        # on the card: one learning-rate tensor for the life of the engine
        # (a captured step reads it by address) and capturable Adam
        self._lr = (torch.full((), train_cfg.learning_rate,
                               dtype=torch.float32, device=self.device)
                    if cuda else None)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(),
            lr=self._lr if cuda else train_cfg.learning_rate,
            weight_decay=train_cfg.weight_decay, eps=1e-8, capturable=cuda)
        # eager steps are capturable on purpose (see the module docstring):
        # silence the optimizer's one-time advice against it
        self.optimizer._warned_capturable_if_run_uncaptured = True
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        # captured steps by their inputs (train.step_graph), and the stream
        # they are warmed up and captured on
        self._graphs: dict = {}
        self._stream = torch.cuda.Stream(self.device) if cuda else None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _forward(self, x: torch.Tensor, supports) -> torch.Tensor:
        # the engine left-pads the input by one step, as the reference's
        x = F.pad(x, (0, 0, 0, 0, 1, 0))
        out = self.model(x, supports, generator=self.generator)
        return out * self.scaler.std + self.scaler.mean

    @staticmethod
    def _metrics(loss, predict, real) -> torch.Tensor:
        return torch.stack([loss, masked_mape(predict, real, 0.0),
                            masked_rmse(predict, real, 0.0)])

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
        predict = self._forward(x, supports)
        real = horizon_target(y)
        return masked_mae(predict, real, 0.0), predict, real

    def _update(self) -> None:
        torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                       self.train_cfg.grad_clip)
        self.optimizer.step()

    def _train_core(self, x: torch.Tensor, y: torch.Tensor,
                    supports) -> torch.Tensor:
        """Forward, backward, clip and Adam on one batch; the learning rate
        is set beforehand. Returns the stacked metrics (3,). No host sync,
        so a CUDA graph can capture it."""
        self.model.train()
        loss, predict, real = self._loss(x, y, supports)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._update()
        with torch.no_grad():
            return self._metrics(loss.detach(), predict.detach(), real)

    @torch.no_grad()
    def _eval_core(self, x: torch.Tensor, y: torch.Tensor,
                   supports) -> torch.Tensor:
        self.model.eval()
        predict = self._forward(x, supports)
        real = horizon_target(y)
        return self._metrics(masked_mae(predict, real, 0.0), predict, real)

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
        x, y = self._tensor(x), self._tensor(y)
        if n_micro < 1 or x.shape[0] % n_micro:
            raise ValueError(f"batch {x.shape[0]} must divide by "
                             f"n_micro={n_micro}")
        mb = x.shape[0] // n_micro
        self._set_lr()
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        buffers = list(self.model.buffers())
        start = [b.clone() for b in buffers]
        ms = []
        for i in range(n_micro):
            if i:
                # every micro-batch updates the running statistics from
                # the step's starting values: the last update is kept
                for b, b0 in zip(buffers, start):
                    b.copy_(b0)
            loss, predict, real = self._loss(x[i * mb:(i + 1) * mb],
                                             y[i * mb:(i + 1) * mb], supports)
            loss.backward()
            with torch.no_grad():
                ms.append(self._metrics(loss.detach(), predict.detach(),
                                        real))
        with torch.no_grad():
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.div_(n_micro)
        self._update()
        self.step += 1
        return _as_dict(torch.stack(ms).mean(0))

    def _fused(self, kind: str, gather, key: tuple, idx, supports) -> dict:
        """S steps of ``kind`` ("train" or "eval") over the rows of ``idx``
        (S, B): on the card through a :class:`step_graph.StepGraph`, on the
        CPU as the eager loop. ``gather(sel)`` -> the batch (x, y); ``key``:
        the resident inputs it reads and its static arguments."""
        idx = torch.as_tensor(idx, device=self.device).to(torch.int32)
        if idx.ndim != 2:
            raise ValueError(f"idx must be (S, B), got {tuple(idx.shape)}")
        train = kind == "train"
        core = self._train_core if train else self._eval_core

        def body(sel):
            return core(*gather(sel), supports)

        def after():
            self.step += 1

        if self.device.type != "cuda":
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
        keep = key + (None if supports is None else tuple(supports),)
        gkey = (kind, idx.shape[1],
                *(id(k) if torch.is_tensor(k) else k for k in key),
                None if supports is None else tuple(map(id, supports)))
        out = step_graph.run_steps(
            self._graphs, gkey, body, idx, self._stream, keep=keep,
            generator=self.generator if train else None,
            before=self._set_lr if train else None,
            after=after if train else None)
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
        return self._fused("train", *self._arrays(xs, ys), idx, supports)

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
        return self._fused("train", gather, key, anchors, supports)

    def eval_steps_resident(self, xs: torch.Tensor, ys: torch.Tensor, idx,
                            supports) -> dict:
        """Eval metrics of every row of ``idx`` (C, B) over resident
        arrays: (C,) device tensors, one sync for the caller per split."""
        return self._fused("eval", *self._arrays(xs, ys), idx, supports)

    def eval_steps_windows(self, series: torch.Tensor, anchors, window: int,
                           horizon: int, y_start: int, supports,
                           y_series: torch.Tensor | None = None) -> dict:
        """Eval metrics of every row of ``anchors`` (C, B), the windows
        gathered as in :meth:`train_steps_windows`."""
        gather, key = self._windows(series, window, horizon, y_start,
                                    y_series)
        return self._fused("eval", gather, key, anchors, supports)

    @staticmethod
    def _arrays(xs, ys):
        """(gather, inputs) of the resident-array feed."""
        return (lambda sel: (xs.index_select(0, sel), ys.index_select(0, sel)),
                (xs, ys))

    @staticmethod
    def _windows(series, window, horizon, y_start, y_series):
        """(gather, inputs) of the windows-on-demand feed."""
        ys_src = series if y_series is None else y_series
        y_len = horizon - y_start + 1
        return (lambda a: gather_xy_windows(series, ys_src, a, window,
                                            y_start, y_len),
                (series, ys_src, window, horizon, y_start))

    @torch.no_grad()
    def eval_step(self, x, y, supports) -> dict:
        """Loss, MAPE and RMSE of a batch in eval mode (engine pad kept)."""
        return _as_dict(self._eval_core(self._tensor(x), self._tensor(y),
                                        supports))

    @torch.no_grad()
    def predict_step(self, x, supports) -> torch.Tensor:
        """The raw (standardized) forward for the per-horizon test loop.
        Like the reference's test loop it runs the model with no engine-level
        pad: the model's own receptive-field pad covers the missing step."""
        self.model.eval()
        return self.model(self._tensor(x), supports)

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
