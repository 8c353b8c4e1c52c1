"""Training engine: one module, one optimizer, and the real-data steps.

Counterpart of ``graph_wavenet_tpu/train/engine.py`` (``make_optimizer``,
``horizon_target``, ``Engine`` with ``train_step``, ``eval_step`` and
``predict_step``), which reproduces the reference trainer: masked MAE with
``null_val`` 0.0 on inverse-standardized predictions, global-norm gradient
clipping, Adam with L2 weight decay. The optimizer chain is the same as the
reference package's optax one: ``clip_grad_norm_`` first, then Adam's
weight decay adds ``wd * p`` to the clipped gradient, then the Adam moments
(``eps`` 1e-8). The one difference is ``clip_grad_norm_``'s ``+1e-6`` in
the clip factor against optax's exact clip.

PyTorch's idiom: a step updates the module and the optimizer in place and
returns its metrics as device tensors, which the caller syncs. The
gradient-accumulation and fused multi-step variants wait (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models.gwnet import GWNet
from graph_wavenet_tpu_torch.train.metrics import (
    masked_mae,
    masked_mape,
    masked_rmse,
)


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


class Engine:
    """The model, its optimizer and the dropout generator, on ``device``.
    ``seed`` (default ``train_cfg.seed``) draws the weights and seeds the
    dropout stream; ``steps_per_epoch`` converts the step decay's epochs to
    optimizer steps."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 scaler: StandardScaler | None, *,
                 device: torch.device | str = "cuda",
                 seed: int | None = None, steps_per_epoch: int = 0):
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
        self.model = GWNet(model_cfg, device=self.device, seed=seed)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=train_cfg.learning_rate,
            weight_decay=train_cfg.weight_decay, eps=1e-8)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _forward(self, x: torch.Tensor, supports) -> torch.Tensor:
        # the engine left-pads the input by one step, as the reference's
        x = F.pad(x, (0, 0, 0, 0, 1, 0))
        out = self.model(x, supports, generator=self.generator)
        return out * self.scaler.std + self.scaler.mean

    @staticmethod
    def _metrics(loss, predict, real) -> dict:
        return {"loss": loss, "mape": masked_mape(predict, real, 0.0),
                "rmse": masked_rmse(predict, real, 0.0)}

    def train_step(self, x, y, supports) -> dict:
        """One optimizer step on a batch: x (B, T, N, in_dim) standardized,
        y (B, H, N, F) raw units. Returns loss, MAPE and RMSE as device
        scalars."""
        self.model.train()
        predict = self._forward(self._tensor(x), supports)
        real = horizon_target(self._tensor(y))
        loss = masked_mae(predict, real, 0.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(self.model.parameters(),
                                       self.train_cfg.grad_clip)
        lr = learning_rate(self.train_cfg, self.step, self.steps_per_epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            return self._metrics(loss.detach(), predict.detach(), real)

    @torch.no_grad()
    def eval_step(self, x, y, supports) -> dict:
        """Loss, MAPE and RMSE of a batch in eval mode (engine pad kept)."""
        self.model.eval()
        predict = self._forward(self._tensor(x), supports)
        real = horizon_target(self._tensor(y))
        return self._metrics(masked_mae(predict, real, 0.0), predict, real)

    @torch.no_grad()
    def predict_step(self, x, supports) -> torch.Tensor:
        """The raw (standardized) forward for the per-horizon test loop.
        Like the reference's test loop it runs the model with no engine-level
        pad: the model's own receptive-field pad covers the missing step."""
        self.model.eval()
        return self.model(self._tensor(x), supports)

    def train_state(self) -> dict:
        """What a checkpoint needs to continue: optimizer, step count and
        the dropout generator's state."""
        return {"optimizer": self.optimizer.state_dict(), "step": self.step,
                "generator": self.generator.get_state()}
