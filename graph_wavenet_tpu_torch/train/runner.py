"""Experiment runner: the epoch loop, a checkpoint per epoch, the best
model, and the per-horizon test.

Counterpart of ``graph_wavenet_tpu/train/runner.py``'s ``Runner.fit`` and
``Runner.test`` for shared-graph datasets, trimmed: every epoch shuffles
the training split, runs the train steps (logging every ``print_every``),
runs the validation pass, appends a line to ``save_dir/history.jsonl`` and
saves a checkpoint; after the last epoch the best-validation weights are
reloaded and the test scores them per horizon on the real (unpadded) test
samples. Step metrics stay on the device until the end of the epoch. The
watchdog, early stop, resume, best-k pruning, asynchronous checkpoints,
``scan_steps``, ``grad_accum`` and meshes wait (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from graph_wavenet_tpu_torch.config import TrainConfig
from graph_wavenet_tpu_torch.train import checkpoint as ckpt
from graph_wavenet_tpu_torch.train.engine import Engine
from graph_wavenet_tpu_torch.train.metrics import metric


def _epoch_mean(steps: list[dict]) -> dict:
    """Mean of each metric over a list of step-metric dicts, with one
    device sync."""
    if not steps:
        return {}
    stacked = {k: torch.stack([s[k] for s in steps]).cpu().tolist()
               for k in steps[0]}
    return {k: float(np.mean(v)) for k, v in stacked.items()}


@dataclass
class EpochLog:
    epoch: int
    train: dict
    valid: dict
    train_time: float
    valid_time: float


@dataclass
class RunResult:
    history: list[EpochLog] = field(default_factory=list)
    best_epoch: int = -1
    best_val_loss: float = float("inf")
    best_checkpoint: str = ""
    test_metrics: dict = field(default_factory=dict)
    per_horizon: list[tuple[float, float, float]] = field(
        default_factory=list)


def _print_flush(*args, **kwargs):
    print(*args, flush=True, **kwargs)


class Runner:
    """Drives an :class:`Engine` over a dataset dict of
    :func:`data.metr.load_dataset`. ``extra_meta``: JSON records merged
    into every checkpoint sidecar's ``extra`` (the city node layout)."""

    def __init__(self, engine: Engine, train_cfg: TrainConfig,
                 log_fn=_print_flush, extra_meta: dict | None = None):
        self.engine = engine
        self.cfg = train_cfg
        self.log = log_fn
        self.extra_meta = extra_meta or {}

    def fit(self, data: dict, supports) -> RunResult:
        result = RunResult()
        engine = self.engine
        self._append_history({"run_start": time.time(), "start_epoch": 1,
                              "resumed_from": None})
        for epoch in range(1, self.cfg.epochs + 1):
            t1 = time.time()
            loader = data["train_loader"]
            loader.shuffle()
            steps = []
            for it, (x, y) in enumerate(loader.get_iterator()):
                m = engine.train_step(x, y, supports)
                steps.append(m)
                if it % self.cfg.print_every == 0:
                    mm = _epoch_mean([m])
                    self.log(f"Iter: {it:03d}, Train Loss: {mm['loss']:.4f}, "
                             f"Train MAPE: {mm['mape']:.4f}, Train RMSE: "
                             f"{mm['rmse']:.4f}")
            train_m = _epoch_mean(steps)
            t2 = time.time()
            vsteps = [engine.eval_step(x, y, supports)
                      for x, y in data["val_loader"].get_iterator()]
            valid_m = _epoch_mean(vsteps)
            log = EpochLog(epoch, train_m, valid_m, t2 - t1,
                           time.time() - t2)
            result.history.append(log)
            self._append_history({
                "epoch": epoch, "train": train_m, "valid": valid_m,
                "train_time_s": log.train_time,
                "valid_time_s": log.valid_time, "ts": time.time()})
            self.log(f"Epoch: {epoch:03d}, Train Loss: {train_m['loss']:.4f}, "
                     f"Valid Loss: {valid_m['loss']:.4f}, Training Time: "
                     f"{log.train_time:.4f}/epoch")
            self._save_epoch(epoch, valid_m["loss"], result)
        if result.best_checkpoint:
            engine.model.load_state_dict(ckpt.load_state_dict(
                result.best_checkpoint, device=engine.device))
            self.log(f"The valid loss on best model is "
                     f"{result.best_val_loss:.4f}")
        return result

    def test(self, data: dict, supports, result: RunResult | None = None,
             return_predictions: bool = False) -> RunResult:
        """Per-horizon test: predictions are truncated to the real test
        count, inverse-transformed by the engine's scaler and scored per
        horizon step. ``return_predictions``: also keep the standardized
        predictions (n, N, H) as ``test_metrics["yhat"]``, a numpy array."""
        result = result or RunResult()
        engine = self.engine
        outputs = [engine.predict_step(x, supports)[:, 0]     # (B, N, H)
                   for x, _ in data["test_loader"].get_iterator()]
        realy = torch.as_tensor(np.transpose(data["y_test"][..., 0],
                                             (0, 2, 1)), device=engine.device)
        yhat = torch.cat(outputs)[:realy.shape[0]]
        per_h = []
        for h in range(yhat.shape[-1]):
            pred = engine.scaler.inverse_transform(yhat[:, :, h])
            scores = torch.stack(metric(pred, realy[:, :, h])).cpu().tolist()
            per_h.append(tuple(scores))
            self.log(f"Evaluate best model on test data for horizon "
                     f"{h + 1:d}, Test MAE: {scores[0]:.4f}, Test MAPE: "
                     f"{scores[1]:.4f}, Test RMSE: {scores[2]:.4f}")
        result.per_horizon = per_h
        result.test_metrics = {
            name: float(np.mean([m[i] for m in per_h]))
            for i, name in enumerate(("mae", "mape", "rmse"))}
        if return_predictions:
            result.test_metrics["yhat"] = yhat.cpu().numpy()
        self.log("On average over seq_length horizons, Test MAE: "
                 f"{result.test_metrics['mae']:.4f}, Test MAPE: "
                 f"{result.test_metrics['mape']:.4f}, Test RMSE: "
                 f"{result.test_metrics['rmse']:.4f}")
        return result

    def _append_history(self, rec: dict) -> None:
        os.makedirs(self.cfg.save_dir, exist_ok=True)
        with open(os.path.join(self.cfg.save_dir, "history.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _save_epoch(self, epoch: int, val_loss: float,
                    result: RunResult) -> None:
        engine = self.engine
        path = os.path.join(
            self.cfg.save_dir,
            f"exp{self.cfg.expid}_epoch_{epoch}_{round(val_loss, 2)}.pt")
        ckpt.save_checkpoint(
            path, engine.model.state_dict(), model_cfg=engine.model_cfg,
            train_cfg=self.cfg, scaler=engine.scaler,
            extra={"epoch": epoch, "val_loss": val_loss, **self.extra_meta},
            train_state=engine.train_state())
        if val_loss < result.best_val_loss:
            result.best_val_loss = val_loss
            result.best_epoch = epoch
            result.best_checkpoint = path
