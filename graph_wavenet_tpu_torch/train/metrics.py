"""Masked regression metrics.

Counterpart of ``graph_wavenet_tpu/train/metrics.py``, with the reference
metrics' quirks kept: the mask is ``labels != null_val`` (or non-NaN when
``null_val`` is NaN), normalized by its own mean, with NaNs zeroed both in
the mask and in the masked loss; MAPE divides by the raw labels with no
epsilon and relies on the zero mask to remove the infinities.
"""

from __future__ import annotations

import math

import torch


def _mask(labels: torch.Tensor, null_val: float) -> torch.Tensor:
    if math.isnan(null_val):
        mask = ~torch.isnan(labels)
    else:
        mask = labels != null_val
    mask = mask.float()
    mask = mask / mask.mean()
    return torch.where(torch.isnan(mask), torch.zeros_like(mask), mask)


def _masked_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    loss = loss * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return loss.mean()


def masked_mse(preds, labels, null_val: float = float("nan")):
    return _masked_mean((preds - labels) ** 2, _mask(labels, null_val))


def masked_rmse(preds, labels, null_val: float = float("nan")):
    return torch.sqrt(masked_mse(preds, labels, null_val))


def masked_mae(preds, labels, null_val: float = float("nan")):
    return _masked_mean(torch.abs(preds - labels), _mask(labels, null_val))


def masked_mape(preds, labels, null_val: float = float("nan")):
    return _masked_mean(torch.abs(preds - labels) / labels,
                        _mask(labels, null_val))


def metric(pred, real) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(MAE, MAPE, RMSE) with null_val 0.0, as the reference test loops
    compute them; tensors on the inputs' device."""
    return (masked_mae(pred, real, 0.0), masked_mape(pred, real, 0.0),
            masked_rmse(pred, real, 0.0))
