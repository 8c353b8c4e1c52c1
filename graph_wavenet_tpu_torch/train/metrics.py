"""Masked regression metrics.

Counterpart of ``graph_wavenet_tpu/train/metrics.py``, with the reference
metrics' quirks kept: the mask is ``labels != null_val`` (or non-NaN when
``null_val`` is NaN), normalized by its own mean, with NaNs zeroed both in
the mask and in the masked loss; MAPE divides by the raw labels with no
epsilon and relies on the zero mask to remove the infinities. A mean is
the sum over the count.

Under a process group (``group``: the ranks that hold the rest of the
predictions, DP and node-TP) the mask's mean and the count are the global
ones, so each rank's value is its *part*: its local numerator over the
global denominator, and the ranks' parts sum to the single-process value.
A rank back-propagates its part of the loss (the parts are distinct terms
of one sum), never a replicated global loss, which autograd through an
all-reduce would count once per rank. :func:`global_terms` sums the parts
for reporting, RMSE the square root of the global masked MSE. Under
time-halo sequence parallelism every rank of a time group holds the same
labels but only the last one the predictions (``holds``): the others'
masks and counts are zero, so their parts are exact zeros.
"""

from __future__ import annotations

import math

import torch

from graph_wavenet_tpu_torch.parallel.collectives import all_reduce_


def _mask(labels: torch.Tensor, null_val: float, group=None,
          holds: bool = True):
    """(mask normalized by its global mean, the global count); a rank that
    does not hold the predictions counts nothing."""
    if math.isnan(null_val):
        mask = ~torch.isnan(labels)
    else:
        mask = labels != null_val
    mask = mask.float()
    if not holds:
        mask = torch.zeros_like(mask)
    # the count filled on the device: no host copy, so a CUDA graph can
    # capture the step
    stats = torch.stack([mask.sum(), mask.new_full(
        (), float(mask.numel()) if holds else 0.0)])
    total, count = all_reduce_(stats, group)
    mask = mask / (total / count)
    return torch.where(torch.isnan(mask), torch.zeros_like(mask), mask), count


def _masked_mean(loss: torch.Tensor, mask: torch.Tensor,
                 count: torch.Tensor) -> torch.Tensor:
    """The masked loss's sum over its global element count: the labels'
    ``count`` times the broadcast of the loss over them (predictions with
    more time steps than the target, as the reference allows)."""
    loss = loss * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return loss.sum() / (count * (loss.numel() / mask.numel()))


def masked_terms(preds, labels, null_val: float = 0.0, group=None,
                 holds: bool = True):
    """This rank's parts of (MAE, MAPE, MSE) under one mask (one
    all-reduce for the mask's statistics). ``holds``: False on a rank
    whose ``preds`` are not predictions (time SP), whose parts are then
    zeros with a zero gradient."""
    if not holds:
        # a select, not a product: the garbage may not be finite
        preds = torch.where(torch.zeros((), dtype=torch.bool,
                                        device=preds.device), preds, 0.0)
    mask, count = _mask(labels, null_val, group, holds)
    err = preds - labels
    return (_masked_mean(torch.abs(err), mask, count),
            _masked_mean(torch.abs(err) / labels, mask, count),
            _masked_mean(err ** 2, mask, count))


def masked_mse(preds, labels, null_val: float = float("nan")):
    return masked_terms(preds, labels, null_val)[2]


def masked_rmse(preds, labels, null_val: float = float("nan")):
    return torch.sqrt(masked_mse(preds, labels, null_val))


def masked_mae(preds, labels, null_val: float = float("nan")):
    return masked_terms(preds, labels, null_val)[0]


def masked_mape(preds, labels, null_val: float = float("nan")):
    return masked_terms(preds, labels, null_val)[1]


def batch_time_l1(yhat, y) -> torch.Tensor:
    """The mean absolute error over every element, flattened (the
    reference ``miscTools``' batch-time L1)."""
    return torch.mean(torch.abs(yhat.reshape(-1) - y.reshape(-1)))


def batch_time_mse(yhat, y) -> torch.Tensor:
    """The mean over columns of ``||yhat - y|| / ||y||``: every axis but the
    last two flattened into rows, the last two (N * F) kept as columns, as
    the reference flattens ``x.view(-1, N*F)``; for (B, T, N, F) inputs the
    norm runs over batch x time per (node, feature) column."""
    cols = yhat.shape[-1] * yhat.shape[-2]
    diff = (yhat - y).reshape(-1, cols)
    return torch.mean(torch.linalg.vector_norm(diff, dim=0)
                      / torch.linalg.vector_norm(y.reshape(-1, cols), dim=0))


def global_terms(mae, mape, mse, group=None) -> torch.Tensor:
    """(3,) global (MAE, MAPE, RMSE) from every rank's parts, detached."""
    parts = all_reduce_(torch.stack([mae, mape, mse]).detach(), group)
    return torch.stack([parts[0], parts[1], torch.sqrt(parts[2])])


def metric(pred, real, group=None, holds: bool = True
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(MAE, MAPE, RMSE) with null_val 0.0, as the reference test loops
    compute them, over every rank of ``group`` that ``holds`` its
    predictions; tensors on the inputs' device."""
    return tuple(global_terms(*masked_terms(pred, real, 0.0, group, holds),
                              group))
