"""Batch normalization over channels-last ``(B, T, N, C)``.

Counterpart of ``graph_wavenet_tpu/ops/normalization.py`` with the
reference ``nn.BatchNorm2d`` state-dict names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``). Statistics
and normalization run in fp32 and return the input dtype. In train mode
the batch statistics over (B, T, N) normalize (biased variance) and update
the running statistics in place (unbiased variance, momentum 0.1), which
keep their dtype; in eval mode the running statistics normalize.
``t_valid`` restricts the batch statistics to the last ``t_valid`` time
steps (JAX ``batch_norm_apply(t_valid=)``), for stacks whose leading steps
are garbage: the other steps are replaced by the mean with a select, so
no garbage reaches a sum (forward or backward) and the output there is
the bias; without it the plain branch runs.

Under a process group (``parallel``: DP and node-TP) the batch statistics
are those of the whole batch across the ranks, as GSPMD keeps them in the
JAX package: the mean is the sum over every rank's (B, T, N) divided by
the global count, then the biased variance the same way over the squared
deviations, each sum a differentiable all-reduce (whose backward is a sum
all-reduce of the cotangent); the running statistics unbias with the
global count, so every rank tracks the same values. One process computes
the same sums and divisions with no collective. Under time-halo sequence
parallelism a rank's block holds part of the valid steps, or none:
``t_valid`` is its share, and ``count`` the global number of (B, T, N)
positions the statistics cover. Under node-TP over uneven node ranges the
ranks' shares differ too, so the model always passes ``count``.

:meth:`BatchNorm.tail` normalizes a layer's tail, ``h * drop + residual``
before the normalization. bf16 activations on a CUDA device with
statistics over every step take the layer-tail kernel
(``ops.cuda.bn_tail``): the multiply, the add and the statistics in one
pass, the normalize in another, and two passes backward, the sums in fp32
as here and all-reduced over the group between the launches. Every other
dtype and device, and ``t_valid``, keep the chain of PyTorch ops below.
"""

from __future__ import annotations

import torch
from torch import nn

from graph_wavenet_tpu_torch.ops.cuda import bn_tail
from graph_wavenet_tpu_torch.ops.linear import takes_kernel
from graph_wavenet_tpu_torch.parallel.collectives import all_sum, group_size


MOMENTUM = 0.1


def takes_tail_kernel(h: torch.Tensor, t_valid: int | None) -> bool:
    """Whether a tail over ``h`` runs the layer-tail kernel: bf16 on a CUDA
    device (:func:`ops.linear.takes_kernel`) with statistics over every
    step (time-halo sequence parallelism's ``t_valid`` keeps the chain)."""
    return takes_kernel(h) and t_valid is None


class BatchNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5, *,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_mean",
                             torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_var",
                             torch.ones(c, device=device, dtype=dtype))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), device=device, dtype=torch.long))

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        y, stats = self.normalize(x, group)
        if stats is not None:
            self.track(*stats)
        return y

    def normalize(self, x: torch.Tensor, group=None,
                  t_valid: int | None = None, count: float | None = None):
        """``(y, stats)`` without touching the running statistics: in train
        mode ``stats`` = (batch mean, biased variance, count) for
        :meth:`track`, in eval mode None. The model's rematerialized layers
        call this, so a recomputation does not count a batch twice.
        ``group``: the process group whose ranks hold the rest of the
        batch, or None; ``t_valid``: take the statistics over the last
        ``t_valid`` steps of axis 1 only; ``count``: the statistics'
        number of positions over the group (default: every rank's share
        equal to this one's, which uneven node ranges break)."""
        return self.tail(x, group=group, t_valid=t_valid, count=count)

    def tail(self, h: torch.Tensor, residual: torch.Tensor | None = None,
             drop: torch.Tensor | None = None, group=None,
             t_valid: int | None = None, count: float | None = None):
        """:meth:`normalize` of a layer's tail ``x = h * drop +
        residual[:, -T:]`` (each step in h's dtype; ``drop`` and
        ``residual`` may be None). Where :func:`takes_tail_kernel` holds the
        tail runs on the layer-tail kernel (``ops.cuda.bn_tail``), else as
        the chain of PyTorch ops."""
        if takes_tail_kernel(h, t_valid):
            running = None
            if not self.training:
                running = (self.running_mean.float(),
                           self.running_var.float())
            return bn_tail.tail(h, drop, residual, self.weight, self.bias,
                                self.eps, group, count, running)
        x = h if drop is None else h * drop
        if residual is not None:
            x = x + residual[:, -x.shape[1]:]
        return self._chain(x, group, t_valid, count)

    def _chain(self, x: torch.Tensor, group, t_valid: int | None,
               count: float | None):
        xf = x.float()
        stats = None
        if self.training:
            dims = tuple(range(x.ndim - 1))
            per_step = x.numel() // (x.shape[-1] * x.shape[1])
            if count is None:
                steps = x.shape[1] if t_valid is None else t_valid
                count = per_step * steps * group_size(group)
            n = float(count)
            if t_valid is None:
                mean = all_sum(xf.sum(dim=dims), group) / n
                var = all_sum(((xf - mean) ** 2).sum(dim=dims), group) / n
            else:
                # the left-out steps become the mean: they add nothing to
                # the sums, forward or backward, whatever they held
                t = x.shape[1]
                keep = (torch.arange(t, device=x.device) >= t - t_valid
                        ).view(1, t, *([1] * (x.ndim - 2)))
                mean = all_sum(torch.where(keep, xf, 0.0).sum(dim=dims),
                               group) / n
                xf = torch.where(keep, xf, mean)
                var = all_sum(((xf - mean) ** 2).sum(dim=dims), group) / n
            stats = (mean.detach(), var.detach(), n)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean) * inv * self.weight.float() + self.bias.float()
        return y.to(x.dtype), stats

    @torch.no_grad()
    def track(self, mean: torch.Tensor, var: torch.Tensor, n: float) -> None:
        """Fold one batch's statistics into the running ones (unbiased
        variance, momentum 0.1)."""
        m = MOMENTUM
        unbiased = var * (n / max(n - 1.0, 1.0))
        self.running_mean.copy_((1 - m) * self.running_mean.float()
                                + m * mean)
        self.running_var.copy_((1 - m) * self.running_var.float()
                               + m * unbiased)
        self.num_batches_tracked += 1
