"""Batch normalization over channels-last ``(B, T, N, C)``.

Counterpart of ``graph_wavenet_tpu/ops/normalization.py`` with the
reference ``nn.BatchNorm2d`` state-dict names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``). Statistics
and normalization run in fp32 and return the input dtype. In train mode
the batch statistics over (B, T, N) normalize (biased variance) and update
the running statistics in place (unbiased variance, momentum 0.1), which
keep their dtype; in eval mode the running statistics normalize. The
reference's ``t_valid`` restriction waits for the pipeline slice.
"""

from __future__ import annotations

import torch
from torch import nn


MOMENTUM = 0.1


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dim=dims)
            var = ((xf - mean) ** 2).mean(dim=dims)        # biased
            n = float(x.numel() // x.shape[-1])
            with torch.no_grad():
                m = MOMENTUM
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_mean.copy_(
                    (1 - m) * self.running_mean.float() + m * mean)
                self.running_var.copy_(
                    (1 - m) * self.running_var.float() + m * unbiased)
                self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps)
        y = (xf - mean) * inv * self.weight.float() + self.bias.float()
        return y.to(x.dtype)
