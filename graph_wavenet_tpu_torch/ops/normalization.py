"""Batch normalization over channels-last ``(B, T, N, C)``, eval mode.

Counterpart of ``graph_wavenet_tpu/ops/normalization.py`` with the
reference ``nn.BatchNorm2d`` state-dict names (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``). Normalization
runs in fp32 from the running statistics and returns the input dtype.
Batch statistics (train mode) arrive with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


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
        if self.training:
            raise NotImplementedError(
                "BatchNorm batch statistics (train mode) are not ported yet; "
                "they come with the training slice (ROADMAP.md). Call "
                "model.eval()")
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        y = ((x.float() - self.running_mean.float()) * inv
             * self.weight.float() + self.bias.float())
        return y.to(x.dtype)
