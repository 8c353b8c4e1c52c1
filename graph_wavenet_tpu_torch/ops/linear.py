"""Channel-wise dense ("1x1 conv") op on channels-last activations.

Counterpart of ``graph_wavenet_tpu/ops/linear.py``. Parameters keep the
reference's ``nn.Conv2d`` shapes (``weight (out, in, 1, 1)``, ``bias
(out,)``) so state dicts carry the reference names. The math is the JAX
package's: the weight is cast to the activation dtype, the contraction
accumulates in fp32, the fp32 bias is added, and the result is cast back
once.
"""

from __future__ import annotations

import torch
from torch import nn


def conv_uniform_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place: torch's Conv2d default
    for both weight (kaiming_uniform with a=sqrt(5)) and bias."""
    bound = 1.0 / (fan_in ** 0.5)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def channel_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., C) @ w (C, F) with w cast to x's dtype and fp32 accumulation;
    returns fp32."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


class Linear(nn.Module):
    """y[..., f] = sum_c x[..., c] w[f, c] + b[f] over the last axis."""

    def __init__(self, c_in: int, c_out: int, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(c_out, c_in, 1, 1, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(c_out, device=device,
                                             dtype=dtype))
        conv_uniform_(self.weight, c_in, generator)
        conv_uniform_(self.bias, c_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, :, 0, 0].t()
        return (channel_matmul(x, w) + self.bias.float()).to(x.dtype)
