"""Gated dilated causal temporal convolution on ``(B, T, N, C)``.

Counterpart of ``graph_wavenet_tpu/ops/temporal.py``. Weights keep the
reference's Conv2d shape ``(out, in, 1, k)``; tap ``i`` multiplies
``x[:, t + i*dilation]`` (cross-correlation), so a (1, k) valid conv is k
shifted channel matmuls, summed in fp32 in tap order, plus the fp32 bias,
cast once. The filter and gate convs run packed as one double-width conv.
bf16 activations on a CUDA device run every tap in one launch of the
projection kernel (``ops.linear.project``), reading the taps in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from graph_wavenet_tpu_torch.ops.linear import conv_uniform_, project


class CausalConv(nn.Module):
    """Parameters of one (1, k) dilated conv: ``weight (out, in, 1, k)``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            c_out, c_in, 1, kernel_size, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(c_out, device=device,
                                             dtype=dtype))
        fan_in = c_in * kernel_size
        conv_uniform_(self.weight, fan_in, generator)
        conv_uniform_(self.bias, fan_in, generator)


def causal_conv_apply(weight: torch.Tensor, bias: torch.Tensor,
                      x: torch.Tensor, dilation: int) -> torch.Tensor:
    """Valid dilated conv over the time axis of ``(B, T, N, C)``; output
    length ``T - dilation*(k-1)``, right-aligned to the input."""
    k = weight.shape[-1]
    t_out = x.shape[1] - dilation * (k - 1)
    # (k*in, out), tap-major rows: tap i's block multiplies x's slice i
    taps = weight[:, :, 0, :].permute(2, 1, 0).reshape(-1, weight.shape[0])
    return project([x[:, i * dilation:i * dilation + t_out]
                    for i in range(k)], taps.t(), bias)


def gated_tcn_apply(filter_conv: CausalConv, gate_conv: CausalConv,
                    x: torch.Tensor, dilation: int) -> torch.Tensor:
    """tanh(filter) * sigmoid(gate), both convs run as one packed conv."""
    f = filter_conv.weight.shape[0]
    w = torch.cat([filter_conv.weight, gate_conv.weight], dim=0)
    b = torch.cat([filter_conv.bias, gate_conv.bias])
    fg = causal_conv_apply(w, b, x, dilation)
    return torch.tanh(fg[..., :f]) * torch.sigmoid(fg[..., f:])


def left_pad_time(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Zero-pad the time axis (dim 1) on the left up to ``target_len``."""
    t = x.shape[1]
    if t >= target_len:
        return x
    # F.pad pads trailing dims first: (C, N, T) pairs for (B, T, N, C)
    return F.pad(x, (0, 0, 0, 0, target_len - t, 0))
