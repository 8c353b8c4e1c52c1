"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the weights, and synthetic traffic readings. Both are
drawn on the device from one generator, in a few large calls."""

from __future__ import annotations

import math

import torch

BN_ONES = ("weight", "running_var")


def generator(seed: int, device) -> torch.Generator:
    """The inputs' generator: seeded apart from the program's dropout
    stream, which the seed itself seeds."""
    return torch.Generator(device=device).manual_seed(
        (seed * 6364136223846793005 + 1442695040888963407) % 2 ** 63)


def weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """fp32 weights for the parameter and buffer names in ``shapes``: each
    convolution's weight and bias uniform in +-1/sqrt(fan in) (PyTorch's
    default for the reference's ``nn.Conv2d``), the node embeddings
    standard normal, batch normalization at its initial values."""
    uni, nrm, out = [], [], {}
    for name, shape in shapes.items():
        base = name.rsplit(".", 1)
        if name.startswith("bn."):
            fill = 1.0 if base[-1] in BN_ONES else 0.0
            out[name] = torch.full(shape, fill, device=device)
        elif name.startswith("nodevec"):
            nrm.append((name, shape))
        else:
            w = shapes[base[0] + ".weight"]
            uni.append((name, shape, 1.0 / math.sqrt(math.prod(w[1:]))))
    u = torch.rand(sum(math.prod(s) for _, s, _ in uni), generator=gen,
                   device=device) * 2.0 - 1.0
    z = torch.randn(sum(math.prod(s) for _, s in nrm), generator=gen,
                    device=device)
    at = 0
    for name, shape, bound in uni:
        k = math.prod(shape)
        out[name] = (u[at:at + k] * bound).reshape(shape)
        at += k
    at = 0
    for name, shape in nrm:
        k = math.prod(shape)
        out[name] = z[at:at + k].reshape(shape).clone()
        at += k
    return out


def readings(n_windows: int, nodes: int, seq: int, horizon: int,
             scaler: dict, gen: torch.Generator, device,
             missing: float = 0.02):
    """``n_windows`` windows of speed readings at 5-minute steps: inputs x
    (n, seq, N, 2), standardized speed and time of day, and targets y (n,
    horizon, N, 2) in raw units, a share ``missing`` of the speeds 0 (a
    missing reading, which the loss leaves out). Each node has its own
    free-flow speed and rush-hour congestion; each window starts at its
    own time of day, so windows differ as mornings differ from nights."""
    t = seq + horizon
    v = 55.0 + 15.0 * torch.rand(nodes, generator=gen, device=device)
    c = 10.0 + 30.0 * torch.rand(nodes, generator=gen, device=device)
    shift = 0.02 * torch.randn(nodes, generator=gen, device=device)
    tod0 = torch.rand(n_windows, generator=gen, device=device)
    noise = torch.randn((n_windows, t, nodes), generator=gen, device=device)
    drop = torch.rand((n_windows, horizon, nodes), generator=gen,
                      device=device) < missing
    tod = (tod0[:, None] + torch.arange(t, device=device) / 288.0) % 1.0
    when = tod[:, :, None] + shift
    rush = (torch.exp(-((when - 0.33) / 0.04) ** 2)
            + torch.exp(-((when - 0.73) / 0.05) ** 2))
    speed = (v - c * rush + 3.0 * noise).clamp(min=1.0)
    tod_f = tod[:, :, None].expand(-1, -1, nodes)
    x = torch.stack([(speed[:, :seq] - scaler["mean"]) / scaler["std"],
                     tod_f[:, :seq]], dim=-1)
    ys = torch.where(drop, torch.zeros_like(speed[:, seq:]), speed[:, seq:])
    y = torch.stack([ys, tod_f[:, seq:]], dim=-1)
    return x.contiguous(), y.contiguous()
