"""DCRNN (Li, Yu, Shahabi and Liu, ICLR 2018, arXiv:1707.01926) in plain
float32 PyTorch, written from its released code (github.com/liyaguang/
DCRNN: ``model/dcrnn_cell.py``'s ``_gconv`` and ``DCGRUCell``,
``model/dcrnn_model.py``'s encoder-decoder and curriculum, and
``data/model/dcrnn_la.yaml``): the yardstick the port's
``models/dcrnn.py`` and ``DCRNNEngine`` are held to on the CPU. It imports
neither the port nor JAX; callers switch TF32 off.

Per sample, on z (N, C) and the supports S_1..S_S (a step maps z to
``out[w] = sum_v z[v] P[v, w]``):

    D(z)   = [z, S1 z, 2 S1 S1 z - z, S2 S1 z, 2 S2 S2 S1 z - S1 z]  (order 2)
    [r, u] = sigmoid(D([x_t, h]) W_g + b_g)
    c      = tanh(D([x_t, r * h]) W_c + b_c)
    h'     = u * h + (1 - u) * c

Departures from the paper that the released code makes, and this file
follows:

- the recurrence: the paper's Eq. 2 sums the powers ``(D_O^-1 W)^k`` and
  ``(D_I^-1 W^T)^k``; the code's k-th feature is ``2 S x_{k-1} - x_{k-2}``
  (a Chebyshev-like recurrence), not ``S^k z``;
- the carry: the code does not reset ``x0`` between supports, so the
  second support's chain starts from the first's first hop ``S1 z`` and
  its second feature is ``2 S2 S2 S1 z - S1 z``. ``carry=False`` resets it
  (the paper's per-support chain from z), for the tests that show the
  difference.

The projection weight ``(F, (1 + S K) (C_in + U))`` is hop-major: hop k's
block of ``C_in + U`` rows, the input's channels before the state's. The
encoder runs the stacked cells over the inputs from zero states; the
decoder starts from the encoder's states, its first input zeros, each
output ``h W_p + b_p``; in training decoder input t + 1 is the
standardized label of step t where the step's coin says so, else output
t. The loss is the masked MAE of the inverse-scaled outputs against the
labels, zero labels left out. The optimizer: global-norm clipping (with
``clip_grad_norm_``'s 1e-6), then Adam.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def transition(src, dst, w, n: int) -> np.ndarray:
    """Dense ``D^-1 A`` of the edges ``src -> dst`` of weight ``w``."""
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (src, dst), w)
    rs = a.sum(axis=1, keepdims=True)
    return np.where(rs > 0, a / np.where(rs > 0, rs, 1.0), 0.0)


def supports_from_edges(src, dst, w, n: int) -> list[torch.Tensor]:
    """The dual random walk pair ``[D_O^-1 A, D_I^-1 A^T]`` as dense
    float32 (N, N)."""
    return [torch.as_tensor(transition(s, d, w, n), dtype=torch.float32)
            for s, d in ((src, dst), (dst, src))]


def hop(z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, N, C): ``out[w] = sum_v z[v] a[v, w]``."""
    return torch.einsum("bvc,vw->bwc", z, a)


def features(z: torch.Tensor, supports: list, order: int,
             carry: bool = True) -> torch.Tensor:
    """DCRNN's ``_gconv`` features of z (B, N, C), hop-major: (B, N, (1 +
    S order) C)."""
    x0 = z
    out = [z]
    for a in supports:
        if not carry:
            x0 = z
        x1 = hop(x0, a)
        out.append(x1)
        for _ in range(2, order + 1):
            x2 = 2.0 * hop(x1, a) - x0
            out.append(x2)
            x1, x0 = x2, x1
    return torch.cat(out, dim=-1)


def gconv(p: dict, name: str, z: torch.Tensor, supports: list, order: int,
          carry: bool = True) -> torch.Tensor:
    return (features(z, supports, order, carry) @ p[name + ".weight"].t()
            + p[name + ".bias"])


def cell(p: dict, name: str, x: torch.Tensor, h: torch.Tensor,
         supports: list, order: int, carry: bool = True) -> torch.Tensor:
    units = h.shape[-1]
    ru = torch.sigmoid(gconv(p, name + ".gate", torch.cat([x, h], -1),
                             supports, order, carry))
    r, u = ru[..., :units], ru[..., units:]
    c = torch.tanh(gconv(p, name + ".cand", torch.cat([x, r * h], -1),
                         supports, order, carry))
    return u * h + (1.0 - u) * c


def forward(p: dict, x: torch.Tensor, supports: list, cfg: dict, *,
            labels: torch.Tensor | None = None,
            teacher: list | None = None, carry: bool = True
            ) -> torch.Tensor:
    """x (B, T, N, input_dim) standardized -> (B, horizon, N, output_dim)
    standardized. ``labels`` (B, horizon, N, output_dim) standardized and
    ``teacher`` (horizon - 1 bools): decoder input t + 1 is ``labels[:,
    t]`` where ``teacher[t]``, else output t."""
    b, t_in, n, _ = x.shape
    layers, units = cfg["num_rnn_layers"], cfg["rnn_units"]
    order = cfg["max_diffusion_step"]
    h = [x.new_zeros(b, n, units) for _ in range(layers)]
    for t in range(t_in):
        inp = x[:, t]
        for i in range(layers):
            h[i] = cell(p, f"encoder.{i}", inp, h[i], supports, order, carry)
            inp = h[i]
    inp = x.new_zeros(b, n, cfg["output_dim"])
    outs = []
    for t in range(cfg["horizon"]):
        for i in range(layers):
            h[i] = cell(p, f"decoder.{i}", inp, h[i], supports, order, carry)
            inp = h[i]
        y = inp @ p["proj.weight"].t() + p["proj.bias"]
        outs.append(y)
        inp = labels[:, t] if teacher is not None and t + 1 < cfg[
            "horizon"] and teacher[t] else y
    return torch.stack(outs, dim=1)


def masked_mae(pred: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over the labels that are not 0."""
    mask = (real != 0).float()
    mask = mask / mask.mean()
    loss = torch.abs(pred - real) * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return loss.mean()


def loss_of(p: dict, x: torch.Tensor, y: torch.Tensor, supports: list,
            cfg: dict, scaler: dict, teacher: list | None,
            carry: bool = True) -> torch.Tensor:
    """x (B, T, N, C) standardized, y (B, H, N, F) raw: the masked MAE of
    the inverse-scaled outputs against ``y[..., 0]``."""
    k = cfg["output_dim"]
    labels = (y[..., :k] - scaler["mean"]) / scaler["std"]
    out = forward(p, x, supports, cfg, labels=labels, teacher=teacher,
                  carry=carry)
    pred = out[..., 0] * scaler["std"] + scaler["mean"]
    return masked_mae(pred, y[..., 0])


def train_steps(p0: dict, batches, supports: list, cfg: dict, opt: dict,
                scaler: dict, teachers: list, carry: bool = True) -> dict:
    """Optimizer steps from the weights ``p0`` over ``batches`` [(x, y)],
    step i's decoder coins ``teachers[i]``: clip, then Adam (``opt``:
    ``learning_rate``, ``epsilon``, ``grad_clip``). Returns each step's
    loss, the first step's clipped gradient per leaf, and the weights
    after the last step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    names = list(p)
    b1, b2 = 0.9, 0.999
    lr, eps = opt["learning_rate"], opt["epsilon"]
    m, v = {}, {}
    losses, first_grad = [], None
    for step, ((x, y), teacher) in enumerate(zip(batches, teachers),
                                             start=1):
        loss = loss_of(p, x, y, supports, cfg, scaler, teacher, carry)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        coef = min(1.0, opt["grad_clip"] / (float(total) + 1e-6))
        with torch.no_grad():
            taken = {}
            for k, g in zip(names, grads):
                g = g * coef
                taken[k] = g
                m[k] = b1 * m.get(k, torch.zeros_like(g)) + (1 - b1) * g
                v[k] = b2 * v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** step)) + eps
                p[k] -= (lr / (1 - b1 ** step)) * m[k] / denom
        if first_grad is None:
            first_grad = taken
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p[k].detach() for k in names}}
