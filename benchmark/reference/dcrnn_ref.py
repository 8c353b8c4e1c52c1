"""DCRNN (Li, Yu, Shahabi and Liu, ICLR 2018, arXiv:1707.01926) in plain
PyTorch, written from its released code (github.com/liyaguang/DCRNN:
``model/dcrnn_cell.py``, ``model/dcrnn_model.py``, ``data/model/
dcrnn_la.yaml``): the benchmark's yardstick for the program's DCRNN, on
``graph_ref``'s block supports through ``gwnet_ref.hop``. Nothing here
imports the program.

Per sample, on z (N, C) and the supports S_1..S_S (a step maps z to
``out[w] = sum_v z[v] P[v, w]``):

    D(z)   = [z, S1 z, 2 S1 S1 z - z, S2 S1 z, 2 S2 S2 S1 z - S1 z]  (order 2)
    [r, u] = sigmoid(D([x_t, h]) W_g + b_g)
    c      = tanh(D([x_t, r * h]) W_c + b_c)
    h'     = u * h + (1 - u) * c

As in the released code, and departing from the paper's Eq. 2: the k-th
feature is ``2 S x_{k-1} - x_{k-2}``, not ``S^k z``, and ``x0`` carries
across supports (the second support's chain starts from ``S1 z``). The
projection weight ``(F, (1 + S K)(C_in + U))`` is hop-major, the input's
channels before the state's. The encoder runs the stacked cells over the
inputs from zero states; the decoder starts from its states, first input
zeros, each output ``h W_p + b_p``; in training decoder input t + 1 is the
standardized label of step t where the step's coin (a uniform draw below
``tau / (tau + exp(step / tau))``) says so, else output t. The loss is the
masked MAE of the inverse-scaled outputs, zero labels left out; clip,
then Adam.

Everything runs in float32 (TF32 is the caller's to switch off); ``q``
rounds where the program rounds its activations, weights and supports
(the control). The batch is computed in pieces of ``PIECE`` samples so
that 40,960 sensors fit: the masked MAE is normalized by the whole
batch's count and the pieces' gradients summed, which DCRNN (no batch
normalization, no dropout) makes exact up to the order of the sums.
"""

from __future__ import annotations

import math

import torch

from reference.gwnet_ref import hop, identity

PIECE = 1


def _hop(z: torch.Tensor, a, q) -> torch.Tensor:
    """(B, N, C) -> (B, N, C), rounded as the program rounds a hop."""
    return q(hop(z[:, None], a, q)[:, 0])


def gconv(p: dict, name: str, z: torch.Tensor, supports: list, order: int,
          q) -> torch.Tensor:
    """DCRNN's ``_gconv`` of z (B, N, C): its features, projected."""
    x0 = z
    feats = [z]
    for a in supports:
        x1 = _hop(x0, a, q)
        feats.append(x1)
        for _ in range(2, order + 1):
            x2 = 2.0 * _hop(x1, a, q) - x0
            feats.append(x2)
            x1, x0 = x2, x1
    return q(torch.cat(feats, dim=-1) @ q(p[name + ".weight"]).t()
             + p[name + ".bias"])


def cell(p: dict, name: str, x: torch.Tensor, h: torch.Tensor,
         supports: list, order: int, q) -> torch.Tensor:
    """x (B, N, C_in) as the program holds it, h (B, N, U) fp32."""
    units = h.shape[-1]
    ru = torch.sigmoid(gconv(p, name + ".gate", torch.cat([x, q(h)], -1),
                             supports, order, q))
    r, u = ru[..., :units], ru[..., units:]
    c = torch.tanh(gconv(p, name + ".cand", torch.cat([x, q(r * h)], -1),
                         supports, order, q))
    return u * h + (1.0 - u) * c


def forward(p: dict, x: torch.Tensor, supports: list, cfg: dict, *,
            labels: torch.Tensor | None = None, teacher: list | None = None,
            q=identity) -> torch.Tensor:
    """x (B, T, N, input_dim) standardized -> (B, horizon, N, output_dim)
    standardized. ``labels`` standardized and ``teacher`` (horizon - 1
    bools): decoder input t + 1 is ``labels[:, t]`` where ``teacher[t]``,
    else output t."""
    b, t_in, n, _ = x.shape
    layers, units = cfg["num_rnn_layers"], cfg["rnn_units"]
    order = cfg["max_diffusion_step"]
    x = q(x)
    h = [x.new_zeros(b, n, units) for _ in range(layers)]
    for t in range(t_in):
        inp = x[:, t]
        for i in range(layers):
            h[i] = cell(p, f"encoder.{i}", inp, h[i], supports, order, q)
            inp = q(h[i])
    inp = x.new_zeros(b, n, cfg["output_dim"])
    outs = []
    for t in range(cfg["horizon"]):
        for i in range(layers):
            h[i] = cell(p, f"decoder.{i}", inp, h[i], supports, order, q)
            inp = q(h[i])
        y = q(inp @ q(p["proj.weight"]).t() + p["proj.bias"])
        outs.append(y)
        if teacher is not None and t + 1 < cfg["horizon"] and teacher[t]:
            inp = q(labels[:, t])
        else:
            inp = y
    return torch.stack(outs, dim=1)


def coins(gen: torch.Generator, step: int, cfg: dict, device) -> list:
    """One step's teacher-forcing decisions: ``horizon - 1`` uniforms from
    ``gen`` below the curriculum's threshold at global step ``step``,
    computed on the device in float32."""
    tau = cfg["cl_decay_steps"]
    u = torch.rand((cfg["horizon"] - 1,), generator=gen, device=device)
    s = torch.full((), step, dtype=torch.int64, device=device)
    p = tau / (tau + torch.exp(s.float() / tau))
    return (u < p).tolist()


def train_steps(p0: dict, batches, supports: list, cfg: dict, opt: dict,
                scaler: dict, teachers: list, q=identity,
                piece: int = PIECE) -> dict:
    """Optimizer steps from the weights ``p0`` over ``batches`` [(x, y)]
    (x standardized, y raw), step i's coins ``teachers[i]``: clip, then
    Adam (``opt``: ``learning_rate``, ``epsilon``, ``grad_clip``). Returns
    each step's loss, the first step's clipped gradient per leaf, and the
    weights after the last step."""
    names = list(p0)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    b1, b2 = 0.9, 0.999
    lr, eps = opt["learning_rate"], opt["epsilon"]
    k_out = cfg["output_dim"]
    m, v = {}, {}
    losses, first_grad = [], None
    for step, ((x, y), teacher) in enumerate(zip(batches, teachers),
                                             start=1):
        count = (y[..., 0] != 0).sum().float()
        grads = {k: torch.zeros_like(p[k]) for k in names}
        loss = 0.0
        for lo in range(0, x.shape[0], piece):
            xs, ys = x[lo:lo + piece], y[lo:lo + piece]
            labels = (ys[..., :k_out] - scaler["mean"]) / scaler["std"]
            out = forward(p, xs, supports, cfg, labels=labels,
                          teacher=teacher, q=q)
            pred = out[..., 0] * scaler["std"] + scaler["mean"]
            real = ys[..., 0]
            part = (torch.abs(pred - real) * (real != 0).float()).sum() \
                / count
            for k, g in zip(names, torch.autograd.grad(
                    part, [p[k] for k in names])):
                grads[k] += g
            loss += float(part.detach())
            del out, pred, part
        losses.append(loss)
        total = torch.sqrt(sum((g.double() ** 2).sum()
                               for g in grads.values()))
        coef = min(1.0, opt["grad_clip"] / (float(total) + 1e-6))
        with torch.no_grad():
            taken = {}
            for k in names:
                g = grads[k] * coef
                taken[k] = g
                m[k] = b1 * m.get(k, torch.zeros_like(g)) + (1 - b1) * g
                v[k] = b2 * v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** step)) + eps
                p[k] -= (lr / (1 - b1 ** step)) * m[k] / denom
        if first_grad is None:
            first_grad = taken
        del grads
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p[k].detach() for k in names}}
