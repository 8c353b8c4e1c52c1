"""Graph WaveNet (Wu et al., IJCAI 2019, arXiv:1906.00121) in plain
PyTorch, written from the paper and its reference ``train.py``: the
benchmark's yardstick for what the program computes.

Activations are ``(B, T, N, C)``. A layer is the gated dilated causal
convolution (kernel 2), a skip projection of its last ``T_final`` steps,
the diffusion convolution over the fixed supports and the adaptive
adjacency ``softmax(relu(E1 E2))`` (order 2, hops concatenated as ``[x,
P1 x, P1^2 x, P2 x, ...]`` and projected), inverted dropout on that
projection in training, the residual, and batch normalization. The head
is ``relu -> 1x1 -> relu -> 1x1`` over the summed skips. The loss is the
masked MAE on de-standardized predictions (labels equal to 0 left out),
the optimizer gradient-norm clipping and then Adam with L2 weight decay.

Everything runs in float32 (TF32 is the caller's to switch off). ``q``
is where the arithmetic rounds: identity for the reference, or a
rounding to a lower precision at every point where the program rounds
its activations, weights and supports (the control; straight-through in
the backward). Block supports (:class:`graph_ref.BlockSupport`) are
multiplied block by block in chunks, so that 40,960 nodes fit; their
backward recomputes from the saved input instead of saving every
gathered block. The adaptive adjacency over a block mask is the row
softmax of each source node over the entries its live blocks hold.
"""

from __future__ import annotations

import math

import torch

from reference.graph_ref import BlockSupport

CHUNK_BYTES = 1 << 28


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_rounding(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 (e4m3) rounding, as fp8 training recipes
    scale: the largest magnitude maps to 448. Straight-through backward."""
    with torch.no_grad():
        s = t.abs().amax().clamp(min=1e-30) / 448.0
        r = (t / s).to(torch.float8_e4m3fn).float() * s
    return t + (r - t).detach()


# ---------------------------------------------------------------------------
# block-sparse diffusion steps
# ---------------------------------------------------------------------------

def _chunk(bs: int, r: int) -> int:
    return max(1, CHUNK_BYTES // (bs * r * 4))


def _hop(xn: torch.Tensor, blocks: torch.Tensor, vb: torch.Tensor,
         wb: torch.Tensor, nb: int) -> torch.Tensor:
    """``out[w] = sum_v xn[v] P[v, w]`` for (N, R) ``xn``, block ``l`` of P
    at rows ``vb[l]`` and columns ``wb[l]``."""
    bs, r = blocks.shape[1], xn.shape[1]
    xb = xn.reshape(nb, bs, r)
    out = xn.new_zeros(nb, bs, r)
    step = _chunk(bs, r)
    for lo in range(0, blocks.shape[0], step):
        hi = lo + step
        prod = torch.bmm(blocks[lo:hi].transpose(1, 2),
                         xb.index_select(0, vb[lo:hi]))
        out.index_add_(0, wb[lo:hi], prod)
    return out.reshape(nb * bs, r)


def _cotangent(xn: torch.Tensor, g: torch.Tensor, vb: torch.Tensor,
               wb: torch.Tensor, nb: int) -> torch.Tensor:
    """d loss / d block ``l``: ``xn[vb-block]^T`` times ``g[wb-block]``."""
    r = xn.shape[1]
    bs = xn.shape[0] // nb
    xb, gb = xn.reshape(nb, bs, r), g.reshape(nb, bs, r)
    out = []
    step = _chunk(bs, r)
    for lo in range(0, vb.shape[0], step):
        hi = lo + step
        out.append(torch.bmm(xb.index_select(0, vb[lo:hi]),
                             gb.index_select(0, wb[lo:hi]).transpose(1, 2)))
    return torch.cat(out)


class _BlockHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xn, blocks, vb, wb, nb):
        ctx.save_for_backward(xn, blocks, vb, wb)
        ctx.nb = nb
        return _hop(xn, blocks, vb, wb, nb)

    @staticmethod
    def backward(ctx, g):
        xn, blocks, vb, wb = ctx.saved_tensors
        gx = gb = None
        if ctx.needs_input_grad[0]:
            gx = _hop(g, blocks.transpose(1, 2), wb, vb, ctx.nb)
        if ctx.needs_input_grad[1]:
            gb = _cotangent(xn, g, vb, wb, ctx.nb)
        return gx, gb, None, None, None


def hop(x: torch.Tensor, a, q) -> torch.Tensor:
    """One diffusion step of (B, T, N, C) ``x`` over a dense (N, N) support
    or a :class:`BlockSupport`, the support rounded by ``q``."""
    if isinstance(a, BlockSupport):
        b, t, n, c = x.shape
        xn = x.permute(2, 0, 1, 3).reshape(n, b * t * c)
        out = _BlockHop.apply(xn, q(a.blocks), a.vb, a.wb, n // a.bs)
        return out.reshape(n, b, t, c).permute(1, 2, 0, 3)
    return torch.einsum("btvc,vw->btwc", x, q(a))


def adaptive_blocks(nodevec1: torch.Tensor, nodevec2: torch.Tensor, vb, wb,
                    bs: int) -> torch.Tensor:
    """Blocks of the masked adaptive adjacency: for block ``l``,
    ``relu(E1[v] . E2[:, w])`` over its (v, w), normalized by a softmax over
    every live entry of row v."""
    n, r = nodevec1.shape
    nb = n // bs
    e1 = nodevec1.reshape(nb, bs, r).index_select(0, vb)
    e2 = nodevec2.reshape(r, nb, bs).permute(1, 0, 2).index_select(0, wb)
    logits = torch.relu(torch.bmm(e1, e2))                 # (L, bs, bs)
    with torch.no_grad():
        row_max = torch.full((nb, bs), -math.inf, device=logits.device)
        row_max = row_max.scatter_reduce(
            0, vb[:, None].expand(-1, bs), logits.amax(2), "amax")
    ex = torch.exp(logits - row_max.index_select(0, vb)[:, :, None])
    row_sum = ex.new_zeros(nb, bs).index_add(0, vb, ex.sum(2))
    return ex / row_sum.index_select(0, vb)[:, :, None]


def adaptive_dense(nodevec1: torch.Tensor,
                   nodevec2: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.relu(nodevec1 @ nodevec2), dim=1)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def dilations(cfg: dict) -> list[int]:
    out = []
    for _ in range(cfg["blocks"]):
        d = 1
        for _ in range(cfg["layers"]):
            out.append(d)
            d *= 2
    return out


def receptive_field(cfg: dict) -> int:
    return 1 + (cfg["kernel_size"] - 1) * sum(dilations(cfg))


def _linear(p: dict, name: str, x: torch.Tensor, q) -> torch.Tensor:
    w = p[name + ".weight"][:, :, 0, 0].t()
    return q(x @ q(w) + p[name + ".bias"])


def _conv(p: dict, name: str, x: torch.Tensor, d: int, q) -> torch.Tensor:
    """(1, 2) dilated valid convolution over time, right-aligned."""
    w = p[name + ".weight"]
    t_out = x.shape[1] - d * (w.shape[-1] - 1)
    out = p[name + ".bias"]
    for i in range(w.shape[-1]):
        out = out + x[:, i * d:i * d + t_out] @ q(w[:, :, 0, i].t())
    return q(out)


def _batch_norm(p: dict, name: str, x: torch.Tensor, train: bool, q):
    if train:
        mean = x.mean(dim=(0, 1, 2))
        var = ((x - mean) ** 2).mean(dim=(0, 1, 2))
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    y = (x - mean) * torch.rsqrt(var + 1e-5) * p[name + ".weight"]
    return q(y + p[name + ".bias"])


def supports_with_adaptive(p: dict, fixed: list, pairs, cfg: dict) -> list:
    """The fixed supports and, under ``addaptadj``, the adaptive one (on
    the block pairs ``pairs``, or dense where ``pairs`` is None)."""
    if not cfg["addaptadj"]:
        return list(fixed)
    if pairs is None:
        return list(fixed) + [adaptive_dense(p["nodevec1"], p["nodevec2"])]
    vb, wb, bs = pairs
    blocks = adaptive_blocks(p["nodevec1"], p["nodevec2"], vb, wb, bs)
    return list(fixed) + [BlockSupport(vb, wb, blocks,
                                       p["nodevec1"].shape[0], bs)]


def forward(p: dict, x: torch.Tensor, supports: list, cfg: dict, *,
            train: bool, masks: list | None = None, q=identity
            ) -> torch.Tensor:
    """x (B, T, N, in_dim) -> (B, T_final, N, out_dim). ``masks``: the
    dropout factors of each layer's diffusion output in training."""
    rf = receptive_field(cfg)
    if x.shape[1] < rf:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, rf - x.shape[1], 0))
    t_final = x.shape[1] - sum(dilations(cfg))
    x = _linear(p, "start_conv", q(x), q)
    skip = None
    for i, d in enumerate(dilations(cfg)):
        res = x
        f = _conv(p, f"filter_convs.{i}", x, d, q)
        g = _conv(p, f"gate_convs.{i}", x, d, q)
        x = q(q(torch.tanh(f)) * q(torch.sigmoid(g)))
        s = _linear(p, f"skip_convs.{i}", x[:, -t_final:], q)
        skip = s if skip is None else q(s + skip)
        hops = [x]
        for a in supports:
            h = x
            for _ in range(cfg["diffusion_order"]):
                h = q(hop(h, a, q))
                hops.append(h)
        x = _linear(p, f"gconv.{i}.mlp.mlp", torch.cat(hops, dim=-1), q)
        if train and masks is not None:
            x = q(x * masks[i])
        x = q(x + res[:, -x.shape[1]:])
        x = _batch_norm(p, f"bn.{i}", x, train, q)
    out = torch.relu(skip)
    out = torch.relu(_linear(p, "end_conv_1", out, q))
    return _linear(p, "end_conv_2", out, q)


def dropout_masks(gen: torch.Generator, cfg: dict, b: int, t_in: int,
                  n: int, device) -> list[torch.Tensor]:
    """Each layer's inverted-dropout factors for a batch of ``b`` inputs of
    ``t_in`` steps (after padding), drawn as uniforms from ``gen`` in layer
    order: kept where the draw is below ``1 - p``."""
    p = cfg["dropout"]
    out = []
    t = t_in
    for d in dilations(cfg):
        t -= d * (cfg["kernel_size"] - 1)
        u = torch.rand((b, t, n, cfg["residual_channels"]), generator=gen,
                       device=device)
        out.append((u < 1.0 - p).float() / (1.0 - p))
    return out


def masked_mae(pred: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over the labels that are not 0."""
    mask = (real != 0).float()
    mask = mask / mask.mean()
    loss = torch.abs(pred - real) * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return loss.mean()


def loss_of(p: dict, x: torch.Tensor, y: torch.Tensor, fixed: list, pairs,
            cfg: dict, scaler: dict, masks, q) -> torch.Tensor:
    """The training loss of a batch: x (B, T, N, C) standardized, y (B, H,
    N, F) raw. The input is left-padded by one step, as the reference
    trainer pads it."""
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 0))
    sups = supports_with_adaptive(p, fixed, pairs, cfg)
    out = forward(p, x, sups, cfg, train=True, masks=masks, q=q)
    pred = out * scaler["std"] + scaler["mean"]
    real = y[..., 0].permute(0, 2, 1)[:, None]
    return masked_mae(pred, real)


def train_steps(p0: dict, batches, fixed: list, pairs, cfg: dict,
                opt: dict, scaler: dict, gen: torch.Generator, q=identity
                ) -> dict:
    """Optimizer steps from the weights ``p0`` over ``batches`` [(x, y)]:
    clip, then Adam with L2 weight decay. Returns each step's loss, the
    first step's gradient as Adam takes it (clipped, weight decay added)
    per leaf, and the weights after the last step."""
    names = [k for k in p0 if not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))]
    p = {k: v.detach().clone() for k, v in p0.items()}
    for k in names:
        p[k].requires_grad_(True)
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    m, v = {}, {}
    losses, first_grad = [], None
    for step, (x, y) in enumerate(batches, start=1):
        b, n = x.shape[0], x.shape[2]
        masks = dropout_masks(gen, cfg, b, x.shape[1] + 1, n, x.device)
        loss = loss_of(p, x, y, fixed, pairs, cfg, scaler, masks, q)
        grads = torch.autograd.grad(loss, [p[k] for k in names],
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        live = {k: g for k, g in zip(names, grads) if g is not None}
        total = torch.sqrt(sum((g.double() ** 2).sum() for g in live.values()))
        coef = min(1.0, opt["grad_clip"] / (float(total) + 1e-6))
        with torch.no_grad():
            taken = {}
            for k, g in live.items():
                g = g * coef + wd * p[k]
                taken[k] = g
                m[k] = b1 * m.get(k, torch.zeros_like(g)) + (1 - b1) * g
                v[k] = b2 * v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** step)) + eps
                p[k] -= (lr / (1 - b1 ** step)) * m[k] / denom
        if first_grad is None:
            first_grad = taken
        del grads, live, loss
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: p[k].detach() for k in names}}


@torch.no_grad()
def predict(p: dict, x: torch.Tensor, fixed: list, pairs, cfg: dict,
            scaler: dict, perm: torch.Tensor | None, q=identity
            ) -> torch.Tensor:
    """Forecasts (B, H, N) in raw units of standardized windows x (B, T, N,
    C) given in original node order; ``perm`` (``new = perm[old]``) is the
    order the weights and supports are laid out in."""
    if perm is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.numel(), device=perm.device)
        x = x.index_select(2, inv)
    sups = supports_with_adaptive(p, fixed, pairs, cfg)
    out = forward(p, x, sups, cfg, train=False, q=q)
    pred = out[:, -1].permute(0, 2, 1)
    if perm is not None:
        pred = pred.index_select(2, perm)
    return pred * scaler["std"] + scaler["mean"]
