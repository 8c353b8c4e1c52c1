"""The layer-tail kernel (``csrc/bn_tail.cu``): ops, plain versions and the
autograd function.

A dense-ops kernel with no Pallas counterpart (the JAX package leaves
BatchNorm to XLA's fusion). The tail of a Graph WaveNet layer is
``x = bf16(bf16(h * drop) + res)`` followed by BatchNorm over the (B, T, N)
positions of channels-last ``(B, T, N, C)`` activations. Six ops of the
seam (``ops/cuda/build.py``), each with a CPU kernel (the plain PyTorch
version beside it), a CUDA kernel (the launch) and a fake kernel, so a CUDA
graph captures them and ``torch.export`` writes them into an artifact:

- ``bn_tail_stats(h, drop, res)``: ``(x, sum x)``, the sum per channel in
  fp32; ``drop`` and ``res`` may be None, ``res`` any (B, T, N, C) view
  (the layer input's last T steps);
- ``bn_tail_var(x, mean)``: ``sum (x - mean)^2`` per channel (the biased
  variance's two-pass sum);
- ``bn_tail_apply(x, mean, inv, w, b)``: ``bf16((x - mean) * inv * w +
  b)``;
- ``bn_tail_eval(h, drop, res, mean, inv, w, b)``: the same from the parts
  of x in one pass (eval mode's running statistics);
- ``bn_tail_grad_reduce(g, x, mean, inv)``: (2, C) fp32, ``sum g`` and
  ``sum g * xhat``, the bias's and the weight's gradients;
- ``bn_tail_grad_apply(g, x, drop, mean, inv, w, sums, count, t_res)``:
  ``dx = bf16(w * inv * (g - sums[0] / count - xhat * sums[1] / count))``
  and ``(dh, dres)``: ``dh = bf16(dx * drop)`` and, for ``t_res`` > 0, the
  gradient of the whole (B, t_res, N, C) residual, ``dx`` on its last T
  steps and zeros before them.

Every sum is fp32 and reduced in a fixed order (no atomics). :func:`tail`
runs the training tail through them: statistics, the mean and the variance
each summed over a process group between the launches
(``parallel.collectives.all_sum``), the normalize; its backward reduces,
all-reduces the two gradient sums and applies. The seam counts the
launches of each op (:data:`OPS`) in ``build.LAUNCHES``. Each op carries a
FLOP formula for ``torch.utils.flop_counter`` (zero: the tail does no
matmul work, and the counter counts none of the chain's elementwise ops).
"""

from __future__ import annotations

import math

import torch

from graph_wavenet_tpu_torch.ops.cuda import build
from graph_wavenet_tpu_torch.parallel.collectives import all_sum, group_size

OPS = ("bn_tail_stats", "bn_tail_var", "bn_tail_apply", "bn_tail_eval",
       "bn_tail_grad_reduce", "bn_tail_grad_apply")

_DIMS = (0, 1, 2)


# ---------------------------------------------------------------------------
# plain versions (the CPU kernels, and what the CUDA kernel is held against)
# ---------------------------------------------------------------------------

def _x(h, drop, res):
    """x = h * drop + res in h's dtype, as the chain's ops round it."""
    x = h if drop is None else h * drop
    return x if res is None else x + res


def stats_plain(h, drop, res):
    x = _x(h, drop, res)
    if x is h:
        x = h.clone()
    return x, x.float().sum(dim=_DIMS)


def var_plain(x, mean):
    return ((x.float() - mean) ** 2).sum(dim=_DIMS)


def apply_plain(x, mean, inv, w, b):
    return ((x.float() - mean) * inv * w + b).to(x.dtype)


def eval_plain(h, drop, res, mean, inv, w, b):
    return apply_plain(_x(h, drop, res), mean, inv, w, b)


def grad_reduce_plain(g, x, mean, inv):
    gf = g.float()
    xhat = (x.float() - mean) * inv
    return torch.stack([gf.sum(dim=_DIMS), (gf * xhat).sum(dim=_DIMS)])


def grad_apply_plain(g, x, drop, mean, inv, w, sums, count, t_res):
    xhat = (x.float() - mean) * inv
    dx = (w * inv * (g.float() - sums[0] / count - xhat * (sums[1] / count))
          ).to(x.dtype)
    dh = dx if drop is None else dx * drop
    if t_res == 0:
        return dh, x.new_empty((0,))
    b, t, n, c = x.shape
    dres = x.new_zeros((b, t_res, n, c))
    dres[:, t_res - t:] = dx
    return dh, dres


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

_stats_op = build.Op(
    "bn_tail_stats", "(Tensor h, Tensor? drop, Tensor? res) "
    "-> (Tensor, Tensor)", stats_plain)
_var_op = build.Op("bn_tail_var", "(Tensor x, Tensor mean) -> Tensor",
                   var_plain)
_apply_op = build.Op(
    "bn_tail_apply", "(Tensor x, Tensor mean, Tensor inv, Tensor w, "
    "Tensor b) -> Tensor", apply_plain)
_eval_op = build.Op(
    "bn_tail_eval", "(Tensor h, Tensor? drop, Tensor? res, Tensor mean, "
    "Tensor inv, Tensor w, Tensor b) -> Tensor", eval_plain)
_grad_reduce_op = build.Op(
    "bn_tail_grad_reduce", "(Tensor g, Tensor x, Tensor mean, "
    "Tensor inv) -> Tensor", grad_reduce_plain)
_grad_apply_op = build.Op(
    "bn_tail_grad_apply", "(Tensor g, Tensor x, Tensor? drop, "
    "Tensor mean, Tensor inv, Tensor w, Tensor sums, int count, "
    "int t_res) -> (Tensor, Tensor)", grad_apply_plain)


def _chan(x):
    return x.new_empty(x.shape[-1:], dtype=torch.float32)


@_stats_op.fake
def _(h, drop, res):
    return torch.empty_like(h, memory_format=torch.contiguous_format), _chan(h)


@_var_op.fake
def _(x, mean):
    return _chan(x)


@_apply_op.fake
def _(x, mean, inv, w, b):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@_eval_op.fake
def _(h, drop, res, mean, inv, w, b):
    return torch.empty_like(h, memory_format=torch.contiguous_format)


@_grad_reduce_op.fake
def _(g, x, mean, inv):
    return x.new_empty((2,) + tuple(x.shape[-1:]), dtype=torch.float32)


@_grad_apply_op.fake
def _(g, x, drop, mean, inv, w, sums, count, t_res):
    dh = torch.empty_like(x, memory_format=torch.contiguous_format)
    if t_res == 0:
        return dh, x.new_empty((0,))
    b, _, n, c = x.shape
    return dh, x.new_empty((b, t_res, n, c))


def _no_flops(*args, out_shape=None, **kwargs) -> int:
    return 0


for _op in (_stats_op, _var_op, _apply_op, _eval_op, _grad_reduce_op,
            _grad_apply_op):
    _op.flops(_no_flops)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

# threads a block aims at, resident blocks aimed at per SM, and the widest
# channel axis the kernels take (a block's partial sums in shared memory)
THREADS = 256
BLOCKS_PER_SM = 8
MAX_CHANNELS = 1024


def plan(b: int, t: int, n: int, c: int, vec: int,
         sms: int) -> tuple[int, int, int]:
    """(lanes, rows, gx) of a launch over a (b, t, n, c) tensor with
    ``vec`` channels a thread: ``lanes`` threads across a row, ``rows``
    rows a block covers at once (about ``THREADS`` threads a block), and
    ``gx`` blocks along each (b, t) plane's nodes, about ``BLOCKS_PER_SM``
    blocks an SM in all. Shapes and the card's SM count fix all three, so
    the sums' order is fixed."""
    if not 1 <= c <= MAX_CHANNELS or c % vec:
        raise ValueError(f"the tail kernel takes 1 to {MAX_CHANNELS} "
                         f"channels, got {c}")
    lanes = c // vec
    rows = max(1, THREADS // lanes)
    gx = max(1, min(math.ceil(BLOCKS_PER_SM * sms / (b * t)),
                    math.ceil(n / rows)))
    return lanes, rows, gx


def _view(t: torch.Tensor | None) -> list[int]:
    if t is None:
        return [0, 0, 0, 0]
    return [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]


def _check(like: torch.Tensor, *ts) -> None:
    """bf16 (B, T, N, C) views of ``like``'s shape with a unit channel
    stride."""
    for t in (like,) + ts:
        if t is None:
            continue
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the tail kernel takes bf16, got {t.dtype}")
        if t.ndim != 4 or t.shape != like.shape:
            raise ValueError(f"the tail kernel takes (B, T, N, C) tensors "
                             f"of one shape, got {tuple(t.shape)} beside "
                             f"{tuple(like.shape)}")
        if t.stride(3) != 1 and t.shape[3] != 1:
            raise ValueError("the tail kernel takes a unit channel stride")


def _head(x: torch.Tensor, *views) -> list[int]:
    """The descriptor's head: shape, channels a thread and the plan."""
    b, t, n, c = x.shape
    vec = 8 if c % 8 == 0 and all(
        v is None or (v.data_ptr() % 16 == 0
                      and all(s % 8 == 0 for s in v.stride()[:3]))
        for v in views) else 1
    lanes, rows, gx = plan(b, t, n, c, vec, build.sms(x.device))
    if b * t > 65535 or n > 2 ** 31 - 1:
        raise ValueError(f"the tail kernel takes at most 65,535 (b, t) "
                         f"planes, got a {tuple(x.shape)} tensor")
    return [b, t, n, c, vec, lanes, rows, gx]


def _part(x: torch.Tensor, head: list[int], k: int) -> torch.Tensor:
    b, t, _, c = x.shape
    return torch.empty(head[7] * b * t * k * c, dtype=torch.float32,
                       device=x.device)


def _fp32(*ts) -> list[int]:
    out = []
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("per-channel vectors must be contiguous fp32")
        out.append(t.data_ptr())
    return out


def _empty(x: torch.Tensor) -> bool:
    return x.numel() == 0


@_stats_op.cuda
def _(h, drop, res):
    _check(h, drop, res)
    x = torch.empty_like(h, memory_format=torch.contiguous_format)
    s = _chan(h)
    if _empty(h):
        return x, s.zero_()
    head = _head(h, h, drop, res, x)
    part = _part(h, head, 1)
    build.launch("bn_tail.cu", "gwt_bn_tail_stats",
                 head + _view(h) + _view(drop) + _view(res) + _view(x)
                 + [part.data_ptr(), s.data_ptr()], h.device, "bn_tail_stats")
    return x, s


@_var_op.cuda
def _(x, mean):
    _check(x)
    s = _chan(x)
    if _empty(x):
        return s.zero_()
    head = _head(x, x)
    part = _part(x, head, 1)
    build.launch("bn_tail.cu", "gwt_bn_tail_var",
                 head + _view(x) + _fp32(mean)
                 + [part.data_ptr(), s.data_ptr()], x.device, "bn_tail_var")
    return s


def _apply(op, h, drop, res, x, mean, inv, w, b):
    like = h if x is None else x
    _check(like, drop, res)
    y = torch.empty_like(like, memory_format=torch.contiguous_format)
    if _empty(like):
        return y
    head = _head(like, h, drop, res, x, y)
    build.launch("bn_tail.cu", "gwt_bn_tail_apply",
                 head + [int(x is None)] + _view(h) + _view(drop)
                 + _view(res) + _view(x) + _view(y) + _fp32(mean, inv, w, b),
                 like.device, op)
    return y


@_apply_op.cuda
def _(x, mean, inv, w, b):
    return _apply("bn_tail_apply", None, None, None, x, mean, inv, w, b)


@_eval_op.cuda
def _(h, drop, res, mean, inv, w, b):
    return _apply("bn_tail_eval", h, drop, res, None, mean, inv, w, b)


@_grad_reduce_op.cuda
def _(g, x, mean, inv):
    _check(x, g)
    sums = x.new_empty((2,) + tuple(x.shape[-1:]), dtype=torch.float32)
    if _empty(x):
        return sums.zero_()
    head = _head(x, g, x)
    part = _part(x, head, 2)
    build.launch("bn_tail.cu", "gwt_bn_tail_grad_reduce",
                 head + _view(g) + _view(x) + _fp32(mean, inv)
                 + [part.data_ptr(), sums.data_ptr()], x.device,
                 "bn_tail_grad_reduce")
    return sums


@_grad_apply_op.cuda
def _(g, x, drop, mean, inv, w, sums, count, t_res):
    _check(x, g, drop)
    b, t, n, c = x.shape
    dh = torch.empty_like(x, memory_format=torch.contiguous_format)
    dres = x.new_empty((0,))
    tail = None
    if t_res:
        if t_res < t:
            raise ValueError(f"the residual's {t_res} steps are fewer than "
                             f"the output's {t}")
        dres = x.new_empty((b, t_res, n, c))
        dres[:, :t_res - t].zero_()
        tail = dres[:, t_res - t:]
    if _empty(x):
        return dh, dres
    head = _head(x, g, x, drop, dh, tail)
    build.launch("bn_tail.cu", "gwt_bn_tail_grad_apply",
                 head + _view(g) + _view(x) + _view(drop) + _view(dh)
                 + _view(tail) + _fp32(mean, inv, w, sums) + [int(count)],
                 x.device, "bn_tail_grad_apply")
    return dh, dres


# ---------------------------------------------------------------------------
# the tail through the ops
# ---------------------------------------------------------------------------

def _statistics(h, drop, res, eps, group, count):
    """Training statistics: (x, mean, biased var, inv), the two sums each
    all-reduced over ``group`` before its division."""
    ops = torch.ops.gwt_torch
    x, s1 = ops.bn_tail_stats(h, drop, res)
    mean = all_sum(s1, group) / count
    var = all_sum(ops.bn_tail_var(x, mean), group) / count
    return x, mean, var, torch.rsqrt(var + eps)


class _Tail(torch.autograd.Function):
    """The tail with its hand-written backward: the two gradient sums
    reduced once, all-reduced in one call under a group (training), zero
    in eval mode, and both input gradients from one pass."""

    @staticmethod
    def forward(ctx, h, drop, res, w, b, eps, group, count, running):
        ops = torch.ops.gwt_torch
        t = h.shape[1]
        resv = None if res is None else res[:, -t:]
        if running is None:
            x, mean, var, inv = _statistics(h, drop, resv, eps, group, count)
        else:
            mean, var = running
            inv = torch.rsqrt(var + eps)
            x, _ = ops.bn_tail_stats(h, drop, resv)
        y = ops.bn_tail_apply(x, mean, inv, w, b)
        ctx.save_for_backward(x, drop, mean, inv, w)
        ctx.group, ctx.count, ctx.train = group, count, running is None
        ctx.t_res = 0 if res is None else res.shape[1]
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        ops = torch.ops.gwt_torch
        x, drop, mean, inv, w = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        local = ops.bn_tail_grad_reduce(dy, x, mean, inv)
        sums = (all_sum(local, ctx.group) if ctx.train
                else torch.zeros_like(local))
        dh, dres = ops.bn_tail_grad_apply(dy, x, drop, mean, inv, w, sums,
                                          ctx.count, ctx.t_res)
        db, dw = local.unbind(0)
        return (dh, None, dres if ctx.t_res else None, dw, db, None, None,
                None, None)


def tail(h: torch.Tensor, drop: torch.Tensor | None,
         res: torch.Tensor | None, weight: torch.Tensor, bias: torch.Tensor,
         eps: float, group=None, count: int | None = None,
         running: tuple | None = None):
    """``(y, stats)`` of ``BatchNorm(bf16(bf16(h * drop) + res[:, -T:]))``
    through the ops: ``running`` None, training (batch statistics over
    ``count`` positions across ``group``, by default every rank's share
    equal to this one's; ``stats`` = (mean, biased var, count)), else eval mode with ``running`` = (mean, var) fp32 and
    ``stats`` None. ``res``: the layer input (B, T_in >= T, N, C), of which
    the last T steps are added, or None; ``drop`` a mask of h's shape or
    None."""
    w, b = weight.float(), bias.float()
    if count is None:
        count = h.numel() // h.shape[-1] * group_size(group)
    count = int(count)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (h, res, w, b))
    if grad:
        y, mean, var = _Tail.apply(h, drop, res, w, b, eps, group, count,
                                   running)
    else:
        resv = None if res is None else res[:, -h.shape[1]:]
        if running is None:
            x, mean, var, inv = _statistics(h, drop, resv, eps, group, count)
            y = torch.ops.gwt_torch.bn_tail_apply(x, mean, inv, w, b)
        else:
            mean, var = running
            y = torch.ops.gwt_torch.bn_tail_eval(
                h, drop, resv, mean, torch.rsqrt(var + eps), w, b)
    stats = None if running is not None else (mean, var, float(count))
    return y, stats
