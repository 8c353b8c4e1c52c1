"""Channel-wise dense ("1x1 conv") op on channels-last activations.

Counterpart of ``graph_wavenet_tpu/ops/linear.py``. Parameters keep the
reference's ``nn.Conv2d`` shapes (``weight (out, in, 1, 1)``, ``bias
(out,)``) so state dicts carry the reference names. The math is the JAX
package's: the weight is cast to the activation dtype, the contraction
accumulates in fp32, the fp32 bias is added, and the result is cast back
once.

:func:`project` is that projection over one or more operands summed into
one output, and picks its path from what the input shows: bf16 activations
on a CUDA device take the hand-written kernel (``ops.cuda.chan_proj``): one
launch forward, bf16 tensor-core products with fp32 sums in registers, the
bias and the cast in its epilogue, and hand-written backward passes. Every
other dtype and device keeps the fp32 chain of :func:`channel_matmul` bit
for bit (on the tensor cores fp32 would become TF32, less precision than
such configurations state).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from graph_wavenet_tpu_torch.ops.cuda import chan_proj


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


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether a projection of ``x`` runs the projection kernel: bf16
    activations on a CUDA device."""
    return x.dtype == torch.bfloat16 and x.device.type == "cuda"


def project(xs: list[torch.Tensor], w: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """``sum_k xs[k] @ w[:, cols_k].T + bias``, cast once to the operands'
    dtype: on the projection kernel where :func:`takes_kernel`, else the
    fp32 chain.

    ``xs``: 1 to ``chan_proj.MAX_OPERANDS`` operands of one dtype and one
    leading shape, each ``(..., C_k)`` with any strides (the kernel reads
    views in place); ``w`` (F, sum C_k) in the parameters' dtype, its
    columns in operand order, cast to the operands' dtype as
    :func:`channel_matmul` casts it; ``bias`` (F,). Returns ``(..., F)``.
    Other operands raise ``ValueError``.
    """
    if (not 1 <= len(xs) <= chan_proj.MAX_OPERANDS
            or any(x.shape[:-1] != xs[0].shape[:-1]
                   or x.dtype != xs[0].dtype for x in xs)):
        raise ValueError(
            f"project takes 1 to {chan_proj.MAX_OPERANDS} operands of one "
            f"dtype and leading shape, got "
            f"{[(tuple(x.shape), x.dtype) for x in xs]}")
    if takes_kernel(xs[0]):
        return _kernel(xs, w, bias)
    return _chain(xs, w, bias)


def _chain(xs, w, bias):
    """The fp32 chain: one :func:`channel_matmul` per operand, summed in
    operand order, + bias, one cast."""
    wt, h, k = w.t(), None, 0
    for x in xs:
        p = channel_matmul(x, wt[k:k + x.shape[-1]])
        k += x.shape[-1]
        h = p if h is None else h + p
    return (h + bias.float()).to(xs[0].dtype)


def _kernel(xs, w, bias):
    """The projection through the ``gwt_torch::chan_proj`` ops (on the CPU,
    their plain versions)."""
    rows = _row_views(xs)
    wb = w.to(xs[0].dtype, memory_format=torch.contiguous_format)
    b = bias.float()
    if torch.is_grad_enabled() and (b.requires_grad or wb.requires_grad
                                    or any(x.requires_grad for x in rows)):
        y = _Project.apply(wb, b, *rows)
    else:
        y = torch.ops.gwt_torch.chan_proj(rows, wb, b)
    return y.reshape(tuple(xs[0].shape[:-1]) + (w.shape[0],))


def _merges(x: torch.Tensor, lo: int, hi: int) -> bool:
    """Whether dims ``[lo, hi)`` of ``x`` are one strided run."""
    dims = [d for d in range(lo, hi) if x.shape[d] != 1]
    return all(x.stride(a) == x.stride(b) * x.shape[b]
               for a, b in zip(dims, dims[1:]))


def _row_views(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The operands as (O, I, C_k) views sharing (O, I): the leading dims
    before a split make O and the rest I, the first split at which the
    most operands are views; an operand that is none there is copied
    contiguous."""
    lead = xs[0].shape[:-1]
    nd = len(lead)
    best = None
    for p in range(nd + 1):
        bad = [k for k, x in enumerate(xs)
               if x.stride(-1) != 1 or not _merges(x, 0, p)
               or not _merges(x, p, nd)]
        if best is None or len(bad) < len(best[1]):
            best = (p, bad)
    p, bad = best
    o, i = math.prod(lead[:p]), math.prod(lead[p:])
    return [(x.contiguous() if k in bad else x).reshape(o, i, x.shape[-1])
            for k, x in enumerate(xs)]


class _Project(torch.autograd.Function):
    """The kernel's forward, and its backward: every operand's gradient in
    one dgrad launch, the weight's and the bias's in one wgrad launch."""

    @staticmethod
    def forward(ctx, w, bias, *xs):
        ctx.save_for_backward(w, *xs)
        return torch.ops.gwt_torch.chan_proj(list(xs), w, bias)

    @staticmethod
    def backward(ctx, g):
        w, *xs = ctx.saved_tensors
        if g.stride(-1) != 1:
            g = g.contiguous()
        dxs = [None] * len(xs)
        if any(ctx.needs_input_grad[2:]):
            dxs = torch.ops.gwt_torch.chan_proj_dgrad(g, w, xs)
        dw = db = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dw, db = torch.ops.gwt_torch.chan_proj_wgrad(xs, g)
        return (dw, db, *dxs)


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
        return project([x], self.weight[:, :, 0, 0], self.bias)
