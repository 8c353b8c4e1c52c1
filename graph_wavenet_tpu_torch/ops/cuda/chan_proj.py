"""The channel projection kernel (``csrc/chan_proj.cu``): ops and plain
versions.

A dense-ops kernel with no Pallas counterpart (the JAX package leaves its
channel matmuls to XLA). Three ops of the seam (``ops/cuda/build.py``),
each with a CPU kernel (the plain PyTorch version beside it), a CUDA kernel
(the launch) and a fake kernel, so a CUDA graph captures them and
``torch.export`` writes them into an artifact:

- ``chan_proj(xs, w, bias)``: ``bf16(sum_k xs[k] @ w[:, cols_k].T +
  bias)`` (O, I, F). Every ``xs[k]`` is a bf16 (O, I, C_k) view with a unit
  channel stride and any row strides, all with the same (O, I); ``w`` (F,
  sum C_k) bf16 contiguous, its columns in operand order; ``bias`` (F,)
  fp32;
- ``chan_proj_dgrad(g, w, xs)``: ``[bf16(g @ w[:, cols_k])]`` from g (O,
  I, F), each laid out like ``xs[k]`` (``empty_like``: a dense view's
  strides, else contiguous), so a transposed operand's gradient is
  transposed back for free;
- ``chan_proj_wgrad(xs, g)``: ``(bf16(g^T x), sum g)``, dW (F, sum C_k)
  over all rows in fp32 (per-block partials and a second pass in a fixed
  order) and db (F,) in fp32.

``ops.linear.project`` sends every bf16 CUDA projection here and none to
the fp32 chain. The seam counts the launches of each op (:data:`OPS`) in
``build.LAUNCHES``. Each op carries a FLOP formula for
``torch.utils.flop_counter``.
"""

from __future__ import annotations

import math

import torch

from graph_wavenet_tpu_torch.ops.cuda import build

OPS = ("chan_proj", "chan_proj_dgrad", "chan_proj_wgrad")

# operands of one launch (the kernel's parameter arrays)
MAX_OPERANDS = 16


def _offsets(widths) -> list[int]:
    out, k = [], 0
    for c in widths:
        out.append(k)
        k += c
    return out


def w_cols(xs) -> int:
    return sum(x.shape[-1] for x in xs)


# ---------------------------------------------------------------------------
# plain versions (the CPU kernels, and what the CUDA kernel is held against)
# ---------------------------------------------------------------------------

def chan_proj_plain(xs: list[torch.Tensor], w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The forward in fp32 matmuls, summed in operand order, + bias, one
    cast to the operands' dtype."""
    h = None
    for x, k in zip(xs, _offsets(x.shape[-1] for x in xs)):
        p = torch.matmul(x.float(), w[:, k:k + x.shape[-1]].float().t())
        h = p if h is None else h + p
    return (h + bias.float()).to(xs[0].dtype)


def chan_proj_dgrad_plain(g: torch.Tensor, w: torch.Tensor,
                          xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each operand's input gradient ``g @ w[:, cols_k]`` in fp32, one
    cast, laid out like the operand."""
    out = []
    for x, k in zip(xs, _offsets(x.shape[-1] for x in xs)):
        t = torch.empty_like(x)
        t.copy_(torch.matmul(g.float(), w[:, k:k + x.shape[-1]].float()))
        out.append(t)
    return out


def chan_proj_wgrad_plain(xs: list[torch.Tensor], g: torch.Tensor):
    """(dW (F, sum C_k) in g's dtype, db (F,) fp32): fp32 sums over every
    row, dW cast once."""
    g2 = g.reshape(-1, g.shape[-1]).float()
    dw = torch.cat([g2.t() @ x.reshape(-1, x.shape[-1]).float()
                    for x in xs], dim=1)
    return dw.to(g.dtype), g2.sum(0)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

_forward_op = build.Op(
    "chan_proj", "(Tensor[] xs, Tensor w, Tensor bias) -> Tensor",
    chan_proj_plain)
_dgrad_op = build.Op(
    "chan_proj_dgrad", "(Tensor g, Tensor w, Tensor[] xs) -> Tensor[]",
    chan_proj_dgrad_plain)
_wgrad_op = build.Op(
    "chan_proj_wgrad", "(Tensor[] xs, Tensor g) -> (Tensor, Tensor)",
    chan_proj_wgrad_plain)


@_forward_op.fake
def _(xs, w, bias):
    return xs[0].new_empty(tuple(xs[0].shape[:2]) + (w.shape[0],))


@_dgrad_op.fake
def _(g, w, xs):
    return [torch.empty_like(x) for x in xs]


@_wgrad_op.fake
def _(xs, g):
    return (g.new_empty(tuple(g.shape[-1:]) + (w_cols(xs),)),
            g.new_empty(g.shape[-1:], dtype=torch.float32))


@_forward_op.flops
def _(xs, w, *args, out_shape=None, **kwargs) -> int:
    return 2 * xs[0][0] * xs[0][1] * sum(x[2] for x in xs) * w[0]


@_dgrad_op.flops
def _(g, w, *args, out_shape=None, **kwargs) -> int:
    return 2 * g[0] * g[1] * g[2] * w[1]


@_wgrad_op.flops
def _(xs, g, *args, out_shape=None, **kwargs) -> int:
    return 2 * g[0] * g[1] * g[2] * sum(x[2] for x in xs)


def _operand(x: torch.Tensor, koff: int) -> list[int]:
    return [x.data_ptr(), x.stride(0), x.stride(1), x.shape[2], koff]


def _check(xs, *others) -> None:
    for t in list(xs) + list(others):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the projection kernel takes bf16, got "
                            f"{t.dtype}")
        if t.ndim != 3 or t.stride(2) != 1:
            raise ValueError("operands must be (O, I, C) views with a unit "
                             "channel stride")
    if not 1 <= len(xs) <= MAX_OPERANDS:
        raise ValueError(f"1 to {MAX_OPERANDS} operands, got {len(xs)}")
    if any(x.shape[:2] != xs[0].shape[:2] for x in xs):
        raise ValueError("operands must share their (O, I) rows")


@_forward_op.cuda
def _(xs, w, bias):
    _check(xs)
    o, i = xs[0].shape[:2]
    f = w.shape[0]
    if not (w.dtype == torch.bfloat16 and w.is_contiguous()
            and w.shape[1] == w_cols(xs)):
        raise ValueError(f"w must be contiguous bf16 (F, {w_cols(xs)})")
    bias = bias.float().contiguous()
    out = xs[0].new_empty((o, i, f))
    if out.numel() == 0:
        return out
    desc = [len(xs), 1, o * i, i, f, w.shape[1], w.data_ptr(),
            bias.data_ptr()]
    for x, k in zip(xs, _offsets(x.shape[2] for x in xs)):
        desc += _operand(x, k)
    desc += [out.data_ptr(), i * f, f, 0, f]
    build.launch("chan_proj.cu", "gwt_chan_proj", desc, out.device,
                 "chan_proj")
    return out


@_dgrad_op.cuda
def _(g, w, xs):
    _check(xs, g)
    o, i, f = g.shape
    wt = w.t().contiguous()                     # (sum C_k, F)
    outs = [torch.empty_like(x) for x in xs]
    if o * i == 0:
        return outs
    desc = [1, len(xs), o * i, i, wt.shape[0], f, wt.data_ptr(), 0]
    desc += _operand(g, 0)
    for t, k in zip(outs, _offsets(x.shape[2] for x in xs)):
        desc += [t.data_ptr(), t.stride(0), t.stride(1), k, t.shape[2]]
    build.launch("chan_proj.cu", "gwt_chan_proj", desc, g.device,
                 "chan_proj_dgrad")
    return outs


def wgrad_plan(rows: int, f: int, ctot: int, sms: int) -> tuple[int, int]:
    """(WF, splits) of the weight gradient's first pass. Its (WF, 8192 /
    WF) tiles of (F, C + 1) take WF = 32, 64 or 128, the one that reads
    the fewest bytes (g once per column tile, x once per row tile), then
    the one that pads least; the rows split into about two blocks an SM,
    at least 256 rows each.
    Shapes and the card's SM count fix both, so the sums' order is
    fixed."""
    def tiles(wf):
        return math.ceil(f / wf), math.ceil((ctot + 1) / (8192 // wf))

    def cost(wf):
        tf, tc = tiles(wf)
        return tc * f + tf * ctot, tf * wf + tc * (8192 // wf)
    wf = min((32, 64, 128), key=cost)
    n = math.prod(tiles(wf))
    return wf, max(1, min(math.ceil(2 * sms / n), math.ceil(rows / 256),
                          65535))


@_wgrad_op.cuda
def _(xs, g):
    _check(xs, g)
    o, i, f = g.shape
    ctot = w_cols(xs)
    dw = g.new_empty((f, ctot))
    db = g.new_empty((f,), dtype=torch.float32)
    rows = o * i
    if rows == 0:
        return dw.zero_(), db.zero_()
    wf, n_split = wgrad_plan(rows, f, ctot, build.sms(g.device))
    part = torch.empty(n_split * f * (ctot + 1), dtype=torch.float32,
                       device=g.device)
    desc = [len(xs), rows, i, f, ctot, n_split, wf, g.data_ptr(),
            g.stride(0), g.stride(1), part.data_ptr(), dw.data_ptr(),
            db.data_ptr()]
    for x, k in zip(xs, _offsets(x.shape[2] for x in xs)):
        desc += _operand(x, k)
    build.launch("chan_proj.cu", "gwt_chan_proj_wgrad", desc, g.device,
                 "chan_proj_wgrad")
    return dw, db
