"""Diffusion graph convolution: dense supports and block-sparse ones.

Counterpart of ``graph_wavenet_tpu/ops/diffusion.py``. The diffusion step
:func:`nconv` is ``x[b,t,v,c] A[v,w] -> [b,t,w,c]``: it contracts the
support's *first* axis. The projection weight's row blocks follow the
reference concat order ``[x, s1 hop1, s1 hop2, ..., sS hop1, sS hop2]``; in
training the projected output takes inverted dropout.

Dense supports ((N, N), or (B, N, N) per sample) run one of three modes,
equal to accumulation rounding:

- ``fused``: ``h += hop_k @ W_k`` with the weight split per hop;
- ``concat``: the concatenated hops, then one matmul;
- ``stacked``: the power stack ``[A, ..., A^order]`` of each support
  (:func:`support_powers`, computed once per forward and passed as
  ``stacks``) makes all hops of a support in one wide contraction, then one
  (hop, channel) projection. A list that mixes sparse and dense supports
  runs ``fused``.

Every product casts its weight or support to the activation dtype and
accumulates in fp32 by an upcast of both operands (``ops.linear``'s
convention), then casts once. These products are plain ``torch.matmul`` and
``einsum``: the reference computes them outside any Pallas kernel.

Under dense node-TP a support is a rank's rows (any support with ``nconv``,
``parallel.dense_tp.ShardedDenseSupport``): its own ``nconv``, ``powers``
and ``hops`` give the rows' contractions summed over the model group, in
every mode.

All-sparse lists (every support has ``mix_2d``) take the reference's
``_gcn_apply_sparse``: the node axis moves to the front once for the whole
hop block, ``(B, T, N, C) -> (N, R)`` with ``R = B*T*C``; every hop is a
support's ``mix_2d`` (or both order-2 hops at once through a fused
support's ``mix2_2d``), projected in place and accumulated in fp32.

bf16 activations on a CUDA device project every hop (x included) in one
launch of the projection kernel (``ops.linear.project``), the bias added
in its epilogue: the dense modes without the concatenation, the stacked
mode from each power stack's hops, and the all-sparse path reading the
node-leading hops in place, its output already ``(B, T, N, F)``. Every
other dtype and device keeps the chains below.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from graph_wavenet_tpu_torch.ops.linear import (
    Linear,
    channel_matmul,
    project,
    takes_kernel,
)
from graph_wavenet_tpu_torch.ops.sparse import nconv_sparse

GCN_MODES = ("fused", "stacked", "concat")


class _Mlp(nn.Module):
    """Holds the projection as ``mlp`` so the state-dict path reads
    ``gconv.i.mlp.mlp.*`` like the reference's gcn -> linear -> Conv2d."""

    def __init__(self, lin: Linear):
        super().__init__()
        self.mlp = lin


class GCN(nn.Module):
    """Projection parameters over the concatenated hops:
    ``(order * n_supports + 1) * c_in -> c_out``."""

    def __init__(self, c_in: int, c_out: int, n_supports: int,
                 order: int = 2, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str = "cpu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.order = order
        self.mlp = _Mlp(Linear((order * n_supports + 1) * c_in, c_out,
                               generator=generator, device=device,
                               dtype=dtype))

    def forward(self, x: torch.Tensor, supports: list, *,
                drop: torch.Tensor | None = None, mode: str = "fused",
                stacks: list | None = None) -> torch.Tensor:
        """``drop``: a :func:`dropout_scale` mask drawn beforehand, applied
        in train mode only."""
        lin = self.mlp.mlp
        return gcn_apply(lin.weight, lin.bias, x, supports, self.order,
                         drop=drop if self.training else None, mode=mode,
                         stacks=stacks)


def dropout_scale(generator: torch.Generator | None, p: float, shape,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Inverted-dropout mask: {0, 1/(1-p)} in ``dtype``, an element kept
    where a uniform draw from ``generator`` is below 1 - p (the reference's
    ``bernoulli(1 - p)``). The divisor is 1 - p rounded to ``dtype`` and
    filled on the device: no host copy, so the step can be captured in a
    CUDA graph, and the mask is the one a host-made scalar gives."""
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - p
    return keep.to(dtype) / torch.full((), 1.0 - p, dtype=dtype,
                                       device=device)


def nconv(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One diffusion step over a shared dense support: x (B, T, N, C), A
    (N, N) -> (B, T, N, C), ``out[w] = sum_v x[v] A[v, w]``."""
    return torch.einsum("btvc,vw->btwc", x.float(),
                        a.to(x.dtype).float()).to(x.dtype)


def nconv_batched(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """One diffusion step over per-sample supports A (B, N, N)."""
    return torch.einsum("btvc,bvw->btwc", x.float(),
                        a.to(x.dtype).float()).to(x.dtype)


def _is_sparse(a) -> bool:
    return hasattr(a, "mix_2d")


def _is_sharded(a) -> bool:
    return hasattr(a, "nconv")


def is_dense(a) -> bool:
    """A dense support: a tensor, or a node-TP rank's rows of one."""
    return torch.is_tensor(a) or _is_sharded(a)


def diffusion_hops(x: torch.Tensor, supports: list,
                   order: int) -> list[torch.Tensor]:
    """``[x, A1 x, A1^2 x, ..., AS x, ..., AS^order x]`` in the reference
    concat order. A support is (N, N), batched (B, N, N), a node-TP rank's
    rows of either, or sparse (any support with ``mix_2d``, stepped by
    :func:`ops.sparse.nconv_sparse`)."""
    hops = [x]
    for a in supports:
        if _is_sharded(a):
            step = a.nconv
        elif _is_sparse(a):
            step = functools.partial(nconv_sparse, sp=a)
        else:
            step = functools.partial(nconv_batched if a.ndim == 3 else nconv,
                                     a=a)
        xk = x
        for _ in range(order):
            xk = step(xk)
            hops.append(xk)
    return hops


def support_powers(a: torch.Tensor, order: int) -> torch.Tensor:
    """``[A, A^2, ..., A^order]`` stacked on a hop axis: (N, N) ->
    (order, N, N), (B, N, N) -> (B, order, N, N), in the support's dtype; a
    node-TP rank's rows give its rows of each power."""
    if _is_sharded(a):
        return a.powers(order)
    powers = [a]
    for _ in range(order - 1):
        powers.append(powers[-1] @ a)
    return torch.stack(powers, dim=-3)


def _stacked_hops_project(x: torch.Tensor, pw: torch.Tensor,
                          wk: torch.Tensor, order: int) -> torch.Tensor:
    """All ``order`` hops of one support from its power stack ``pw`` in one
    contraction, projected with one (hop, channel) contraction by ``wk``
    (order*C, F), this support's rows in concat order. Returns fp32."""
    c_in, f = x.shape[-1], wk.shape[-1]
    hops = _stacked_hops(x, pw)
    wk = wk.reshape(order, c_in, f).to(x.dtype).float()
    return torch.einsum("btkwc,kcf->btwf", hops.float(), wk)


def _stacked_hops(x: torch.Tensor, pw) -> torch.Tensor:
    """All hops of one support from its power stack ``pw`` in one
    contraction: (B, T, order, N, C) in x's dtype."""
    if _is_sharded(pw):
        return pw.hops(x)
    pw = pw.to(x.dtype).float()
    eq = "btvc,bkvw->btkwc" if pw.ndim == 4 else "btvc,kvw->btkwc"
    return torch.einsum(eq, x.float(), pw).to(x.dtype)


def gcn_apply(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              supports: list, order: int = 2, *,
              drop: torch.Tensor | None = None, mode: str = "fused",
              stacks: list | None = None) -> torch.Tensor:
    """Diffusion conv: x (B, T, N, C) -> (B, T, N, F). weight (F,
    n_hops*C, 1, 1) in the reference Conv2d shape. ``mode``: the dense
    dataflow (``fused``, ``stacked`` or ``concat``); ``stacks``: the
    supports' :func:`support_powers`, precomputed for ``stacked``. ``drop``
    (a :func:`dropout_scale` mask, train mode only) multiplies the
    output."""
    if mode not in GCN_MODES:
        raise ValueError(f"mode must be one of {GCN_MODES}, got {mode!r}")
    c_in = x.shape[-1]
    w = weight[:, :, 0, 0].t()                     # (n_hops*C, F)
    n_hops = len(supports) * order + 1
    if w.shape[0] != n_hops * c_in:
        raise ValueError(
            f"gcn weight expects {w.shape[0] // c_in} hops, got {n_hops}: "
            "n_supports at init must match the supports list")
    sparse = bool(supports) and all(_is_sparse(s) for s in supports)
    if takes_kernel(x):
        h = _kernel_project(weight[:, :, 0, 0], bias, x, supports, order,
                            mode, stacks, sparse)
    elif sparse:
        b, t, n, _ = x.shape
        h = (_sparse_hops_project(w, x, supports, order)
             + bias.float()).to(x.dtype)                # (N, B*T, F)
        h = h.reshape(n, b, t, -1).permute(1, 2, 0, 3).contiguous()
    else:
        h = (_dense_hops_project(w, x, supports, order, mode, stacks)
             + bias.float()).to(x.dtype)
    if drop is not None:
        h = h * drop
    return h


def _dense_hops_project(w: torch.Tensor, x: torch.Tensor, supports: list,
                        order: int, mode: str,
                        stacks: list | None) -> torch.Tensor:
    """Dense or mixed supports in ``mode`` (``stacked`` falls back to
    ``fused`` when a support is sparse); returns the fp32 sum (B, T, N, F)
    before the bias."""
    c_in = x.shape[-1]
    if mode == "stacked" and not any(_is_sparse(s) for s in supports):
        if stacks is None:
            stacks = [support_powers(a, order) for a in supports]
        h = channel_matmul(x, w[:c_in])
        for s, pw in enumerate(stacks):
            lo = (1 + s * order) * c_in
            h = h + _stacked_hops_project(x, pw, w[lo:lo + order * c_in],
                                          order)
        return h
    hops = diffusion_hops(x, supports, order)
    if mode == "concat":
        return channel_matmul(torch.cat(hops, dim=-1), w)
    h = channel_matmul(hops[0], w[:c_in])
    for k in range(1, len(hops)):
        h = h + channel_matmul(hops[k], w[k * c_in:(k + 1) * c_in])
    return h


def _sparse_hops(x: torch.Tensor, supports: list, order: int):
    """The all-sparse path's hops in concat order, node-leading (N,
    B*T*C), one at a time: x, then each support's (both order-2 hops of a
    fused support from one ``mix2_2d``). A caller that projects each hop
    as it comes keeps the chain's order of operations."""
    b, t, n, c_in = x.shape
    xn = x.permute(2, 0, 1, 3).reshape(n, b * t * c_in)
    yield xn
    for sp in supports:
        if order == 2 and hasattr(sp, "mix2_2d"):
            yield from sp.mix2_2d(xn)
            continue
        xk = xn
        for _ in range(order):
            xk = sp.mix_2d(xk)
            yield xk


def _sparse_hops_project(w: torch.Tensor, x: torch.Tensor, supports: list,
                         order: int) -> torch.Tensor:
    """The all-sparse path: every hop node-leading, projected in place;
    returns the fp32 sum (N, B*T, F) before the bias."""
    b, t, n, c_in = x.shape
    h = None
    for k, xk in enumerate(_sparse_hops(x, supports, order)):
        p = channel_matmul(xk.reshape(n, b * t, c_in),
                           w[k * c_in:(k + 1) * c_in])
        h = p if h is None else h + p
    return h


def _kernel_project(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    supports: list, order: int, mode: str,
                    stacks: list | None, sparse: bool) -> torch.Tensor:
    """Every hop of x, x included, through one projection-kernel launch
    with the bias: w (F, n_hops*C). Returns bf16 (B, T, N, F)."""
    b, t, n, c_in = x.shape
    if sparse:
        # node-leading hops read as (B*T, N, C) views: the rows come out in
        # (B, T, N) order
        hops = [xk.reshape(n, b * t, c_in).transpose(0, 1)
                for xk in _sparse_hops(x, supports, order)]
        return project(hops, w, bias).reshape(b, t, n, -1)
    if mode == "stacked" and not any(_is_sparse(s) for s in supports):
        if stacks is None:
            stacks = [support_powers(a, order) for a in supports]
        hops = [x]
        for pw in stacks:
            hk = _stacked_hops(x, pw)
            hops += [hk[:, :, j] for j in range(order)]
    else:
        hops = diffusion_hops(x, supports, order)
    return project(hops, w, bias)


# ---------------------------------------------------------------------------
# DCRNN's diffusion convolution (models.dcrnn)
# ---------------------------------------------------------------------------
# DCRNN's released ``_gconv`` (github.com/liyaguang/DCRNN, model/
# dcrnn_cell.py) emits, for node-leading features z (N, R) and supports
# S_1..S_S, ``x0 = z``, then per support ``x1 = S x0`` and for k = 2..K
# ``x2 = 2 S x1 - x0; x1, x0 = x2, x1``, with x0 NOT reset between
# supports: support s + 1's chain starts from what support s left in x0.
# At K = 2 that is ``[z, S1 z, 2 S1 S1 z - z, S2 S1 z, 2 S2 S2 S1 z -
# S1 z]``. Two forms compute its projection:
#
# - ``dcrnn_features`` (any K): the features themselves, the recurrence's
#   combinations as elementwise passes in the activations' dtype;
# - ``dcrnn_pairs`` + ``dcrnn_fold`` (K = 2): every support's order-2 pair
#   ``(S a, S S a)`` in one call (kernel 3 on a fused flat support), its
#   start ``a`` support s - 1's first hop, and the combinations folded into
#   the projection's weight columns: ``(W0 - W2) a + W1 S a + 2 W2 S S a``
#   per support, the same function with no elementwise pass.

def dcrnn_hop(x2: torch.Tensor, a) -> torch.Tensor:
    """One diffusion step of node-leading (N, R) ``x2``, ``out[w] = sum_v
    x2[v] A[v, w]``: a dense (N, N) support in fp32 accumulation (cast
    once, as :func:`nconv`), or any support with ``mix_2d``."""
    if _is_sparse(a):
        return a.mix_2d(x2)
    return (a.to(x2.dtype).float().t() @ x2.float()).to(x2.dtype)


def _pair(x2: torch.Tensor, a):
    """``(S a, S S a)`` of node-leading (N, R): one ``mix2_2d`` call on a
    fused flat support, else two hops."""
    if hasattr(a, "mix2_2d"):
        return a.mix2_2d(x2)
    h1 = dcrnn_hop(x2, a)
    return h1, dcrnn_hop(h1, a)


def dcrnn_features(z2: torch.Tensor, supports: list,
                   order: int) -> list[torch.Tensor]:
    """DCRNN's ``1 + len(supports) * order`` diffusion features of
    node-leading (N, R) ``z2``, as its ``_gconv`` concatenates them."""
    x0 = z2
    out = [z2]
    for a in supports:
        x1 = dcrnn_hop(x0, a)
        out.append(x1)
        for _ in range(2, order + 1):
            x2 = 2.0 * dcrnn_hop(x1, a) - x0
            out.append(x2)
            x1, x0 = x2, x1
    return out


def dcrnn_pairs(z2: torch.Tensor, supports: list) -> list[torch.Tensor]:
    """The raw order-2 hops ``[z, S1 z, S1 S1 z, S2 S1 z, S2 S2 S1 z,
    ...]`` of node-leading (N, R) ``z2``: support s's pair starts from
    support s - 1's first hop (the carry), so the pairs run in turn."""
    out = [z2]
    a = z2
    for sp in supports:
        h1, h2 = _pair(a, sp)
        out += [h1, h2]
        a = h1
    return out


def dcrnn_fold(w: torch.Tensor, n_supports: int) -> torch.Tensor:
    """The projection weight ``(F, 1 + 2 S, C)`` over the K = 2 features
    (hop-major) refolded onto :func:`dcrnn_pairs`' raw hops: raw 0 takes
    ``W0 - W[f2 of support 0]``, support s's first hop ``W[f1_s] -
    W[f2_{s+1}]`` (its carry into the next support), its second ``2
    W[f2_s]``."""
    cols = []
    for k in range(1 + 2 * n_supports):
        s, second = (k - 1) // 2, (k - 1) % 2 == 1
        if k == 0:
            cols.append(w[:, 0] - w[:, 2])
        elif second:
            cols.append(2.0 * w[:, k])
        elif s + 1 < n_supports:
            cols.append(w[:, k] - w[:, k + 3])
        else:
            cols.append(w[:, k])
    return torch.stack(cols, dim=1)
