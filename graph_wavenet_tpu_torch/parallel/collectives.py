"""The collectives of the parallel layer (JAX takes them from ``lax``:
``psum``, ``all_gather``, ``psum_scatter``, ``ppermute``): the sum
all-reduce, the row all_gather and the row reduce-scatter (each
differentiable, the last two each other's transpose), the two-neighbour
exchange, the one-direction shift along a chain of ranks (differentiable;
time-halo sequence parallelism, ``parallel.halo``, and the pipeline's
hand-off from stage to stage, ``parallel.pipeline``) and the gradient
all-reduce.

Every function takes a process group, or None for a layout of one rank, in
which case it is the identity. The caller chooses the backend when it
creates the group: on a gloo group a CUDA tensor goes through a pinned host
buffer (gloo runs only some collectives on CUDA tensors), on an NCCL group
it stays on the card; nothing switches backend on a failure.

Inside a CUDA graph capture (the fused train and eval steps,
``train.step_graph``) every collective of a step is captured with it: on an
NCCL group they are. A gloo group cannot be captured, because it stages a
CUDA tensor through host memory; such a call during a capture raises
:class:`GlooCaptureError` instead of staging.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


class GlooCaptureError(RuntimeError):
    """A collective of a gloo group over CUDA tensors inside a CUDA graph
    capture: gloo stages the tensors through host memory, which a graph
    cannot capture."""


def _staged(t: torch.Tensor, group) -> bool:
    """True when ``t`` must go through the host: a CUDA tensor on gloo.
    Raises :class:`GlooCaptureError` when that happens during a capture."""
    staged = t.device.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged and torch.cuda.is_current_stream_capturing():
        raise GlooCaptureError(
            "a gloo collective over CUDA tensors stages them through host "
            "memory, which a CUDA graph cannot capture: capture the fused "
            "steps over an NCCL group (one rank per card), or run "
            "train_step / eval_step on gloo")
    return staged


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (the copy waits for the card)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if group is None:
        return t
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s value, in place."""
    if _staged(t, group):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


class _AllSum(torch.autograd.Function):
    """Sum all-reduce whose backward is a sum all-reduce of the cotangent:
    every rank uses the sum, so the gradient of a rank's summand is the sum
    of every rank's cotangent."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable."""
    if group is None:
        return t
    return _AllSum.apply(t, group)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    s = dist.get_world_size(group)
    x = x.contiguous()
    shape = (s * x.shape[0],) + tuple(x.shape[1:])
    if _staged(x, group):
        h = _host(x)
        out = torch.empty(shape, dtype=x.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, h, group=group)
        return out.to(x.device)
    out = x.new_empty(shape)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """(S * n, ...) -> (n, ...): this rank's block of the rows summed over
    the group. NCCL reduce-scatters; gloo all-reduces the whole and keeps
    the block (its groups are ranks that share a card, a check of the path
    rather than a measurement of it; ``all_reduce`` is in every version)."""
    s, me = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    n = x.shape[0] // s
    if dist.get_backend(group) == "gloo":
        return all_reduce_(x.clone(), group)[me * n:(me + 1) * n].clone()
    out = x.new_empty((n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """:func:`all_gather_rows`; its backward reduce-scatters the
    cotangent: every rank used all the rows, so a rank's rows take the sum
    of every rank's cotangent of them."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter_rows`; its backward all-gathers the
    cotangent: every rank's summand reaches every rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) on every rank -> (S * n, ...): the ranks' rows in group
    order (JAX ``all_gather(..., tiled=True)``), differentiable."""
    if group is None:
        return x
    return _AllGather.apply(x, group)


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(S * n, ...) on every rank -> (n, ...): the group's sum of the
    rank's block of rows, block m on the group's m-th rank (JAX
    ``psum_scatter(..., tiled=True)``), differentiable."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, group)


def neighbour_exchange(x: torch.Tensor, group, ranks) -> tuple:
    """``(prev, next)``: ``x`` of the previous and of the next rank of
    ``group``, with wrap-around (JAX: two ``ppermute``s). ``ranks``: the
    group's global ranks in group order. Sends carry tag 0 towards the
    next rank and tag 1 towards the previous one, so with two ranks (both
    neighbours the same peer) each receive takes the right message; NCCL
    matches them in the order posted, which is the same."""
    if group is None:
        return x, x
    s = len(ranks)
    me = dist.get_rank(group)
    nxt, prv = ranks[(me + 1) % s], ranks[(me - 1) % s]
    staged = _staged(x, group)
    src = _host(x) if staged else x.contiguous()

    def empty():
        return (torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                if staged else torch.empty_like(src))

    got_prev, got_next = empty(), empty()
    ops = [dist.P2POp(dist.isend, src, nxt, group, 0),
           dist.P2POp(dist.isend, src, prv, group, 1),
           dist.P2POp(dist.irecv, got_prev, prv, group, 0),
           dist.P2POp(dist.irecv, got_next, nxt, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        return got_prev.to(x.device), got_next.to(x.device)
    return got_prev, got_next


def _shift(x: torch.Tensor, group, ranks, step: int,
           wrap: bool) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` places further along ``ranks`` and
    return what the rank ``step`` places back sent (same shape and dtype);
    without ``wrap`` the ranks past an end send nothing and those before
    the start receive zeros."""
    s = len(ranks)
    me = dist.get_rank(group)
    to, frm = me + step, me - step
    if wrap:
        to, frm = to % s, frm % s
    staged = _staged(x, group)
    src = _host(x) if staged else x.contiguous()
    got = (torch.zeros(src.shape, dtype=src.dtype, pin_memory=True)
           if staged else torch.zeros_like(src))
    ops = []
    if 0 <= to < s:
        ops.append(dist.P2POp(dist.isend, src, ranks[to], group, 2))
    if 0 <= frm < s:
        ops.append(dist.P2POp(dist.irecv, got, ranks[frm], group, 2))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got.to(x.device) if staged else got


class _Shift(torch.autograd.Function):
    """:func:`shift`; its backward shifts the cotangent the other way, so
    a rank's tensor takes the cotangent of the copy it sent."""

    @staticmethod
    def forward(ctx, x, group, ranks, step, wrap):
        ctx.args = (group, ranks, step, wrap)
        return _shift(x, group, ranks, step, wrap)

    @staticmethod
    def backward(ctx, g):
        group, ranks, step, wrap = ctx.args
        return _shift(g, group, ranks, -step, wrap), None, None, None, None


def shift(x: torch.Tensor, group, ranks, step: int = 1,
          wrap: bool = False) -> torch.Tensor:
    """``x`` of the rank ``step`` places back along ``group`` (``ranks``:
    its global ranks in order), differentiable: one send and one receive a
    rank. Without ``wrap`` the first ``step`` ranks (for ``step`` > 0; the
    last for ``step`` < 0) get zeros; with it the chain is a ring (JAX's
    ``ppermute``). A group of one rank (None) gets ``x`` under ``wrap``,
    else zeros."""
    if group is None:
        return x if wrap else torch.zeros_like(x)
    return _Shift.apply(x, group, tuple(ranks), step, wrap)


def all_reduce_grads(params, group) -> None:
    """Sum every parameter's gradient over ``group`` through one flat
    buffer per dtype (parameters without a gradient are skipped: every rank
    runs the same graph, so they are the same ones)."""
    if group is None:
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
