"""Flat block-sparse diffusion supports (the city-scale form).

Counterpart of the flat half of ``graph_wavenet_tpu/ops/block_sparse.py``.
A support stores its live nonzero blocks once, sorted by destination
block-row, plus a trailing all-zero block that dummy entries point at so
every destination row is visited:

    blocks_flat (L+1, BSs, BSd)  [L] = zero block
    row_tbl / src_tbl / slot_tbl (Lt,) int32: destination row, source
        x block-row and storage slot per entry, sorted by row
    row_t / src_t / slot_t: the same for the transpose (dx) orientation

``A[src, dst] = weight`` and a hop is ``out[dst] += weight * x[src]`` (the
``nconv`` orientation). Hops run the CUDA kernels of
``ops.cuda.block_diffusion`` on a CUDA device and their plain versions on
the CPU, forward and backward, as the reference's custom VJPs do:

- one hop (``mix_2d``): dx is kernel 1 over the transpose tables; the
  blocks' cotangent is kernel 2 (one fp32 outer product per forward-table
  entry) gathered into storage order by ``inv_slot``;
- both order-2 hops (``mix2_2d``, fused supports): the transpose chain
  ``g1_eff = g1 + mixT(g2); dx = mixT(g1_eff)`` is one kernel-3 launch over
  the transpose tables with ``add = g1`` where the transpose band fuses
  (``delay_t > 0``), two kernel-1 launches otherwise; the blocks' cotangent
  is two kernel-2 launches, ``x (x) g1_eff`` and ``out1 (x) g2``.

The blocks are an input of the autograd functions, so a support whose
blocks require a gradient (the materialized adaptive adjacency) passes it
on; fixed supports' blocks do not, and their backward launches no kernel 2.

``nb`` (destination block-rows) is a Python int on the support, so a hop
never reads a table back from the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.ops.cuda.block_diffusion import (
    fused2_lag,
    fused2_schedule,
    gathered_block_mix_flat,
    gathered_block_mix_flat2,
    gathered_block_outer_flat,
    row_pointer,
)


@dataclass(eq=False)
class FlatBlockSparseSupport:
    """Live nonzero blocks stored once, row-sorted; hops via ``mix_2d``."""

    blocks_flat: torch.Tensor   # (L+1, BSs, BSd), [L] = zero block
    row_tbl: torch.Tensor       # (Lt,) int32 dest block-row, sorted
    src_tbl: torch.Tensor       # (Lt,) int32 source x block-row
    slot_tbl: torch.Tensor      # (Lt,) int32 into blocks_flat
    row_t: torch.Tensor         # (Lt2,) int32 x block-row (dx out), sorted
    src_t: torch.Tensor         # (Lt2,) int32 dest block-row (g source)
    slot_t: torch.Tensor        # (Lt2,) int32 into blocks_flat
    inv_slot: torch.Tensor      # (L+1,) int32 fwd-table position of slot s
    nb: int                     # destination block-rows
    # CSR row pointers of row_tbl / row_t, built here when not given
    row_ptr: torch.Tensor | None = None
    row_ptr_t: torch.Tensor | None = None

    def __post_init__(self):
        if self.row_ptr is None:
            self.row_ptr = row_pointer(self.row_tbl, self.nb)
        if self.row_ptr_t is None:
            self.row_ptr_t = row_pointer(self.row_t, self.nb_t)

    @property
    def n_nodes(self) -> int:
        return self.nb * self.blocks_flat.shape[2]

    @property
    def nb_t(self) -> int:
        """Source block-rows: the destination rows of the transpose (dx)
        tables."""
        return self.n_nodes // self.blocks_flat.shape[1]

    @property
    def block_size(self) -> int:
        return self.blocks_flat.shape[1]

    @property
    def n_live(self) -> int:
        """Live (nonzero) blocks, without the trailing zero block."""
        return self.blocks_flat.shape[0] - 1

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        """Node-leading (N, R) -> (N, R): one diffusion hop."""
        return _MixFlat.apply(x2, self.blocks_flat, self)

    def astype(self, dtype: torch.dtype):
        """Copy with block values stored in ``dtype`` (tables shared).
        Under a matching activation dtype this is numerically free: every
        hop casts the blocks to the activation dtype anyway."""
        return dataclasses.replace(self, blocks_flat=self.blocks_flat.to(dtype))


def _outer(sp: FlatBlockSparseSupport, xb: torch.Tensor,
           gb: torch.Tensor) -> torch.Tensor:
    """Kernel 2 over the forward table: (Lt, BSs, BSd) fp32."""
    return gathered_block_outer_flat(xb, gb, sp.src_tbl, sp.row_tbl)


def _to_storage(sp: FlatBlockSparseSupport, dflat: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Per-entry cotangents -> storage order: each live slot appears once
    in the forward table, so this is a gather by ``inv_slot``. Dummy
    entries belong to the shared trailing zero block, whose gradient is
    pinned to zero: ``inv_slot``'s sentinel points at a zero pad row."""
    pad = dflat.new_zeros((1,) + dflat.shape[1:])
    return torch.cat([dflat, pad]).index_select(
        0, sp.inv_slot.long()).to(dtype)


def _mix_t(sp: FlatBlockSparseSupport, blocks: torch.Tensor,
           g: torch.Tensor, r: int) -> torch.Tensor:
    """dx of one hop: kernel 1 over the transpose tables, contracting the
    block's destination axis with g (N, R) -> (N, R)."""
    bs_s, bs_d = blocks.shape[1], blocks.shape[2]
    out = gathered_block_mix_flat(
        blocks, sp.slot_t, g.reshape(sp.nb, bs_d, r), sp.src_t, sp.row_t,
        nb=sp.nb_t, transpose_lhs=False, row_ptr=sp.row_ptr_t)
    return out.reshape(sp.nb_t * bs_s, r)


class _MixFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, blocks, sp: FlatBlockSparseSupport):
        n, r = x2.shape
        bs_s, bs_d = blocks.shape[1], blocks.shape[2]
        if n % bs_s or n % bs_d or n // bs_d != sp.nb:
            raise ValueError(f"x has {n} nodes; the support has "
                             f"{sp.n_nodes} in blocks of {bs_s}x{bs_d}")
        x2 = x2.contiguous()
        ctx.sp = sp
        ctx.save_for_backward(x2, blocks)
        out = gathered_block_mix_flat(
            blocks.to(x2.dtype), sp.slot_tbl, x2.reshape(n // bs_s, bs_s, r),
            sp.src_tbl, sp.row_tbl, nb=sp.nb, transpose_lhs=True,
            row_ptr=sp.row_ptr)
        return out.reshape(n, r)

    @staticmethod
    def backward(ctx, gout):
        x2, blocks = ctx.saved_tensors
        sp = ctx.sp
        n, r = x2.shape
        g = gout.to(x2.dtype).contiguous()
        dx = dblocks = None
        if ctx.needs_input_grad[0]:
            dx = _mix_t(sp, blocks.to(x2.dtype), g, r)
        if ctx.needs_input_grad[1]:
            bs_s, bs_d = blocks.shape[1], blocks.shape[2]
            dflat = _outer(sp, x2.reshape(n // bs_s, bs_s, r),
                           g.reshape(sp.nb, bs_d, r))
            dblocks = _to_storage(sp, dflat, blocks.dtype)
        return dx, dblocks, None


@dataclass(eq=False)
class Fused2FlatSupport(FlatBlockSparseSupport):
    """A flat support whose order-2 hop chain (``mix2_2d``) runs the fused
    kernel; single hops (``mix_2d``) are inherited. Build with
    :func:`as_fused2`; only banded (ordered) layouts with square blocks
    qualify."""

    # the reference's schedule (which layouts fuse), kept for parity
    delay: int = 1
    ring_w: int = 1
    # transpose-table schedule for the fused backward chain; 0 = the
    # transpose band does not qualify
    delay_t: int = 0
    ring_w_t: int = 0
    # rows by which the CUDA kernel runs hop 2 behind hop 1 (fused2_lag),
    # over the forward and over the transpose tables
    lag: int = 0
    lag_t: int = 0

    def mix2_2d(self, x2: torch.Tensor):
        """(N, R) -> ((N, R), (N, R)): hop and hop-of-hop in one pass."""
        # the blocks enter twice, hop 2's cotangent first, so that autograd
        # sums the two in the order two chained mix_2d hops deliver them
        # and the gradients equal the unfused support's bit for bit
        return _MixFlat2.apply(x2, self.blocks_flat, self.blocks_flat, self)


class _MixFlat2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, blocks, blocks_again, sp: Fused2FlatSupport):
        n, r = x2.shape
        bs = sp.block_size
        if n != sp.n_nodes:
            raise ValueError(f"x has {n} nodes, the support {sp.n_nodes}")
        x2 = x2.contiguous()
        o1, o2 = gathered_block_mix_flat2(
            blocks.to(x2.dtype), sp.slot_tbl, x2.reshape(n // bs, bs, r),
            sp.src_tbl, sp.row_tbl, nb=sp.nb, lag=sp.lag,
            transpose_lhs=True, row_ptr=sp.row_ptr)
        o1, o2 = o1.reshape(n, r), o2.reshape(n, r)
        ctx.sp = sp
        ctx.save_for_backward(x2, o1, blocks)
        return o1, o2

    @staticmethod
    def backward(ctx, g1, g2):
        x2, o1, blocks = ctx.saved_tensors
        sp = ctx.sp
        n, r = x2.shape
        bs = blocks.shape[1]
        dt = x2.dtype
        g1 = g1.to(dt).contiguous()
        g2 = g2.to(dt).contiguous()
        bf = blocks.to(dt)
        if sp.delay_t > 0:
            ge, dxb = gathered_block_mix_flat2(
                bf, sp.slot_t, g2.reshape(sp.nb, bs, r), sp.src_t, sp.row_t,
                nb=sp.nb, lag=sp.lag_t, transpose_lhs=False,
                add=g1.reshape(sp.nb, bs, r), row_ptr=sp.row_ptr_t)
            g1_eff, dx = ge.reshape(n, r), dxb.reshape(n, r)
        else:
            g1_eff = g1 + _mix_t(sp, bf, g2, r)
            dx = _mix_t(sp, bf, g1_eff, r)
        d2 = d1 = None
        shape = (sp.nb, bs, r)
        if ctx.needs_input_grad[1]:
            d2 = _to_storage(sp, _outer(sp, o1.reshape(shape),
                                        g2.reshape(shape)), blocks.dtype)
        if ctx.needs_input_grad[2]:
            d1 = _to_storage(sp, _outer(sp, x2.reshape(shape),
                                        g1_eff.reshape(shape)), blocks.dtype)
        return dx, d2, d1, None


def _with_dummies(row, src, slot, n_rows: int, zero_slot: int):
    """Append a zero-block entry for every row with no entry, re-sorted."""
    empty = np.setdiff1d(np.arange(n_rows), row)
    if len(empty):
        row = np.concatenate([row, empty])
        src = np.concatenate([src, np.zeros(len(empty), np.int64)])
        slot = np.concatenate([slot,
                               np.full(len(empty), zero_slot, np.int64)])
        order = np.argsort(row, kind="stable")
        row, src, slot = row[order], src[order], slot[order]
    return row, src, slot


def from_edges_flat(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                    n_nodes: int, bs_src: int = 128, bs_dst: int = 512,
                    perm: np.ndarray | None = None, *,
                    device: torch.device | str = "cuda"
                    ) -> FlatBlockSparseSupport:
    """Build the flat form straight from an edge list, with optionally
    rectangular blocks (``bs_src`` x ``bs_dst``). Edge (src -> dst,
    weight): ``A[src, dst] = weight`` (duplicates accumulate). ``n_nodes``
    must divide by both block sizes. ``perm``: node reordering applied
    first (``new = perm[old]``). Tables equal the reference builder's."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        src, dst = perm[src], perm[dst]
    if n_nodes % bs_src or n_nodes % bs_dst:
        raise ValueError(
            f"N={n_nodes} must divide by both block sizes ({bs_src}, "
            f"{bs_dst}); zero-pad the graph first (zero rows are inert)")
    nbs = n_nodes // bs_src
    nbd = n_nodes // bs_dst
    sb, gd = src // bs_src, dst // bs_dst
    pair = gd * nbs + sb                            # dest-major
    uniq, inv = np.unique(pair, return_inverse=True)
    u_gd, u_sb = uniq // nbs, uniq % nbs
    n_live = len(uniq)
    blocks_flat = np.zeros((n_live + 1, bs_src, bs_dst), np.float32)
    np.add.at(blocks_flat, (inv, src % bs_src, dst % bs_dst), weight)

    row, srct, slot = _with_dummies(u_gd, u_sb,
                                    np.arange(n_live, dtype=np.int64),
                                    nbd, n_live)
    inv_slot = np.zeros(n_live + 1, np.int64)
    inv_slot[slot] = np.arange(len(slot), dtype=np.int64)
    inv_slot[n_live] = len(slot)

    order_t = np.argsort(u_sb, kind="stable")
    row_t, src_t, slot_t = _with_dummies(
        u_sb[order_t], u_gd[order_t],
        np.arange(n_live, dtype=np.int64)[order_t], nbs, n_live)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return FlatBlockSparseSupport(
        torch.as_tensor(blocks_flat, device=device), i32(row), i32(srct),
        i32(slot), i32(row_t), i32(src_t), i32(slot_t), i32(inv_slot),
        nb=nbd)


def as_unfused(sp: FlatBlockSparseSupport) -> FlatBlockSparseSupport:
    """Downgrade a fused support to the plain two-call chain (bit-identical
    results either way)."""
    if not isinstance(sp, Fused2FlatSupport):
        return sp
    return FlatBlockSparseSupport(sp.blocks_flat, sp.row_tbl, sp.src_tbl,
                                  sp.slot_tbl, sp.row_t, sp.src_t,
                                  sp.slot_t, sp.inv_slot, nb=sp.nb,
                                  row_ptr=sp.row_ptr, row_ptr_t=sp.row_ptr_t)


def as_fused2(sp: FlatBlockSparseSupport,
              max_ring: int = 24) -> FlatBlockSparseSupport:
    """Upgrade a flat support to the fused order-2 kernel when its layout
    qualifies (banded under the node ordering; square blocks); returns
    the support unchanged otherwise. ``max_ring`` keeps the reference's
    qualification rule, so both packages fuse the same layouts."""
    if isinstance(sp, Fused2FlatSupport):
        return sp
    if sp.blocks_flat.shape[1] != sp.blocks_flat.shape[2]:
        return sp
    row = sp.row_tbl.cpu().numpy()
    src = sp.src_tbl.cpu().numpy()
    sched = fused2_schedule(row, src, sp.nb, max_ring=max_ring)
    if sched is None:
        return sp
    d, w = sched
    sched_t = fused2_schedule(sp.row_t.cpu().numpy(),
                              sp.src_t.cpu().numpy(), sp.nb,
                              max_ring=max_ring)
    dt, wt = sched_t if sched_t is not None else (0, 0)
    return Fused2FlatSupport(sp.blocks_flat, sp.row_tbl, sp.src_tbl,
                             sp.slot_tbl, sp.row_t, sp.src_t, sp.slot_t,
                             sp.inv_slot, nb=sp.nb, row_ptr=sp.row_ptr,
                             row_ptr_t=sp.row_ptr_t, delay=d, ring_w=w,
                             delay_t=dt, ring_w_t=wt,
                             lag=fused2_lag(row, src),
                             lag_t=fused2_lag(sp.row_t.cpu().numpy(),
                                              sp.src_t.cpu().numpy()))
