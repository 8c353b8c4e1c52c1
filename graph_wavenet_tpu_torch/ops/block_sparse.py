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
the CPU. In this slice they are forward only: the backward kernels
(gathered_block_outer_flat, and kernel 3 with ``add`` over the transpose
tables) come with the training slice.

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
    row_pointer,
)

_NO_BACKWARD = (
    "block-sparse hops are forward-only in this port: the backward needs "
    "gathered_block_outer_flat (kernel 2) and the fused kernel with `add` "
    "over the transpose tables (kernel 3), queued in ROADMAP.md")


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

    def __post_init__(self):
        self.row_ptr = row_pointer(self.row_tbl, self.nb)

    @property
    def n_nodes(self) -> int:
        return self.nb * self.blocks_flat.shape[2]

    @property
    def block_size(self) -> int:
        return self.blocks_flat.shape[1]

    @property
    def n_live(self) -> int:
        """Live (nonzero) blocks, without the trailing zero block."""
        return self.blocks_flat.shape[0] - 1

    def _blocks_as(self, dtype: torch.dtype) -> torch.Tensor:
        b = self.blocks_flat
        return b if b.dtype == dtype else b.to(dtype)

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        """Node-leading (N, R) -> (N, R): one diffusion hop."""
        return _MixFlat.apply(x2, self)

    def astype(self, dtype: torch.dtype):
        """Copy with block values stored in ``dtype`` (tables shared).
        Under a matching activation dtype this is numerically free: every
        hop casts the blocks to the activation dtype anyway."""
        return dataclasses.replace(self, blocks_flat=self.blocks_flat.to(dtype))


class _MixFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, sp: FlatBlockSparseSupport):
        n, r = x2.shape
        bs_s, bs_d = sp.blocks_flat.shape[1], sp.blocks_flat.shape[2]
        if n % bs_s or n % bs_d or n // bs_d != sp.nb:
            raise ValueError(f"x has {n} nodes; the support has "
                             f"{sp.n_nodes} in blocks of {bs_s}x{bs_d}")
        out = gathered_block_mix_flat(
            sp._blocks_as(x2.dtype), sp.slot_tbl,
            x2.contiguous().reshape(n // bs_s, bs_s, r), sp.src_tbl,
            sp.row_tbl, nb=sp.nb, transpose_lhs=True, row_ptr=sp.row_ptr)
        return out.reshape(n, r)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_NO_BACKWARD)


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
    # rows by which the CUDA kernel runs hop 2 behind hop 1 (fused2_lag)
    lag: int = 0

    def mix2_2d(self, x2: torch.Tensor):
        """(N, R) -> ((N, R), (N, R)): hop and hop-of-hop in one pass."""
        return _MixFlat2.apply(x2, self)


class _MixFlat2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, sp: Fused2FlatSupport):
        n, r = x2.shape
        bs = sp.block_size
        if n != sp.n_nodes:
            raise ValueError(f"x has {n} nodes, the support {sp.n_nodes}")
        o1, o2 = gathered_block_mix_flat2(
            sp._blocks_as(x2.dtype), sp.slot_tbl,
            x2.contiguous().reshape(n // bs, bs, r), sp.src_tbl, sp.row_tbl,
            nb=sp.nb, lag=sp.lag, transpose_lhs=True, row_ptr=sp.row_ptr)
        return o1.reshape(n, r), o2.reshape(n, r)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(_NO_BACKWARD)


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
                                  sp.slot_t, sp.inv_slot, nb=sp.nb)


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
                             sp.inv_slot, nb=sp.nb, delay=d, ring_w=w,
                             delay_t=dt, ring_w_t=wt,
                             lag=fused2_lag(row, src))
