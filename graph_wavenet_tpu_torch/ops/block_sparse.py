"""Block-sparse diffusion supports: the padded and the flat form.

Counterpart of ``graph_wavenet_tpu/ops/block_sparse.py``. ``A[src, dst] =
weight`` and a hop is ``out[dst] += weight * x[src]`` (the ``nconv``
orientation). Hops run the CUDA kernels of ``ops.cuda.block_diffusion`` on a
CUDA device and their plain versions on the CPU, forward and backward, as
the reference's custom VJPs do.

**Padded form** (:class:`BlockSparseSupport`, :class:`PallasBlockSparseSupport`)::

    blocks    (NB, MB, BS, BS)  nonzero blocks, padded per block-row
    block_idx (NB, MB) int32    source block-row of each; NB = sentinel
    idx_t / perm_t (NB, MBt)    transpose table: dest block-row and flat
                                slot per t-edge; padding idx_t = the row
                                itself, perm_t = NB * MB (the zero block)

One hop is kernel 4 over ``(slot = i * MB + m, block_idx)``; its dx is
kernel 4 over ``(perm_t, idx_t)``; the blocks' cotangent is kernel 5. x and
the blocks reach the kernels unpadded, so the sentinels fall outside them
and are skipped. Both classes run these kernels (the reference's
``BlockSparseSupport`` runs an XLA gather-and-einsum, which is the plain
version here).

**Flat form** (:class:`FlatBlockSparseSupport`, the city-scale form): the
live nonzero blocks stored once, sorted by destination block-row, plus a
trailing all-zero block that dummy entries point at so every destination
row is visited::

    blocks_flat (L+1, BSs, BSd)  [L] = zero block
    row_tbl / src_tbl / slot_tbl (Lt,) int32: destination row, source
        x block-row and storage slot per entry, sorted by row
    row_t / src_t / slot_t: the same for the transpose (dx) orientation

- one hop (``mix_2d``): dx is kernel 1 over the transpose tables; the
  blocks' cotangent is kernel 2 (one fp32 outer product per forward-table
  entry), written straight into storage order (the reference's gather by
  ``inv_slot``) and the blocks' dtype;
- both order-2 hops (``mix2_2d``, fused supports): forward, one kernel-3
  launch or kernel 1 twice, as ``fused2_dispatch`` picks; the transpose
  chain ``g1_eff = g1 + mixT(g2); dx = mixT(g1_eff)`` is the same pair over
  the transpose tables with ``add = g1`` where the transpose band fuses
  (``delay_t > 0``), two kernel-1 launches otherwise; the blocks'
  cotangent is two kernel-2 launches, ``x (x) g1_eff`` and ``out1 (x)
  g2``.

The blocks are an input of the autograd functions, so a support whose
blocks require a gradient (the materialized adaptive adjacency) passes it
on; fixed supports' blocks do not, and their backward launches no kernel 2
or 5.

``nb`` (destination block-rows) is a Python int on a flat support, so a hop
never reads a table back from the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.ops.cuda.block_diffusion import (
    fused2_lag,
    fused2_schedule,
    gathered_block_mix,
    gathered_block_mix_flat,
    gathered_block_mix_flat2,
    gathered_block_outer,
    gathered_block_outer_flat,
    row_pointer,
)
from graph_wavenet_tpu_torch.ops.sparse import nconv_sparse


# ---------------------------------------------------------------------------
# padded form
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class BlockSparseSupport:
    """Nonzero blocks of a support matrix, padded per block-row to MB
    slots; hops via ``mix_2d``."""

    blocks: torch.Tensor      # (NB, MB, BS, BS)
    block_idx: torch.Tensor   # (NB, MB) int32; NB = zero-block sentinel
    idx_t: torch.Tensor       # (NB, MBt) int32: dest block-row per t-edge
    perm_t: torch.Tensor      # (NB, MBt) int32 into the NB*MB slots
    # storage slot of each (i, m) of the forward table: i * MB + m
    slot: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        nb, mb = self.block_idx.shape
        self.slot = torch.arange(nb * mb, dtype=torch.int32,
                                 device=self.block_idx.device).reshape(nb, mb)

    @property
    def n_nodes(self) -> int:
        return self.blocks.shape[0] * self.blocks.shape[2]

    @property
    def block_size(self) -> int:
        return self.blocks.shape[2]

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        """Node-leading (N, R) -> (N, R): one diffusion hop."""
        return _MixPadded.apply(x2, self.blocks, self)

    def astype(self, dtype: torch.dtype):
        """Copy with block values stored in ``dtype`` (tables shared).
        Under a matching activation dtype this is numerically free: every
        hop casts the blocks to the activation dtype anyway."""
        return dataclasses.replace(self, blocks=self.blocks.to(dtype))

    def to_dense(self) -> np.ndarray:
        """Dense (N, N) support with the same ``nconv`` semantics."""
        nb, mb, bs, _ = self.blocks.shape
        dense = np.zeros((nb * bs, nb * bs), np.float32)
        blocks = self.blocks.float().cpu().numpy()
        bidx = self.block_idx.cpu().numpy()
        for r in range(nb):
            for m in range(mb):
                s = bidx[r, m]
                if s < nb:
                    dense[s * bs:(s + 1) * bs, r * bs:(r + 1) * bs] += (
                        blocks[r, m])
        return dense


@dataclass(eq=False)
class PallasBlockSparseSupport(BlockSparseSupport):
    """The reference's name for a padded support whose hops run the
    gathered-block kernels; build with :func:`as_pallas`. In the port every
    padded support runs them (kernels 4 and 5 on the card)."""


class _MixPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, blocks, sp: BlockSparseSupport):
        n, r = x2.shape
        nb, mb, bs, _ = blocks.shape
        if n != nb * bs:
            raise ValueError(f"x has {n} nodes, the support {nb * bs}")
        x2 = x2.contiguous()
        ctx.sp = sp
        ctx.save_for_backward(x2, blocks)
        out = gathered_block_mix(
            blocks.to(x2.dtype).reshape(nb * mb, bs, bs), sp.slot,
            x2.reshape(nb, bs, r), sp.block_idx, transpose_lhs=True)
        return out.reshape(n, r)

    @staticmethod
    def backward(ctx, gout):
        x2, blocks = ctx.saved_tensors
        sp = ctx.sp
        n, r = x2.shape
        nb, mb, bs, _ = blocks.shape
        g = gout.to(x2.dtype).contiguous().reshape(nb, bs, r)
        dx = dblocks = None
        if ctx.needs_input_grad[0]:
            # dx[v] = sum over transposed edges: blocks[r, m] (contract the
            # destination axis) g[r]; perm_t's sentinel NB * MB lies outside
            # the unpadded blocks
            dx = gathered_block_mix(
                blocks.to(x2.dtype).reshape(nb * mb, bs, bs), sp.perm_t, g,
                sp.idx_t, transpose_lhs=False).reshape(n, r)
        if ctx.needs_input_grad[1]:
            dblocks = gathered_block_outer(x2.reshape(nb, bs, r), g,
                                           sp.block_idx,
                                           out_dtype=blocks.dtype)
        return dx, dblocks, None


def _finish(blocks: np.ndarray, bidx: np.ndarray,
            device: torch.device) -> BlockSparseSupport:
    """Derive the transpose block table (scatter-free backward)."""
    nb, mb = bidx.shape
    live = bidx.reshape(-1) < nb
    flat = np.arange(nb * mb, dtype=np.int64)
    targets = bidx.reshape(-1)                     # source block-row
    order = np.argsort(targets[live], kind="stable")
    tgt_sorted = targets[live][order]
    flat_sorted = flat[live][order]
    counts = np.bincount(tgt_sorted, minlength=nb)
    mbt = max(int(counts.max()) if counts.size else 0, 1)
    idx_t = np.tile(np.arange(nb, dtype=np.int64)[:, None], (1, mbt))
    perm_t = np.full((nb, mbt), nb * mb, dtype=np.int64)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(tgt_sorted), dtype=np.int64) - starts[tgt_sorted]
    idx_t[tgt_sorted, pos] = flat_sorted // mb     # dest block-row r
    perm_t[tgt_sorted, pos] = flat_sorted

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return BlockSparseSupport(torch.as_tensor(blocks, device=device),
                              i32(bidx), i32(idx_t), i32(perm_t))


def from_dense(a: np.ndarray, block_size: int = 128, *,
               device: torch.device | str = "cuda") -> BlockSparseSupport:
    """Partition a dense support into blocks and keep the nonzero ones. N
    must divide by ``block_size`` (zero rows and columns are inert)."""
    device = resolve_device(device)
    a = np.asarray(a, np.float32)
    n = a.shape[0]
    if n % block_size:
        raise ValueError(f"N={n} must divide by block_size={block_size}; "
                         "zero-pad the support first (zero rows are inert)")
    nb = n // block_size
    # block (s, r): rows of source block s, columns of dest block-row r
    tiles = a.reshape(nb, block_size, nb, block_size)
    nz = np.abs(tiles).sum((1, 3)).T != 0          # (dest r, src s)
    mb = max(int(nz.sum(1).max()), 1)
    blocks = np.zeros((nb, mb, block_size, block_size), np.float32)
    bidx = np.full((nb, mb), nb, np.int64)
    for r in range(nb):
        for m, s in enumerate(np.nonzero(nz[r])[0]):
            blocks[r, m] = tiles[s, :, r, :]
            bidx[r, m] = s
    return _finish(blocks, bidx, device)


def from_edges_blocked(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                       n_nodes: int, block_size: int = 128,
                       perm: np.ndarray | None = None, *,
                       device: torch.device | str = "cuda"
                       ) -> BlockSparseSupport:
    """Build straight from an edge list: O(E) memory, no dense
    intermediate. Edge (src -> dst, weight): ``A[src, dst] = weight``
    (duplicates accumulate). ``perm``: node reordering applied first
    (``new = perm[old]``). N is zero-padded up to a multiple of
    ``block_size``. Tables equal the reference builder's."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    if perm is not None:
        perm = np.asarray(perm, np.int64)
        src, dst = perm[src], perm[dst]
    n_pad = -(-n_nodes // block_size) * block_size
    nb = n_pad // block_size
    sb, db = src // block_size, dst // block_size
    pair = db * nb + sb                             # dest-major block pair
    uniq, inv = np.unique(pair, return_inverse=True)
    u_db, u_sb = uniq // nb, uniq % nb
    counts = np.bincount(u_db, minlength=nb)
    mb = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_of_uniq = np.arange(len(uniq), dtype=np.int64) - starts[u_db]
    bidx = np.full((nb, mb), nb, np.int64)
    bidx[u_db, slot_of_uniq] = u_sb
    blocks = np.zeros((nb, mb, block_size, block_size), np.float32)
    np.add.at(blocks,
              (db, slot_of_uniq[inv], src % block_size, dst % block_size),
              weight)
    return _finish(blocks, bidx, device)


def random_block_support(n_blocks: int, blocks_per_row: int,
                         block_size: int = 128,
                         rng: np.random.Generator | None = None, *,
                         device: torch.device | str = "cuda"
                         ) -> BlockSparseSupport:
    """Synthetic clustered support built in block form: each block-row gets
    its own diagonal block plus ``blocks_per_row - 1`` random others;
    columns are normalized within the materialized blocks. The same ``rng``
    gives the reference builder's support."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng()
    mb = min(blocks_per_row, n_blocks)
    bidx = np.zeros((n_blocks, mb), np.int64)
    blocks = rng.random((n_blocks, mb, block_size, block_size)).astype(
        np.float32)
    for r in range(n_blocks):
        pool = np.delete(np.arange(n_blocks), r)
        others = (rng.choice(pool, size=mb - 1, replace=False) if mb > 1
                  else np.empty(0, np.int64))
        bidx[r] = np.concatenate([[r], others])[:mb]
    blocks = blocks / blocks.sum((1, 2), keepdims=True)
    return _finish(blocks, bidx, device)


def as_pallas(sp: BlockSparseSupport) -> PallasBlockSparseSupport:
    """Rewrap a padded support under the reference's kernel-backed class."""
    return PallasBlockSparseSupport(sp.blocks, sp.block_idx, sp.idx_t,
                                    sp.perm_t)


def nconv_block_sparse(x: torch.Tensor, sp) -> torch.Tensor:
    """Block-sparse diffusion step, same contract as ``nconv``: x (B, T, N,
    C) -> (B, T, N, C). Alias of :func:`ops.sparse.nconv_sparse`, which
    takes any support with ``mix_2d``."""
    return nconv_sparse(x, sp)


# ---------------------------------------------------------------------------
# flat form
# ---------------------------------------------------------------------------

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

    @property
    def device(self) -> torch.device:
        return self.blocks_flat.device

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        """Node-leading (N, R) -> (N, R): one diffusion hop."""
        return _MixFlat.apply(x2, self.blocks_flat, self)

    def astype(self, dtype: torch.dtype):
        """Copy with block values stored in ``dtype`` (tables shared).
        Under a matching activation dtype this is numerically free: every
        hop casts the blocks to the activation dtype anyway."""
        return dataclasses.replace(self, blocks_flat=self.blocks_flat.to(dtype))


def _outer(sp: FlatBlockSparseSupport, xb: torch.Tensor, gb: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """The blocks' cotangent (L+1, BSs, BSd) in ``dtype``: kernel 2 over the
    forward table, each entry's product written to its storage slot. Each
    live slot appears once in the table; the dummy entries belong to the
    shared trailing zero block, whose gradient is pinned to zero."""
    return gathered_block_outer_flat(
        xb, gb, sp.src_tbl, sp.row_tbl, slot=sp.slot_tbl,
        n_slots=sp.blocks_flat.shape[0], out_dtype=dtype)


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
            dblocks = _outer(sp, x2.reshape(n // bs_s, bs_s, r),
                             g.reshape(sp.nb, bs_d, r), blocks.dtype)
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
        """(N, R) -> ((N, R), (N, R)): hop and hop-of-hop, kernel 3 or two
        kernel-1 launches as ``fused2_dispatch`` picks for R and dtype."""
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
        # two launches, one per cotangent: summing both products in one
        # accumulator would round otherwise than the unfused support's two
        # hops, whose gradients these equal bit for bit
        if ctx.needs_input_grad[1]:
            d2 = _outer(sp, o1.reshape(shape), g2.reshape(shape),
                        blocks.dtype)
        if ctx.needs_input_grad[2]:
            d1 = _outer(sp, x2.reshape(shape), g1_eff.reshape(shape),
                        blocks.dtype)
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


def _flat_support(blocks_flat: torch.Tensor, dst: np.ndarray, src: np.ndarray,
                  n_dst: int, n_src: int) -> FlatBlockSparseSupport:
    """A flat support from its storage (``blocks_flat``, the zero block
    last) and the destination and source block-row of each live block in
    storage order (sorted by destination): the forward and transpose tables
    with their dummy entries, and ``inv_slot``."""
    n_live = len(dst)
    slots = np.arange(n_live, dtype=np.int64)
    row, srct, slot = _with_dummies(dst, src, slots, n_dst, n_live)
    inv_slot = np.zeros(n_live + 1, np.int64)
    inv_slot[slot] = np.arange(len(slot), dtype=np.int64)
    inv_slot[n_live] = len(slot)
    order_t = np.argsort(src, kind="stable")
    row_t, src_t, slot_t = _with_dummies(src[order_t], dst[order_t],
                                         slots[order_t], n_src, n_live)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32),
                               device=blocks_flat.device)

    return FlatBlockSparseSupport(
        blocks_flat, i32(row), i32(srct), i32(slot), i32(row_t), i32(src_t),
        i32(slot_t), i32(inv_slot), nb=n_dst)


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
    n_live = len(uniq)
    blocks_flat = np.zeros((n_live + 1, bs_src, bs_dst), np.float32)
    np.add.at(blocks_flat, (inv, src % bs_src, dst % bs_dst), weight)
    return _flat_support(torch.as_tensor(blocks_flat, device=device),
                         uniq // nbs, uniq % nbs, nbd, nbs)


def as_flat_pallas(sp: BlockSparseSupport) -> FlatBlockSparseSupport:
    """The flat live-block form of a padded support, on its device and in
    its storage dtype: the live slots in row-major order, so every row's
    entries keep their padded order. Tables equal the reference's."""
    bidx = sp.block_idx.cpu().numpy().astype(np.int64)
    nb = bidx.shape[0]
    rr, mm = np.nonzero(bidx < nb)                 # row-major => row-sorted
    live = sp.blocks[torch.as_tensor(rr, device=sp.device),
                     torch.as_tensor(mm, device=sp.device)]
    blocks_flat = torch.cat([live, live.new_zeros((1,) + live.shape[1:])])
    return _flat_support(blocks_flat, rr, bidx[rr, mm], nb, nb)


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
