"""Block-masked adaptive adjacency: the learned graph at city scale.

Counterpart of ``graph_wavenet_tpu/ops/adaptive_block.py``. The reference
model appends ``softmax(relu(nodevec1 @ nodevec2), dim=1)`` to the supports
every forward; at 40,960 nodes that dense (N, N) matrix cannot exist. Here
it is computed only on the live blocks of a flat block-sparse mask
(:class:`BlockAdaptiveMask`, usually the union of the fixed supports' live
patterns plus the diagonal):

- gather the per-block nodevec tiles ``E1[src-block] (BS, r)`` and
  ``E2[:, dst-block] (r, BS)``;
- per-block logits ``relu(E1_tile @ E2_tile)``, fp32-accumulated;
- a row softmax over the live entries of each global source row, through
  segment reductions keyed by source block-row.

Every segment reduction is a gather through a padded table of each
segment's live blocks (built on the host with the mask, a zero or -inf
sentinel for the short rows) and a sum or max over the table's columns,
and the gathers of the embedding tiles by repeated block indices
(:func:`gather_rows`) take that segment sum as their backward. So nothing
accumulates with atomics, forward or backward, and a training step with
the mask repeats bit for bit on the card, as the JAX step is a function of
its inputs (``index_add_`` and ``index_select``'s backward add in whatever
order the card's atomics land).

Under a full mask this is the dense adaptive adjacency exactly; under a
partial mask it is the softmax over the representable edge set. The
materialized support is an ordinary flat support, so it runs the hop
kernels unchanged, and its gradient reaches the nodevecs through the hops'
blocks cotangent (kernel 2) and then ordinary autograd. This module is
plain PyTorch: the reference computes it in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graph_wavenet_tpu_torch.ops.block_sparse import (
    BlockSparseSupport,
    FlatBlockSparseSupport,
    Fused2FlatSupport,
    from_edges_flat,
)
from graph_wavenet_tpu_torch.ops.cuda.block_diffusion import (
    fused2_lag,
    fused2_schedule,
)


@dataclass(eq=False)
class BlockAdaptiveMask:
    """Static live-block pattern and every table of the flat support it
    materializes (block values are the only thing computed per forward),
    plus the storage-order live-block coordinates the materialization
    gathers nodevec tiles with. Not a support itself: it has no
    ``mix_2d``, and the model materializes it only under ``addaptadj``."""

    # duck-type marker the model looks for
    adaptive_mask = True

    # tables of the materialized support (int32, on the device)
    row_tbl: torch.Tensor
    src_tbl: torch.Tensor
    slot_tbl: torch.Tensor
    row_t: torch.Tensor
    src_t: torch.Tensor
    slot_t: torch.Tensor
    inv_slot: torch.Tensor
    row_ptr: torch.Tensor
    row_ptr_t: torch.Tensor
    # storage-order live-block coordinates (slot i -> dst/src block-row)
    live_dst: torch.Tensor      # (L,) int64
    live_src: torch.Tensor      # (L,) int64
    # the live slots of each source (destination) block-row in storage
    # order, padded with the sentinel L: (n_src_blocks, max) int64
    seg_src: torch.Tensor
    seg_dst: torch.Tensor
    bs_src: int
    bs_dst: int
    n_src_blocks: int
    n_dst_blocks: int
    # (delay, ring_w, delay_t, ring_w_t) when the pattern qualifies for the
    # fused order-2 kernel (the reference's schedule), else None
    fuse2: tuple | None = None
    lag: int = 0
    lag_t: int = 0

    @property
    def n_live(self) -> int:
        return self.live_dst.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.n_src_blocks * self.bs_src

    def materialize(self, nodevec1: torch.Tensor, nodevec2: torch.Tensor,
                    out_dtype: torch.dtype | None = None
                    ) -> FlatBlockSparseSupport:
        """Adaptive support for the current embeddings, differentiable in
        both. nodevec1 (N, r), nodevec2 (r, N). ``out_dtype``: storage dtype
        of the blocks; the softmax runs in the nodevecs' dtype and the cast
        at the exit is the one every hop would apply per use."""
        blocks = adaptive_blocks(self, nodevec1, nodevec2)
        if out_dtype is not None:
            blocks = blocks.to(out_dtype)
        blocks_flat = torch.cat(
            [blocks, blocks.new_zeros((1, self.bs_src, self.bs_dst))])
        tables = (blocks_flat, self.row_tbl, self.src_tbl, self.slot_tbl,
                  self.row_t, self.src_t, self.slot_t, self.inv_slot)
        kw = dict(nb=self.n_dst_blocks, row_ptr=self.row_ptr,
                  row_ptr_t=self.row_ptr_t)
        if self.fuse2 is not None:
            d, w, dt, wt = self.fuse2
            return Fused2FlatSupport(*tables, **kw, delay=d, ring_w=w,
                                     delay_t=dt, ring_w_t=wt, lag=self.lag,
                                     lag_t=self.lag_t)
        return FlatBlockSparseSupport(*tables, **kw)


def segment_table(seg: np.ndarray, n_segments: int) -> np.ndarray:
    """(n_segments, max count) int64: the entries of each segment, in
    increasing order, padded with ``len(seg)`` (the sentinel row that
    :func:`_padded` appends). Host side."""
    seg = np.asarray(seg, np.int64)
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=n_segments)
    table = np.full((n_segments, max(int(counts.max(initial=0)), 1)),
                    len(seg), np.int64)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    col = np.arange(len(seg)) - np.repeat(start, counts)
    table[seg[order], col] = order
    return table


def _padded(vals: torch.Tensor, table: torch.Tensor,
            fill: float) -> torch.Tensor:
    """(n_segments, max, ...): the rows of ``vals`` that ``table`` names,
    ``fill`` at the sentinel."""
    pad = vals.new_full((1,) + tuple(vals.shape[1:]), fill)
    return torch.cat([vals, pad]).index_select(0, table.reshape(-1)).reshape(
        tuple(table.shape) + tuple(vals.shape[1:]))


class _SegmentSum(torch.autograd.Function):
    """Sum of ``vals`` rows by segment in a fixed order; the backward is
    the gather of the cotangent by ``seg``."""

    @staticmethod
    def forward(ctx, vals, seg, table):
        ctx.save_for_backward(seg)
        return _padded(vals, table, 0.0).sum(1)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        return g.index_select(0, seg), None, None


class _GatherRows(torch.autograd.Function):
    """``src.index_select(0, idx)``; the backward is the segment sum of the
    cotangent by ``idx`` in a fixed order (``table``: the segment table of
    ``idx``), not an atomic scatter."""

    @staticmethod
    def forward(ctx, src, idx, table):
        ctx.save_for_backward(table)
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        return _padded(g, table, 0.0).sum(1), None, None


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
    """(n_segments, ...) sums of the rows of ``vals`` (L, ...) by segment
    ``seg`` (L,), each in the order of ``table`` (:func:`segment_table`);
    differentiable, with a gather as the backward."""
    if torch.is_grad_enabled() and vals.requires_grad:
        return _SegmentSum.apply(vals, seg, table)
    return _padded(vals, table, 0.0).sum(1)


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                table: torch.Tensor) -> torch.Tensor:
    """``src.index_select(0, idx)`` whose backward sums the cotangent of
    each source row in the fixed order of ``table``, the segment table of
    ``idx``."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _GatherRows.apply(src, idx, table)
    return src.index_select(0, idx)


def adaptive_blocks(mask: BlockAdaptiveMask, nodevec1: torch.Tensor,
                    nodevec2: torch.Tensor) -> torch.Tensor:
    """Live blocks (L, BS_src, BS_dst) of the block-masked adaptive
    adjacency, in the nodevecs' dtype: the row softmax of each global
    source row over its live destinations, computed in fp32 (fp64 for
    fp64 nodevecs). Every sum runs in a fixed order (module docstring)."""
    r = nodevec1.shape[1]
    dt = nodevec1.dtype
    ct = torch.promote_types(dt, torch.float32)
    seg = mask.live_src
    e1 = gather_rows(nodevec1.reshape(mask.n_src_blocks, mask.bs_src, r),
                     seg, mask.seg_src)                    # (L, BS_s, r)
    e2 = gather_rows(nodevec2.reshape(r, mask.n_dst_blocks,
                                      mask.bs_dst).permute(1, 0, 2),
                     mask.live_dst, mask.seg_dst)          # (L, r, BS_d)
    logits = torch.relu(torch.bmm(e1.to(ct), e2.to(ct)))   # (L, BS_s, BS_d)
    # per-source-row max over live destinations: a stability shift only
    # (detached, as jax.nn.softmax's; the shift cancels analytically)
    with torch.no_grad():
        row_max = _padded(logits.amax(dim=2), mask.seg_src,
                          -torch.inf).amax(1)
        row_max = torch.where(torch.isfinite(row_max), row_max,
                              torch.zeros_like(row_max))
    ex = torch.exp(logits - row_max.index_select(0, seg)[:, :, None])
    row_sum = segment_sum(ex.sum(dim=2), seg, mask.seg_src)
    # the gather by repeated indices needs the fixed-order backward too
    return (ex / gather_rows(row_sum, seg, mask.seg_src)[:, :, None]).to(dt)


def _live_pairs(sp):
    """(dst_block, src_block) live pairs and block geometry of a flat or
    padded support (host side)."""
    if isinstance(sp, BlockSparseSupport):
        bidx = sp.block_idx.cpu().numpy().astype(np.int64)
        nb = bidx.shape[0]
        dst, m = np.nonzero(bidx < nb)
        bs = sp.block_size
        return dst, bidx[dst, m], bs, bs, nb, nb
    if not isinstance(sp, FlatBlockSparseSupport):
        raise TypeError(
            f"cannot derive a block mask from {type(sp).__name__}; pass "
            "flat or padded block-sparse supports")
    slot = sp.slot_tbl.cpu().numpy().astype(np.int64)
    live = slot < sp.n_live
    dst = sp.row_tbl.cpu().numpy().astype(np.int64)[live]
    src = sp.src_tbl.cpu().numpy().astype(np.int64)[live]
    bs_s, bs_d = sp.blocks_flat.shape[1], sp.blocks_flat.shape[2]
    return dst, src, bs_s, bs_d, sp.nb_t, sp.nb


def widen_block_pairs(dst_block, src_block, n_blocks: int,
                      hops: int) -> tuple[np.ndarray, np.ndarray]:
    """K-hop closure of a block pattern: pair (d, s) is live iff a path of
    at most ``hops`` pattern edges connects source block s to destination
    block d (host-side boolean matrix powers over N / BS blocks)."""
    if hops <= 1:
        return (np.asarray(dst_block, np.int64),
                np.asarray(src_block, np.int64))
    p = np.zeros((n_blocks, n_blocks), np.bool_)
    p[np.asarray(dst_block, np.int64), np.asarray(src_block, np.int64)] = True
    acc, cur = p.copy(), p
    for _ in range(hops - 1):
        # (P_cur @ P)[d, s] = exists m: d <- m and m <- s
        cur = (cur.astype(np.uint8) @ p.astype(np.uint8)) > 0
        acc |= cur
    d, s = np.nonzero(acc)
    return d.astype(np.int64), s.astype(np.int64)


def mask_from_supports(supports: list, add_diagonal: bool = True,
                       hops: int = 1) -> BlockAdaptiveMask:
    """The adaptive mask as the union of the supports' live patterns (host
    side), on the supports' device. ``add_diagonal`` adds every (d, d)
    block; ``hops`` widens the pattern to its k-hop block closure."""
    if not supports:
        raise ValueError("mask_from_supports needs at least one support")
    geom = None
    all_dst, all_src = [], []
    for sp in supports:
        dst, src, bs_s, bs_d, nbs, nbd = _live_pairs(sp)
        if geom is None:
            geom = (bs_s, bs_d, nbs, nbd)
        elif geom != (bs_s, bs_d, nbs, nbd):
            raise ValueError("all supports must share block geometry: "
                             f"{geom} vs {(bs_s, bs_d, nbs, nbd)}")
        all_dst.append(dst)
        all_src.append(src)
    bs_s, bs_d, nbs, nbd = geom
    if bs_s != bs_d:
        raise ValueError(
            "the adaptive mask needs square blocks (rectangular destination "
            "grouping would softmax over lcm-aligned source ranges); build "
            "the fixed supports with form='flat', not 'flat-rect', when "
            "training the adaptive adjacency")
    if add_diagonal:
        diag = np.arange(min(nbs, nbd), dtype=np.int64)
        all_dst.append(diag)
        all_src.append(diag)
    dst, src = widen_block_pairs(np.concatenate(all_dst),
                                 np.concatenate(all_src), max(nbs, nbd),
                                 hops)
    return mask_from_pairs(dst, src, bs_s, nbs,
                           device=supports[0].device)


def mask_from_pairs(dst_block: np.ndarray, src_block: np.ndarray,
                    block_size: int, n_blocks: int, *,
                    device: torch.device | str = "cuda"
                    ) -> BlockAdaptiveMask:
    """Mask from explicit (dst, src) block pairs (duplicates collapse).
    ``n_blocks`` is the square block grid's side (N = n_blocks *
    block_size)."""
    pair = np.unique(np.asarray(dst_block, np.int64) * n_blocks
                     + np.asarray(src_block, np.int64))
    dst, src = pair // n_blocks, pair % n_blocks
    # one unit edge per live pair reuses from_edges_flat's table builder;
    # its storage order (dest-major unique pairs) is the order of pair, so
    # live_dst/live_src line up with the slots
    tmpl = from_edges_flat(src * block_size, dst * block_size,
                           np.ones(len(dst), np.float32),
                           n_blocks * block_size, block_size, block_size,
                           device=device)
    row, srct = tmpl.row_tbl.cpu().numpy(), tmpl.src_tbl.cpu().numpy()
    row_t, src_t = tmpl.row_t.cpu().numpy(), tmpl.src_t.cpu().numpy()
    fuse2 = fused2_schedule(row, srct, n_blocks)
    if fuse2 is not None:
        sched_t = fused2_schedule(row_t, src_t, n_blocks)
        fuse2 = fuse2 + (sched_t if sched_t is not None else (0, 0))
    dev = tmpl.row_tbl.device
    return BlockAdaptiveMask(
        row_tbl=tmpl.row_tbl, src_tbl=tmpl.src_tbl, slot_tbl=tmpl.slot_tbl,
        row_t=tmpl.row_t, src_t=tmpl.src_t, slot_t=tmpl.slot_t,
        inv_slot=tmpl.inv_slot, row_ptr=tmpl.row_ptr,
        row_ptr_t=tmpl.row_ptr_t,
        live_dst=torch.as_tensor(dst, device=dev),
        live_src=torch.as_tensor(src, device=dev),
        seg_src=torch.as_tensor(segment_table(src, n_blocks), device=dev),
        seg_dst=torch.as_tensor(segment_table(dst, n_blocks), device=dev),
        bs_src=block_size, bs_dst=block_size, n_src_blocks=n_blocks,
        n_dst_blocks=n_blocks, fuse2=fuse2, lag=fused2_lag(row, srct),
        lag_t=fused2_lag(row_t, src_t))


def full_mask(n_nodes: int, block_size: int = 128, *,
              device: torch.device | str = "cuda") -> BlockAdaptiveMask:
    """All-live mask: the materialized support equals the dense adaptive
    adjacency exactly (parity and testing; at scale use a sparse union)."""
    if n_nodes % block_size:
        raise ValueError(f"N={n_nodes} must divide by {block_size}")
    nb = n_nodes // block_size
    d, s = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    return mask_from_pairs(d.reshape(-1), s.reshape(-1), block_size, nb,
                           device=device)
