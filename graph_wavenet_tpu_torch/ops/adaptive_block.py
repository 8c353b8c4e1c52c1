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
  segment reductions keyed by source block-row (``scatter_reduce`` amax
  for the max, ``index_add_`` for the sum).

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


def adaptive_blocks(mask: BlockAdaptiveMask, nodevec1: torch.Tensor,
                    nodevec2: torch.Tensor) -> torch.Tensor:
    """Live blocks (L, BS_src, BS_dst) of the block-masked adaptive
    adjacency, in the nodevecs' dtype: the row softmax of each global
    source row over its live destinations."""
    r = nodevec1.shape[1]
    dt = nodevec1.dtype
    e1 = nodevec1.reshape(mask.n_src_blocks, mask.bs_src, r).index_select(
        0, mask.live_src)                                  # (L, BS_s, r)
    e2 = nodevec2.reshape(r, mask.n_dst_blocks, mask.bs_dst).permute(
        1, 0, 2).index_select(0, mask.live_dst)            # (L, r, BS_d)
    logits = torch.relu(torch.bmm(e1.float(), e2.float()))  # (L, BS_s, BS_d)
    seg = mask.live_src
    nbs = mask.n_src_blocks
    # per-source-row max over live destinations: a stability shift only
    # (detached, as jax.nn.softmax's; the shift cancels analytically)
    with torch.no_grad():
        lmax = logits.amax(dim=2)
        row_max = lmax.new_full((nbs, mask.bs_src), -torch.inf)
        row_max = row_max.scatter_reduce(
            0, seg[:, None].expand_as(lmax), lmax, "amax")
        row_max = torch.where(torch.isfinite(row_max), row_max,
                              torch.zeros_like(row_max))
    ex = torch.exp(logits - row_max.index_select(0, seg)[:, :, None])
    row_sum = ex.new_zeros((nbs, mask.bs_src))
    row_sum.index_add_(0, seg, ex.sum(dim=2))
    return (ex / row_sum.index_select(0, seg)[:, :, None]).to(dt)


def _live_pairs(sp: FlatBlockSparseSupport):
    """(dst_block, src_block) live pairs and block geometry of a flat
    support (host side)."""
    if not isinstance(sp, FlatBlockSparseSupport):
        raise TypeError(
            f"cannot derive a block mask from {type(sp).__name__}; pass "
            "flat block-sparse supports (the padded form is not ported)")
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
                           device=supports[0].blocks_flat.device)


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
    return BlockAdaptiveMask(
        row_tbl=tmpl.row_tbl, src_tbl=tmpl.src_tbl, slot_tbl=tmpl.slot_tbl,
        row_t=tmpl.row_t, src_t=tmpl.src_t, slot_t=tmpl.slot_t,
        inv_slot=tmpl.inv_slot, row_ptr=tmpl.row_ptr,
        row_ptr_t=tmpl.row_ptr_t,
        live_dst=torch.as_tensor(dst, device=tmpl.row_tbl.device),
        live_src=torch.as_tensor(src, device=tmpl.row_tbl.device),
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
