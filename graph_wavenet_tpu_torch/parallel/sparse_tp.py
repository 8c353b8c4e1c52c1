"""Node tensor parallelism (node-TP) for the flat block-sparse supports.

Counterpart of ``graph_wavenet_tpu/parallel/sparse_tp.py``, one process per
rank:

- every rank of a model group owns a contiguous range of DESTINATION
  block-rows (contiguous is what the RCM/Hilbert orderings optimize for)
  and the live blocks that target them;
- forward: gather the node-sharded activations over the model group, then
  kernel 1 (``gathered_block_mix_flat``) over the rank's LOCAL tables; the
  output is born node-sharded;
- backward dx: gather the cotangent, then kernel 1 over a
  SOURCE-partitioned copy of the blocks with the transposed tables
  (``transpose_lhs=False``);
- backward of the blocks: a fixed support's blocks take no gradient. A
  trainable one (:class:`TrainableShardedFlatSupport`, and the block-masked
  adaptive adjacency through :func:`shard_adaptive_mask`) keeps one GLOBAL
  ``blocks`` leaf; the rank's two copies are gathers of it, and the dest
  copy's cotangent is kernel 2 over the gathered x and the local
  cotangent (each live block lives on one dest shard; the source copy's
  cotangent is zero by construction, so it is a detached gather). Summed
  over the ranks (the gradient all-reduce) the leaf's gradient is exact.

Two exchange forms, as in JAX: the all_gather (each rank receives (S-1)/S
of the rows), or, when every shard's sources lie in the shards beside it
(the band the orderings produce), the halo: two neighbour exchanges giving
``[prev | own | next]`` with wrap-around, 2 N/S rows, the tables' sources
remapped into that concat.

Per-rank tables are padded to the longest shard's with dummy entries on
the zero block, as the host partitioning of the JAX module (copied here,
so the tables are its tables) builds them for its stacked arrays; a rank
keeps its row. A sharded support has no fused order-2 pair: each hop is
kernel 1 (two launches a hop in a train step, forward and dx).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from graph_wavenet_tpu_torch.ops.adaptive_block import (
    BlockAdaptiveMask,
    adaptive_blocks,
)
from graph_wavenet_tpu_torch.ops.block_sparse import FlatBlockSparseSupport
from graph_wavenet_tpu_torch.ops.cuda.block_diffusion import (
    gathered_block_mix_flat,
    gathered_block_outer_flat,
    row_pointer,
)
from graph_wavenet_tpu_torch.parallel import collectives
from graph_wavenet_tpu_torch.parallel.mesh import Mesh


def _extract_live(flat: FlatBlockSparseSupport):
    """(row, src, blocks) of the live entries, storage order."""
    row = flat.row_tbl.cpu().numpy().astype(np.int64)
    src = flat.src_tbl.cpu().numpy().astype(np.int64)
    slot = flat.slot_tbl.cpu().numpy().astype(np.int64)
    blocks = flat.blocks_flat.float().cpu().numpy()
    n_live = blocks.shape[0] - 1
    live = slot < n_live
    order = np.argsort(slot[live], kind="stable")
    return (row[live][order], src[live][order], blocks[:n_live])


def _partition(row, src, blocks, n_shards: int, nb_local: int, bs_a: int,
               bs_b: int):
    """Partition live entries by ``row // nb_local``; localize rows; pad
    every shard to the same (max) table length with zero-block dummies and
    guarantee every local row appears. Returns stacked arrays with a
    leading shard axis:

    (blocks, rows, srcs, slots, glob) where ``glob (S, Lmax+1)`` maps
    each shard-local block-storage slot to its GLOBAL storage slot
    (sentinel slots -> n_live_global, the global zero block), the table
    the trainable path's exact weight cotangent needs. The JAX module
    also returns ``inv``, the gather of its per-entry cotangent; kernel 2
    writes storage order, so the port has no use for it."""
    per_rows, per_srcs, per_slots, per_blocks = [], [], [], []
    per_glob = []
    n_live_global = len(row)
    max_live = 0
    shards = []
    for s in range(n_shards):
        sel = (row // nb_local) == s
        r = row[sel] - s * nb_local
        sc = src[sel]
        b = blocks[sel]
        gids = np.nonzero(sel)[0]                 # global slot per local
        # local dummy coverage for empty local dest rows; dummy sources
        # point at the shard's OWN first row (the zero block makes the
        # value irrelevant, and halo mode needs in-range sources)
        empty = np.setdiff1d(np.arange(nb_local), r)
        n_live = len(r)
        rr = np.concatenate([r, empty])
        ss = np.concatenate([sc, np.full(len(empty), s * nb_local,
                                         np.int64)])
        sl = np.concatenate([np.arange(n_live, dtype=np.int64),
                             np.full(len(empty), -1, np.int64)])  # -1 = zero
        order = np.argsort(rr, kind="stable")
        shards.append((rr[order], ss[order], sl[order], b, n_live, gids))
        max_live = max(max_live, n_live)
    max_tbl = max(len(s[0]) for s in shards)
    for shard_id, (rr, ss, sl, b, n_live, gids) in enumerate(shards):
        pad_t = max_tbl - len(rr)
        # pad tables with dummies on the LAST local row (rows stay sorted)
        rr = np.concatenate([rr, np.full(pad_t, nb_local - 1, np.int64)])
        ss = np.concatenate([ss, np.full(pad_t, shard_id * nb_local,
                                         np.int64)])
        sl = np.concatenate([sl, np.full(pad_t, -1, np.int64)])
        sl = np.where(sl < 0, max_live, sl)       # sentinel -> zero block
        order = np.argsort(rr, kind="stable")
        rr, ss, sl = rr[order], ss[order], sl[order]
        per_rows.append(rr)
        per_srcs.append(ss)
        per_slots.append(sl)
        bpad = np.zeros((max_live + 1, bs_a, bs_b), np.float32)
        bpad[:b.shape[0]] = b
        per_blocks.append(bpad)
        glob = np.full(max_live + 1, n_live_global, np.int64)
        glob[:n_live] = gids
        per_glob.append(glob)
    as_i32 = lambda a: np.stack(a).astype(np.int32)  # noqa: E731
    return (np.stack(per_blocks), as_i32(per_rows), as_i32(per_srcs),
            as_i32(per_slots), as_i32(per_glob))


def _halo_eligible(src_stacked, nb_local: int) -> bool:
    """True iff every shard's sources lie in shards {s-1, s, s+1}
    (no wrap) — the band structure RCM/Hilbert orderings produce."""
    src = np.asarray(src_stacked, np.int64) // nb_local   # (S, Lt) shards
    s_idx = np.arange(src.shape[0])[:, None]
    return bool(np.all(np.abs(src - s_idx) <= 1))


def _remap_halo(src_stacked, nb_local: int) -> np.ndarray:
    """Global block-row ids -> indices into each shard's
    [prev | own | next] 3*nb_local concat: src - (s-1)*nb_local."""
    src = np.asarray(src_stacked, np.int64)
    s_idx = np.arange(src.shape[0])[:, None]
    return (src - (s_idx - 1) * nb_local).astype(np.int32)


def partition_tables(flat: FlatBlockSparseSupport, n_shards: int,
                     halo: bool | str = "auto") -> dict:
    """Every shard's tables, stacked on a leading shard axis (host numpy,
    the JAX module's ``shard_flat_support`` fields): ``blocks_f``,
    ``row_f``, ``src_f``, ``slot_f``, ``glob_f`` (the dest partition),
    the same with ``_b`` (the source partition, for dx), ``halo`` (the
    exchange form chosen), ``nb_local`` and ``n_live`` (live blocks per
    shard). ``halo``: "auto" takes the halo form where every shard's
    sources fit in the shards beside it; True forces it (and raises where
    they do not); False the all_gather."""
    bs_a, bs_b = flat.blocks_flat.shape[1], flat.blocks_flat.shape[2]
    if bs_a != bs_b:
        raise ValueError(
            "node-TP sharding needs square blocks (the rectangular form's "
            "dest grouping would need lcm-aligned ranges)")
    nb = flat.nb
    if nb % n_shards:
        raise ValueError(f"{nb} block-rows must divide by the model axis "
                         f"size {n_shards}")
    nb_local = nb // n_shards
    row, src, blocks = _extract_live(flat)
    blocks_f, row_f, src_f, slot_f, glob_f = _partition(
        row, src, blocks, n_shards, nb_local, bs_a, bs_b)
    # source partition for dx: same entries keyed by src, contract dest
    blocks_b, row_b, src_b, slot_b, glob_b = _partition(
        src, row, blocks, n_shards, nb_local, bs_a, bs_b)
    eligible = (n_shards >= 2 and _halo_eligible(src_f, nb_local)
                and _halo_eligible(src_b, nb_local))
    if halo is True and not eligible:
        raise ValueError(
            "halo=True but some shard draws sources beyond its adjacent "
            "shards; reorder the graph (graphs.ordering rcm/hilbert) or "
            "use halo=False")
    use_halo = eligible if halo == "auto" else bool(halo)
    if use_halo:
        src_f = _remap_halo(src_f, nb_local)
        src_b = _remap_halo(src_b, nb_local)
    n_live = (glob_f < len(row)).sum(axis=1)
    return dict(blocks_f=blocks_f, row_f=row_f, src_f=src_f, slot_f=slot_f,
                glob_f=glob_f, blocks_b=blocks_b, row_b=row_b,
                src_b=src_b, slot_b=slot_b, glob_b=glob_b, halo=use_halo,
                nb_local=nb_local, n_live=n_live, n_live_global=len(row),
                blocks=blocks)


@dataclass(eq=False)
class ShardedFlatSupport:
    """This rank's shard of a flat support (module docstring): the dest
    partition's blocks and tables for the hop, the source partition's for
    dx, local CSR row pointers. ``blocks_f`` may carry a gradient (a
    trainable support's derived copy); ``blocks_b`` never does."""

    blocks_f: torch.Tensor    # (Lf+1, BS, BS) dest-partitioned
    row_f: torch.Tensor       # (Ltf,) int32 LOCAL dest block-row, sorted
    src_f: torch.Tensor       # (Ltf,) int32 GLOBAL (or halo) x block-row
    slot_f: torch.Tensor      # (Ltf,) int32
    blocks_b: torch.Tensor    # (Lb+1, BS, BS) source-partitioned (dx)
    row_b: torch.Tensor       # (Ltb,) int32 LOCAL x block-row, sorted
    src_b: torch.Tensor       # (Ltb,) int32 GLOBAL (or halo) dest row
    slot_b: torch.Tensor      # (Ltb,) int32
    row_ptr_f: torch.Tensor   # (nb_local+1,) int32
    row_ptr_b: torch.Tensor
    nb_local: int
    n_live: int               # this shard's live dest blocks
    halo: bool
    mesh: Mesh

    @property
    def block_size(self) -> int:
        return self.blocks_f.shape[1]

    @property
    def n_nodes(self) -> int:
        """The global node count."""
        return self.mesh.model * self.nb_local * self.block_size

    @property
    def device(self) -> torch.device:
        return self.blocks_f.device

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        """This rank's (N/S, R) -> (N/S, R): one diffusion hop."""
        return _ShardedMix.apply(x2, self.blocks_f, self)

    def astype(self, dtype: torch.dtype):
        return dataclasses.replace(self, blocks_f=self.blocks_f.to(dtype),
                                   blocks_b=self.blocks_b.to(dtype))


def _gathered(x: torch.Tensor, sp: ShardedFlatSupport) -> torch.Tensor:
    """The rows this rank's kernel reads: the all_gather, or the
    ``[prev | own | next]`` halo concat."""
    group = sp.mesh.model_group
    if not sp.halo:
        return collectives.all_gather_rows(x, group)
    prev, nxt = collectives.neighbour_exchange(x, group, sp.mesh.model_ranks)
    return torch.cat([prev, x, nxt])


class _ShardedMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, blocks_f, sp: ShardedFlatSupport):
        n, r = x2.shape
        bs = sp.block_size
        if n != sp.nb_local * bs:
            raise ValueError(f"x has {n} local nodes; the shard has "
                             f"{sp.nb_local * bs}")
        xg = _gathered(x2.contiguous(), sp)
        out = gathered_block_mix_flat(
            blocks_f.to(x2.dtype), sp.slot_f, xg.reshape(-1, bs, r),
            sp.src_f, sp.row_f, nb=sp.nb_local, transpose_lhs=True,
            row_ptr=sp.row_ptr_f)
        ctx.sp = sp
        ctx.x_dtype, ctx.blocks_dtype = x2.dtype, blocks_f.dtype
        # the gathered rows are the weight cotangent's x: kept, not
        # gathered again
        ctx.save_for_backward(xg if ctx.needs_input_grad[1] else None)
        return out.reshape(n, r)

    @staticmethod
    def backward(ctx, gout):
        (xg,) = ctx.saved_tensors
        sp = ctx.sp
        n, r = gout.shape
        bs = sp.block_size
        dt = ctx.x_dtype
        g = gout.to(dt).contiguous()
        dx = dblocks = None
        if ctx.needs_input_grad[0]:
            gg = _gathered(g, sp)
            dx = gathered_block_mix_flat(
                sp.blocks_b.to(dt), sp.slot_b, gg.reshape(-1, bs, r),
                sp.src_b, sp.row_b, nb=sp.nb_local, transpose_lhs=False,
                row_ptr=sp.row_ptr_b).reshape(n, r)
        if ctx.needs_input_grad[1]:
            dblocks = gathered_block_outer_flat(
                xg.reshape(-1, bs, r), g.reshape(sp.nb_local, bs, r),
                sp.src_f, sp.row_f, slot=sp.slot_f,
                n_slots=sp.blocks_f.shape[0], out_dtype=ctx.blocks_dtype)
            # the kernel writes only the slots its table names: the
            # padding slots of a shard with fewer live blocks than the
            # longest, and the zero block, get a zero gradient
            dblocks[sp.n_live:] = 0
        return dx, dblocks, None


@dataclass(eq=False)
class TrainableShardedFlatSupport:
    """A sharded flat support whose weights train: ``blocks (L+1, BS,
    BS)`` is the single global storage (the zero block last); the rank's
    copies are gathers of it (``glob_f``, ``glob_b``), so ``blocks`` is the
    one leaf and its gradient, summed over the ranks, is exact.
    ``tables`` holds the rank's tables (its blocks unused)."""

    blocks: torch.Tensor      # (L+1, BS, BS), [L] = zero
    glob_f: torch.Tensor      # (Lf+1,) local dest slot -> global slot
    glob_b: torch.Tensor      # (Lb+1,) local source slot -> global slot
    tables: ShardedFlatSupport

    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.tables.n_nodes

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def halo(self) -> bool:
        return self.tables.halo

    def local(self) -> ShardedFlatSupport:
        """The rank's shard with its two copies gathered from ``blocks``
        (fresh tensors: the bf16 kernels need aligned blocks): the dest
        copy carries the gradient, the source copy none."""
        return dataclasses.replace(
            self.tables, blocks_f=self.blocks.index_select(0, self.glob_f),
            blocks_b=self.blocks.detach().index_select(0, self.glob_b))

    def mix_2d(self, x2: torch.Tensor) -> torch.Tensor:
        return self.local().mix_2d(x2)


def shard_flat_support(flat: FlatBlockSparseSupport, mesh: Mesh,
                       halo: bool | str = "auto", trainable: bool = False):
    """This rank's shard of ``flat`` over the mesh's model axis (host-side
    partitioning, :func:`partition_tables`); N's block-rows must divide by
    the axis size. A fused support is taken apart: a sharded support has
    no fused pair. ``trainable``: a :class:`TrainableShardedFlatSupport`
    whose global ``blocks`` is a leaf with an exact gradient; otherwise
    the blocks are fixed (no gradient)."""
    t = partition_tables(flat, mesh.model, halo)
    s = mesh.model_index
    dev, dtype = flat.device, flat.blocks_flat.dtype

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a[s]), device=dev)

    def blocks(a):
        return torch.as_tensor(a[s], device=dev).to(dtype)

    row_f, row_b = i32(t["row_f"]), i32(t["row_b"])
    sp = ShardedFlatSupport(
        blocks(t["blocks_f"]), row_f, i32(t["src_f"]), i32(t["slot_f"]),
        blocks(t["blocks_b"]), row_b, i32(t["src_b"]), i32(t["slot_b"]),
        row_pointer(row_f, t["nb_local"]), row_pointer(row_b, t["nb_local"]),
        nb_local=t["nb_local"], n_live=int(t["n_live"][s]),
        halo=t["halo"], mesh=mesh)
    if not trainable:
        return sp
    bs = sp.block_size
    blocks_global = torch.cat([
        torch.as_tensor(t["blocks"], device=dev),
        torch.zeros((1, bs, bs), device=dev)]).to(dtype)

    def i64(a):
        return torch.as_tensor(a[s], device=dev).long()

    return TrainableShardedFlatSupport(blocks_global, i64(t["glob_f"]),
                                       i64(t["glob_b"]), sp)


@dataclass(eq=False)
class ShardedBlockAdaptiveMask:
    """Node-TP counterpart of :class:`ops.adaptive_block.BlockAdaptiveMask`.
    ``materialize`` computes every live block of the block-masked
    adaptive adjacency from the replicated embeddings (the JAX module does
    it replicated too: O(live blocks x BS^2), small next to a hop over
    batched activations) and returns this rank's shard with its dest copy
    gathered from them, once per forward; the embeddings' gradient on a
    rank is its shard's part, and the gradient all-reduce sums the parts."""

    inner: BlockAdaptiveMask
    template: TrainableShardedFlatSupport   # blocks = (1, BS, BS) dummy
    adaptive_mask = True        # duck-type marker used by models.gwnet

    @property
    def n_live(self) -> int:
        return self.inner.n_live

    @property
    def n_nodes(self) -> int:
        return self.inner.n_nodes

    @property
    def halo(self) -> bool:
        return self.template.halo

    def materialize(self, nodevec1: torch.Tensor, nodevec2: torch.Tensor,
                    out_dtype: torch.dtype | None = None
                    ) -> ShardedFlatSupport:
        blocks = adaptive_blocks(self.inner, nodevec1, nodevec2)
        if out_dtype is not None:
            blocks = blocks.to(out_dtype)
        blocks_flat = torch.cat([blocks, blocks.new_zeros(
            (1, self.inner.bs_src, self.inner.bs_dst))])
        return dataclasses.replace(self.template, blocks=blocks_flat).local()


def shard_adaptive_mask(mask: BlockAdaptiveMask, mesh: Mesh,
                        halo: bool | str = "auto"
                        ) -> ShardedBlockAdaptiveMask:
    """Partition a :class:`BlockAdaptiveMask`'s live pattern over the
    mesh's model axis (host-side); pass the result in the supports list
    like the single-process mask. The tables come from a unit-weight
    template support on the mask's pattern: its storage order is the
    mask's, so the gathers pick the right materialized block."""
    dev = mask.row_tbl.device
    dummy = mask.materialize(torch.ones((mask.n_nodes, 1), device=dev),
                             torch.ones((1, mask.n_nodes), device=dev))
    sharded = shard_flat_support(dummy, mesh, halo=halo, trainable=True)
    template = dataclasses.replace(
        sharded, blocks=sharded.blocks.new_zeros(
            (1, mask.bs_src, mask.bs_dst)))
    return ShardedBlockAdaptiveMask(inner=mask, template=template)


# what the model takes under node-TP
SHARDED = (ShardedFlatSupport, TrainableShardedFlatSupport,
           ShardedBlockAdaptiveMask)
