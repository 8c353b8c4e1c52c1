"""Block-sparse diffusion kernels: wrappers, plain versions, schedule.

Counterpart of ``graph_wavenet_tpu/ops/pallas/block_diffusion.py``:

- :func:`gathered_block_mix_flat` (kernel 1, ``csrc/mix_flat.cu``): for
  every live entry ``l``, ``out[row[l]] += blocks[slot[l]] (contract)
  x[src[l]]``, fp32 accumulation, one cast per output tile;
- :func:`gathered_block_mix_flat2` (kernel 3, ``csrc/mix_flat2.cu``): both
  order-2 hops in one launch, with an optional ``add`` after the inter-hop
  cast; bitwise equal to two calls of kernel 1, which it makes instead
  where :func:`fused2_dispatch` says they are faster;
- :func:`gathered_block_outer_flat` (kernel 2, ``csrc/outer_flat.cu``): the
  per-entry weight cotangent ``x[src[l]] . g[row[l]]^T`` over R, fp32 out,
  or, given the storage slots, written straight in storage order and dtype;
- :func:`gathered_block_mix` (kernel 4, ``csrc/mix_padded.cu``): kernel 1
  over a padded ``(NB, MB)`` table, sentinel slots skipped;
- :func:`gathered_block_outer` (kernel 5, ``csrc/outer_padded.cu``): the
  padded weight cotangent ``x[src[i, m]] . g[i]^T``, sentinel slots zero;
- :func:`fused2_schedule`: the reference's host-side (delay, ring width)
  schedule, copied verbatim; it decides which layouts fuse;
- :func:`fused2_lag`: the row lag the CUDA kernel orders its work by, and
  :func:`fused2_launch` its persistent grid and the span (lag plus slack)
  between its two hops;
- :func:`tile_cols`: the R columns of one output tile of kernels 1, 3 and
  4, by one rule for all three.

Each kernel is an op of the seam (``ops/cuda/build.py``):
``torch.ops.gwt_torch.mix_flat``, ``mix_flat2``, ``outer_flat``,
``mix_padded`` and ``outer_padded`` (:data:`OPS`), so ``torch.export``
writes the ops into an artifact and a loader needs this module (not the
model code) to run it. A CUDA tensor goes to the kernel or raises; a CPU
tensor goes to the plain PyTorch version beside it (gather, fp32 einsum,
and for the mixes ``index_add_`` over the destination rows and a cast).
The seam counts each op's launches in ``build.LAUNCHES``; each op carries
a FLOP formula for ``torch.utils.flop_counter.FlopCounterMode`` (the
reference kernel's ``CostEstimate`` flops).
"""

from __future__ import annotations

import numpy as np
import torch

from graph_wavenet_tpu_torch.ops.cuda import build
# the projection and layer-tail kernels' ops join the namespace: a loader
# of an exported artifact imports this module alone
from graph_wavenet_tpu_torch.ops.cuda import bn_tail, chan_proj  # noqa: F401

# the block kernels' ops, kernels 1-5 (their counts in build.LAUNCHES)
OPS = ("mix_flat", "mix_flat2", "outer_flat", "mix_padded", "outer_padded")

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tile_cols(r: int, dtype: torch.dtype) -> int:
    """R columns per output tile of kernels 1, 3 and 4 for ``r`` columns of
    ``dtype``: 64 in fp32 (the FMA product's tile). In bf16 64 up to R = 64,
    where reading the blocks binds and a wider tile does idle tensor-core
    work; past it 256, unless 128 pads R to fewer columns by more than the
    ~1/8 more a 128-column tile costs per column (it reads the blocks twice
    as often; ``chip_smoke.py``'s ``tile_widths`` phase times all three
    widths). One rule for the
    three kernels keeps kernel 3 bitwise equal to two kernel-1 launches and
    kernel 4 to kernel 1."""
    if dtype != torch.bfloat16:
        return 64
    if r <= 64:
        return 64
    pad128, pad256 = -(-r // 128) * 128, -(-r // 256) * 256
    return 128 if 9 * pad128 < 8 * pad256 else 256


DISPATCHES = ("auto", "chain", "fused")

# R at which kernel 3 beats kernel 1 + add + kernel 1 on the H100, by
# activation dtype and whether the pair has ``add``: (least, most), None
# unbounded. fp32 and bf16 with add: kernel 3 at every R (it saves the
# chain's separate add and out1's trip through device memory). bf16
# forward: kernel 3 up to R = 2,048; above, it ties two kernel-1 launches
# or trails them by ~1.5% (its persistent loop runs kernel 1's product
# ~2.6% slower a tile). chip_smoke.py's ``dispatch`` phase times both
# branches at the main paths' R; PERF.md has the table.
FUSED2_R = {(torch.float32, False): (0, None),
            (torch.float32, True): (0, None),
            (torch.bfloat16, False): (0, 2048),
            (torch.bfloat16, True): (0, None)}


def fused2_dispatch(r: int, dtype: torch.dtype, *, add: bool) -> str:
    """``"fused"`` (kernel 3) or ``"chain"`` (two kernel-1 launches) for an
    order-2 hop pair of ``r`` columns of ``dtype``, with or without
    ``add``: the faster of the two on the H100 (:data:`FUSED2_R`)."""
    least, most = FUSED2_R.get((dtype, bool(add)), (None, None))
    fused = (least is not None and r >= least
             and (most is None or r <= most))
    return "fused" if fused else "chain"


def flag_count(nb: int, r: int, dtype: torch.dtype) -> int:
    """Length of kernel 3's int32 flags buffer: a completion flag per
    (destination row, R tile), then the ticket counter."""
    ct = tile_cols(r, dtype)
    return nb * -(-r // ct) + 1


def fused2_launch(nb: int, r: int, dtype: torch.dtype, lag: int,
                  resident: int) -> tuple[int, int]:
    """Kernel 3's ``(span, grid)`` for ``nb`` block rows of ``r`` columns
    of ``dtype`` with row lag ``lag`` (:func:`fused2_lag`), on a card that
    holds ``resident`` of its thread blocks at once.

    The grid is persistent: ``min(items, resident)`` blocks pull the
    ``2 * nb * tiles`` (hop, row, R tile) items by ticket. Ticket step s
    holds hop 1 of row s and hop 2 of row ``s - span``; ``span = lag +
    slack``, at most ``nb``, where the slack is the steps the tickets held
    at once cover (two a block in bf16, whose producer warp takes the next
    item while its consumers finish one; one in fp32). So the out1 rows hop
    2 reads were published about a wave before it asks for them."""
    tiles = -(-r // tile_cols(r, dtype))
    grid = min(2 * nb * tiles, resident)
    held = (2 if dtype == torch.bfloat16 else 1) * grid
    slack = -(-held // (2 * tiles))
    return min(lag + slack, nb), grid


def row_pointer(row_tbl: torch.Tensor, nb: int) -> torch.Tensor:
    """CSR row pointer (nb + 1,) int32 of a row-sorted entry table: the
    entries of destination row i are ``[ptr[i], ptr[i+1])``."""
    bounds = torch.arange(nb + 1, device=row_tbl.device,
                          dtype=row_tbl.dtype)
    return torch.searchsorted(row_tbl, bounds).to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------

def mix_flat_plain(blocks: torch.Tensor, slot: torch.Tensor,
                   x: torch.Tensor, src: torch.Tensor, row: torch.Tensor,
                   *, nb: int, transpose_lhs: bool) -> torch.Tensor:
    """Kernel 1's function in PyTorch: gather, fp32 einsum, index_add_
    over ``row``, cast to x's dtype."""
    b = blocks.index_select(0, slot.long()).float()
    xs = x.index_select(0, src.long()).float()
    eq = "lko,lkr->lor" if transpose_lhs else "lok,lkr->lor"
    contrib = torch.einsum(eq, b, xs)
    out = torch.zeros((nb,) + contrib.shape[1:], dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, row.long(), contrib)
    return out.to(x.dtype)


def mix_flat2_plain(blocks: torch.Tensor, slot: torch.Tensor,
                    x: torch.Tensor, src: torch.Tensor, row: torch.Tensor,
                    *, nb: int, transpose_lhs: bool,
                    add: torch.Tensor | None = None):
    """Kernel 3's function: two calls of kernel 1's plain version, with
    ``add`` after the inter-hop cast."""
    o1 = mix_flat_plain(blocks, slot, x, src, row, nb=nb,
                        transpose_lhs=transpose_lhs)
    if add is not None:
        o1 = o1 + add.to(o1.dtype)
    o2 = mix_flat_plain(blocks, slot, o1, src, row, nb=nb,
                        transpose_lhs=transpose_lhs)
    return o1, o2


def outer_flat_plain(x: torch.Tensor, g: torch.Tensor, src: torch.Tensor,
                     row: torch.Tensor, slot: torch.Tensor | None = None,
                     n_slots: int | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Kernel 2's function: gather ``x[src]`` and ``g[row]``, then an fp32
    einsum over R. With ``slot``: entry l's product goes to row ``slot[l]``
    of an (n_slots, BSx, BSg) result, the zero slot ``n_slots - 1`` (where
    the dummy entries point) stays zero, and one cast to ``out_dtype``."""
    xs = x.index_select(0, src.long()).float()
    gs = g.index_select(0, row.long()).float()
    per_entry = torch.einsum("lxr,lgr->lxg", xs, gs)
    if slot is None:
        return per_entry
    out = per_entry.new_empty((n_slots,) + per_entry.shape[1:])
    out.index_copy_(0, slot.long(), per_entry)
    out[n_slots - 1] = 0
    return out.to(out_dtype or torch.float32)


def _sentinels_to_zero(t: torch.Tensor, idx: torch.Tensor):
    """``t`` with one zero row appended, and ``idx`` (long) with every index
    outside ``t`` pointed at it: a sentinel reads zeros."""
    n = t.shape[0]
    idx = idx.long()
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    return torch.cat([t, t.new_zeros((1,) + t.shape[1:])]), idx


def mix_padded_plain(blocks: torch.Tensor, slot: torch.Tensor,
                     x: torch.Tensor, src: torch.Tensor, *,
                     transpose_lhs: bool) -> torch.Tensor:
    """Kernel 4's function in PyTorch: gather the (NB, MB) slots' blocks and
    x rows (a sentinel reads zeros), fp32 einsum summing over the slots,
    cast to x's dtype."""
    nb, mb = src.shape
    bz, k = _sentinels_to_zero(blocks, slot.reshape(-1))
    xz, s = _sentinels_to_zero(x, src.reshape(-1))
    b = bz.index_select(0, k).float().reshape(nb, mb, *blocks.shape[1:])
    xs = xz.index_select(0, s).float().reshape(nb, mb, *x.shape[1:])
    eq = "nmko,nmkr->nor" if transpose_lhs else "nmok,nmkr->nor"
    return torch.einsum(eq, b, xs).to(x.dtype)


def outer_padded_plain(x: torch.Tensor, g: torch.Tensor, src: torch.Tensor,
                       *, out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel 5's function: gather ``x[src]`` (a sentinel reads zeros), an
    fp32 einsum over R with ``g`` of the slot's row, one cast."""
    nb, mb = src.shape
    xz, s = _sentinels_to_zero(x, src.reshape(-1))
    xs = xz.index_select(0, s).float().reshape(nb, mb, *x.shape[1:])
    return torch.einsum("nmxr,ngr->nmxg", xs, g.float()).to(out_dtype)


# ---------------------------------------------------------------------------
# launch checks
# ---------------------------------------------------------------------------

def _check_tables(*tables: torch.Tensor) -> None:
    for t in tables:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.ndim != 1:
            raise ValueError("entry tables must be contiguous 1-D int32")


def _check_cuda(x: torch.Tensor, other: torch.Tensor,
                *tables: torch.Tensor, name: str = "blocks") -> int:
    """Checks x, the second operand (``name``) and the int32 tables for a
    launch; returns the kernels' dtype code."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"CUDA block kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if other.dtype != x.dtype:
        raise TypeError(f"{name} ({other.dtype}) must be in x's dtype "
                        f"({x.dtype}); cast first")
    for t in (x, other) + tables:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if not (x.is_contiguous() and other.is_contiguous()):
        raise ValueError(f"x and {name} must be contiguous")
    _check_tables(*tables)
    return _DTYPE_CODE[x.dtype]


# blocks of kernel 3 a card holds at once, by (device, dtype, tile width):
# the occupancy the card reports for the launch times its SMs
_RESIDENT: dict = {}


def resident(x: torch.Tensor, ct: int) -> int:
    """Kernel 3's blocks that ``x``'s card holds at once at tile width
    ``ct`` in ``x``'s dtype."""
    key = (x.device.index, x.dtype, ct)
    if key not in _RESIDENT:
        n = torch.zeros(1, dtype=torch.int32)
        build.launch("mix_flat2.cu", "gwt_mix_flat2_per_sm",
                     [_DTYPE_CODE[x.dtype], ct, n.data_ptr()], x.device)
        if int(n) < 1:
            raise RuntimeError(f"kernel 3 does not fit an SM at {ct} "
                               f"columns of {x.dtype}")
        _RESIDENT[key] = int(n) * build.sms(x.device)
    return _RESIDENT[key]


def _check_aligned(blocks: torch.Tensor) -> None:
    """The bf16 kernels read the blocks with TMA, which needs a 16-byte
    aligned base."""
    if blocks.dtype == torch.bfloat16 and blocks.data_ptr() % 16:
        raise ValueError("bf16 blocks must start on a 16-byte boundary; "
                         "pass a fresh tensor (e.g. .clone()), not a view "
                         "at an odd offset")


# ---------------------------------------------------------------------------
# the kernels as ops
# ---------------------------------------------------------------------------
# One op per kernel (``build.Op``). Its CUDA kernel does the work on data
# pointers through ``build.launch``; its fake kernel gives the output's shape
# and dtype from the arguments alone. The public wrappers check their
# arguments and call the ops; no other device has a kernel. Each op's FLOP
# formula is the reference kernel's ``CostEstimate`` flops over the op's
# shapes, with R the op's own column count (the reference pads R to its
# tile) and, in the padded form, every slot of the (NB, MB) table,
# sentinels included, as the reference counts them. FlopCounterMode does not
# look inside an op, so a CPU kernel's einsums are not counted twice. The
# CPU kernels look the plain versions up when called, so a stand-in for one
# (a counting test) takes effect.


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def mix_flat_desc(blocks, slot, x, src, row_ptr, out, nb: int,
                  transpose_lhs: bool, ct: int) -> list[int]:
    """``gwt_mix_flat``'s descriptor (``csrc/mix_flat.cu``)."""
    bs_c, bs_o = ((blocks.shape[1], blocks.shape[2]) if transpose_lhs
                  else (blocks.shape[2], blocks.shape[1]))
    return [_DTYPE_CODE[x.dtype], blocks.data_ptr(), slot.data_ptr(),
            x.data_ptr(), src.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
            nb, blocks.shape[0], x.shape[0], bs_c, bs_o, x.shape[2],
            int(transpose_lhs), ct]


def mix_flat2_desc(blocks, slot, x, src, row_ptr, add, out1, out2, flags,
                   nb: int, span: int, transpose_lhs: bool, ct: int,
                   grid: int) -> list[int]:
    """``gwt_mix_flat2``'s descriptor (``csrc/mix_flat2.cu``)."""
    return [_DTYPE_CODE[x.dtype], blocks.data_ptr(), slot.data_ptr(),
            x.data_ptr(), src.data_ptr(), row_ptr.data_ptr(), _ptr(add),
            out1.data_ptr(), out2.data_ptr(), flags.data_ptr(), nb,
            blocks.shape[0], span, blocks.shape[1], x.shape[2],
            int(transpose_lhs), ct, grid]


def _need_row_ptr(row_ptr) -> None:
    if row_ptr is None:
        raise ValueError("the CUDA kernel reads the CSR row pointer; pass "
                         "row_ptr")


_mix_flat_op = build.Op(
    "mix_flat", "(Tensor blocks, Tensor slot, Tensor x, Tensor src, "
    "Tensor row, Tensor? row_ptr, int nb, bool transpose_lhs) -> Tensor",
    lambda blocks, slot, x, src, row, row_ptr, nb, transpose_lhs:
    mix_flat_plain(blocks, slot, x, src, row, nb=nb,
                   transpose_lhs=transpose_lhs))


@_mix_flat_op.fake
def _(blocks, slot, x, src, row, row_ptr, nb, transpose_lhs):
    bs_o = blocks.shape[2] if transpose_lhs else blocks.shape[1]
    return x.new_empty((nb, bs_o, x.shape[2]))


@_mix_flat_op.flops
def _(blocks, slot, x, *args, out_shape=None, **kwargs) -> int:
    # the reference's CostEstimate (Pallas block_diffusion.py:227), R unpadded
    return 2 * slot[0] * blocks[1] * blocks[2] * x[2]


@_mix_flat_op.cuda
def _(blocks, slot, x, src, row, row_ptr, nb, transpose_lhs):
    _need_row_ptr(row_ptr)
    _check_aligned(blocks)
    bs_o = blocks.shape[2] if transpose_lhs else blocks.shape[1]
    r = x.shape[2]
    out = torch.empty((nb, bs_o, r), dtype=x.dtype, device=x.device)
    if r == 0 or nb == 0:
        return out
    build.launch("mix_flat.cu", "gwt_mix_flat",
                 mix_flat_desc(blocks, slot, x, src, row_ptr, out, nb,
                               transpose_lhs, tile_cols(r, x.dtype)),
                 x.device, "mix_flat")
    return out


_mix_flat2_op = build.Op(
    "mix_flat2", "(Tensor blocks, Tensor slot, Tensor x, Tensor src, "
    "Tensor row, Tensor? row_ptr, Tensor? add, int nb, int lag, "
    "bool transpose_lhs) -> (Tensor, Tensor)",
    lambda blocks, slot, x, src, row, row_ptr, add, nb, lag, transpose_lhs:
    mix_flat2_plain(blocks, slot, x, src, row, nb=nb,
                    transpose_lhs=transpose_lhs, add=add))


@_mix_flat2_op.fake
def _(blocks, slot, x, src, row, row_ptr, add, nb, lag, transpose_lhs):
    return torch.empty_like(x), torch.empty_like(x)


@_mix_flat2_op.flops
def _(blocks, slot, x, *args, out_shape=None, **kwargs) -> int:
    # both hops (Pallas block_diffusion.py:620)
    return 4 * slot[0] * blocks[1] * blocks[2] * x[2]


@_mix_flat2_op.cuda
def _(blocks, slot, x, src, row, row_ptr, add, nb, lag, transpose_lhs):
    _need_row_ptr(row_ptr)
    _check_aligned(blocks)
    r = x.shape[2]
    out1 = torch.empty_like(x)
    out2 = torch.empty_like(x)
    if r == 0 or nb == 0:
        return out1, out2
    ct = tile_cols(r, x.dtype)
    span, grid = fused2_launch(nb, r, x.dtype, lag, resident(x, ct))
    # a completion flag per (row, R tile) and the ticket counter, zeroed
    # per launch (a captured launch re-zeroes them on every replay)
    flags = torch.zeros(flag_count(nb, r, x.dtype), dtype=torch.int32,
                        device=x.device)
    build.launch("mix_flat2.cu", "gwt_mix_flat2",
                 mix_flat2_desc(blocks, slot, x, src, row_ptr, add, out1,
                                out2, flags, nb, span, transpose_lhs, ct,
                                grid),
                 x.device, "mix_flat2")
    return out1, out2


# positional: a stand-in for the plain version that takes *args (a
# counting test) works
_outer_flat_op = build.Op(
    "outer_flat", "(Tensor x, Tensor g, Tensor src, Tensor row, "
    "Tensor? slot, int? n_slots, ScalarType? out_dtype) -> Tensor",
    lambda x, g, src, row, slot, n_slots, out_dtype:
    outer_flat_plain(x, g, src, row, slot, n_slots, out_dtype))


@_outer_flat_op.fake
def _(x, g, src, row, slot, n_slots, out_dtype):
    n_out = src.numel() if slot is None else n_slots
    return x.new_empty((n_out, x.shape[1], g.shape[1]),
                       dtype=out_dtype or torch.float32)


@_outer_flat_op.flops
def _(x, g, src, *args, out_shape=None, **kwargs) -> int:
    # Pallas block_diffusion.py:296
    return 2 * src[0] * x[1] * g[1] * x[2]


@_outer_flat_op.cuda
def _(x, g, src, row, slot, n_slots, out_dtype):
    out_dtype = out_dtype or torch.float32
    bs_x, bs_g, r = x.shape[1], g.shape[1], x.shape[2]
    lt = src.numel()
    n_out = lt if slot is None else n_slots
    out = torch.empty((n_out, bs_x, bs_g), dtype=out_dtype, device=x.device)
    if lt == 0 or r == 0:
        return out.zero_()
    build.launch("outer_flat.cu", "gwt_outer_flat",
                 [_DTYPE_CODE[x.dtype], x.data_ptr(), g.data_ptr(),
                  src.data_ptr(), row.data_ptr(), _ptr(slot), out.data_ptr(),
                  _DTYPE_CODE[out_dtype], lt, n_slots or 0, x.shape[0],
                  g.shape[0], bs_x, bs_g, r],
                 x.device, "outer_flat")
    return out


_mix_padded_op = build.Op(
    "mix_padded", "(Tensor blocks_flat, Tensor slot_tbl, Tensor x_pad, "
    "Tensor src_tbl, bool transpose_lhs) -> Tensor",
    lambda blocks_flat, slot_tbl, x_pad, src_tbl, transpose_lhs:
    mix_padded_plain(blocks_flat, slot_tbl, x_pad, src_tbl,
                     transpose_lhs=transpose_lhs))


@_mix_padded_op.fake
def _(blocks_flat, slot_tbl, x_pad, src_tbl, transpose_lhs):
    return x_pad.new_empty((src_tbl.shape[0],) + tuple(x_pad.shape[1:]))


@_mix_padded_op.flops
def _(blocks_flat, slot_tbl, x_pad, src_tbl, *args, out_shape=None,
      **kwargs) -> int:
    # every (NB, MB) slot, sentinels included (Pallas block_diffusion.py:119)
    return 2 * src_tbl[0] * src_tbl[1] * x_pad[1] * x_pad[1] * x_pad[2]


@_mix_padded_op.cuda
def _(blocks_flat, slot_tbl, x_pad, src_tbl, transpose_lhs):
    _check_aligned(blocks_flat)
    nb, mb = src_tbl.shape
    bs, r = x_pad.shape[1], x_pad.shape[2]
    out = torch.empty((nb, bs, r), dtype=x_pad.dtype, device=x_pad.device)
    if r == 0 or nb == 0:
        return out
    slot, src = slot_tbl.reshape(-1), src_tbl.reshape(-1)
    build.launch("mix_padded.cu", "gwt_mix_padded",
                 [_DTYPE_CODE[x_pad.dtype], blocks_flat.data_ptr(),
                  slot.data_ptr(), x_pad.data_ptr(), src.data_ptr(),
                  out.data_ptr(), nb, mb, blocks_flat.shape[0],
                  x_pad.shape[0], bs, r, int(transpose_lhs),
                  tile_cols(r, x_pad.dtype)],
                 x_pad.device, "mix_padded")
    return out


_outer_padded_op = build.Op(
    "outer_padded", "(Tensor x_pad, Tensor g_blocks, Tensor src_tbl, "
    "ScalarType out_dtype) -> Tensor",
    lambda x_pad, g_blocks, src_tbl, out_dtype:
    outer_padded_plain(x_pad, g_blocks, src_tbl, out_dtype=out_dtype))


@_outer_padded_op.fake
def _(x_pad, g_blocks, src_tbl, out_dtype):
    bs = x_pad.shape[1]
    return x_pad.new_empty(tuple(src_tbl.shape) + (bs, bs), dtype=out_dtype)


@_outer_padded_op.flops
def _(x_pad, g_blocks, src_tbl, *args, out_shape=None, **kwargs) -> int:
    # Pallas block_diffusion.py:359
    return 2 * src_tbl[0] * src_tbl[1] * x_pad[1] * x_pad[1] * x_pad[2]


@_outer_padded_op.cuda
def _(x_pad, g_blocks, src_tbl, out_dtype):
    nb, mb = src_tbl.shape
    bs, r = x_pad.shape[1], x_pad.shape[2]
    out = torch.empty((nb, mb, bs, bs), dtype=out_dtype, device=x_pad.device)
    if nb * mb == 0:
        return out
    if r == 0:
        return out.zero_()
    src = src_tbl.reshape(-1)
    build.launch("outer_padded.cu", "gwt_outer_padded",
                 [_DTYPE_CODE[x_pad.dtype], x_pad.data_ptr(),
                  g_blocks.data_ptr(), src.data_ptr(), out.data_ptr(),
                  _DTYPE_CODE[out_dtype], nb * mb, mb, x_pad.shape[0], bs, r],
                 x_pad.device, "outer_padded")
    return out


# ---------------------------------------------------------------------------
# public wrappers: argument checks, then the op
# ---------------------------------------------------------------------------

def _on_kernel_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU one (the
    plain version runs); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def gathered_block_mix_flat(blocks: torch.Tensor, slot: torch.Tensor,
                            x: torch.Tensor, src: torch.Tensor,
                            row: torch.Tensor, *, nb: int,
                            transpose_lhs: bool,
                            row_ptr: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """out (nb, BSo, R): for each row-sorted entry l,
    ``blocks[slot[l]] (contract) x[src[l]]`` accumulated into row
    ``row[l]``. blocks (L+1, BSa, BSb); x (nbx, BSc, R); transpose_lhs
    contracts BSa (then BSo = BSb), else BSb (then BSo = BSa).

    ``row_ptr``: :func:`row_pointer` of ``row`` (supports cache it); built
    here when omitted."""
    bs_a, bs_b = blocks.shape[1], blocks.shape[2]
    bs_c, bs_o = (bs_a, bs_b) if transpose_lhs else (bs_b, bs_a)
    if x.ndim != 3 or x.shape[1] != bs_c:
        raise ValueError(f"x {tuple(x.shape)} must be (nbx, {bs_c}, R): "
                         "its rows match the contracted block axis")
    if _on_kernel_device(x):
        kc = 64 if blocks.dtype == torch.bfloat16 else 32
        if bs_o % 128 or bs_c % kc:
            raise ValueError(f"CUDA kernel needs output rows % 128 == 0 "
                             f"and contracted rows % {kc} == 0, got {bs_o}, "
                             f"{bs_c}")
        if row_ptr is None:
            row_ptr = row_pointer(row, nb)
        _check_cuda(x, blocks, slot, src, row_ptr)
        if row_ptr.numel() != nb + 1:
            raise ValueError(f"row_ptr has {row_ptr.numel()} entries, "
                             f"expected nb + 1 = {nb + 1}")
    return torch.ops.gwt_torch.mix_flat(blocks, slot, x, src, row, row_ptr,
                                        nb, transpose_lhs)


def gathered_block_mix_flat2(blocks: torch.Tensor, slot: torch.Tensor,
                             x: torch.Tensor, src: torch.Tensor,
                             row: torch.Tensor, *, nb: int, lag: int,
                             transpose_lhs: bool,
                             add: torch.Tensor | None = None,
                             row_ptr: torch.Tensor | None = None,
                             dispatch: str = "auto"):
    """Both order-2 hops: ``(out1, out2)``, each (nb, BS, R), out1 = mix(x)
    [+ add after the cast], out2 = mix(out1). Square blocks. Every
    destination row must appear in ``row`` (the flat builders add
    zero-block dummy entries).

    ``dispatch``: ``"fused"`` launches kernel 3 (one pass), ``"chain"``
    kernel 1, then ``+ add``, then kernel 1 again, which is the same
    function bit for bit; ``"auto"`` takes :func:`fused2_dispatch`'s
    choice for this dtype, R and ``add`` (host values only, so the choice
    is fixed in a trace).

    ``lag`` (:func:`fused2_lag`) replaces the reference's ``delay`` and
    ``ring_w``: kernel 3 runs hop 2 of row ``i`` after hop 1 of row
    ``i + lag`` or later (:func:`fused2_launch`), and keeps finished out1
    rows in device memory rather than in a ring."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, got "
                         f"{dispatch!r}")
    bs = blocks.shape[1]
    if blocks.shape[2] != bs:
        raise ValueError("the fused order-2 chain needs square blocks")
    if x.ndim != 3 or x.shape[1] != bs or x.shape[0] != nb:
        raise ValueError(f"x {tuple(x.shape)} must be ({nb}, {bs}, R)")
    if add is not None and add.shape != x.shape:
        raise ValueError(f"add {tuple(add.shape)} must match x "
                         f"{tuple(x.shape)}")
    if dispatch == "auto":
        dispatch = fused2_dispatch(x.shape[2], x.dtype, add=add is not None)
    if dispatch == "chain":
        o1 = gathered_block_mix_flat(blocks, slot, x, src, row, nb=nb,
                                     transpose_lhs=transpose_lhs,
                                     row_ptr=row_ptr)
        if add is not None:
            o1 = o1 + add.to(o1.dtype)
        return o1, gathered_block_mix_flat(blocks, slot, o1, src, row, nb=nb,
                                           transpose_lhs=transpose_lhs,
                                           row_ptr=row_ptr)
    if _on_kernel_device(x):
        if bs != 128:
            raise ValueError(f"CUDA fused kernel needs 128-row blocks, got "
                             f"{bs}")
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        if row_ptr is None:
            row_ptr = row_pointer(row, nb)
        _check_cuda(x, blocks, slot, src, row_ptr)
        if row_ptr.numel() != nb + 1:
            raise ValueError(f"row_ptr has {row_ptr.numel()} entries, "
                             f"expected nb + 1 = {nb + 1}")
        if add is not None:
            add = add.to(x.dtype).contiguous()
            if add.device != x.device:
                raise ValueError(f"add on {add.device}, x on {x.device}")
    return torch.ops.gwt_torch.mix_flat2(blocks, slot, x, src, row, row_ptr,
                                         add, nb, lag, transpose_lhs)


def gathered_block_outer_flat(x: torch.Tensor, g: torch.Tensor,
                              src: torch.Tensor, row: torch.Tensor, *,
                              slot: torch.Tensor | None = None,
                              n_slots: int | None = None,
                              out_dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """dW (Lt, BSx, BSg) fp32: for each table entry l (dummies included),
    ``x[src[l]] (BSx, R)`` contracted over R with ``g[row[l]] (BSg, R)``.
    x (nbx, BSx, R) and g (nbg, BSg, R) share a dtype; blocks may be
    rectangular.

    Given ``slot`` (the forward table's storage slot per entry) and
    ``n_slots`` (L + 1), the result is in storage order instead: (n_slots,
    BSx, BSg) in ``out_dtype`` (default fp32), entry l's product cast once
    into row ``slot[l]``, the dummy entries (``slot[l] == L``) skipped and
    row L exact zeros: the per-entry result gathered by ``inv_slot`` and
    cast, bit for bit."""
    if x.ndim != 3 or g.ndim != 3 or x.shape[2] != g.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must "
                         "be (nbx, BSx, R) and (nbg, BSg, R)")
    if src.shape != row.shape:
        raise ValueError("src and row tables must have one entry each")
    if slot is None:
        if n_slots is not None or out_dtype not in (None, torch.float32):
            raise ValueError("n_slots and out_dtype need slot: the "
                             "per-entry result is fp32")
    elif slot.shape != src.shape or n_slots is None or n_slots < 1:
        raise ValueError("slot needs one entry per table entry and "
                         "n_slots >= 1")
    if _on_kernel_device(x):
        bs_x, bs_g = x.shape[1], g.shape[1]
        if bs_x % 128 or bs_g % 64:
            raise ValueError(f"CUDA kernel needs x rows % 128 == 0 and g "
                             f"rows % 64 == 0, got {bs_x}, {bs_g}")
        if (out_dtype or torch.float32) not in _DTYPE_CODE:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                            f"{out_dtype}")
        tables = (src, row) if slot is None else (src, row, slot)
        _check_cuda(x, g, *tables, name="g")
    return torch.ops.gwt_torch.outer_flat(x, g, src, row, slot, n_slots,
                                          out_dtype)


def gathered_block_mix(blocks_flat: torch.Tensor, slot_tbl: torch.Tensor,
                       x_pad: torch.Tensor, src_tbl: torch.Tensor, *,
                       transpose_lhs: bool) -> torch.Tensor:
    """out (NB, BS, R): for each block-row i, the sum over its MB slots of
    ``blocks_flat[slot_tbl[i, m]] (contract) x_pad[src_tbl[i, m]]``, fp32
    accumulation, cast to x's dtype. blocks_flat (L, BS, BS); x_pad (NBx,
    BS, R); slot/src (NB, MB). transpose_lhs contracts the block's first
    axis (the ``nconv`` orientation), else its second.

    A slot outside ``blocks_flat`` or a source outside ``x_pad`` is a
    sentinel and contributes zero. So the reference's contract (a zero block
    and a zero block-row appended, the tables pointing at them) gives its
    result, and a caller may leave both out and save the copies."""
    if slot_tbl.ndim != 2 or src_tbl.shape != slot_tbl.shape:
        raise ValueError("pass slot/src tables as (NB, MB)")
    bs = blocks_flat.shape[1]
    if blocks_flat.ndim != 3 or blocks_flat.shape[2] != bs:
        raise ValueError(f"blocks {tuple(blocks_flat.shape)} must be "
                         "(L, BS, BS): the padded form has square blocks")
    if x_pad.ndim != 3 or x_pad.shape[1] != bs:
        raise ValueError(f"x {tuple(x_pad.shape)} must be (nbx, {bs}, R)")
    if _on_kernel_device(x_pad):
        if bs % 128:
            raise ValueError(f"CUDA kernel needs block size % 128 == 0, got "
                             f"{bs}")
        _check_cuda(x_pad, blocks_flat, slot_tbl.reshape(-1),
                    src_tbl.reshape(-1))
    return torch.ops.gwt_torch.mix_padded(blocks_flat, slot_tbl, x_pad,
                                          src_tbl, transpose_lhs)


def gathered_block_outer(x_pad: torch.Tensor, g_blocks: torch.Tensor,
                         src_tbl: torch.Tensor, *,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """dblocks (NB, MB, BS, BS) in ``out_dtype``: per slot (i, m),
    ``x_pad[src_tbl[i, m]]`` (BS, R) contracted over R with ``g_blocks[i]``
    (BS, R), fp32 accumulation, one cast. x_pad (NBx, BS, R) and g_blocks
    (NB, BS, R) share a dtype. A source outside ``x_pad`` is a sentinel:
    its slot comes out exactly zero (as the reference's zero row gives)."""
    if (src_tbl.ndim != 2 or x_pad.ndim != 3 or g_blocks.shape
            != (src_tbl.shape[0],) + tuple(x_pad.shape[1:])):
        raise ValueError(f"x {tuple(x_pad.shape)}, g {tuple(g_blocks.shape)} "
                         f"and src {tuple(src_tbl.shape)} must be (nbx, BS, "
                         "R), (NB, BS, R) and (NB, MB)")
    if _on_kernel_device(x_pad):
        if x_pad.shape[1] % 128:
            raise ValueError(f"CUDA kernel needs block size % 128 == 0, got "
                             f"{x_pad.shape[1]}")
        if out_dtype not in _DTYPE_CODE:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                            f"{out_dtype}")
        _check_cuda(x_pad, g_blocks, src_tbl.reshape(-1), name="g")
    return torch.ops.gwt_torch.outer_padded(x_pad, g_blocks, src_tbl,
                                            out_dtype)


# ---------------------------------------------------------------------------
# host-side schedule (verbatim from the reference package)
# ---------------------------------------------------------------------------

def fused2_schedule(row_tbl, src_tbl, n_rows: int,
                    max_ring: int = 24) -> tuple[int, int] | None:
    """(delay D, ring width W) for the fused order-2 kernel, or None when
    the layout's band is too wide to ring-buffer (unordered graphs).

    D = max over entries m of comp[src[m]] - m + 1 where comp[s] is the
    last entry index of dest row s (every x1 row is complete D entries
    before any hop-2 read of it). W = max over m of
    row[min(m + D, L-1)] - src[m] + 1 (no ring slot is overwritten
    between a row's completion and its last read)."""
    row = np.asarray(row_tbl, np.int64)
    src = np.asarray(src_tbl, np.int64)
    n_live = len(row)
    comp = np.zeros(n_rows, np.int64)
    comp[row] = np.arange(n_live)        # row-sorted: last index wins
    d = int((comp[src] - np.arange(n_live)).max()) + 1
    d = max(d, 1)
    w = int((row[np.minimum(np.arange(n_live) + d, n_live - 1)]
             - src).max()) + 1
    if w < 1 or w > max_ring:
        return None
    return d, w


def fused2_lag(row_tbl, src_tbl) -> int:
    """Rows by which the fused kernel runs hop 2 behind hop 1: the largest
    ``src - row`` over the entries, at least 0. Hop 2 of row ``i`` then
    reads only out1 rows that hop 1 finished at or before row ``i + lag``."""
    row = np.asarray(row_tbl, np.int64)
    src = np.asarray(src_tbl, np.int64)
    return max(0, int((src - row).max())) if len(row) else 0
