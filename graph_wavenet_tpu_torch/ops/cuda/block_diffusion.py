"""Block-sparse diffusion kernels: wrappers, plain versions, schedule.

Counterpart of ``graph_wavenet_tpu/ops/pallas/block_diffusion.py``:

- :func:`gathered_block_mix_flat` (kernel 1, ``csrc/mix_flat.cu``): for
  every live entry ``l``, ``out[row[l]] += blocks[slot[l]] (contract)
  x[src[l]]``, fp32 accumulation, one cast per output tile;
- :func:`gathered_block_mix_flat2` (kernel 3, ``csrc/mix_flat2.cu``): both
  order-2 hops in one launch, with an optional ``add`` after the inter-hop
  cast; bitwise equal to two calls of kernel 1;
- :func:`gathered_block_outer_flat` (kernel 2, ``csrc/outer_flat.cu``): the
  per-entry weight cotangent ``x[src[l]] . g[row[l]]^T`` over R, fp32 out,
  or, given the storage slots, written straight in storage order and dtype;
- :func:`gathered_block_mix` (kernel 4, ``csrc/mix_padded.cu``): kernel 1
  over a padded ``(NB, MB)`` table, sentinel slots skipped;
- :func:`gathered_block_outer` (kernel 5, ``csrc/outer_padded.cu``): the
  padded weight cotangent ``x[src[i, m]] . g[i]^T``, sentinel slots zero;
- :func:`fused2_schedule`: the reference's host-side (delay, ring width)
  schedule, copied verbatim; it decides which layouts fuse;
- :func:`fused2_lag`: the row lag the CUDA kernel orders its work by;
- :func:`tile_cols`: the R columns of one output tile of kernels 1, 3 and
  4, by one rule for all three.

A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the plain
PyTorch version beside it (gather, fp32 einsum, and for the mixes
``index_add_`` over the destination rows and a cast). Each wrapper counts
its kernel launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graph_wavenet_tpu_torch.ops.cuda import build

# kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {"gathered_block_mix_flat": 0, "gathered_block_mix_flat2": 0,
            "gathered_block_outer_flat": 0, "gathered_block_mix": 0,
            "gathered_block_outer": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def flag_count(nb: int, r: int, dtype: torch.dtype) -> int:
    """Length of kernel 3's int32 flags buffer: a completion flag per
    (destination row, R tile), then the ticket counter."""
    ct = tile_cols(r, dtype)
    return nb * -(-r // ct) + 1


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
# kernel wrappers
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


def _raise_on(lib: ctypes.CDLL, code: int, name: str) -> None:
    if code != 0:
        msg = lib.gwt_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({code})")


def _lib(source: str, fn: str, n_ptr: int, n_int: int) -> ctypes.CDLL:
    lib = build.load(source)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = [_I] + [_VP] * n_ptr + [_I] * n_int + [_VP]
        f.restype = _I
        lib.gwt_error_string.argtypes = [_I]
        lib.gwt_error_string.restype = ctypes.c_char_p
    return lib


def _check_aligned(blocks: torch.Tensor) -> None:
    """The bf16 kernels read the blocks with TMA, which needs a 16-byte
    aligned base."""
    if blocks.dtype == torch.bfloat16 and blocks.data_ptr() % 16:
        raise ValueError("bf16 blocks must start on a 16-byte boundary; "
                         "pass a fresh tensor (e.g. .clone()), not a view "
                         "at an odd offset")


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
    if x.device.type == "cpu":
        return mix_flat_plain(blocks, slot, x, src, row, nb=nb,
                              transpose_lhs=transpose_lhs)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    kc = 64 if blocks.dtype == torch.bfloat16 else 32
    if bs_o % 128 or bs_c % kc:
        raise ValueError(f"CUDA kernel needs output rows % 128 == 0 and "
                         f"contracted rows % {kc} == 0, got {bs_o}, {bs_c}")
    if row_ptr is None:
        row_ptr = row_pointer(row, nb)
    code = _check_cuda(x, blocks, slot, src, row_ptr)
    _check_aligned(blocks)
    if row_ptr.numel() != nb + 1:
        raise ValueError(f"row_ptr has {row_ptr.numel()} entries, "
                         f"expected nb + 1 = {nb + 1}")
    r = x.shape[2]
    out = torch.empty((nb, bs_o, r), dtype=x.dtype, device=x.device)
    if r == 0 or nb == 0:
        return out
    lib = _lib("mix_flat.cu", "gwt_mix_flat", 6, 8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gwt_mix_flat(code, blocks.data_ptr(), slot.data_ptr(),
                              x.data_ptr(), src.data_ptr(),
                              row_ptr.data_ptr(), out.data_ptr(), nb,
                              blocks.shape[0], x.shape[0], bs_c, bs_o, r,
                              int(transpose_lhs), tile_cols(r, x.dtype),
                              stream)
    _raise_on(lib, rc, "gathered_block_mix_flat")
    LAUNCHES["gathered_block_mix_flat"] += 1
    return out


def gathered_block_mix_flat2(blocks: torch.Tensor, slot: torch.Tensor,
                             x: torch.Tensor, src: torch.Tensor,
                             row: torch.Tensor, *, nb: int, lag: int,
                             transpose_lhs: bool,
                             add: torch.Tensor | None = None,
                             row_ptr: torch.Tensor | None = None):
    """Both order-2 hops in one launch: ``(out1, out2)``, each (nb, BS, R),
    out1 = mix(x) [+ add after the cast], out2 = mix(out1). Square blocks.
    Every destination row must appear in ``row`` (the flat builders add
    zero-block dummy entries).

    ``lag`` (:func:`fused2_lag`) replaces the reference's ``delay`` and
    ``ring_w``: the kernel runs hop 2 of row ``i`` after hop 1 of row
    ``i + lag``, and keeps finished out1 rows in device memory rather than
    in a ring."""
    bs = blocks.shape[1]
    if blocks.shape[2] != bs:
        raise ValueError("the fused order-2 chain needs square blocks")
    if x.ndim != 3 or x.shape[1] != bs or x.shape[0] != nb:
        raise ValueError(f"x {tuple(x.shape)} must be ({nb}, {bs}, R)")
    if add is not None and add.shape != x.shape:
        raise ValueError(f"add {tuple(add.shape)} must match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return mix_flat2_plain(blocks, slot, x, src, row, nb=nb,
                               transpose_lhs=transpose_lhs, add=add)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if bs != 128:
        raise ValueError(f"CUDA fused kernel needs 128-row blocks, got {bs}")
    if lag < 0:
        raise ValueError(f"lag must be >= 0, got {lag}")
    if row_ptr is None:
        row_ptr = row_pointer(row, nb)
    code = _check_cuda(x, blocks, slot, src, row_ptr)
    _check_aligned(blocks)
    if row_ptr.numel() != nb + 1:
        raise ValueError(f"row_ptr has {row_ptr.numel()} entries, "
                         f"expected nb + 1 = {nb + 1}")
    if add is not None:
        add = add.to(x.dtype).contiguous()
        if add.device != x.device:
            raise ValueError(f"add on {add.device}, x on {x.device}")
    r = x.shape[2]
    out1 = torch.empty_like(x)
    out2 = torch.empty_like(x)
    if r == 0 or nb == 0:
        return out1, out2
    lib = _lib("mix_flat2.cu", "gwt_mix_flat2", 9, 7)
    flags = torch.zeros(flag_count(nb, r, x.dtype), dtype=torch.int32,
                        device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gwt_mix_flat2(
            code, blocks.data_ptr(), slot.data_ptr(), x.data_ptr(),
            src.data_ptr(), row_ptr.data_ptr(),
            None if add is None else add.data_ptr(), out1.data_ptr(),
            out2.data_ptr(), flags.data_ptr(), nb, blocks.shape[0], lag, bs,
            r, int(transpose_lhs), tile_cols(r, x.dtype), stream)
    _raise_on(lib, rc, "gathered_block_mix_flat2")
    LAUNCHES["gathered_block_mix_flat2"] += 1
    return out1, out2


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
    if x.device.type == "cpu":
        # positional, so a stand-in that takes *args (a counting test) works
        return outer_flat_plain(x, g, src, row, slot, n_slots, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    bs_x, bs_g, r = x.shape[1], g.shape[1], x.shape[2]
    if bs_x % 128 or bs_g % 64:
        raise ValueError(f"CUDA kernel needs x rows % 128 == 0 and g rows "
                         f"% 64 == 0, got {bs_x}, {bs_g}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    tables = (src, row) if slot is None else (src, row, slot)
    code = _check_cuda(x, g, *tables, name="g")
    lt = src.numel()
    n_out = lt if slot is None else n_slots
    out = torch.empty((n_out, bs_x, bs_g), dtype=out_dtype, device=x.device)
    if lt == 0 or r == 0:
        return out.zero_()
    lib = _lib("outer_flat.cu", "gwt_outer_flat", 6, 8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gwt_outer_flat(
            code, x.data_ptr(), g.data_ptr(), src.data_ptr(), row.data_ptr(),
            None if slot is None else slot.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[out_dtype], lt, n_slots or 0, x.shape[0], g.shape[0],
            bs_x, bs_g, r, stream)
    _raise_on(lib, rc, "gathered_block_outer_flat")
    LAUNCHES["gathered_block_outer_flat"] += 1
    return out


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
    if x_pad.device.type == "cpu":
        return mix_padded_plain(blocks_flat, slot_tbl, x_pad, src_tbl,
                                transpose_lhs=transpose_lhs)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    if bs % 128:
        raise ValueError(f"CUDA kernel needs block size % 128 == 0, got {bs}")
    slot, src = slot_tbl.reshape(-1), src_tbl.reshape(-1)
    code = _check_cuda(x_pad, blocks_flat, slot, src)
    _check_aligned(blocks_flat)
    nb, mb = src_tbl.shape
    r = x_pad.shape[2]
    out = torch.empty((nb, bs, r), dtype=x_pad.dtype, device=x_pad.device)
    if r == 0 or nb == 0:
        return out
    lib = _lib("mix_padded.cu", "gwt_mix_padded", 5, 8)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream(x_pad.device).cuda_stream
        rc = lib.gwt_mix_padded(code, blocks_flat.data_ptr(), slot.data_ptr(),
                                x_pad.data_ptr(), src.data_ptr(),
                                out.data_ptr(), nb, mb, blocks_flat.shape[0],
                                x_pad.shape[0], bs, r, int(transpose_lhs),
                                tile_cols(r, x_pad.dtype), stream)
    _raise_on(lib, rc, "gathered_block_mix")
    LAUNCHES["gathered_block_mix"] += 1
    return out


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
    if x_pad.device.type == "cpu":
        return outer_padded_plain(x_pad, g_blocks, src_tbl,
                                  out_dtype=out_dtype)
    if x_pad.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_pad.device}")
    bs, r = x_pad.shape[1], x_pad.shape[2]
    if bs % 128:
        raise ValueError(f"CUDA kernel needs block size % 128 == 0, got {bs}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    src = src_tbl.reshape(-1)
    code = _check_cuda(x_pad, g_blocks, src, name="g")
    nb, mb = src_tbl.shape
    out = torch.empty((nb, mb, bs, bs), dtype=out_dtype, device=x_pad.device)
    if nb * mb == 0:
        return out
    if r == 0:
        return out.zero_()
    lib = _lib("outer_padded.cu", "gwt_outer_padded", 4, 6)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream(x_pad.device).cuda_stream
        rc = lib.gwt_outer_padded(code, x_pad.data_ptr(), g_blocks.data_ptr(),
                                  src.data_ptr(), out.data_ptr(),
                                  _DTYPE_CODE[out_dtype], nb * mb, mb,
                                  x_pad.shape[0], bs, r, stream)
    _raise_on(lib, rc, "gathered_block_outer")
    LAUNCHES["gathered_block_outer"] += 1
    return out


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
