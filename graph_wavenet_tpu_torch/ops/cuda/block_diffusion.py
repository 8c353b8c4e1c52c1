"""Flat block-sparse diffusion kernels: wrappers, plain versions, schedule.

Counterpart of ``graph_wavenet_tpu/ops/pallas/block_diffusion.py``'s flat
forward kernels:

- :func:`gathered_block_mix_flat` (kernel 1, ``csrc/mix_flat.cu``): for
  every live entry ``l``, ``out[row[l]] += blocks[slot[l]] (contract)
  x[src[l]]``, fp32 accumulation, one cast per output tile;
- :func:`gathered_block_mix_flat2` (kernel 3, ``csrc/mix_flat2.cu``): both
  order-2 hops in one launch, with an optional ``add`` after the inter-hop
  cast; bitwise equal to two calls of kernel 1;
- :func:`fused2_schedule`: the reference's host-side (delay, ring width)
  schedule, copied verbatim; it decides which layouts fuse;
- :func:`fused2_lag`: the row lag the CUDA kernel orders its work by.

A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the plain
PyTorch version beside it (gather, fp32 einsum, ``index_add_`` over the
destination rows, cast). Each wrapper counts its kernel launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graph_wavenet_tpu_torch.ops.cuda import build

# kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {"gathered_block_mix_flat": 0, "gathered_block_mix_flat2": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_tables(*tables: torch.Tensor) -> None:
    for t in tables:
        if t.dtype != torch.int32 or not t.is_contiguous() or t.ndim != 1:
            raise ValueError("entry tables must be contiguous 1-D int32")


def _check_cuda(x: torch.Tensor, blocks: torch.Tensor,
                *tables: torch.Tensor) -> int:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"CUDA block mix takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if blocks.dtype != x.dtype:
        raise TypeError(f"blocks ({blocks.dtype}) must be in x's dtype "
                        f"({x.dtype}); cast them first")
    for t in (x, blocks) + tables:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if not (x.is_contiguous() and blocks.is_contiguous()):
        raise ValueError("x and blocks must be contiguous")
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
        if hasattr(lib, "gwt_mix_flat2_tiles"):
            lib.gwt_mix_flat2_tiles.argtypes = [_I]
            lib.gwt_mix_flat2_tiles.restype = _I
    return lib


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
    if bs_o % 128 or bs_c % 32:
        raise ValueError(f"CUDA kernel needs output rows % 128 == 0 and "
                         f"contracted rows % 32 == 0, got {bs_o}, {bs_c}")
    if row_ptr is None:
        row_ptr = row_pointer(row, nb)
    code = _check_cuda(x, blocks, slot, src, row_ptr)
    if row_ptr.numel() != nb + 1:
        raise ValueError(f"row_ptr has {row_ptr.numel()} entries, "
                         f"expected nb + 1 = {nb + 1}")
    r = x.shape[2]
    out = torch.empty((nb, bs_o, r), dtype=x.dtype, device=x.device)
    if r == 0 or nb == 0:
        return out
    lib = _lib("mix_flat.cu", "gwt_mix_flat", 6, 5)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gwt_mix_flat(code, blocks.data_ptr(), slot.data_ptr(),
                              x.data_ptr(), src.data_ptr(),
                              row_ptr.data_ptr(), out.data_ptr(), nb, bs_c,
                              bs_o, r, int(transpose_lhs), stream)
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
    lib = _lib("mix_flat2.cu", "gwt_mix_flat2", 9, 5)
    # completion flag per (row, R tile), then the ticket counter
    flags = torch.zeros(nb * lib.gwt_mix_flat2_tiles(r) + 1,
                        dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.gwt_mix_flat2(
            code, blocks.data_ptr(), slot.data_ptr(), x.data_ptr(),
            src.data_ptr(), row_ptr.data_ptr(),
            None if add is None else add.data_ptr(), out1.data_ptr(),
            out2.data_ptr(), flags.data_ptr(), nb, lag, bs, r,
            int(transpose_lhs), stream)
    _raise_on(lib, rc, "gathered_block_mix_flat2")
    LAUNCHES["gathered_block_mix_flat2"] += 1
    return out1, out2


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
