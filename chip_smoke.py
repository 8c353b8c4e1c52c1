#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (graph_wavenet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failed check raises and the script
exits non-zero:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the CUDA kernels from csrc/, compiled in parallel;
3. kernel checks at the serving path's shapes (40,960 nodes, RCM flat
   supports, R = 3,072 and 32, fp32 and bf16): kernel 1 in both
   orientations on 128x128 and 128x512 blocks and kernel 3 with and
   without ``add`` against their plain versions, kernel 3 bitwise against
   two launches of kernel 1 (and timed against them: chain vs fused),
   with kernel, plain and library times; each line of kernels 1, 3 and 4
   names its tile width (``ct``) and product (fp32 FMAs, or ``wgmma`` in
   bf16); bf16 kernel 1 forward timed at every tile width at four R (the
   evidence for ``tile_cols``);
4. kernel checks at the training path's shapes (the 40,960-node adaptive
   mask, R = 1,536 and 128, fp32 and bf16): kernel 2 per entry against its
   plain version (and once on 128x512 blocks) and in storage order (as
   the flat backward launches it) against its plain version and bitwise
   against the per-entry launch gathered by ``inv_slot`` and cast, each
   line naming its product and tile; kernel 3 over the transpose tables
   with ``add`` against its plain version and bitwise against kernel 1 +
   add + kernel 1, kernel 1 in the transpose orientation;
5. small-N end to end: a 2,048-node fp32 city model at full width on the
   card matches the same model on the CPU (plain versions) to 2e-4, and
   its unfused supports give a bitwise-equal forecast;
6. small-N training: 3 train steps of the 2,048-node fp32 model with the
   adaptive adjacency on the card match 3 on the CPU, and one step's
   gradients with unfused supports and an unfused mask are bitwise equal
   to the fused ones;
7. serving at full width (a main path): a 40,960-node city checkpoint of
   random weights (bf16 activations) served by the port's serve CLI to
   concurrent requests, with the launch counters held to the layout; the
   same checkpoint under the 128x512 layout, whose supports do not fuse,
   runs kernel 1 instead; predict latency at batch 1 and 8;
8. training at full width (a main path): the port's training CLI trains
   the 40,960-node city model with the adaptive adjacency (bf16, batch 4)
   for one epoch on synthetic data, its checkpoint is served with one
   request, one train step's launch counters are held to the layout, and
   the train step is timed and profiled;
9. kernel checks at the padded form's shapes (the 40,960-node RCM padded
   support, 320 x 11 slots, fp32 and bf16): kernel 4 forward (R = 3,072
   and 32) and over the transpose tables (R = 1,536 and 128) against its
   plain version and bitwise against kernel 1 on ``as_flat_pallas``'s
   tables, kernel 5 (R = 1,536 and 128, output in the storage dtype)
   against its plain version, sentinel slots zero, a repeat bit-identical,
   and (fp32 output) bitwise against kernel 2 on ``as_flat_pallas``'s
   tables; the host build of the padded supports timed beside the flat one;
10. small-N padded: the 2,048-node fp32 model over "pallas" supports on the
   card against the CPU (2e-4) and bitwise against the flat form, 3 train
   steps with the adaptive adjacency against the CPU, one gradient with
   respect to the padded blocks against the CPU;
11. padded serving and training at full width (main paths): phases 7 and 8
   for a checkpoint whose layout says "pallas" (32 kernel-4 launches per
   forward; a train step 32 + 28 kernel-4, 15 kernel-3, 14 kernel-2 and no
   kernel-5 launches);
12. kernel 5's path at full width: one forward and backward of the gcn at
   the first layer's training shape (batch 4, bf16, R = 1,536) over the
   padded supports with blocks that require a gradient (4 kernel-5
   launches), each launch held against its plain version on the card.

Before the last line it prints one ``{"kernels": [...]}`` line and the
card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. It needs the repository around it and a
CUDA card, and exits non-zero without either.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
N_CITY = 40_960
N_SMALL = 2_048
KNN = 8
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
K1_SRC = "graph_wavenet_tpu_torch/csrc/mix_flat.cu"
K2_SRC = "graph_wavenet_tpu_torch/csrc/outer_flat.cu"
K3_SRC = "graph_wavenet_tpu_torch/csrc/mix_flat2.cu"
K4_SRC = "graph_wavenet_tpu_torch/csrc/mix_padded.cu"
K5_SRC = "graph_wavenet_tpu_torch/csrc/outer_padded.cu"
K1_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:167"
K2_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:256"
K3_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:497"
K4_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:74"
K5_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:325"
TRAIN_BATCH = 4
TRAIN_SAMPLES = {"train": 16, "val": 4, "test": 4}


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


class CheckFailed(AssertionError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up. At
    small R a launch takes ~40 us, so the callers time 100 there: over 20,
    kernel 4's R = 32 row read 0.037 to 0.075 ms across runs (H100 80GB
    HBM3, 700 W)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tile_of(r: int, dtype) -> dict:
    """The tile width kernels 1, 3 and 4 take at R = r, and the product
    they run it on."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    return {"ct": bd.tile_cols(r, dtype),
            "product": "wgmma" if dtype == torch.bfloat16 else "fp32 FMA"}


def close_err(got, want, summand=None) -> tuple[float, bool, str]:
    """Max |got - want| and whether it is within the dtype's tolerance:
    fp32 rtol 1e-5 (atol 1e-5 of the largest value); bf16 one bf16 ulp of
    the larger of the two values, plus fp32 accumulation-order slack of
    2^-20 of the largest value. ``summand``: the term added after the
    rounding that the tolerance covers (kernel 3's ``add``); its result is
    rounded once more, so one more ulp, of the value before the add, is
    allowed."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    scale = w.abs().max().clamp_min(1e-30)

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.clamp_min(1e-30))) - 7)

    if got.dtype == torch.float32:
        tol = 1e-5 * w.abs() + 1e-5 * scale
        rule = "rtol 1e-5, atol 1e-5 x max|plain|"
    else:
        tol = ulp(torch.maximum(g.abs(), w.abs())) + scale * 2.0 ** -20
        rule = "1 bf16 ulp + 2^-20 x max|plain|"
        if summand is not None:
            tol = tol + ulp((w - summand.float()).abs())
            rule += " (+1 ulp of the value before add)"
    return float(diff.max()), bool((diff <= tol).all()), rule


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def hop_cost(sp, r: int, isz: int, fused: bool, with_add: bool = False):
    """Operations and bytes one call needs: the live blocks' products
    (dummy entries on the zero block need none), every input read once
    and every output written once."""
    n_live = sp.n_live
    bs_a, bs_b = sp.blocks_flat.shape[1], sp.blocks_flat.shape[2]
    hops = 2 if fused else 1
    flops = 2.0 * n_live * bs_a * bs_b * r * hops
    table_bytes = 4 * (3 * sp.row_tbl.numel() + sp.nb + 1)
    outs = 2 if fused else 1
    nbytes = (sp.blocks_flat.numel() * isz + sp.n_nodes * r * isz
              + with_add * sp.n_nodes * r * isz
              + outs * sp.n_nodes * r * isz + table_bytes)
    return flops, nbytes


def library_hop(sp, x2, transpose_lhs: bool):
    """One PyTorch call computing the same hop, for the yardstick time:
    a block-sparse (BSR) product where PyTorch runs one for this dtype on
    CUDA, else a dense matmul against the materialized support. Returns
    (fn, name, out)."""
    import torch

    if transpose_lhs:
        row, src, slot = sp.row_tbl, sp.src_tbl, sp.slot_tbl
        vals = sp.blocks_flat[slot.long()].transpose(1, 2)
        nb, bs_o, bs_c = sp.nb, sp.blocks_flat.shape[2], sp.blocks_flat.shape[1]
    else:
        row, src, slot = sp.row_t, sp.src_t, sp.slot_t
        vals = sp.blocks_flat[slot.long()]
        bs_o, bs_c = sp.blocks_flat.shape[1], sp.blocks_flat.shape[2]
        nb = sp.n_nodes // bs_o
    vals = vals.to(x2.dtype).contiguous()
    crow = torch.searchsorted(row.long(), torch.arange(
        nb + 1, device=row.device))
    n_out, n_in = nb * bs_o, x2.shape[0]
    bsr = torch.sparse_bsr_tensor(crow, src.long(), vals,
                                  size=(n_out, n_in))
    try:
        out = bsr @ x2
        torch.cuda.synchronize()
        return (lambda: bsr @ x2), "torch.sparse_bsr_tensor @ dense", out
    except (RuntimeError, NotImplementedError) as e:
        reason = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    dense = bsr.to_dense()
    del bsr
    out = dense @ x2
    return (lambda: dense @ x2), f"dense torch.matmul ({reason})", out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0])
    return smi


def phase_build() -> None:
    from graph_wavenet_tpu_torch.ops.cuda import build

    secs = build.build_all()
    regs = {src: [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
            for src, log in build.build_log.items()}
    emit("build", seconds=round(secs, 3), sources=list(build.SOURCES),
         ptxas=regs)


def city_graph(n: int):
    import numpy as np

    from graph_wavenet_tpu_torch.graphs.spatial import knn_graph_edges

    pos = np.random.default_rng(0).random((n, 2))
    src, dst, w = knn_graph_edges(pos, KNN)
    return pos, src, dst, w


def phase_kernels(graph) -> dict:
    """Kernels 1 and 3 against their plain versions at the main path's
    shapes; returns the numbers for the kernels line."""
    import torch

    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )
    from graph_wavenet_tpu_torch.ops.block_sparse import Fused2FlatSupport
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    _, src, dst, w = graph
    t0 = time.perf_counter()
    perm = rcm_order_edges(src, dst, N_CITY)
    sq = doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                         form="flat", device="cuda")[0]
    rect = doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                           form="flat-rect",
                                           device="cuda")[0]
    require(isinstance(sq, Fused2FlatSupport),
            "the RCM layout at 40,960 nodes must fuse")
    emit("supports", seconds=round(time.perf_counter() - t0, 3),
         ordering="rcm", square_live_blocks=sq.n_live,
         rect_live_blocks=rect.n_live, delay=sq.delay, ring_w=sq.ring_w,
         lag=sq.lag)
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        for r in (3072, 32):
            reps = 5 if r > 256 else 100
            for sp, label in ((sq, "128x128"), (rect, "128x512")):
                bsd = sp.astype(dtype)
                blocks = bsd.blocks_flat
                for tl in (True, False):
                    if tl:
                        tbl = (sp.slot_tbl, sp.src_tbl, sp.row_tbl)
                        nb, bs_c = sp.nb, blocks.shape[1]
                        ptr = sp.row_ptr
                    else:
                        tbl = (sp.slot_t, sp.src_t, sp.row_t)
                        bs_c = blocks.shape[2]
                        nb = sp.n_nodes // blocks.shape[1]
                        ptr = bd.row_pointer(sp.row_t, nb)
                    slot, srct, rowt = tbl
                    x = torch.randn(sp.n_nodes // bs_c, bs_c, r,
                                    generator=gen, device="cuda").to(dtype)

                    def k1():
                        return bd.gathered_block_mix_flat(
                            blocks, slot, x, srct, rowt, nb=nb,
                            transpose_lhs=tl, row_ptr=ptr)

                    def plain():
                        return bd.mix_flat_plain(blocks, slot, x, srct,
                                                 rowt, nb=nb,
                                                 transpose_lhs=tl)

                    got, want = k1(), plain()
                    torch.cuda.synchronize()
                    err, ok, rule = close_err(got, want)
                    del want
                    rec = dict(kernel="gathered_block_mix_flat",
                               dtype=dname, R=r, **tile_of(r, dtype),
                               blocks=label,
                               orientation="forward" if tl else "transpose",
                               max_abs_err=err, tolerance=rule)
                    require(ok, f"kernel 1 disagrees with its plain "
                                f"version: {rec}")
                    rec["kernel_ms"] = cuda_ms(k1, reps)
                    rec["plain_ms"] = cuda_ms(plain, max(2, reps // 5))
                    lib_fn, lib_name, lib_out = library_hop(
                        bsd, x.reshape(-1, r), tl)
                    lib_err, _, _ = close_err(
                        lib_out.reshape(got.shape).to(dtype), got)
                    del lib_out
                    rec["library_ms"] = cuda_ms(lib_fn, max(2, reps // 5))
                    rec["library"] = lib_name
                    rec["library_max_abs_diff"] = lib_err
                    flops, nbytes = hop_cost(sp, r, isz, fused=False)
                    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes,
                                                             dname)
                    del lib_fn
                    emit("kernel_check", **rec)
                    if (label, tl, dname, r) == ("128x128", True,
                                                 "bfloat16", 3072):
                        summary["k1"] = rec
                    del got
                    torch.cuda.empty_cache()
            # kernel 3 on the square support, with and without add
            blocks = sq.astype(dtype).blocks_flat
            x = torch.randn(sq.nb, 128, r, generator=gen,
                            device="cuda").to(dtype)
            for with_add in (False, True):
                add = (torch.randn(sq.nb, 128, r, generator=gen,
                                   device="cuda").to(dtype)
                       if with_add else None)
                args = (blocks, sq.slot_tbl, x, sq.src_tbl, sq.row_tbl)

                def k3():
                    return bd.gathered_block_mix_flat2(
                        *args, nb=sq.nb, lag=sq.lag, transpose_lhs=True,
                        add=add, row_ptr=sq.row_ptr)

                def k3_plain():
                    return bd.mix_flat2_plain(*args, nb=sq.nb,
                                              transpose_lhs=True, add=add)

                def chain():
                    c1 = bd.gathered_block_mix_flat(*args, nb=sq.nb,
                                                    transpose_lhs=True,
                                                    row_ptr=sq.row_ptr)
                    if add is not None:
                        c1 = c1 + add
                    return c1, bd.gathered_block_mix_flat(
                        blocks, sq.slot_tbl, c1, sq.src_tbl, sq.row_tbl,
                        nb=sq.nb, transpose_lhs=True, row_ptr=sq.row_ptr)

                o1, o2 = k3()
                # bitwise against two launches of kernel 1
                c1, c2 = chain()
                torch.cuda.synchronize()
                bitwise = bool(torch.equal(o1, c1) and torch.equal(o2, c2))
                del c1, c2
                p1, _ = k3_plain()
                err1, ok1, rule = close_err(o1, p1, summand=add)
                del p1
                # hop 2 against the plain hop over the kernel's own out1
                p2 = bd.mix_flat_plain(blocks, sq.slot_tbl, o1, sq.src_tbl,
                                       sq.row_tbl, nb=sq.nb,
                                       transpose_lhs=True)
                err2, ok2, _ = close_err(o2, p2)
                del p2, o1, o2
                rec = dict(kernel="gathered_block_mix_flat2", dtype=dname,
                           R=r, **tile_of(r, dtype), blocks="128x128",
                           add=with_add,
                           max_abs_err_out1=err1, max_abs_err_out2=err2,
                           tolerance=rule, bitwise_vs_two_kernel1=bitwise)
                require(ok1 and ok2, f"kernel 3 disagrees with its plain "
                                     f"version: {rec}")
                require(bitwise, f"kernel 3 is not bitwise equal to two "
                                 f"launches of kernel 1: {rec}")
                rec["kernel_ms"] = cuda_ms(k3, reps)
                rec["chain_ms"] = cuda_ms(chain, reps)
                rec["plain_ms"] = cuda_ms(k3_plain, max(2, reps // 5))
                rec["library_ms"] = None
                flops, nbytes = hop_cost(sq, r, isz, fused=True,
                                         with_add=with_add)
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes,
                                                         dname)
                emit("kernel_check", **rec)
                if (dname, r, with_add) == ("bfloat16", 3072, False):
                    summary["k3"] = rec
                del add
                torch.cuda.empty_cache()
    tile_widths(sq, gen)
    return summary


def tile_widths(sq, gen) -> None:
    """bf16 kernel 1 forward on the square support at each tile width the
    product builds, through the library's entry point (the wrapper always
    takes ``tile_cols``'s width): the measurement behind that rule. These
    launches are not counted."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    blocks = sq.astype(torch.bfloat16).blocks_flat
    lib = bd._lib("mix_flat.cu", "gwt_mix_flat", 6, 8)
    for r in (384, 640, 1152, 3072):
        x = torch.randn(sq.nb, 128, r, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream

        def at(ct):
            rc = lib.gwt_mix_flat(
                1, blocks.data_ptr(), sq.slot_tbl.data_ptr(), x.data_ptr(),
                sq.src_tbl.data_ptr(), sq.row_ptr.data_ptr(), out.data_ptr(),
                sq.nb, blocks.shape[0], x.shape[0], 128, 128, r, 1, ct,
                stream)
            require(rc == 0, f"kernel 1 at {ct} columns: "
                             f"{lib.gwt_error_string(rc).decode()}")

        ms = {ct: cuda_ms(lambda: at(ct), 20 if r < 1000 else 5)
              for ct in (64, 128, 256)}
        emit("tile_widths", kernel="gathered_block_mix_flat", dtype="bfloat16",
             R=r, orientation="forward", ms_by_ct=ms,
             tile_cols=bd.tile_cols(r, torch.bfloat16))
        del x, out


def outer_tile_of(dtype, bs_g: int) -> dict:
    """The product kernels 2 and 5 run on ``dtype`` inputs, and its output
    tile (x rows x g rows)."""
    import torch

    if dtype == torch.bfloat16:
        return {"product": "wgmma (TMA ring)",
                "tile": f"128x{128 if bs_g % 128 == 0 else 64}"}
    return {"product": "fp32 FMA", "tile": "128x64"}


def outer_cost(mask, r: int, isz: int,
               storage_isz: int | None = None) -> tuple[float, float]:
    """Operations and bytes of one kernel-2 launch over the mask's forward
    table, x and g read once and the output written once. Per entry: one
    (BS, BS) product over R per table entry, fp32 out. In storage order
    (``storage_isz``: the output's element size): the live entries'
    products only (the dummies are skipped), L + 1 blocks out."""
    lt = mask.row_tbl.numel()
    bs = mask.bs_src
    if storage_isz is None:
        flops = 2.0 * lt * bs * bs * r
        nbytes = 2 * mask.n_nodes * r * isz + lt * bs * bs * 4 + 8 * lt
    else:
        flops = 2.0 * mask.n_live * bs * bs * r
        nbytes = (2 * mask.n_nodes * r * isz
                  + (mask.n_live + 1) * bs * bs * storage_isz + 12 * lt)
    return flops, nbytes


def rounded_check(got, want, tol) -> tuple[float, bool]:
    """``got`` against the fp32 sums ``want`` within ``tol``, plus one ulp
    where ``got`` is bf16 (both round the fp32 sum once). Returns the
    largest difference from ``want`` in got's dtype, and the verdict."""
    import torch

    if got.dtype == torch.bfloat16:
        mag = torch.maximum(got.float().abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (got.float() - want).abs()
    ok = bool((diff <= tol + 1e-30).all())
    err = float((got.float() - want.to(got.dtype).float()).abs().max())
    return err, ok


def outer_check(got, x, g, src, row, slot=None) -> tuple[float, bool]:
    """Kernel 2 against its plain version: rtol 1e-5 of the sum of |terms|
    (bf16 inputs multiply exactly in fp32, so the bound holds for both),
    plus one ulp of a bf16 output. ``slot``: ``got`` is in storage order."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    store = (() if slot is None
             else (slot, got.shape[0], torch.float32))
    with torch.no_grad():
        want = bd.outer_flat_plain(x, g, src, row, *store)
        tol = bd.outer_flat_plain(x.abs(), g.abs(), src, row,
                                  *store).mul_(1e-5)
        return rounded_check(got, want, tol)


def phase_train_kernels(graph) -> dict:
    """Kernels 2, 3 (transpose tables, ``add``) and 1 (transpose
    orientation) at the training path's shapes: the adaptive mask of the
    40,960-node RCM supports, R = 1,536 and 128 (batch 4, first and last
    layer). Returns the numbers for the kernels line."""
    import torch

    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )
    from graph_wavenet_tpu_torch.ops.adaptive_block import mask_from_supports
    from graph_wavenet_tpu_torch.ops.block_sparse import from_edges_flat
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    _, src, dst, w = graph
    perm = rcm_order_edges(src, dst, N_CITY)
    sups = doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                           form="flat", device="cuda")
    mask = mask_from_supports(sups, hops=1)
    require(mask.fuse2 is not None and mask.fuse2[2] > 0,
            f"the 40,960-node mask must fuse both ways: {mask.fuse2}")
    emit("train_mask", live_blocks=mask.n_live,
         table_entries=mask.row_tbl.numel(), fuse2=list(mask.fuse2),
         lag=mask.lag, lag_t=mask.lag_t)
    gen = torch.Generator(device="cuda").manual_seed(1)
    nv1 = torch.randn(N_CITY, 10, generator=gen, device="cuda")
    nv2 = torch.randn(10, N_CITY, generator=gen, device="cuda")
    nb, bs = mask.n_dst_blocks, mask.bs_src
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        sp = mask.materialize(nv1, nv2, out_dtype=dtype)
        blocks = sp.blocks_flat
        for r in (1536, 128):
            reps = 5 if r > 256 else 100
            x = torch.randn(nb, bs, r, generator=gen,
                            device="cuda").to(dtype)
            g = torch.randn(nb, bs, r, generator=gen,
                            device="cuda").to(dtype)

            # kernel 2 over the mask's forward table
            def k2():
                return bd.gathered_block_outer_flat(x, g, sp.src_tbl,
                                                    sp.row_tbl)

            def k2_plain():
                return bd.outer_flat_plain(x, g, sp.src_tbl, sp.row_tbl)

            got = k2()
            torch.cuda.synchronize()
            err, ok = outer_check(got, x, g, sp.src_tbl, sp.row_tbl)
            again = k2()
            deterministic = bool(torch.equal(got, again))
            del got, again
            rec = dict(kernel="gathered_block_outer_flat", dtype=dname, R=r,
                       **outer_tile_of(dtype, bs), blocks="128x128",
                       form="per entry", table_entries=sp.row_tbl.numel(),
                       max_abs_err=err, tolerance="rtol 1e-5 of sum |terms|",
                       deterministic=deterministic)
            require(ok, f"kernel 2 disagrees with its plain version: {rec}")
            require(deterministic, f"kernel 2 is not deterministic: {rec}")
            rec["kernel_ms"] = cuda_ms(k2, reps)
            rec["plain_ms"] = cuda_ms(k2_plain, max(2, reps // 5))
            xs = x.index_select(0, sp.src_tbl.long())
            gs = g.index_select(0, sp.row_tbl.long()).transpose(1, 2)
            lib_ms = cuda_ms(lambda: torch.bmm(xs, gs), max(2, reps // 5))
            lib_name = ("torch.bmm on operands gathered beforehand (gather "
                        "excluded; output in the input dtype)")
            rec["library_ms"], rec["library"] = lib_ms, lib_name
            del xs, gs
            flops, nbytes = outer_cost(mask, r, isz)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)
            torch.cuda.empty_cache()

            # kernel 2 in storage order and the blocks' dtype, as the flat
            # backward launches it, against the per-entry launch gathered by
            # inv_slot and cast (the path it replaced)
            n_slots = blocks.shape[0]
            store = dict(slot=sp.slot_tbl, n_slots=n_slots, out_dtype=dtype)

            def k2s():
                return bd.gathered_block_outer_flat(x, g, sp.src_tbl,
                                                    sp.row_tbl, **store)

            def per_entry_gathered():
                d = k2()
                return torch.cat([d, d.new_zeros((1,) + d.shape[1:])]
                                 ).index_select(0, sp.inv_slot.long()
                                                ).to(dtype)

            got, want, again = k2s(), per_entry_gathered(), k2s()
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(got, want))
            deterministic = bool(torch.equal(got, again))
            zero_slot = not bool(got[n_slots - 1].any())
            del want, again
            err, ok = outer_check(got, x, g, sp.src_tbl, sp.row_tbl,
                                  sp.slot_tbl)
            del got
            rec = dict(kernel="gathered_block_outer_flat", dtype=dname, R=r,
                       **outer_tile_of(dtype, bs), blocks="128x128",
                       form="storage order", out_dtype=dname,
                       n_slots=n_slots, live_entries=sp.n_live,
                       max_abs_err=err, tolerance="rtol 1e-5 of sum |terms| "
                       "(+1 ulp of a bf16 output)",
                       bitwise_vs_per_entry_gathered=bitwise,
                       zero_slot_zero=zero_slot, deterministic=deterministic)
            require(ok, f"kernel 2 in storage order disagrees with its "
                        f"plain version: {rec}")
            require(bitwise and zero_slot and deterministic,
                    f"kernel 2 in storage order is not the per-entry launch "
                    f"gathered, bit for bit: {rec}")
            rec["kernel_ms"] = cuda_ms(k2s, reps)
            rec["per_entry_gathered_ms"] = cuda_ms(per_entry_gathered, reps)
            rec["plain_ms"] = cuda_ms(
                lambda: bd.outer_flat_plain(x, g, sp.src_tbl, sp.row_tbl,
                                            sp.slot_tbl, n_slots, dtype),
                max(2, reps // 5))
            rec["library_ms"], rec["library"] = lib_ms, lib_name
            flops, nbytes = outer_cost(mask, r, isz, storage_isz=isz)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)
            if (dname, r) == ("bfloat16", 1536):
                summary["k2"] = rec
            torch.cuda.empty_cache()

            # kernel 3 over the transpose tables with add: the fused
            # backward chain (g1_eff, dx) of one hop pair
            args = (blocks, sp.slot_t, g, sp.src_t, sp.row_t)

            def k3t():
                return bd.gathered_block_mix_flat2(
                    *args, nb=nb, lag=sp.lag_t, transpose_lhs=False, add=x,
                    row_ptr=sp.row_ptr_t)

            def k3t_plain():
                return bd.mix_flat2_plain(*args, nb=nb, transpose_lhs=False,
                                          add=x)

            def chain():
                c1 = bd.gathered_block_mix_flat(*args, nb=nb,
                                                transpose_lhs=False,
                                                row_ptr=sp.row_ptr_t) + x
                return c1, bd.gathered_block_mix_flat(
                    blocks, sp.slot_t, c1, sp.src_t, sp.row_t, nb=nb,
                    transpose_lhs=False, row_ptr=sp.row_ptr_t)

            o1, o2 = k3t()
            c1, c2 = chain()
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(o1, c1) and torch.equal(o2, c2))
            del c1, c2
            p1, _ = k3t_plain()
            err1, ok1, rule = close_err(o1, p1, summand=x)
            del p1
            p2 = bd.mix_flat_plain(blocks, sp.slot_t, o1, sp.src_t, sp.row_t,
                                   nb=nb, transpose_lhs=False)
            err2, ok2, _ = close_err(o2, p2)
            del p2, o1, o2
            rec = dict(kernel="gathered_block_mix_flat2", dtype=dname, R=r,
                       **tile_of(r, dtype), tables="transpose", add=True,
                       max_abs_err_out1=err1, max_abs_err_out2=err2,
                       tolerance=rule, bitwise_vs_kernel1_add_kernel1=bitwise)
            require(ok1 and ok2, f"kernel 3 over the transpose tables "
                                 f"disagrees with its plain version: {rec}")
            require(bitwise, f"kernel 3 over the transpose tables is not "
                             f"bitwise equal to kernel 1 + add + kernel 1: "
                             f"{rec}")
            rec["kernel_ms"] = cuda_ms(k3t, reps)
            rec["chain_ms"] = cuda_ms(chain, reps)
            rec["plain_ms"] = cuda_ms(k3t_plain, max(2, reps // 5))
            rec["library_ms"] = None
            flops, nbytes = hop_cost(sp, r, isz, fused=True, with_add=True)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)

            # kernel 1 in the transpose orientation on the mask's tables
            def k1t():
                return bd.gathered_block_mix_flat(
                    *args, nb=nb, transpose_lhs=False, row_ptr=sp.row_ptr_t)

            got = k1t()
            want = bd.mix_flat_plain(*args, nb=nb, transpose_lhs=False)
            torch.cuda.synchronize()
            err, ok, rule = close_err(got, want)
            del got, want
            rec = dict(kernel="gathered_block_mix_flat", dtype=dname, R=r,
                       **tile_of(r, dtype), tables="transpose (mask)",
                       max_abs_err=err, tolerance=rule)
            require(ok, f"kernel 1 (transpose, mask) disagrees with its "
                        f"plain version: {rec}")
            rec["kernel_ms"] = cuda_ms(k1t, reps)
            rec["plain_ms"] = cuda_ms(
                lambda: bd.mix_flat_plain(*args, nb=nb, transpose_lhs=False),
                max(2, reps // 5))
            lib_fn, lib_name, lib_out = library_hop(sp, g.reshape(-1, r),
                                                    False)
            del lib_out
            rec["library_ms"] = cuda_ms(lib_fn, max(2, reps // 5))
            rec["library"] = lib_name
            del lib_fn
            flops, nbytes = hop_cost(sp, r, isz, fused=False)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)
            del x, g
            torch.cuda.empty_cache()

    # kernel 2 once on 128x512 blocks: the wrapper never launches a shape
    # that was never run (no training path sends it there)
    rect = from_edges_flat(src, dst, w, N_CITY, 128, 512, perm=perm,
                           device="cuda")
    x = torch.randn(N_CITY // 128, 128, 128, generator=gen, device="cuda")
    g = torch.randn(N_CITY // 512, 512, 128, generator=gen, device="cuda")
    got = bd.gathered_block_outer_flat(x, g, rect.src_tbl, rect.row_tbl)
    torch.cuda.synchronize()
    err, ok = outer_check(got, x, g, rect.src_tbl, rect.row_tbl)
    emit("kernel_check", kernel="gathered_block_outer_flat", dtype="float32",
         R=128, blocks="128x512", max_abs_err=err)
    require(ok, f"kernel 2 on 128x512 blocks disagrees: {err}")
    return summary


def phase_small_e2e(seed: int = 0) -> None:
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.ops import block_sparse as bsp
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    pos, src, dst, w = city_graph(N_SMALL)
    cfg = ModelConfig(num_nodes=N_SMALL, addaptadj=False, dropout=0.0,
                      dtype="float32")
    scaler = StandardScaler(50.0, 10.0)
    fcs = {}
    for dev in ("cuda", "cpu"):
        sup, _, layout = build_city_supports(src, dst, w, N_SMALL, pos=pos,
                                             ordering="rcm", device=dev)
        model = GWNet(cfg, device=dev, seed=seed)
        fcs[dev] = Forecaster(cfg, model, sup, scaler, node_layout=layout)
    require(all(isinstance(s, bsp.Fused2FlatSupport)
                for s in fcs["cuda"].supports), "2,048-node RCM must fuse")
    x = np.random.default_rng(1).normal(
        size=(2, 12, N_SMALL, 2)).astype(np.float32)
    bd.reset_launch_counts()
    card = fcs["cuda"].predict(x)
    torch.cuda.synchronize()
    k3 = bd.LAUNCHES["gathered_block_mix_flat2"]
    cpu = fcs["cpu"].predict(x)
    err = float((card.cpu() - cpu).abs().max())
    unfused = Forecaster(cfg, fcs["cuda"].model,
                         [bsp.as_unfused(s) for s in fcs["cuda"].supports],
                         scaler, node_layout=fcs["cuda"].node_layout)
    bd.reset_launch_counts()
    card_unfused = unfused.predict(x)
    torch.cuda.synchronize()
    k1 = bd.LAUNCHES["gathered_block_mix_flat"]
    bitwise = bool(torch.equal(card, card_unfused))
    ok = bool(torch.allclose(card.cpu(), cpu, rtol=2e-4, atol=2e-4))
    emit("small_e2e", nodes=N_SMALL, dtype="float32", shape=list(card.shape),
         max_abs_err_vs_cpu=err, tolerance="rtol/atol 2e-4",
         unfused_bitwise_equal=bitwise, kernel3_launches_fused=k3,
         kernel1_launches_unfused=k1)
    layers = cfg.blocks * cfg.layers
    require(ok, f"card vs CPU forecast differ by {err}")
    require(bitwise, "unfused forecast is not bitwise equal to the fused")
    require(k3 == 2 * layers and k1 == 2 * 2 * layers,
            f"launch counts {k3}, {k1} do not match the layout")


def small_train_run(form: str, seed: int = 0):
    """3 train steps of the 2,048-node fp32 model with the adaptive
    adjacency over ``form`` supports on the card (kernels) and on the CPU
    (plain versions) from the same weights, held to each other. Returns
    the card's engine and supports, the batches and the card's launch
    counts."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.train.engine import Engine

    pos, src, dst, w = city_graph(N_SMALL)
    cfg = ModelConfig(num_nodes=N_SMALL, addaptadj=True, dropout=0.0,
                      dtype="float32")
    scaler = StandardScaler(50.0, 10.0)
    sups, engines = {}, {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        sup, mask, _ = build_city_supports(src, dst, w, N_SMALL, pos=pos,
                                           ordering="rcm", form=form,
                                           addaptadj=True, device=dev)
        sups[where] = sup + [mask]
        engines[where] = Engine(cfg, TrainConfig(), scaler, device=dev,
                                seed=seed)
    engines["host"].model.load_state_dict(
        engines["card"].model.state_dict())
    rng = np.random.default_rng(5)
    steps, batch = 3, 2
    xs = rng.normal(size=(steps, batch, 12, N_SMALL, 2)).astype(np.float32)
    ys = rng.normal(50.0, 10.0, size=(steps, batch, 12, N_SMALL, 2)
                    ).astype(np.float32)
    ys[:, :, :, :16, 0] = 0.0
    losses = {}
    for where, eng in engines.items():
        bd.reset_launch_counts()
        losses[where] = [float(eng.train_step(xs[i], ys[i],
                                              sups[where])["loss"])
                         for i in range(steps)]
        if where == "card":
            counts = dict(bd.LAUNCHES)
    sd = {where: {k: v.float().cpu() for k, v in
                  eng.model.state_dict().items()}
          for where, eng in engines.items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["host"]))
    worst = max(((sd["card"][k] - sd["host"][k]).abs()
                 - 1e-4 * sd["host"][k].abs()).max().item()
                for k in sd["host"])
    emit("small_train", form=form, nodes=N_SMALL, dtype="float32",
         steps=steps, batch=batch, losses_card=losses["card"],
         losses_cpu=losses["host"], max_loss_rel_diff=rel,
         tolerance="losses rtol 1e-4; parameters and BN statistics rtol "
         "1e-4 + atol 1e-4", max_param_excess_over_rtol=worst,
         launches_card=counts)
    require(rel <= 1e-4, f"card vs CPU losses differ: {losses}")
    require(worst <= 1e-4, f"card vs CPU parameters differ by {worst}")
    return engines["card"], sups["card"], (xs, ys), counts


def phase_small_train(seed: int = 0) -> None:
    """3 train steps of the 2,048-node fp32 model with the adaptive
    adjacency over flat supports, card against CPU; then one step with
    unfused supports and an unfused mask, whose gradients must equal the
    fused ones bit for bit."""
    import dataclasses

    import torch

    from graph_wavenet_tpu_torch.config import TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.ops import block_sparse as bsp
    from graph_wavenet_tpu_torch.train.engine import Engine

    engine, sup, (xs, ys), counts = small_train_run("flat", seed)
    cfg, scaler = engine.model_cfg, StandardScaler(50.0, 10.0)
    mask = sup[-1]
    require(all(isinstance(s, bsp.Fused2FlatSupport) and s.delay_t > 0
                for s in sup[:-1])
            and mask.fuse2 is not None and mask.fuse2[2] > 0,
            "the 2,048-node supports and mask must fuse both ways")
    require(counts["gathered_block_outer_flat"] > 0
            and counts["gathered_block_mix_flat"] == 0,
            f"launch counts {counts} do not match the fused layout")

    # one step from the same state with fused and with unfused supports
    unfused = ([bsp.as_unfused(s) for s in sup[:-1]]
               + [dataclasses.replace(mask, fuse2=None)])
    state = engine.model.state_dict()
    grads = {}
    # PyTorch's index_add_ (the adaptive softmax's segment sums and the
    # nodevec gathers' backward) uses float atomics unless asked not to
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, sups in (("fused", sup), ("unfused", unfused)):
            eng = Engine(cfg, TrainConfig(), scaler, device="cuda",
                         seed=seed)
            eng.model.load_state_dict(state)
            eng.train_step(xs[0], ys[0], sups)
            grads[name] = {k: p.grad for k, p in
                           eng.model.named_parameters()
                           if p.grad is not None}
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    differ = [k for k in grads["fused"]
              if not torch.equal(grads["fused"][k], grads["unfused"][k])]
    emit("small_train_unfused", parameters=len(grads["fused"]),
         bitwise_equal=not differ, differ=differ[:8])
    require(not differ and grads["fused"].keys() == grads["unfused"].keys(),
            f"unfused gradients are not bitwise equal: {differ}")


# each hand kernel's device functions, by a part of their names in a
# profile (kernels 2 and 5 share one template, told apart by its job type)
HAND_KERNELS = {"gathered_block_mix_flat": "mix_flat_",
                "gathered_block_outer_flat": "FlatJobs",
                "gathered_block_mix_flat2": "mix_flat2_",
                "gathered_block_mix": "mix_padded_",
                "gathered_block_outer": "PaddedJobs"}


def profile_step(fn) -> dict:
    """Device time by kernel over one call of ``fn``: the busy share of the
    wall time, the kernels that take the most device time, and the device
    time and launches of each hand kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, less the ranges the profiler draws on the device
    # timeline for user annotations (``Optimizer.step#Adam.step``): they
    # span kernels that are counted on their own
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    hand = {}
    for wrapper, part in HAND_KERNELS.items():
        hits = [v for k, v in by_name.items() if part in k]
        if hits:
            hand[wrapper] = {"ms": sum(t for t, _ in hits),
                             "launches": sum(n for _, n in hits)}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if kernels
            else None,
            "top_kernels": [{"name": k[:90], "ms": t, "launches": n}
                            for k, (t, n) in top],
            "hand_kernels": hand}


def write_city_data(root: str, n: int) -> None:
    """Synthetic ``train/val/test.npz`` in the layout ``data/metr.py``
    reads: x, y of shape (S, 12, N, 2), speeds around 50 with some missing
    (zero) readings and a time-of-day feature, from ``default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for split, count in TRAIN_SAMPLES.items():
        arrays = {}
        for key in ("x", "y"):
            a = np.empty((count, 12, n, 2), np.float32)
            a[..., 0] = rng.normal(50.0, 10.0, size=(count, 12, n))
            a[..., 0][rng.random((count, 12, n)) < 0.05] = 0.0
            a[..., 1] = rng.random((count, 12, 1))
            arrays[key] = a
        np.savez(os.path.join(root, f"{split}.npz"), **arrays)


def _fused(s) -> bool:
    """Whether a flat support or the adaptive mask runs kernel 3."""
    from graph_wavenet_tpu_torch.ops.block_sparse import Fused2FlatSupport

    if getattr(s, "adaptive_mask", False):
        return s.fuse2 is not None
    return isinstance(s, Fused2FlatSupport)


def forward_launches(supports, layers: int) -> dict:
    """Kernel launches of one forward implied by the supports, every layer:
    kernel 3 for a fused flat support (or adaptive mask), kernel 1 per hop
    for an unfused one, kernel 4 per hop for a padded one."""
    from graph_wavenet_tpu_torch.ops.block_sparse import BlockSparseSupport
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    n = dict.fromkeys(bd.LAUNCHES, 0)
    for s in supports:
        if isinstance(s, BlockSparseSupport):
            n["gathered_block_mix"] += 2 * layers
        elif _fused(s):
            n["gathered_block_mix_flat2"] += layers
        else:
            n["gathered_block_mix_flat"] += 2 * layers
    return n


def expected_step_launches(supports, layers: int) -> dict:
    """Kernel launches of one train step implied by the supports: the
    forward's, then the backward of every layer but the last (whose
    diffusion output feeds only its own residual and BatchNorm, which no
    loss term reads): kernel 3 over the transpose tables for a fused
    support (two kernel-1 launches if its transpose band does not fuse),
    kernel 1 per hop for an unfused one, kernel 4 per hop over the
    transpose tables for a padded one, and kernel 2 once per hop for the
    adaptive support only, the one whose blocks need a gradient. Kernel 5,
    the padded blocks' cotangent, never runs: fixed blocks need none."""
    from graph_wavenet_tpu_torch.ops.block_sparse import BlockSparseSupport

    n = forward_launches(supports, layers)
    back = layers - 1
    for s in supports:
        adaptive = getattr(s, "adaptive_mask", False)
        if isinstance(s, BlockSparseSupport):
            n["gathered_block_mix"] += 2 * back
            continue
        delay_t = (s.fuse2[2] if adaptive and _fused(s)
                   else getattr(s, "delay_t", 0))
        if _fused(s):
            n["gathered_block_mix_flat2"] += back * (delay_t > 0)
            n["gathered_block_mix_flat"] += back * 2 * (delay_t == 0)
        else:
            n["gathered_block_mix_flat"] += 2 * back
        n["gathered_block_outer_flat"] += 2 * back * adaptive
    return n


def phase_train(graph, tmp: str, form: str) -> dict:
    """A training path at full width: the port's training CLI on the
    40,960-node city model with the adaptive adjacency (bf16, batch 4) over
    ``form`` supports (``--sparse``), its checkpoint served, one train
    step's launches held to the layout, the step timed and profiled.
    Returns the launch counts of the train and serve windows (suffixed
    ``_padded`` for a padded form)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve, train
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    tag = "" if form == "flat" else "_padded"
    pos, src, dst, w = graph
    t0 = time.perf_counter()
    gpath = os.path.join(tmp, "train_graph.npz")
    data_dir = os.path.join(tmp, "city_data")
    if not os.path.exists(gpath):
        city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_CITY)
        write_city_data(data_dir, N_CITY)
    setup_s = time.perf_counter() - t0
    save = os.path.join(tmp, f"train_ckpt_{form}")
    t1 = time.perf_counter()
    out = train.main(["--graph_npz", gpath, "--data", data_dir, "--gcn_bool",
                      "--addaptadj", "--dtype", "bfloat16", "--batch_size",
                      str(TRAIN_BATCH), "--seq_length", "12", "--epochs", "1",
                      "--print_every", "1", "--save", save, "--sparse", form,
                      "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t1
    result, runner, sups = out["result"], out["runner"], out["supports"]
    hist = result.history[0]
    finite = all(np.isfinite(v) for v in (
        *hist.train.values(), *hist.valid.values(),
        *result.test_metrics.values()))
    emit("train_cli", form=form, nodes=N_CITY, dtype="bfloat16",
         batch=TRAIN_BATCH, samples=TRAIN_SAMPLES,
         setup_seconds=round(setup_s, 3), seconds=round(cli_s, 3),
         train=hist.train, valid=hist.valid, test=result.test_metrics,
         checkpoint=os.path.basename(result.best_checkpoint))
    require(finite, "non-finite train, validation or test metrics")
    require(os.path.exists(result.best_checkpoint), "no checkpoint written")

    engine = runner.engine
    emit("train_layout", form=form,
         supports=[type(s).__name__ for s in sups],
         fused2=[_fused(s) for s in sups],
         delay_t=[s.fuse2[2] if getattr(s, "adaptive_mask", False)
                  else getattr(s, "delay_t", 0) for s in sups],
         live_blocks=[s.n_live if hasattr(s, "n_live")
                      else int((s.block_idx < s.block_idx.shape[0]).sum())
                      for s in sups])
    rng = np.random.default_rng(6)
    x = rng.normal(size=(TRAIN_BATCH, 12, N_CITY, 2)).astype(np.float32)
    y = rng.normal(50.0, 10.0, size=(TRAIN_BATCH, 12, N_CITY, 2)
                   ).astype(np.float32)
    xt, yt = (torch.as_tensor(a, device="cuda") for a in (x, y))
    counts = {}
    layers = engine.model_cfg.blocks * engine.model_cfg.layers
    bd.reset_launch_counts()
    engine.train_step(xt, yt, sups)
    torch.cuda.synchronize()
    counts["train" + tag] = dict(bd.LAUNCHES)
    want = expected_step_launches(sups, layers)
    emit("train_step_launches", form=form, launches=counts["train" + tag],
         expected=want)
    require(counts["train" + tag] == want,
            f"train-step launches {counts['train' + tag]} do not match "
            f"{want}")

    for _ in range(2):
        engine.train_step(xt, yt, sups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(6):
        t2 = time.perf_counter()
        m = engine.train_step(xt, yt, sups)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t2) * 1e3)
    require(bool(torch.isfinite(m["loss"])), "non-finite train loss")
    med = sorted(times)[len(times) // 2]
    emit("train_step", form=form, batch=TRAIN_BATCH, nodes=N_CITY,
         dtype="bfloat16", median_ms=med, min_ms=min(times),
         max_ms=max(times), times_ms=times,
         node_timesteps_per_s=TRAIN_BATCH * 12 * N_CITY / (med / 1e3),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    emit("train_step_profile", form=form, batch=TRAIN_BATCH,
         **profile_step(lambda: engine.train_step(xt, yt, sups)))
    del engine, runner, out, xt, yt, sups
    torch.cuda.empty_cache()

    # the trained checkpoint through the serve CLI, one request
    run = serve.main(["--checkpoint", result.best_checkpoint, "--graph_npz",
                      gpath, "--device", "cuda", "--port", "0",
                      "--window_ms", "10"], serve_forever=False)
    server, batcher = run["server"], run["batcher"]
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        raw = np.random.default_rng(7).normal(
            50.0, 10.0, size=(12, N_CITY, 2)).astype(np.float32)
        bd.reset_launch_counts()
        answer = np.asarray(post_json(url + "/predict",
                                      {"x": raw.tolist()})["y"])
        torch.cuda.synchronize()
        counts["serve_trained" + tag] = dict(bd.LAUNCHES)
        want = forward_launches(run["forecaster"].supports, layers)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    emit("serve_trained", form=form, shape=list(answer.shape),
         launches=counts["serve_trained" + tag], expected=want)
    require(answer.shape == (12, N_CITY) and np.isfinite(answer).all(),
            f"bad forecast of the trained checkpoint: {answer.shape}")
    require(counts["serve_trained" + tag] == want,
            f"serve launches {counts['serve_trained' + tag]} do not match "
            f"{want}")
    del run
    torch.cuda.empty_cache()
    return counts


def post_json(url: str, payload: dict, timeout: float = 600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def serve_run(path: str, gpath: str, form: str, layers: int):
    """One city checkpoint through the port's serve CLI: 4 concurrent
    requests coalesced into device calls, the launch counters held to the
    layout, predict latency at batch 1 and 8 and a profile at batch 8.
    Returns the requests' launch counts and a batch-1 forecast."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    t0 = time.perf_counter()
    run = serve.main(["--checkpoint", path, "--graph_npz", gpath,
                      "--device", "cuda", "--port", "0", "--window_ms",
                      "3000", "--max_batch", "8"], serve_forever=False)
    server, batcher, fc = run["server"], run["batcher"], run["forecaster"]
    try:
        emit("serve_layout", form=form,
             startup_seconds=round(time.perf_counter() - t0, 3),
             supports=[type(s).__name__ for s in fc.supports],
             fused2=[_fused(s) for s in fc.supports],
             ring_w=[getattr(s, "ring_w", None) for s in fc.supports],
             delay=[getattr(s, "delay", None) for s in fc.supports],
             lag=[getattr(s, "lag", None) for s in fc.supports],
             padded_slots=[list(s.block_idx.shape) for s in fc.supports
                           if hasattr(s, "block_idx")])
        url = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        require(health["status"] == "ok" and health["num_nodes"] == N_CITY,
                f"healthz: {health}")
        n_req = 4
        raw = np.random.default_rng(2).normal(
            50.0, 10.0, size=(n_req, 12, N_CITY, 2)).astype(np.float32)
        bodies = [{"x": raw[i].tolist()} for i in range(n_req)]
        answers: list = [None] * n_req
        errors: list = []

        def ask(i):
            try:
                answers[i] = np.asarray(post_json(url + "/predict",
                                                  bodies[i])["y"])
            except Exception as e:         # reported below; fails the run
                errors.append(f"{type(e).__name__}: {e}")

        bd.reset_launch_counts()
        t1 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        counts = dict(bd.LAUNCHES)
        require(not errors and not any(t.is_alive() for t in threads),
                f"requests failed: {errors}")
        stats = json.loads(urllib.request.urlopen(
            url + "/stats", timeout=60).read())
        calls = stats["device_calls"]
        for a in answers:
            require(a.shape == (12, N_CITY) and np.isfinite(a).all(),
                    f"bad answer shape {a.shape} or non-finite values")
        want = {k: v * calls for k, v in
                forward_launches(fc.supports, layers).items()}
        emit("serve", form=form, requests=n_req, device_calls=calls,
             batch_histogram=stats["batch_histogram"],
             seconds=round(serve_s, 3), launches=counts, expected=want)
        require(counts == want,
                f"launch counts {counts} do not match the layout {want}")

        # predict latency through the Forecaster, batch 1 and 8
        for b in (1, 8):
            x = np.random.default_rng(3).normal(
                size=(b, 12, N_CITY, 2)).astype(np.float32)
            xt = torch.as_tensor(x, device="cuda")
            fc.predict(xt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(10):
                t2 = time.perf_counter()
                out = fc.predict(xt)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t2) * 1e3)
            require(bool(torch.isfinite(out).all()), "non-finite forecast")
            med = sorted(times)[len(times) // 2]
            emit("predict_latency", layout=form, batch=b, median_ms=med,
                 min_ms=min(times), max_ms=max(times),
                 forecast_node_steps_per_s=b * 12 * N_CITY / (med / 1e3),
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        emit("predict_profile", layout=form, batch=8,
             **profile_step(lambda: fc.predict(xt)))
        x1 = torch.randn(1, 12, N_CITY, 2, device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(4))
        pred = fc.predict(x1)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    del fc, run
    torch.cuda.empty_cache()
    return counts, x1, pred


def phase_serve(graph, tmp: str) -> dict:
    """The serving paths: one city checkpoint at full width served through
    the port's entry points under the flat layout and under the padded
    ("pallas") one, then under the 128x512 layout. Returns the launch
    counts of its runs."""
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.ops.block_sparse import Fused2FlatSupport
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.train import checkpoint as ckpt
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    pos, src, dst, w = graph
    t0 = time.perf_counter()
    gpath = os.path.join(tmp, "city_graph.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_CITY)
    _, _, layout = city.build_city_supports(src, dst, w, N_CITY, pos=pos,
                                            ordering="best", form="flat",
                                            device="cuda")
    cfg = ModelConfig(num_nodes=layout["n_pad"], in_dim=2, out_dim=12,
                      residual_channels=32, dilation_channels=32,
                      skip_channels=256, end_channels=512, blocks=4,
                      layers=2, addaptadj=False, n_supports=2,
                      dtype="bfloat16")
    model = GWNet(cfg, device="cuda", seed=0)
    scaler = StandardScaler(50.0, 10.0)
    paths = {}
    for form in ("flat", "flat-rect", "pallas"):
        paths[form] = os.path.join(tmp, f"city_{form}.pt")
        ckpt.save_checkpoint(paths[form], model.state_dict(), model_cfg=cfg,
                             scaler=scaler, extra={"graph_layout": dict(
                                 layout, form=form,
                                 fused2=layout["fused2"] and form == "flat")})
    del model
    emit("serve_setup", seconds=round(time.perf_counter() - t0, 3),
         nodes=N_CITY, ordering=layout["ordering"],
         n_blocks=layout["n_blocks"], fused2=layout["fused2"])

    layers = cfg.blocks * cfg.layers
    counts = {}
    counts["serve"], x1, fused_pred = serve_run(paths["flat"], gpath, "flat",
                                                layers)
    counts["serve_padded"], _, padded_pred = serve_run(
        paths["pallas"], gpath, "pallas", layers)
    emit("predict_padded_vs_flat", batch=1,
         bitwise_equal=bool(torch.equal(padded_pred, fused_pred)),
         max_abs_diff=float((padded_pred - fused_pred).abs().max()))
    require(bool(torch.isfinite(padded_pred).all()), "non-finite forecast")

    # the same checkpoint under the 128x512 layout: no support fuses, so
    # every hop runs kernel 1
    rect = Forecaster.from_city_checkpoint(paths["flat-rect"], gpath,
                                           device="cuda")
    require(not any(isinstance(s, Fused2FlatSupport)
                    for s in rect.supports), "rect supports must not fuse")
    bd.reset_launch_counts()
    rect_pred = rect.predict(x1)
    torch.cuda.synchronize()
    counts["rect"] = dict(bd.LAUNCHES)
    want = forward_launches(rect.supports, layers)
    diff = float((rect_pred - fused_pred).abs().max())
    med = sorted(
        cuda_ms(lambda: rect.predict(x1), 1) for _ in range(10))[5]
    emit("predict_rect", layout="flat-rect", batch=1, launches=counts["rect"],
         expected=want, median_ms=med,
         max_abs_diff_vs_square_layout=diff)
    require(counts["rect"] == want,
            f"launch counts {counts['rect']} do not match the layout")
    require(bool(torch.isfinite(rect_pred).all()), "non-finite forecast")
    return counts


def padded_cost(sp, r: int, isz: int, table_entries: int,
                out_isz: int | None = None) -> tuple[float, float]:
    """Operations and bytes of one launch on a padded support: the live
    slots' products only (sentinels need none), the table read once, and
    for kernel 4 (``out_isz`` None) the padded blocks, x and the output
    once each; for kernel 5 x and g once and the output, sentinel slots
    included, once."""
    nb, mb, bs, _ = sp.blocks.shape
    n_live = int((sp.block_idx < nb).sum())
    flops = 2.0 * n_live * bs * bs * r
    rows = nb * bs * r * isz
    if out_isz is None:
        nbytes = nb * mb * bs * bs * isz + 2 * rows
    else:
        nbytes = 2 * rows + nb * mb * bs * bs * out_isz
    return flops, nbytes + 4 * table_entries


def padded_outer_check(got, x, g, src) -> tuple[float, bool]:
    """Kernel 5 against its plain version: within rtol 1e-5 of the sum of
    |terms| of the fp32 sums, plus one ulp where the output is bf16 (both
    round the fp32 sum once). Returns the largest difference from the plain
    version in the output's dtype, and the verdict."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    with torch.no_grad():
        want = bd.outer_padded_plain(x, g, src, out_dtype=torch.float32)
        tol = bd.outer_padded_plain(x.abs(), g.abs(), src,
                                    out_dtype=torch.float32).mul_(1e-5)
        return rounded_check(got, want, tol)


def phase_padded_kernels(graph):
    """Kernels 4 and 5 at the padded form's shapes: the 40,960-node RCM
    doubletransition supports built with form="pallas" (the host build
    timed beside the flat one). Returns the supports (fp32 storage) and
    the numbers for the kernels line."""
    import torch

    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )
    from graph_wavenet_tpu_torch.ops.block_sparse import as_flat_pallas
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    _, src, dst, w = graph
    perm = rcm_order_edges(src, dst, N_CITY)
    t0 = time.perf_counter()
    sups = doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                           form="pallas", device="cuda")
    torch.cuda.synchronize()
    padded_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                    form="flat", device="cuda")
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    sp = sups[0]
    nb, mb, bs, _ = sp.blocks.shape
    n_live = int((sp.block_idx < nb).sum())
    emit("padded_supports", ordering="rcm", host_build_seconds=padded_s,
         flat_host_build_seconds=flat_s, nb=nb, mb=mb, live_blocks=n_live,
         sentinel_share=1 - n_live / (nb * mb), mbt=sp.idx_t.shape[1],
         blocks_bytes_fp32=sp.blocks.numel() * 4)
    gen = torch.Generator(device="cuda").manual_seed(2)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        spd = sp.astype(dtype)
        flat = as_flat_pallas(spd)
        bflat = spd.blocks.reshape(nb * mb, bs, bs)
        for tl, rs in ((True, (3072, 32)), (False, (1536, 128))):
            slot, srct = ((spd.slot, spd.block_idx) if tl
                          else (spd.perm_t, spd.idx_t))
            for r in rs:
                reps = 5 if r > 256 else 100
                x = torch.randn(nb, bs, r, generator=gen,
                                device="cuda").to(dtype)

                def k4():
                    return bd.gathered_block_mix(bflat, slot, x, srct,
                                                 transpose_lhs=tl)

                def plain():
                    return bd.mix_padded_plain(bflat, slot, x, srct,
                                               transpose_lhs=tl)

                got, want = k4(), plain()
                if tl:
                    k1 = bd.gathered_block_mix_flat(
                        flat.blocks_flat, flat.slot_tbl, x, flat.src_tbl,
                        flat.row_tbl, nb=flat.nb, transpose_lhs=True,
                        row_ptr=flat.row_ptr)
                else:
                    k1 = bd.gathered_block_mix_flat(
                        flat.blocks_flat, flat.slot_t, x, flat.src_t,
                        flat.row_t, nb=flat.nb_t, transpose_lhs=False,
                        row_ptr=flat.row_ptr_t)
                torch.cuda.synchronize()
                err, ok, rule = close_err(got, want)
                bitwise = bool(torch.equal(got, k1))
                k1_diff = float((got.float() - k1.float()).abs().max())
                del want, k1
                rec = dict(kernel="gathered_block_mix", dtype=dname, R=r,
                           **tile_of(r, dtype),
                           orientation="forward" if tl else "transpose",
                           slots=[nb, slot.shape[1]], max_abs_err=err,
                           tolerance=rule, bitwise_vs_kernel1_flat=bitwise,
                           max_abs_diff_vs_kernel1_flat=k1_diff)
                require(ok, f"kernel 4 disagrees with its plain version: "
                            f"{rec}")
                require(bitwise, f"kernel 4 is not bitwise equal to kernel "
                                 f"1 on the flat tables: {rec}")
                rec["kernel_ms"] = cuda_ms(k4, reps)
                rec["plain_ms"] = cuda_ms(plain, max(2, reps // 5))
                lib_fn, lib_name, lib_out = library_hop(flat, x.reshape(-1, r),
                                                        tl)
                rec["library_max_abs_diff"], _, _ = close_err(
                    lib_out.reshape(got.shape).to(dtype), got)
                del lib_out
                rec["library_ms"] = cuda_ms(lib_fn, max(2, reps // 5))
                rec["library"] = lib_name + " (as_flat_pallas tables)"
                del lib_fn
                flops, nbytes = padded_cost(spd, r, isz, 2 * slot.numel())
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
                emit("kernel_check", **rec)
                if (tl, dname, r) == (True, "bfloat16", 3072):
                    summary["k4"] = rec
                del got, x
                torch.cuda.empty_cache()

        # kernel 5 at the training shapes, out in the blocks' storage dtype
        live = spd.block_idx < nb
        for r in (1536, 128):
            reps = 5 if r > 256 else 100
            x = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)
            g = torch.randn(nb, bs, r, generator=gen, device="cuda").to(dtype)

            def k5():
                return bd.gathered_block_outer(x, g, spd.block_idx,
                                               out_dtype=dtype)

            def k5_plain():
                return bd.outer_padded_plain(x, g, spd.block_idx,
                                             out_dtype=dtype)

            got = k5()
            again = k5()
            torch.cuda.synchronize()
            deterministic = bool(torch.equal(got, again))
            del again
            err, ok = padded_outer_check(got, x, g, spd.block_idx)
            sentinel_zero = not bool(got[~live].any())
            del got
            # fp32 out, bitwise against kernel 2 on as_flat_pallas's tables
            # (its live slots in row-major order)
            k5f = bd.gathered_block_outer(x, g, spd.block_idx,
                                          out_dtype=torch.float32)
            k2f = bd.gathered_block_outer_flat(
                x, g, flat.src_tbl, flat.row_tbl, slot=flat.slot_tbl,
                n_slots=flat.n_live + 1)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(k5f[live], k2f[:flat.n_live]))
            del k5f, k2f
            rec = dict(kernel="gathered_block_outer", dtype=dname,
                       out_dtype=dname, R=r, **outer_tile_of(dtype, bs),
                       slots=nb * mb, live=n_live,
                       max_abs_err=err, tolerance="rtol 1e-5 of sum |terms| "
                       "of the fp32 sums (+1 ulp of a bf16 output)",
                       sentinel_slots_zero=sentinel_zero,
                       deterministic=deterministic,
                       bitwise_vs_kernel2_flat_fp32_out=bitwise)
            require(ok, f"kernel 5 disagrees with its plain version: {rec}")
            require(sentinel_zero and deterministic,
                    f"kernel 5 sentinels or repeat: {rec}")
            require(bitwise, f"kernel 5 is not bitwise equal to kernel 2 on "
                             f"the flat tables: {rec}")
            rec["kernel_ms"] = cuda_ms(k5, reps)
            rec["plain_ms"] = cuda_ms(k5_plain, max(2, reps // 5))
            xs = x.index_select(0, spd.block_idx[live].long())
            gs = g.index_select(0, torch.nonzero(live)[:, 0]).transpose(1, 2)
            rec["library_ms"] = cuda_ms(lambda: torch.bmm(xs, gs),
                                        max(2, reps // 5))
            rec["library"] = ("torch.bmm on the live slots' operands "
                              "gathered beforehand (gather and sentinel "
                              "zeros excluded)")
            del xs, gs
            flops, nbytes = padded_cost(spd, r, isz, nb * mb, out_isz=isz)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)
            if (dname, r) == ("bfloat16", 1536):
                summary["k5"] = rec
            del x, g
            torch.cuda.empty_cache()
        del spd, flat, bflat
    return sups, summary


def phase_small_padded(seed: int = 0) -> None:
    """2,048 nodes, fp32, padded ("pallas") supports: the forecast on the
    card against the CPU (2e-4) and bitwise against the flat form (kernel
    4 equals kernel 1, and kernel 3 two kernel-1 launches); 3 train steps
    with the adaptive adjacency against the CPU; one gradient with respect
    to the padded blocks against the CPU, sentinel slots zero."""
    import dataclasses

    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    pos, src, dst, w = city_graph(N_SMALL)
    cfg = ModelConfig(num_nodes=N_SMALL, addaptadj=False, dropout=0.0,
                      dtype="float32")
    layers = cfg.blocks * cfg.layers
    x = np.random.default_rng(1).normal(
        size=(2, 12, N_SMALL, 2)).astype(np.float32)
    preds, counts, sups = {}, {}, {}
    for where, dev, form in (("card", "cuda", "pallas"),
                             ("host", "cpu", "pallas"),
                             ("card", "cuda", "flat")):
        sup, _, layout = build_city_supports(src, dst, w, N_SMALL, pos=pos,
                                             ordering="rcm", form=form,
                                             device=dev)
        sups[where, form] = sup
        fc = Forecaster(cfg, GWNet(cfg, device=dev, seed=seed), sup,
                        StandardScaler(50.0, 10.0), node_layout=layout)
        bd.reset_launch_counts()
        preds[where, form] = fc.predict(x)
        torch.cuda.synchronize()
        counts[where, form] = dict(bd.LAUNCHES)
    card, cpu = preds["card", "pallas"], preds["host", "pallas"]
    err = float((card.cpu() - cpu).abs().max())
    bitwise = bool(torch.equal(card, preds["card", "flat"]))
    want = forward_launches(sups["card", "pallas"], layers)
    emit("small_padded_e2e", nodes=N_SMALL, dtype="float32",
         mb=sups["card", "pallas"][0].block_idx.shape[1],
         max_abs_err_vs_cpu=err, tolerance="rtol/atol 2e-4",
         bitwise_equal_flat_form=bitwise,
         max_abs_diff_vs_flat_form=float(
             (card - preds["card", "flat"]).abs().max()),
         launches=counts["card", "pallas"], expected=want)
    require(bool(torch.allclose(card.cpu(), cpu, rtol=2e-4, atol=2e-4)),
            f"padded card vs CPU forecast differ by {err}")
    require(bitwise, "the padded forecast is not bitwise equal to the flat")
    require(counts["card", "pallas"] == want,
            f"launch counts {counts['card', 'pallas']} do not match {want}")

    engine, sup, _, counts = small_train_run("pallas", seed)
    want = {k: 3 * v for k, v in expected_step_launches(sup, layers).items()}
    emit("small_padded_train_launches", launches=counts, expected=want)
    require(counts == want, f"3 padded train steps launched {counts}, "
                            f"expected {want}")

    # one gradient with respect to the padded blocks, card against CPU
    rng = np.random.default_rng(9)
    x2 = rng.normal(size=(N_SMALL, 96)).astype(np.float32)
    cot = rng.normal(size=(N_SMALL, 96)).astype(np.float32)
    grads = {}
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        sp = sups[where, "pallas"][0]
        blocks = sp.blocks.clone().requires_grad_(True)
        out = dataclasses.replace(sp, blocks=blocks).mix_2d(
            torch.as_tensor(x2, device=dev))
        bd.reset_launch_counts()
        grads[where], = torch.autograd.grad(out, blocks,
                                            torch.as_tensor(cot, device=dev))
        torch.cuda.synchronize()
        if where == "card":
            k5 = bd.LAUNCHES["gathered_block_outer"]
    sp = sups["card", "pallas"][0]
    sent = sp.block_idx == sp.block_idx.shape[0]
    got, want_g = grads["card"].cpu(), grads["host"]
    gerr = float((got - want_g).abs().max())
    ok = bool(torch.allclose(got, want_g, rtol=1e-5,
                             atol=1e-5 * float(want_g.abs().max())))
    zero = not bool(grads["card"][sent].any())
    emit("small_padded_blocks_grad", max_abs_err_vs_cpu=gerr,
         tolerance="rtol 1e-5, atol 1e-5 x max|cpu|",
         sentinel_slots=int(sent.sum()), sentinel_slots_zero=zero,
         kernel5_launches=k5)
    require(ok and zero and k5 == 1,
            f"padded blocks gradient: err {gerr}, zero {zero}, k5 {k5}")


def phase_kernel5_path(sups) -> dict:
    """Kernel 5 on its path at full width: one forward and backward of the
    gcn at the first layer's training shape (40,960 nodes, batch 4, bf16,
    R = 1,536) over the two padded supports with bf16 blocks that require a
    gradient (the fixed supports' blocks do not, so no CLI path runs it).
    Each kernel-5 launch is held against the plain version on the card at
    the inputs the path gave it. Returns the window's launch counts."""
    import dataclasses

    import torch

    from graph_wavenet_tpu_torch.ops import block_sparse as bsp
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.ops.diffusion import gcn_apply

    gen = torch.Generator(device="cuda").manual_seed(8)
    c, t = 32, 12
    leaves = [s.blocks.to(torch.bfloat16).requires_grad_(True) for s in sups]
    grad_sups = [dataclasses.replace(s, blocks=b)
                 for s, b in zip(sups, leaves)]
    x = torch.randn(TRAIN_BATCH, t, N_CITY, c, generator=gen, device="cuda"
                    ).to(torch.bfloat16).requires_grad_(True)
    weight = torch.randn(c, 5 * c, 1, 1, generator=gen,
                         device="cuda") / (5 * c) ** 0.5
    bias = torch.zeros(c, device="cuda")
    cot = torch.randn(TRAIN_BATCH, t, N_CITY, c, generator=gen,
                      device="cuda").to(torch.bfloat16)
    calls = []
    kernel5 = bsp.gathered_block_outer

    def recording(x_pad, g, src, *, out_dtype):
        out = kernel5(x_pad, g, src, out_dtype=out_dtype)
        calls.append((x_pad.detach(), g.detach(), src, out.detach()))
        return out

    bsp.gathered_block_outer = recording
    try:
        bd.reset_launch_counts()
        t0 = time.perf_counter()
        gcn_apply(weight, bias, x, grad_sups, 2).backward(cot)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(bd.LAUNCHES)
    finally:
        bsp.gathered_block_outer = kernel5
    errs = []
    for x_pad, g, src, got in calls:
        err, ok = padded_outer_check(got, x_pad, g, src)
        errs.append(err)
        require(ok and got.dtype == torch.bfloat16,
                f"kernel 5 on its path disagrees with its plain version: "
                f"{err}")
    nb = sups[0].block_idx.shape[0]
    zero = all(not bool(b.grad[s.block_idx == nb].any())
               for s, b in zip(sups, leaves))
    want = dict.fromkeys(bd.LAUNCHES, 0)
    want.update(gathered_block_mix=8, gathered_block_outer=4)
    emit("kernel5_path", nodes=N_CITY, batch=TRAIN_BATCH, dtype="bfloat16",
         R=TRAIN_BATCH * t * c, launches=counts, expected=want,
         max_abs_err=errs, sentinel_slots_zero=zero, wall_ms=wall_ms)
    require(counts == want, f"kernel-5 path launched {counts}, not {want}")
    require(zero, "the sentinel slots' gradient is not zero")
    del calls, leaves, grad_sups, x, cot
    torch.cuda.empty_cache()
    return {"kernel5_path": counts}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "graph_wavenet_tpu_torch")):
        print("chip_smoke: graph_wavenet_tpu_torch is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # cuBLAS is deterministic under torch.use_deterministic_algorithms
    # only with a fixed workspace; set before the first matmul
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    smi = phase_card()
    phase_build()
    graph = city_graph(N_CITY)
    summary = phase_kernels(graph)
    summary.update(phase_train_kernels(graph))
    padded, padded_summary = phase_padded_kernels(graph)
    summary.update(padded_summary)
    phase_small_e2e()
    phase_small_train()
    phase_small_padded()
    with tempfile.TemporaryDirectory(prefix="gwt_chip_smoke_") as tmp:
        counts = phase_serve(graph, tmp)
        counts.update(phase_train(graph, tmp, "flat"))
        counts.update(phase_train(graph, tmp, "pallas"))
    counts.update(phase_kernel5_path(padded))

    # launches on the main paths: kernel 1 serving the 128x512 layout,
    # kernel 2 in a train step, kernel 3 serving and in a train step,
    # kernel 4 serving and training the padded form, kernel 5 on the
    # gradient through padded blocks
    kernels = []
    for key, name, src, tpu, windows in (
            ("k1", "gathered_block_mix_flat", K1_SRC, K1_TPU, ("rect",)),
            ("k2", "gathered_block_outer_flat", K2_SRC, K2_TPU, ("train",)),
            ("k3", "gathered_block_mix_flat2", K3_SRC, K3_TPU,
             ("serve", "train")),
            ("k4", "gathered_block_mix", K4_SRC, K4_TPU,
             ("serve_padded", "train_padded")),
            ("k5", "gathered_block_outer", K5_SRC, K5_TPU,
             ("kernel5_path",))):
        rec = summary[key]
        launches = sum(counts[w][name] for w in windows)
        require(all(counts[w][name] > 0 for w in windows),
                f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches,
            "max_abs_err": rec.get("max_abs_err",
                                   rec.get("max_abs_err_out2")),
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    emit("done", seconds=round(time.perf_counter() - t0, 3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
