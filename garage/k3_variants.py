"""Kernel 3 (csrc/mix_flat2.cu) against design variants on the card.

Builds copies of mix_flat2.cu with one design choice undone each, and
times them at the 40,960-node city's shapes (bf16, the RCM support's
tables forward, the adaptive mask's transpose tables with add) against
kernel 1 + add + kernel 1 ("chain") and one kernel-1 launch, in rounds of
alternating order (the minimum of each), each variant first checked bit
for bit against the chain:

- ``final``: the kernel as it is;
- ``consumer_publish``: thread 0 of the consumer warps publishes each out1
  flag after a barrier of the consumer warps, instead of the publisher
  warp;
- ``counter_first``: every ticket, a block's first too, comes from the
  counter;
- ``hop1_final`` / ``hop1_consumer_publish``: the same kernels with the
  tickets of hop 2 dropped (out1 only; bitwise against the chain's out1),
  against one kernel-1 launch: what the persistent loop costs on kernel
  1's own work;
- ``slack0``, ``slack2x``, ``slack4x``, ``serial``: ``final`` with span =
  lag (no slack), lag + 2 and 4 times ``fused2_launch``'s slack, and nb
  (every hop 1 before any hop 2), through the C entry point.

    python garage/k3_variants.py          # on a machine with an H100

Prints one JSON line per shape, with the card's name and power limit.
Needs nvcc (the same flags as ops/cuda/build.py) and the repository
around it; builds under graph_wavenet_tpu_torch/_build/variants/.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from graph_wavenet_tpu_torch.ops.cuda import build  # noqa: E402

SRC = "mix_flat2.cu"
OUT = os.path.join(REPO, "graph_wavenet_tpu_torch", "_build", "variants")
HOP1_ONLY = ("  if (t < a) return Item{0, t / nt, t % nt, 0};",
             "  if (t < nb * nt) return Item{0, t / nt, t % nt, 0};\n"
             "  return Item{0, -1, 0, 0};")
CONSUMER_PUBLISH = [
    ("        bar_wait(stored + out.stage, out.parity);\n"
     "        out.next<2>();\n"
     "        if (lane == 0) publish(flags + (size_t)it.rw * ntiles + "
     "it.tile);\n", ""),
    ("      __syncwarp();\n"
     "      if (lane == 0) bar_arrive(stored + out.stage);\n"
     "      out.next<2>();\n",
     "      asm volatile(\"bar.sync 1, 256;\" ::: \"memory\");\n"
     "      if (threadIdx.x == 0)\n"
     "        publish(flags + (size_t)it.rw * ntiles + it.tile);\n")]
COUNTER_FIRST = [(
    "  return first ? static_cast<int>(blockIdx.x)\n"
    "               : static_cast<int>(gridDim.x) + atomicAdd(counter, 1);",
    "  return atomicAdd(counter, 1);")]
VARIANTS = {"final": [], "consumer_publish": CONSUMER_PUBLISH,
            "counter_first": COUNTER_FIRST, "hop1_final": [HOP1_ONLY],
            "hop1_consumer_publish": [HOP1_ONLY] + CONSUMER_PUBLISH}
SHAPES = (("forward", 3072), ("forward", 2304), ("forward", 1536),
          ("forward", 384), ("transpose+add", 1536), ("transpose+add", 384))


def build_variants() -> dict:
    """Compiles each variant (its includes from csrc/), all at once;
    returns the loaded libraries."""
    os.makedirs(OUT, exist_ok=True)
    text = (build.CSRC / SRC).read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        body = text
        for old, new in subs:
            if old not in body:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old[:60]!r}")
            body = body.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(body)
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-I", str(build.CSRC), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    return libs


def main() -> int:
    import torch

    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )
    from graph_wavenet_tpu_torch.ops.adaptive_block import mask_from_supports
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_card()
    build.build_all()
    libs = build_variants()
    _, src, dst, w = cs.city_graph(cs.N_CITY)
    perm = rcm_order_edges(src, dst, cs.N_CITY)
    sups = doubletransition_block_supports(src, dst, w, cs.N_CITY, perm=perm,
                                           form="flat", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    nv1 = torch.randn(cs.N_CITY, 10, generator=gen, device="cuda")
    nv2 = torch.randn(10, cs.N_CITY, generator=gen, device="cuda")
    dtype = torch.bfloat16
    fwd = sups[0].astype(dtype)
    bwd = mask_from_supports(sups, hops=1).materialize(nv1, nv2,
                                                       out_dtype=dtype)
    for tables, r in SHAPES:
        if tables == "forward":
            sp, tl, lag, ptr = fwd, True, fwd.lag, fwd.row_ptr
            tbl = (sp.slot_tbl, sp.src_tbl, sp.row_tbl)
        else:
            sp, tl, lag, ptr = bwd, False, bwd.lag_t, bwd.row_ptr_t
            tbl = (sp.slot_t, sp.src_t, sp.row_t)
        x = torch.randn(sp.nb, 128, r, generator=gen, device="cuda").to(dtype)
        add = (None if tl else torch.randn(sp.nb, 128, r, generator=gen,
                                           device="cuda").to(dtype))
        ct = bd.tile_cols(r, dtype)
        span, grid = bd.fused2_launch(sp.nb, r, dtype, lag,
                                      bd.resident(x, ct))

        def direct(lib, span=span):
            o1, o2 = torch.empty_like(x), torch.empty_like(x)
            flags = torch.zeros(bd.flag_count(sp.nb, r, dtype),
                                dtype=torch.int32, device="cuda")
            build.call(lib, "gwt_mix_flat2", bd.mix_flat2_desc(
                sp.blocks_flat, tbl[0], x, tbl[1], ptr, add, o1, o2, flags,
                sp.nb, span, tl, ct, grid), x.device)
            return o1, o2

        def chain():
            return bd.gathered_block_mix_flat2(
                sp.blocks_flat, tbl[0], x, tbl[1], tbl[2], nb=sp.nb, lag=lag,
                transpose_lhs=tl, add=add, row_ptr=ptr, dispatch="chain")

        def kernel1():
            return bd.gathered_block_mix_flat(
                sp.blocks_flat, tbl[0], x, tbl[1], tbl[2], nb=sp.nb,
                transpose_lhs=tl, row_ptr=ptr)

        fns = {"chain": chain, "kernel1_once": kernel1}
        fns.update({n: (lambda lib=lib: direct(lib))
                    for n, lib in libs.items()})
        fns["slack0"] = lambda: direct(libs["final"], lag)
        for k in (2, 4):
            fns[f"slack{k}x"] = (lambda k=k: direct(
                libs["final"], min(lag + k * (span - lag), sp.nb)))
        fns["serial"] = lambda: direct(libs["final"], sp.nb)
        c1, c2 = chain()
        bitwise = {}
        for name, fn in fns.items():
            if name in ("chain", "kernel1_once"):
                continue
            f1, f2 = fn()
            torch.cuda.synchronize()
            # the hop-1-only kernels write out1 alone
            bitwise[name] = bool(torch.equal(f1, c1) and (
                name.startswith("hop1") or torch.equal(f2, c2)))
        del c1, c2
        reps = 20 if r <= 1024 else 10
        order = list(fns)
        times = {k: [] for k in order}
        for rnd in range(4):
            for k in (order if rnd % 2 == 0 else order[::-1]):
                times[k].append(cs.cuda_ms(fns[k], reps))
        print(json.dumps({
            "phase": "k3_variants", "tables": tables, "R": r, "ct": ct,
            "span": span, "grid": grid, "lag": lag,
            "ms": {k: min(v) for k, v in times.items()},
            "bitwise_vs_chain": bitwise, "card": cs.CARD}), flush=True)
        if not all(bitwise.values()):
            raise RuntimeError(f"a variant differs from the chain: {bitwise}")
        del x, add
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
