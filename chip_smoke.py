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
   two launches of kernel 1, with kernel, plain and library times;
4. small-N end to end: a 2,048-node fp32 city model at full width on the
   card matches the same model on the CPU (plain versions) to 2e-4, and
   its unfused supports give a bitwise-equal forecast;
5. serving at full width (the main path): a 40,960-node city checkpoint of
   random weights (bf16 activations) served by the port's serve CLI to
   concurrent requests, with the launch counters held to the layout; the
   same checkpoint under the 128x512 layout, whose supports do not fuse,
   runs kernel 1 instead; predict latency at batch 1 and 8.

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
K3_SRC = "graph_wavenet_tpu_torch/csrc/mix_flat2.cu"
K1_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:165"
K3_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:494"


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
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
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
            reps = 5 if r > 256 else 20
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
                               dtype=dname, R=r, blocks=label,
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

                o1, o2 = k3()
                # bitwise against two launches of kernel 1
                c1 = bd.gathered_block_mix_flat(*args, nb=sq.nb,
                                                transpose_lhs=True,
                                                row_ptr=sq.row_ptr)
                if add is not None:
                    c1 = c1 + add
                c2 = bd.gathered_block_mix_flat(
                    blocks, sq.slot_tbl, c1, sq.src_tbl, sq.row_tbl,
                    nb=sq.nb, transpose_lhs=True, row_ptr=sq.row_ptr)
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
                           R=r, blocks="128x128", add=with_add,
                           max_abs_err_out1=err1, max_abs_err_out2=err2,
                           tolerance=rule, bitwise_vs_two_kernel1=bitwise)
                require(ok1 and ok2, f"kernel 3 disagrees with its plain "
                                     f"version: {rec}")
                require(bitwise, f"kernel 3 is not bitwise equal to two "
                                 f"launches of kernel 1: {rec}")
                rec["kernel_ms"] = cuda_ms(k3, reps)
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


def profile_predict(fc, xt) -> dict:
    """Device time by kernel over one predict: the busy share of the wall
    time and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fc.predict(xt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if kernels
            else None,
            "top_kernels": [{"name": k[:90], "ms": t, "launches": n}
                            for k, (t, n) in top]}


def post_json(url: str, payload: dict, timeout: float = 600):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def phase_serve(graph, tmp: str) -> dict:
    """The main path: a city checkpoint at full width served through the
    port's entry points. Returns the launch counts of its runs."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve
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
    for form in ("flat", "flat-rect"):
        paths[form] = os.path.join(tmp, f"city_{form}.pt")
        ckpt.save_checkpoint(paths[form], model.state_dict(), model_cfg=cfg,
                             scaler=scaler, extra={"graph_layout": dict(
                                 layout, form=form)})
    del model
    emit("serve_setup", seconds=round(time.perf_counter() - t0, 3),
         nodes=N_CITY, ordering=layout["ordering"],
         n_blocks=layout["n_blocks"], fused2=layout["fused2"])

    layers = cfg.blocks * cfg.layers
    run = serve.main(["--checkpoint", paths["flat"], "--graph_npz", gpath,
                      "--device", "cuda", "--port", "0", "--window_ms",
                      "3000", "--max_batch", "8"], serve_forever=False)
    server, batcher, fc = run["server"], run["batcher"], run["forecaster"]
    counts = {}
    try:
        fused = [isinstance(s, Fused2FlatSupport) for s in fc.supports]
        emit("serve_layout", fused2=fused,
             ring_w=[getattr(s, "ring_w", None) for s in fc.supports],
             delay=[getattr(s, "delay", None) for s in fc.supports],
             lag=[getattr(s, "lag", None) for s in fc.supports],
             live_blocks=[s.n_live for s in fc.supports])
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
        counts["serve"] = dict(bd.LAUNCHES)
        require(not errors and not any(t.is_alive() for t in threads),
                f"requests failed: {errors}")
        stats = json.loads(urllib.request.urlopen(
            url + "/stats", timeout=60).read())
        calls = stats["device_calls"]
        for a in answers:
            require(a.shape == (12, N_CITY) and np.isfinite(a).all(),
                    f"bad answer shape {a.shape} or non-finite values")
        # per forward: one kernel-3 launch per layer for each support
        # that fuses, two kernel-1 launches (one per hop) for each that
        # does not
        want_k3 = layers * calls * sum(fused)
        want_k1 = 2 * layers * calls * (len(fused) - sum(fused))
        emit("serve", requests=n_req, device_calls=calls,
             batch_histogram=stats["batch_histogram"],
             seconds=round(serve_s, 3), launches=counts["serve"],
             expected={"gathered_block_mix_flat2": want_k3,
                       "gathered_block_mix_flat": want_k1})
        require(counts["serve"] == {"gathered_block_mix_flat": want_k1,
                                    "gathered_block_mix_flat2": want_k3},
                f"launch counts {counts['serve']} do not match the layout")

        # predict latency through the Forecaster, batch 1 and 8
        timing = {}
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
            timing[b] = dict(
                batch=b, median_ms=med, min_ms=min(times),
                max_ms=max(times),
                forecast_node_steps_per_s=b * cfg.out_dim * N_CITY
                / (med / 1e3),
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            emit("predict_latency", layout="flat", **timing[b])
        emit("predict_profile", layout="flat", batch=8,
             **profile_predict(fc, xt))
        x1 = torch.randn(1, 12, N_CITY, 2, device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(4))
        fused_pred = fc.predict(x1)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    del fc, run
    torch.cuda.empty_cache()

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
    want = {"gathered_block_mix_flat": 2 * 2 * layers,
            "gathered_block_mix_flat2": 0}
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    smi = phase_card()
    phase_build()
    graph = city_graph(N_CITY)
    summary = phase_kernels(graph)
    phase_small_e2e()
    with tempfile.TemporaryDirectory(prefix="gwt_chip_smoke_") as tmp:
        counts = phase_serve(graph, tmp)

    kernels = []
    for key, name, src, tpu, window in (
            ("k1", "gathered_block_mix_flat", K1_SRC, K1_TPU, "rect"),
            ("k3", "gathered_block_mix_flat2", K3_SRC, K3_TPU, "serve")):
        rec = summary[key]
        launches = counts[window][name]
        require(launches > 0, f"{name} was not launched on the main path")
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
