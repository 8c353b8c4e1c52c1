#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (graph_wavenet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failed check raises and the script
exits non-zero:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: the CUDA kernels from csrc/, compiled in parallel;
3. kernel checks at the serving path's shapes (40,960 nodes, RCM flat
   supports, R = 3,072 and 32, fp32 and bf16): kernel 1 in both
   orientations on 128x128 and 128x512 blocks and kernel 3 (dispatch
   "fused") with and without ``add`` against their plain versions, kernel
   3 bitwise against two launches of kernel 1 (and timed against them:
   ``chain_ms``, and the branch ``"auto"`` picks), with kernel, plain and
   library times (kernel 3's: two chained BSR products); each line of
   kernels 1, 3 and 4 names its tile width (``ct``) and product (fp32
   FMAs, or ``wgmma`` in bf16); bf16 kernel 1 forward timed at every tile
   width at R = 3,072 (the evidence for ``tile_cols``);
4. kernel checks at the training path's shapes (the 40,960-node adaptive
   mask, R = 1,536 and 128, fp32 and bf16): kernel 2 per entry against its
   plain version (and once on 128x512 blocks) and in storage order (as
   the flat backward launches it) against its plain version and bitwise
   against the per-entry launch gathered by ``inv_slot`` and cast, each
   line naming its product and tile; kernel 3 over the transpose tables
   with ``add`` against its plain version and bitwise against kernel 1 +
   add + kernel 1, kernel 1 in the transpose orientation;
5. kernel padded checks (kernels 4 and 5 at the 40,960-node padded
   support's shapes, 320 x 11 slots, fp32 and bf16): kernel 4 forward (R
   = 3,072 and 32) and over the transpose tables (R = 1,536 and 128)
   against its plain version and bitwise against kernel 1 on
   ``as_flat_pallas``'s tables, kernel 5 (R = 1,536 and 128, output in the
   storage dtype) against its plain version, sentinel slots zero, a repeat
   bit-identical, and (fp32 output) bitwise against kernel 2 on
   ``as_flat_pallas``'s tables; the host build of the padded supports
   timed beside the flat one;
5b. the projection kernel (``csrc/chan_proj.cu``, ``phase_chan_proj``) at
   the city train step's first-layer shapes (batch 4, 40,960 nodes: the
   sparse diffusion's 7 x 32 -> 32 over node-leading views and over
   row-major operands, the temporal taps, skip, end_conv_1 and 2, start):
   the forward through ``ops.linear.project``, the operands' gradient and
   the weight and bias gradient, each against its plain version within
   one bf16 ulp plus 2^-16 of the largest value, timed beside it, beside
   cuBLAS's bf16 GEMM and beside its bound; likewise at DCRNN's shapes
   (batch 8: a cell's gate and candidate over five node-leading hops of 72
   or 128 channels, its output 64 -> 1); its launches are held to the
   model's count in the train steps of 10 and 13 and the serving of 9;
5b'. the layer-tail kernel (``csrc/bn_tail.cu``, ``phase_layer_tail``):
   the dropout multiply, residual add and BatchNorm of every city layer
   shape (batch 4, 40,960 nodes, 32 channels, T = 12 to 1), each op
   against its plain version (x bit for bit), timed beside its byte bound,
   and the training tail forward and backward and the eval tail timed
   beside the chain of PyTorch ops; its launches held to one per layer and
   kind in two graphed city train steps (none backward in the last layer)
   and a batch-8 eval forward;
5c. DCRNN on the city (``phase_dcrnn``, the cell ``dcrnn-city-40k.train``'s
   path): kernel 3 in bf16 at its pairs' R (576 and 1,024), forward and
   over the transpose tables with ``add``, against its plain version and
   bit for bit against the chain; then one graphed call of two bf16 train
   steps at batch 8 and 40,960 sensors (``DCRNNEngine.
   train_steps_resident``) with the launch counters zeroed just before it:
   the captured step's block-kernel launches (``models.dcrnn.COUNTS``) held
   to the model's count (every pair forward and its transpose backward on
   kernel 3, less the first cell's gate backward), the projection kernel's
   to one per projection forward and weight gradient and one operands'
   gradient fewer;
6. kernel 3's dispatch: the fused pass against the chain at the main
   paths' R of ``DISPATCH_R``, forward and over the transpose tables with
   ``add``, fp32 and bf16, bit for bit, each line with both branches' host
   time per call and the branch ``"auto"`` picks (``fused2_dispatch``),
   which must not be the slower by more than 25% and 0.05 ms; and once on
   a table whose block rows are shuffled (lag >= half the rows), bit for
   bit (``dispatch_shuffled``);
7. small-N end to end: a 2,048-node fp32 city model at full width on the
   card matches the same model on the CPU (plain versions) to 2e-4, and
   its unfused supports give a bitwise-equal forecast;
8. small-N training: 3 train steps of the 2,048-node fp32 model with the
   adaptive adjacency on the card match 3 on the CPU, and one step's
   gradients with unfused supports and an unfused mask are bitwise equal
   to the fused ones; and the same over padded supports, with one gradient
   with respect to the padded blocks against the CPU;
9. serving at full width (a main path): a 40,960-node city checkpoint of
   random weights (bf16 activations) served by the port's serve CLI to
   concurrent requests under the flat layout and the padded ("pallas")
   one, with the launch counters held to the layout and the dispatch rule;
   a batch-8 predict's block casts with the blocks stored in bf16 (none)
   and in fp32 (one per order-2 pair); the same checkpoint under the
   128x512 layout, whose supports do not fuse, runs kernel 1 instead;
   predict latency at batch 1 and 8, under the dispatch rule and (flat)
   under kernel 3 at every R and under kernel 3 nowhere, alternating
   (``dispatch_ab``);
10. training at full width (main paths): the port's training CLI trains
   the 40,960-node city model with the adaptive adjacency (bf16, batch 4)
   for one epoch on synthetic data in the flat and the padded form, its
   checkpoint is served with one request, one train step's launch counters
   are held to the layout and the dispatch rule, and the train step is
   timed (also under kernel 3 at every R and nowhere, alternating) and
   profiled;
11. city ``aptonly`` at 2,048 nodes: the training CLI trains the adaptive
   adjacency alone under ``--profile DIR``, whose trace
   (``train.profiling.trace``) must name every hand kernel the step
   launches, and the serve CLI serves it;
12. the METR path: the port's ETL writes a synthetic 207-node dataset,
   ``gwt-torch-train`` trains the bf16 dense model one epoch (dataset on
   the device, the CLI's default) and the test CLI reproduces its test
   metrics from the checkpoint;
13. the dense model at ``bench.py``'s width (207 nodes, batch 64): card
   fp32 against CPU fp32, card bf16 against card fp32, 12 train steps
   timed and profiled, and the step time of each ``gcn_mode``;
14. device-resident training (``phase_resident``): the dense model of 13
   (dropout 0.3) on device-resident arrays, two fused calls of S = 22
   steps (``Engine.train_steps_resident``: one eager warm-up step, one
   captured CUDA graph replayed for the rest) bit for bit against 44 eager
   steps (metrics, weights, BatchNorm buffers, Adam, the dropout
   generator), then step time, node-timesteps/s, profiled idle share and
   peak memory of host-resident eager, device-resident eager and graphed
   steps; the same comparison (S = 4, under deterministic algorithms) for
   the 40,960-node city train step with the adaptive adjacency in the flat
   and the padded form, kernels 1-4 inside the graph, each replay's
   launches held to the layout, and eager against graphed step times and
   idle shares; and the METR CLI (12) with ``--resident device
   --scan_steps 8``, ``--resume`` of its epoch-1 checkpoint, ``--early_stop
   1`` on data whose validation cannot improve, and ``--grad_accum 2``;
15. kernel 5's path at full width: one forward and backward of the gcn at
   the first layer's training shape (batch 4, bf16, R = 1,536) over the
   padded supports with blocks that require a gradient (4 kernel-5
   launches), each launch held against its plain version on the card;
16. export (``phase_export``): ``gwt-torch-export`` at batch 8 of the
   serving checkpoint of 9 (flat), the padded checkpoint of 10 (with the
   masked adaptive adjacency) and the METR checkpoint of 12
   (``--adjdata``); each artifact loaded and run in a fresh process that
   imports only torch and the op library, its forecast bit for bit
   ``Forecaster.predict``'s, its launches the layout's; export and load
   seconds, artifact size, and the artifact's predict timed against the
   Forecaster's;
17. ``gwt-torch-serve --artifact`` on the flat artifact (4 concurrent
   requests padded to its batch of 8) and ``--checkpoint --adjdata`` on
   the METR checkpoint, answers against the Forecaster's;
18. streaming (``phase_rolling``): ``rolling_forecast`` over 24 origins of
   the 40,960-node flat model and over one day (288 origins) of the METR
   model, the replayed CUDA graph bit for bit the eager loop of
   ``predict``, each replay's launches one predict's, ms per origin and
   idle share of both; ``autoregressive_forecast`` (city at batch 1, 3
   rounds; METR with ``future_aux``) bit for bit its eager rounds.
19. the per-sample-graph model (``phase_diffg``): README's diff-G run at
   full width (80 nodes, K = 48, 4 x 2 layers from dilation 4, batch 32,
   fp32; subjects cut to 8/2/4) through ``gwt-torch-train --data syn
   --scan_steps 8`` for two epochs and its test, one ``--same_g`` epoch,
   one ``--data crash`` epoch on stand-in records and a ``--fresh_nodevec``
   run; graphed ``train_steps_syn_resident`` steps bit for bit against
   eager ``train_step_syn`` ones (dropout 0.3, with and without
   ``fresh_nodevec``), per-step ms and idle share of both; the checkpoint
   served from a bank of the test split's graphs (4 concurrent requests
   naming 4 graphs in one device call, against ``predict_indexed``;
   ``predict_indexed`` against ``predict`` on the gathered supports;
   ``/predict_modalities`` against the engine's ``eval_step_syn``),
   predict ms at batch 1 and 32; ``gwt-torch-export --graph_bank``, the
   artifact in a fresh process bit for bit ``predict_indexed``, served
   once with ``--artifact``. The path launches no hand kernel
   (``diffg_launches``).

20. ``--mesh_dp`` through the METR training CLI under torchrun with one
   rank and NCCL, bit for bit the same run without a process group
   (``dist_nccl1``);
21. data parallelism and node-TP at full width (``dist_city``): 4 ranks
   (2 x 2, the halo form) over a real process group (NCCL where every
   rank has a card, else gloo with the ranks sharing it), 2 fp32 steps
   with dropout 0 against the single
   process on the card, both under deterministic algorithms
   (``dist_compare``: losses rtol 1e-5; the first
   step's gradients, each tensor within ``GRAD_RTOL`` of its largest
   magnitude; after the first step every parameter element Adam resolves
   and every buffer atol 1e-5 of the state's largest magnitude), the
   gradient rule itself passing the single process against itself on the
   batch in reverse row order (and the single process repeating bit for
   bit, a reading without deterministic algorithms beside it) and
   rejecting two planted faults in one
   rank's mask cotangent (``grad_witness``), with the adaptive
   embeddings' gradient in fp32 and fp64 beside it, the state bit for bit
   equal across the ranks, one bf16 step with dropout 0.3 timed with each
   rank's peak memory and launches (kernel 1 forward and dx per hop,
   kernel 2 for the mask, per shard); the 2 x 2 group's processes then
   run the same steps on 2 model x 2 time (``tp2_t2``, the all_gather
   form: kernels 1 and 2 per shard on each time block, the bf16 step's
   counted in the ``dist_tp2_t2`` window) with the same checks; then the
   training CLI under torchrun with 2 node-TP ranks, its
   checkpoint served in one
   process against the single-process CLI run's; beside all of it, under
   torchrun, the city ``--aptonly`` model with node-TP and the METR model with
   ``--mesh_dp`` and with ``--mesh_model 2`` (dense node-TP, 104 + 103
   nodes), each test MAE within ``CLI_MAE_RTOL`` of the one-process run's
   of its flags;
22. ``dist_metr``: dense node-TP of the METR model at ``bench.py``'s
   width (207 nodes, batch 64): one set of 4 gloo processes sharing the
   card runs 2 data x 2 model (104 + 103 nodes) and 4 model (52 x 3 + 51)
   in turn, each 2 fp32 steps held to the single process as in 21 (the
   first step's gradients within ``METR_GRAD_RTOL``), one bf16 step with
   dropout 0.3 a rank timed, peak memory and the bytes a rank sends a
   step (``dense_exchange``); it runs while 21's torchrun node-TP ranks
   do, and its seconds are inside ``dist_city``'s;
23. ``tp_tables``: the node-TP partition of the city supports and mask
   for S = 2 and 4 (live blocks per shard, table lengths, dummy share,
   the exchange form, the bytes per hop of each form);
24. ``tp_local``: node-TP's kernels per shard in one process (S = 2 and
   4, both exchange forms, fp32 and bf16, R = 1,536): kernel 1 forward
   and dx and kernel 2 over each shard's tables and concatenated rows,
   put back together, bit for bit the unsharded support's where the
   tables sum the same entries in the same order.
25. ``dist_nccl1`` also runs the METR and the diff-G training CLIs with
   ``--mesh_dp --scan_steps 4`` under one NCCL rank (each fused step a
   CUDA graph with its collectives captured) against the plain
   ``--scan_steps 1`` runs, the checkpoints bit for bit;
26. ``dist_graphed``: on a one-rank NCCL group (``graphed_worker``), the
   METR model (bf16, batch 64), the city training cell (flat, the mask,
   bf16, batch 4; kernels 1, 2 and 3 in the replays, counted in the
   ``kernels`` line's ``dist_graphed`` window) and README's diff-G run
   (fp32, batch 32), dropout 0.3, graphed steps (S = 4) bit for bit the
   eager ones without deterministic algorithms, with ms per step and idle
   share of both;
27. ``dist_diffg``: README's diff-G run on 2 gloo DP ranks sharing the
   card, 2 fp32 steps with dropout 0 against the single process
   (``dist_compare``), and ``--data crash --mesh_dp`` under torchrun, its
   test MAE within ``CLI_MAE_RTOL`` of the one-process run's;
28. ``determinism``: two fresh fp32 city training steps with the mask
   (40,960 nodes, batch 4, flat, dropout 0) in two child processes,
   started together, without deterministic algorithms, equal bit for bit
   (losses, gradients, parameters);
29. ``dist_time``: time-halo sequence parallelism, the CRASH-scale diff-G
   step (K = 2,912, 200 nodes, nhid 32, 13 x 3 layers from dilation 32,
   per-sample supports and the adaptive adjacency, batch 4, remat) on 4
   gloo time ranks sharing the card, and its first 4 blocks (K = 896) on
   2 data x 2 model x 2 time (8 ranks: dense node-TP on each time
   block), 2 fp32 steps with dropout 0 against the single process of the
   same depth (``dist_compare``, the losses within 1e-6 relative), each
   rank's peak memory beside the single process's, one bf16 step a rank
   timed, the bytes a rank exchanges a step (halo and node exchange) and
   the share of garbage steps; and ``--data syn --mesh_time 2`` under
   torchrun, its test MAE within ``CLI_MAE_RTOL`` of the one-process
   run's (``dist_time_cli``).
30. ``data_feed``: on the METR data of 12, the native window loader
   (``data.native_loader``, built with g++) loaded, its window and batch
   gathers and feature-0 scaling bit for bit numpy's, each timed against
   numpy; ``Runner.fit`` and ``test`` of the host-resident dataset with
   ``TrainConfig(prefetch=2)`` bit for bit ``prefetch=0``;
31. ``dist_pipe``: the GPipe pipeline (``parallel.pipeline``) on one set
   of 4 gloo processes sharing the card: the METR model at ``bench.py``'s
   width on 2 data x 2 stages (2 micro-batches) and on 4 stages (4), 2
   fp32 steps held to one process's ``train_step_accum`` with the same
   ``n_micro`` (``dist_compare``, the gradients at ``PIPE_GRAD_RTOL``
   beside fp32's floor ``accum_floor``), one bf16 step with dropout 0.3
   a rank timed with its peak memory; then the pipelined eval forward of
   the 2,048-node fp32 city model of 7 over flat supports on 2 stages
   against the one-process forward (``pipe_eval_check``), its kernel-1
   and kernel-3 launches counted in the ``kernels`` line's ``dist_pipe``
   window; it runs beside ``dist_city``'s torchrun pair, after
   ``dist_metr``.
32. ``bench``: ``graph_wavenet_tpu_torch.benchmarks`` on the card
   (``phase_bench``): the flagship train step (bf16, batch 64, graphed
   steps) and inference rows, the 40,960-node sparse train step over flat
   RCM blocks (kernels 1 and 3) and random padded blocks (kernel 4), each
   kernel's first launch on the path against its plain version, no plain
   version on the path, ``0 < mfu <= 1.05``, the flagship's FLOP count on
   the card equal to the host CPU's, and the TPU's record refused by
   ``band_check``.

The script's cuts for time: the tile-width sweep at R = 3,072
only, the dispatch table at the R of ``DISPATCH_R``, plain and library
times only on the ``kernels`` line's shapes, fewer timed repeats in
``export``, fewer rolling origins of the METR model, one bf16 step in
``dist_city``, whose 2-rank node-TP group is gone (its all_gather form
and its checks run under model x time in the 2 x 2 group's processes),
``dist_metr``'s layouts in one set of processes, run beside
``dist_city``'s torchrun pair (``dist_pipe`` too), the torchrun CLIs
of ``dist_city`` started beside its rank group, ``determinism``'s two
children started together, each ``export`` artifact's fresh process run
while the next export is made, and the one-process references of
``dist_time``, ``dist_metr`` and ``dist_pipe`` computed while their ranks
run (``start_dist_group``); every check still runs. Before the ``kernels``
line it prints
``{"phase_seconds": {...}}``.

The launch counts of a graphed window add each replay's launches (a
wrapper counts its Python calls, so a capture counts a step once).

Before the last line it prints one ``{"kernels": [...]}`` line (kernels
1-5, then the projection kernel's three ops at the sparse diffusion's
shape) and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. It needs the repository around it and a
CUDA card, and exits non-zero without either.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
PROJ_SRC = "graph_wavenet_tpu_torch/csrc/chan_proj.cu"
K1_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:167"
K2_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:256"
K3_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:497"
K4_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:74"
K5_TPU = "graph_wavenet_tpu/ops/pallas/block_diffusion.py:325"
# kernel 3 forward at the batch-8 predict's first layer (bf16), timed with
# its plain version and two chained library products; the kernels line
# takes kernel 3 over the transpose tables with add at R = 1,536 (the
# train step's backward), a pair the dispatch rule sends to kernel 3
K3_FORWARD_R = 3072
TRAIN_BATCH = 4
TRAIN_SAMPLES = {"train": 16, "val": 4, "test": 4}
# DCRNN's cell (dcrnn-city-40k.train): batch 8, its kernel-3 pairs at R = 8
# x 72 (a first-layer cell) and 8 x 128 (a second-layer cell)
DCRNN_BATCH = 8
DCRNN_R = (576, 1024)


_T0 = time.perf_counter()
# the card's name and power limit (``phase_card``), on every emitted line
CARD = None


def emit(phase: str, **kv) -> None:
    """One JSON line, with the card's name and power limit and the seconds
    since the script started."""
    print(json.dumps({"phase": phase, **kv, "card": CARD,
                      "t": round(time.perf_counter() - _T0, 1)}), flush=True)


class CheckFailed(AssertionError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def deterministic(on: bool):
    """Deterministic algorithms on (or off) inside the block, off after."""
    import torch

    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def reset_launches() -> None:
    """Zero the hand kernels' launch counter (``ops.cuda.build.LAUNCHES``)."""
    from graph_wavenet_tpu_torch.ops.cuda import build
    build.reset_launch_counts()


def kernel_launches(ops=None) -> dict:
    """Launches since :func:`reset_launches` of each op of ``ops``, by
    default the five block kernels' (``block_diffusion.OPS``)."""
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.ops.cuda import build
    return {k: build.LAUNCHES[k] for k in ops or bd.OPS}


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


def host_us(fn, reps: int = 20) -> float:
    """Host time of one call of ``fn`` in microseconds: ``reps`` calls
    enqueued without a sync (few enough that the launch queue never fills),
    after one warm-up. Where it exceeds the device time, back-to-back
    ``cuda_ms`` measures the host, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def tile_of(r: int, dtype) -> dict:
    """The tile width kernels 1, 3 and 4 take at R = r, and the product
    they run it on."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    return {"ct": bd.tile_cols(r, dtype),
            "product": "wgmma" if dtype == torch.bfloat16 else "fp32 FMA"}


def close_err(got, want, summand=None,
              slack: float = 2.0 ** -20) -> tuple[float, bool, str]:
    """Max |got - want| and whether it is within the dtype's tolerance:
    fp32 rtol 1e-5 (atol 1e-5 of the largest value); bf16 one bf16 ulp of
    the larger of the two values, plus fp32 accumulation-order ``slack``
    of the largest value. ``summand``: the term added after the
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
        tol = ulp(torch.maximum(g.abs(), w.abs())) + scale * slack
        rule = f"1 bf16 ulp + 2^{math.log2(slack):.0f} x max|plain|"
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


def library_operator(sp, x2, transpose_lhs: bool):
    """One PyTorch call computing a hop of ``sp`` on (N, R) inputs like
    ``x2``, for the yardstick time: a block-sparse (BSR) product where
    PyTorch runs one for this dtype on CUDA, else a dense matmul against the
    materialized support. Returns (apply, name)."""
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
        bsr @ x2
        torch.cuda.synchronize()
        return (lambda v: bsr @ v), "torch.sparse_bsr_tensor @ dense"
    except (RuntimeError, NotImplementedError) as e:
        reason = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
    dense = bsr.to_dense()
    del bsr
    return (lambda v: dense @ v), f"dense torch.matmul ({reason})"


def library_hop(sp, x2, transpose_lhs: bool):
    """:func:`library_operator` on ``x2``: (fn, name, out)."""
    apply, name = library_operator(sp, x2, transpose_lhs)
    return (lambda: apply(x2)), name, apply(x2)


def library_hop_pair(sp, x2, transpose_lhs: bool, add=None):
    """Kernel 3's function as PyTorch calls: two chained library products,
    ``+ add`` between them. Returns (fn, name)."""
    apply, name = library_operator(sp, x2, transpose_lhs)
    if add is None:
        return (lambda: apply(apply(x2))), f"two chained {name}"
    return (lambda: apply(apply(x2) + add)), f"two chained {name}, + add"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    import torch

    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    CARD = smi
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
                    rec = dict(kernel="mix_flat",
                               dtype=dname, R=r, **tile_of(r, dtype),
                               blocks=label,
                               orientation="forward" if tl else "transpose",
                               max_abs_err=err, tolerance=rule)
                    require(ok, f"kernel 1 disagrees with its plain "
                                f"version: {rec}")
                    rec["kernel_ms"] = cuda_ms(k1, reps)
                    flops, nbytes = hop_cost(sp, r, isz, fused=False)
                    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes,
                                                             dname)
                    # the plain and library times of the kernels line's
                    # shape only
                    if (label, tl, dname, r) == ("128x128", True,
                                                 "bfloat16", 3072):
                        rec["plain_ms"] = cuda_ms(plain, max(2, reps // 5))
                        lib_fn, lib_name, lib_out = library_hop(
                            bsd, x.reshape(-1, r), tl)
                        lib_err, _, _ = close_err(
                            lib_out.reshape(got.shape).to(dtype), got)
                        del lib_out
                        rec["library_ms"] = cuda_ms(lib_fn,
                                                    max(2, reps // 5))
                        rec["library"] = lib_name
                        rec["library_max_abs_diff"] = lib_err
                        del lib_fn
                        summary["k1"] = rec
                    emit("kernel_check", **rec)
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
                        add=add, row_ptr=sq.row_ptr, dispatch="fused")

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
                rec = dict(kernel="mix_flat2", dtype=dname,
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
                rec["auto"] = bd.fused2_dispatch(r, dtype, add=with_add)
                flops, nbytes = hop_cost(sq, r, isz, fused=True,
                                         with_add=with_add)
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes,
                                                         dname)
                if (dname, r, with_add) == ("bfloat16", K3_FORWARD_R, False):
                    rec["plain_ms"] = cuda_ms(k3_plain, max(2, reps // 5))
                    lib_fn, rec["library"] = library_hop_pair(
                        sq.astype(dtype), x.reshape(-1, r), True,
                        None if add is None else add.reshape(-1, r))
                    rec["library_ms"] = cuda_ms(lib_fn, max(2, reps // 5))
                    del lib_fn
                emit("kernel_check", **rec)
                del add
                torch.cuda.empty_cache()
    tile_widths(sq, gen)
    return summary


# the R of the batch-8 predict's first layer, the widest kernel-1 launch of
# the main paths (the sweep at 384, 640 and 1,152 too agreed with
# ``tile_cols``, which has not changed since)
TILE_WIDTH_R = (3072,)


def tile_widths(sq, gen) -> None:
    """bf16 kernel 1 forward on the square support at each tile width the
    product builds, through the library's entry point (the wrapper always
    takes ``tile_cols``'s width): the measurement behind that rule. These
    launches are not counted."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.ops.cuda import build

    blocks = sq.astype(torch.bfloat16).blocks_flat
    for r in TILE_WIDTH_R:
        x = torch.randn(sq.nb, 128, r, generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = torch.empty_like(x)

        def at(ct):
            build.launch("mix_flat.cu", "gwt_mix_flat", bd.mix_flat_desc(
                blocks, sq.slot_tbl, x, sq.src_tbl, sq.row_ptr, out, sq.nb,
                True, ct), x.device)

        ms = {ct: cuda_ms(lambda: at(ct), 20 if r < 1000 else 5)
              for ct in (64, 128, 256)}
        emit("tile_widths", kernel="mix_flat", dtype="bfloat16",
             R=r, orientation="forward", ms_by_ct=ms,
             tile_cols=bd.tile_cols(r, torch.bfloat16))
        del x, out


# R of the order-2 hop pairs the dispatch table is checked at (B x T x 32
# channels, T = 12, 10, 9, 7, 6, 4, 3, 1 over the eight layers): the
# smallest and largest of the main paths (predict at batch 1 and 8, the
# batch-4 train step forward, and its backward over the transpose tables
# with add), each tile width, the main paths' R on both sides of the
# threshold of ``block_diffusion.FUSED2_R`` (bf16 forward fused up to
# 2,048: 1,792 and 2,304, the batch-8 predict's layers 4 and 3), and
# DCRNN's pairs (``DCRNN_R``) both ways
DISPATCH_R = {
    "forward": (32, 128, 192, 384, 448, 512, 576, 1024, 1536, 1792, 2304,
                3072),
    "transpose+add": (128, 192, 384, 448, 512, 576, 1024, 1536)}


def phase_dispatch(graph) -> dict:
    """Kernel 3 (dispatch "fused") against kernel 1 + add + kernel 1
    ("chain") at every R of :data:`DISPATCH_R`, fp32 and bf16: forward on
    the 40,960-node RCM support's tables, and over the adaptive mask's
    transpose tables with ``add`` (the train step's backward chain). Each
    pair is timed fused, chain, chain, fused (the minimum of each) and
    checked bit for bit; each line names the branch ``"auto"`` picks
    (``fused2_dispatch``) and fails the run when auto picks a branch slower
    by more than 10% and 0.02 ms. Returns the table by (dtype, tables)."""
    import torch

    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )
    from graph_wavenet_tpu_torch.ops.adaptive_block import mask_from_supports
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    _, src, dst, w = graph
    perm = rcm_order_edges(src, dst, N_CITY)
    sups = doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                           form="flat", device="cuda")
    mask = mask_from_supports(sups, hops=1)
    gen = torch.Generator(device="cuda").manual_seed(11)
    nv1 = torch.randn(N_CITY, 10, generator=gen, device="cuda")
    nv2 = torch.randn(10, N_CITY, generator=gen, device="cuda")
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        fwd = sups[0].astype(dtype)
        bwd = mask.materialize(nv1, nv2, out_dtype=dtype)
        for tables, rs in DISPATCH_R.items():
            if tables == "forward":
                sp, tl = fwd, True
                tbl = (sp.slot_tbl, sp.src_tbl, sp.row_tbl)
                lag, ptr = sp.lag, sp.row_ptr
            else:
                sp, tl = bwd, False
                tbl = (sp.slot_t, sp.src_t, sp.row_t)
                lag, ptr = sp.lag_t, sp.row_ptr_t
            rows = []
            for r in rs:
                reps = 50 if r <= 256 else 20 if r <= 1024 else 5
                x = torch.randn(sp.nb, 128, r, generator=gen,
                                device="cuda").to(dtype)
                add = (None if tables == "forward" else
                       torch.randn(sp.nb, 128, r, generator=gen,
                                   device="cuda").to(dtype))

                def run(branch):
                    return bd.gathered_block_mix_flat2(
                        sp.blocks_flat, tbl[0], x, tbl[1], tbl[2], nb=sp.nb,
                        lag=lag, transpose_lhs=tl, add=add, row_ptr=ptr,
                        dispatch=branch)

                f1, f2 = run("fused")
                c1, c2 = run("chain")
                torch.cuda.synchronize()
                bitwise = bool(torch.equal(f1, c1) and torch.equal(f2, c2))
                del f1, f2, c1, c2
                require(bitwise, f"dispatch chain and fused differ: {dname} "
                                 f"{tables} R={r}")
                t = [cuda_ms(lambda b=b: run(b), reps)
                     for b in ("fused", "chain", "chain", "fused")]
                fused_ms, chain_ms = min(t[0], t[3]), min(t[1], t[2])
                h = [host_us(lambda b=b: run(b))
                     for b in ("fused", "chain", "chain", "fused")]
                fused_us, chain_us = min(h[0], h[3]), min(h[1], h[2])
                auto = bd.fused2_dispatch(r, dtype, add=add is not None)
                faster = "fused" if fused_ms < chain_ms else "chain"
                picked, other = ((fused_ms, chain_ms) if auto == "fused"
                                 else (chain_ms, fused_ms))
                rec = dict(dtype=dname, tables=tables, R=r,
                           **tile_of(r, dtype), fused_ms=fused_ms,
                           chain_ms=chain_ms, fused_host_us=fused_us,
                           chain_host_us=chain_us, faster=faster, auto=auto,
                           bitwise=bitwise)
                emit("dispatch", **rec)
                rows.append(rec)
                # a stale rule shows as a pick slower by far more than two
                # calls' spread (up to ~20% at R <= 128, where a few
                # hundredths of a ms separate the branches)
                require(picked <= max(1.25 * other, other + 0.05),
                        f"auto picks the slower branch: {rec}")
                del x, add
            table[dname, tables] = rows
            torch.cuda.empty_cache()
    shuffled_pair(sups[0].astype(torch.bfloat16), gen)
    return table


# R of the large-lag check: the batch-4 train step's first layer
SHUFFLED_R = 1536


def shuffled_pair(sp, gen) -> None:
    """Kernel 3 on a table whose lag is at least half its rows: the RCM
    support's block rows renumbered by a random permutation (the same
    blocks, entries re-sorted by row), bf16 forward at ``SHUFFLED_R``, bit
    for bit against kernel 1 + kernel 1 and timed against them. Hop 2 then
    reads out1 rows published far apart in ticket order."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    perm = np.random.default_rng(12).permutation(sp.nb)
    row = perm[sp.row_tbl.cpu().numpy()]
    src = perm[sp.src_tbl.cpu().numpy()]
    order = np.argsort(row, kind="stable")
    row, src = row[order], src[order]
    slot = sp.slot_tbl.cpu().numpy()[order]
    lag = bd.fused2_lag(row, src)
    require(lag >= sp.nb // 2, f"the shuffled table's lag {lag} is under "
                               f"half its {sp.nb} rows")
    row_t, src_t, slot_t = (torch.as_tensor(a.astype(np.int32),
                                            device="cuda")
                            for a in (row, src, slot))
    ptr = bd.row_pointer(row_t, sp.nb)
    x = torch.randn(sp.nb, 128, SHUFFLED_R, generator=gen,
                    device="cuda").to(torch.bfloat16)

    def run(branch):
        return bd.gathered_block_mix_flat2(
            sp.blocks_flat, slot_t, x, src_t, row_t, nb=sp.nb, lag=lag,
            transpose_lhs=True, row_ptr=ptr, dispatch=branch)

    f1, f2 = run("fused")
    c1, c2 = run("chain")
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(f1, c1) and torch.equal(f2, c2))
    del f1, f2, c1, c2
    t = [cuda_ms(lambda b=b: run(b), 5)
         for b in ("fused", "chain", "chain", "fused")]
    rec = dict(dtype="bfloat16", tables="forward, block rows shuffled",
               R=SHUFFLED_R, nb=sp.nb, lag=lag, bitwise=bitwise,
               fused_ms=min(t[0], t[3]), chain_ms=min(t[1], t[2]))
    emit("dispatch_shuffled", **rec)
    require(bitwise, f"kernel 3 on the shuffled table differs from the "
                     f"chain: {rec}")


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
            # plain and library times at the kernels line's shape only
            full = (dname, r) == ("bfloat16", 1536)
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
            rec = dict(kernel="outer_flat", dtype=dname, R=r,
                       **outer_tile_of(dtype, bs), blocks="128x128",
                       form="per entry", table_entries=sp.row_tbl.numel(),
                       max_abs_err=err, tolerance="rtol 1e-5 of sum |terms|",
                       deterministic=deterministic)
            require(ok, f"kernel 2 disagrees with its plain version: {rec}")
            require(deterministic, f"kernel 2 is not deterministic: {rec}")
            rec["kernel_ms"] = cuda_ms(k2, reps)
            if full:
                rec["plain_ms"] = cuda_ms(k2_plain, max(2, reps // 5))
                xs = x.index_select(0, sp.src_tbl.long())
                gs = g.index_select(0, sp.row_tbl.long()).transpose(1, 2)
                lib_ms = cuda_ms(lambda: torch.bmm(xs, gs),
                                 max(2, reps // 5))
                lib_name = ("torch.bmm on operands gathered beforehand "
                            "(gather excluded; output in the input dtype)")
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
            rec = dict(kernel="outer_flat", dtype=dname, R=r,
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
            if full:
                rec["plain_ms"] = cuda_ms(
                    lambda: bd.outer_flat_plain(x, g, sp.src_tbl, sp.row_tbl,
                                                sp.slot_tbl, n_slots, dtype),
                    max(2, reps // 5))
                rec["library_ms"], rec["library"] = lib_ms, lib_name
                summary["k2"] = rec
            flops, nbytes = outer_cost(mask, r, isz, storage_isz=isz)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)
            torch.cuda.empty_cache()

            # kernel 3 over the transpose tables with add: the fused
            # backward chain (g1_eff, dx) of one hop pair
            args = (blocks, sp.slot_t, g, sp.src_t, sp.row_t)

            def k3t():
                return bd.gathered_block_mix_flat2(
                    *args, nb=nb, lag=sp.lag_t, transpose_lhs=False, add=x,
                    row_ptr=sp.row_ptr_t, dispatch="fused")

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
            rec = dict(kernel="mix_flat2", dtype=dname, R=r,
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
            rec["auto"] = bd.fused2_dispatch(r, dtype, add=True)
            if full:
                rec["plain_ms"] = cuda_ms(k3t_plain, max(2, reps // 5))
                lib_fn, rec["library"] = library_hop_pair(
                    sp, g.reshape(-1, r), False, x.reshape(-1, r))
                rec["library_ms"] = cuda_ms(lib_fn, max(2, reps // 5))
                del lib_fn
                summary["k3"] = rec
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
            rec = dict(kernel="mix_flat", dtype=dname, R=r,
                       **tile_of(r, dtype), tables="transpose (mask)",
                       max_abs_err=err, tolerance=rule)
            require(ok, f"kernel 1 (transpose, mask) disagrees with its "
                        f"plain version: {rec}")
            rec["kernel_ms"] = cuda_ms(k1t, reps)
            if full:
                rec["plain_ms"] = cuda_ms(
                    lambda: bd.mix_flat_plain(*args, nb=nb,
                                              transpose_lhs=False),
                    max(2, reps // 5))
                lib_fn, lib_name, lib_out = library_hop(
                    sp, g.reshape(-1, r), False)
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
    emit("kernel_check", kernel="outer_flat", dtype="float32",
         R=128, blocks="128x512", max_abs_err=err)
    require(ok, f"kernel 2 on 128x512 blocks disagrees: {err}")
    return summary


# the city train step's projections at its first layer (batch 4, 40,960
# nodes): name, C, F, operands, layout. ``nodes``: the sparse diffusion's
# node-leading hops read as (B*T, N, C) views; ``rows``: the same over
# (B, T, N, C) operands (the dense modes'); ``taps``: the temporal conv's
# two time slices of one tensor; ``last``: the skip conv's last 12 steps;
# ``dcrnn``: DCRNN's (N, B, C) hops at its cell's batch (a first-layer
# cell's 8 padded input + 64 state channels, a second-layer cell's 128;
# F = 2 x 64 for the gate, 64 for the candidate, 1 for the output)
PROJ_SHAPES = (("diffusion", 32, 32, 7, "nodes"),
               ("diffusion_rows", 32, 32, 7, "rows"),
               ("tcn", 32, 64, 2, "taps"), ("skip", 32, 256, 1, "last"),
               ("end_conv_1", 256, 512, 1, "end"),
               ("end_conv_2", 512, 12, 1, "end"),
               ("start", 2, 32, 1, "start"),
               ("dcrnn_gate_1", 72, 128, 5, "dcrnn"),
               ("dcrnn_cand_1", 72, 64, 5, "dcrnn"),
               ("dcrnn_gate_2", 128, 128, 5, "dcrnn"),
               ("dcrnn_cand_2", 128, 64, 5, "dcrnn"),
               ("dcrnn_output", 64, 1, 1, "dcrnn"))


def proj_operands(layout: str, c: int, k: int, gen) -> list:
    import torch

    b, t, n = TRAIN_BATCH, 12, N_CITY

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    if layout == "nodes":
        return [draw(n, b * t * c).reshape(n, b * t, c).transpose(0, 1)
                for _ in range(k)]
    if layout == "rows":
        return [draw(b, t, n, c) for _ in range(k)]
    if layout == "taps":
        x = draw(b, t + 1, n, c)
        return [x[:, i:i + t] for i in range(k)]
    if layout == "last":
        return [draw(b, t + 1, n, c)[:, -t:]]
    if layout == "end":
        return [draw(b, 1, n, c)]
    if layout == "dcrnn":
        return [draw(n, DCRNN_BATCH, c) for _ in range(k)]
    return [draw(b, t + 1, n, c)]                        # start


def phase_chan_proj() -> dict:
    """The projection kernel (``csrc/chan_proj.cu``) at the city train
    step's and DCRNN's shapes (``PROJ_SHAPES``): its forward through
    ``ops.linear.
    project``, its operands' gradient and its weight and bias gradient
    (``chan_proj_dgrad``, ``chan_proj_wgrad``), each against its plain
    version (``chan_proj_*_plain``: fp32 matmuls, sums and one cast) on
    the same card tensors, within one bf16 ulp plus 2^-16 of the largest
    value (fp32 sums in another order; the fp32 bias gradient within rtol
    1e-5), and timed beside the plain version, cuBLAS's bf16 GEMM on the
    operands already concatenated (``library_ms``, bf16 output, which
    reads each operand once) and its bound (each byte read and written
    once, or the bf16 tensor cores' peak). Returns the diffusion's rows
    for the kernels line."""
    import torch

    from graph_wavenet_tpu_torch.ops import linear
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj as cp

    ops = torch.ops.gwt_torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    for name, c, f, k, layout in PROJ_SHAPES:
        xs = proj_operands(layout, c, k, gen)
        ctot = c * k
        w = torch.randn(f, ctot, generator=gen, device="cuda") / ctot ** 0.5
        bias = torch.randn(f, generator=gen, device="cuda")
        rows = linear._row_views(xs)
        wb = w.bfloat16()
        m = rows[0].shape[0] * rows[0].shape[1]
        g = torch.randn(rows[0].shape[:2] + (f,), generator=gen,
                        device="cuda").bfloat16()
        # the library's operands: concatenated, contiguous, outside its time
        x2 = torch.cat([x.reshape(m, c) for x in rows], dim=1)
        g2 = g.reshape(m, f)
        passes = {
            "chan_proj": (
                lambda: linear.project(xs, w, bias),
                lambda: cp.chan_proj_plain(rows, wb, bias),
                lambda: torch.addmm(bias.bfloat16(), x2, wb.t())),
            "chan_proj_dgrad": (
                lambda: ops.chan_proj_dgrad(g, wb, rows),
                lambda: cp.chan_proj_dgrad_plain(g, wb, rows),
                lambda: g2 @ wb),
            "chan_proj_wgrad": (
                lambda: ops.chan_proj_wgrad(rows, g),
                lambda: cp.chan_proj_wgrad_plain(rows, g),
                lambda: (g2.t() @ x2, g2.sum(0, dtype=torch.float32)))}
        for op, (kern, plain, library) in passes.items():
            reset_launches()
            with torch.no_grad():
                got, want = kern(), plain()
            torch.cuda.synchronize()
            counts = kernel_launches(cp.OPS)
            require(counts[op] == 1 and sum(counts.values()) == 1,
                    f"{name} {op}: launches {counts}")
            got = list(got) if isinstance(got, (list, tuple)) else [got]
            want = list(want) if isinstance(want, (list, tuple)) else [want]
            errs = []
            for a, b in zip(got, want):
                # project's output keeps the operands' leading shape
                require(a.numel() == b.numel() and a.dtype == b.dtype,
                        f"{name} {op}: {a.shape} {a.dtype} against "
                        f"the plain version's {b.shape} {b.dtype}")
                err, ok, rule = close_err(a.reshape(b.shape), b,
                                          slack=2.0 ** -16)
                require(ok, f"{name} {op} disagrees with its plain "
                            f"version: {err} ({rule})")
                errs.append(err)
            del got, want
            flops = 2 * m * ctot * f
            nbytes = 2 * m * (ctot + f)
            with torch.no_grad():
                rec = dict(op=op, projection=name, C=c, F=f, operands=k,
                           layout=layout, rows=m, max_abs_err=max(errs),
                           kernel_ms=cuda_ms(kern, 20),
                           plain_ms=cuda_ms(plain, 3),
                           library_ms=cuda_ms(library, 20))
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes,
                                                     "bfloat16")
            emit("chan_proj_check", **rec)
            if name == "diffusion":
                summary[op] = rec
        del xs, rows, x2, g, g2, passes
        torch.cuda.empty_cache()
    return summary


# the city step's layers: (output steps, dilation); each layer's residual
# is its input, ``dilation`` steps longer
TAIL_LAYERS = ((12, 1), (10, 2), (9, 1), (7, 2), (6, 1), (4, 2), (3, 1),
               (1, 2))
TAIL_TRAIN_OPS = ("bn_tail_stats", "bn_tail_var", "bn_tail_apply",
                  "bn_tail_grad_reduce", "bn_tail_grad_apply")
# bytes an element each op reads and writes once (bf16): stats reads h,
# the mask and the residual and writes x; var reads x; apply reads x and
# writes y; eval reads h and the residual and writes y; grad_reduce reads
# g and x; grad_apply reads g, x and the mask and writes dh and dres
TAIL_BYTES = {"bn_tail_stats": 8, "bn_tail_var": 2, "bn_tail_apply": 4,
              "bn_tail_eval": 6, "bn_tail_grad_reduce": 4,
              "bn_tail_grad_apply": 10}
TAIL_SRC = "graph_wavenet_tpu_torch/csrc/bn_tail.cu"
TAIL_SYMBOLS = {"bn_tail_stats": ["bn_tail_stats", "bn_tail_finish"],
                "bn_tail_var": ["bn_tail_var", "bn_tail_finish"],
                "bn_tail_apply": ["bn_tail_apply"],
                "bn_tail_eval": ["bn_tail_apply"],
                "bn_tail_grad_reduce": ["bn_tail_grad_reduce",
                                        "bn_tail_finish"],
                "bn_tail_grad_apply": ["bn_tail_grad_apply"]}


def tail_chain(bn, h, drop, res):
    """The tail as the chain of PyTorch ops (``BatchNorm._chain``)."""
    x = h if drop is None else h * drop
    return bn._chain(x + res[:, -x.shape[1]:], None, None, None)


def phase_layer_tail(graph) -> dict:
    """The layer-tail kernel (``csrc/bn_tail.cu``) at the city train step's
    eight layer shapes (batch 4, 40,960 nodes, 32 channels, the residual
    the layer input's last T steps): each op against its plain version on
    the same card tensors (x bit for bit; sums within rtol 1e-5; y, dh and
    dres within one bf16 ulp plus 2^-16 of the largest value), timed
    beside its bound (its bytes read and written once at 3.35 TB/s), and
    the whole training tail forward and backward and the eval tail timed
    beside the chain of PyTorch ops they replace. Then one call of two
    graphed bf16 city train steps at batch 4 (the first eager, the second
    captured) and one batch-8 eval forward with the counters zeroed just
    before each: every forward kind 8 times a step and every backward kind
    7 (the last layer's output reaches no loss term), ``eval`` 8 times a
    forward. Returns the
    first layer's rows for the kernels line and the windows' launches."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import bn_tail as bt
    from graph_wavenet_tpu_torch.ops.normalization import BatchNorm

    ops = torch.ops.gwt_torch
    gen = torch.Generator(device="cuda").manual_seed(22)
    b, n, c = TRAIN_BATCH, N_CITY, 32
    summary = {}
    totals = {"tail_ms": 0.0, "chain_ms": 0.0, "eval_ms": 0.0,
              "chain_eval_ms": 0.0, "bound_ms": 0.0}
    for t, dil in TAIL_LAYERS:
        shape = (b, t, n, c)
        h = (2 * torch.randn(shape, generator=gen, device="cuda")
             + 0.5).bfloat16()
        keep = torch.rand(shape, generator=gen, device="cuda") < 0.7
        drop = keep.bfloat16() / torch.full((), 0.7, dtype=torch.bfloat16,
                                            device="cuda")
        res = torch.randn((b, t + dil, n, c), generator=gen,
                          device="cuda").bfloat16()
        resv = res[:, -t:]
        dy = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        w = 1 + 0.3 * torch.randn(c, generator=gen, device="cuda")
        bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
        count = b * t * n
        with torch.no_grad():
            x, s1 = ops.bn_tail_stats(h, drop, resv)
            xw, s1w = bt.stats_plain(h, drop, resv)
            require(torch.equal(x, xw),
                    f"tail stats at T = {t}: x differs from the chain's")
            mean = s1w / count
            s2w = bt.var_plain(x, mean)
            inv = torch.rsqrt(s2w / count + 1e-5)
            rinv = inv * 0.8
            sums_w = bt.grad_reduce_plain(dy, x, mean, inv)
            passes = {
                "bn_tail_stats": (
                    lambda: ops.bn_tail_stats(h, drop, resv)[1],
                    lambda: s1w),
                "bn_tail_var": (lambda: ops.bn_tail_var(x, mean),
                                lambda: s2w),
                "bn_tail_apply": (
                    lambda: ops.bn_tail_apply(x, mean, inv, w, bias),
                    lambda: bt.apply_plain(x, mean, inv, w, bias)),
                "bn_tail_eval": (
                    lambda: ops.bn_tail_eval(h, None, resv, mean, rinv, w,
                                             bias),
                    lambda: bt.eval_plain(h, None, resv, mean, rinv, w,
                                          bias)),
                "bn_tail_grad_reduce": (
                    lambda: ops.bn_tail_grad_reduce(dy, x, mean, inv),
                    lambda: sums_w),
                "bn_tail_grad_apply": (
                    lambda: ops.bn_tail_grad_apply(dy, x, drop, mean, inv,
                                                   w, sums_w, count, t + dil),
                    lambda: bt.grad_apply_plain(dy, x, drop, mean, inv, w,
                                                sums_w, count, t + dil))}
            for kind, (kern, plain) in passes.items():
                reset_launches()
                got, want = kern(), plain()
                torch.cuda.synchronize()
                counts = kernel_launches(bt.OPS)
                require(counts[kind] == 1 and sum(counts.values()) == 1,
                        f"{kind} at T = {t}: launches {counts}")
                got = list(got) if isinstance(got, tuple) else [got]
                want = list(want) if isinstance(want, tuple) else [want]
                errs = []
                for j, (a, w_) in enumerate(zip(got, want)):
                    # dh is dx times the mask, rounded once more
                    once_more = (torch.zeros_like(w_)
                                 if kind == "bn_tail_grad_apply" and j == 0
                                 else None)
                    err, ok, rule = close_err(a, w_, once_more,
                                              slack=2.0 ** -16)
                    require(ok, f"{kind} at T = {t} disagrees with its "
                                f"plain version: {err} ({rule})")
                    errs.append(err)
                nbytes = TAIL_BYTES[kind] * count * c
                if kind == "bn_tail_grad_apply":
                    nbytes += 2 * b * dil * n * c     # dres's leading zeros
                rec = dict(op=kind, T=t, dilation=dil,
                           elements=count * c, max_abs_err=max(errs),
                           kernel_ms=cuda_ms(kern, 20),
                           plain_ms=cuda_ms(plain, 3) if kind in (
                               "bn_tail_apply", "bn_tail_eval",
                               "bn_tail_grad_apply") else None,
                           library_ms=None)
                rec["bound_ms"], rec["bound_by"] = bound(0.0, nbytes,
                                                         "bfloat16")
                emit("bn_tail_check", **rec)
                if kind != "bn_tail_eval":
                    totals["bound_ms"] += rec["bound_ms"]
                if t == TAIL_LAYERS[0][0]:
                    summary[kind] = rec
                del got, want
        # the whole tail, forward and backward, against the chain
        bn = BatchNorm(c, device="cuda")
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(bias)
        hg = h.clone().requires_grad_()
        rg = res.clone().requires_grad_()
        leaves = (hg, rg, bn.weight, bn.bias)

        def tail_step():
            y, _ = bn.tail(hg, rg, drop)
            return torch.autograd.grad(y, leaves, dy)

        def chain_step():
            y, _ = tail_chain(bn, hg, drop, rg)
            return torch.autograd.grad(y, leaves, dy)

        bn.eval()
        with torch.no_grad():
            def eval_tail():
                return bn.tail(h, res)[0]

            def eval_chain():
                return tail_chain(bn, h, None, res)[0]

            e_ms, ec_ms = cuda_ms(eval_tail, 20), cuda_ms(eval_chain, 5)
        bn.train()
        rec = dict(T=t, dilation=dil, elements=count * c,
                   tail_ms=cuda_ms(tail_step, 10),
                   chain_ms=cuda_ms(chain_step, 5), eval_ms=e_ms,
                   chain_eval_ms=ec_ms)
        emit("bn_tail_layer", **rec)
        for k in ("tail_ms", "chain_ms", "eval_ms", "chain_eval_ms"):
            totals[k] += rec[k]
        del h, drop, res, resv, dy, x, xw, hg, rg, passes, bn
        torch.cuda.empty_cache()
    emit("bn_tail_step", layers=len(TAIL_LAYERS), batch=b, nodes=n,
         **{k: round(v, 4) for k, v in totals.items()})

    # the launches of a graphed city train step and of a serving forward
    eng, sups, x_np, y_np = dist_engine("city", "bfloat16", 0.3, "cuda",
                                        None, graph)
    xs = torch.as_tensor(np.concatenate([x_np, x_np[::-1]]), device="cuda")
    ys = torch.as_tensor(np.concatenate([y_np, y_np[::-1]]), device="cuda")
    idx = np.arange(2 * b, dtype=np.int64).reshape(2, b)
    layers = len(TAIL_LAYERS)
    reset_launches()
    first = eng.train_steps_resident(xs, ys, idx, sups)["loss"]
    torch.cuda.synchronize()
    train_counts = kernel_launches(bt.OPS)
    want = {k: 2 * (layers if k in TAIL_TRAIN_OPS[:3] else layers - 1)
            for k in TAIL_TRAIN_OPS}
    want["bn_tail_eval"] = 0
    require(train_counts == want,
            f"two graphed city steps launched the tail {train_counts}, "
            f"expected {want}")
    reset_launches()
    eng.model.eval()
    with torch.no_grad():
        eng.model(xs, sups)
    torch.cuda.synchronize()
    serve_counts = kernel_launches(bt.OPS)
    require(serve_counts == dict(dict.fromkeys(TAIL_TRAIN_OPS, 0),
                                 bn_tail_eval=layers),
            f"a batch-8 city forward launched the tail {serve_counts}")
    emit("bn_tail_launches", train_call=train_counts, serve=serve_counts,
         losses=first.tolist(),
         peak_gib=round(torch.cuda.max_memory_reserved() / 2 ** 30, 3))
    del eng, sups, xs, ys
    torch.cuda.empty_cache()
    summary["tail_windows"] = {"tail_train": train_counts,
                               "tail_serve": serve_counts}
    return summary


def pair_check(sp, r: int, dtype, tables: str, gen) -> dict:
    """Kernel 3 (dispatch "fused") on flat support ``sp`` at R = ``r``:
    ``"forward"`` over its tables, ``"transpose+add"`` over its transpose
    tables with ``add`` (a pair's backward); hop 1 against the plain
    version, hop 2 against the plain hop over the kernel's own hop 1, and
    both bit for bit against the chain. Returns the line emitted."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    fwd = tables == "forward"
    blocks = sp.blocks_flat
    tbl = ((sp.slot_tbl, sp.src_tbl, sp.row_tbl) if fwd
           else (sp.slot_t, sp.src_t, sp.row_t))
    lag, ptr = (sp.lag, sp.row_ptr) if fwd else (sp.lag_t, sp.row_ptr_t)
    x = torch.randn(sp.nb, 128, r, generator=gen, device="cuda").to(dtype)
    add = (None if fwd else torch.randn(sp.nb, 128, r, generator=gen,
                                        device="cuda").to(dtype))

    def run(branch):
        return bd.gathered_block_mix_flat2(
            blocks, tbl[0], x, tbl[1], tbl[2], nb=sp.nb, lag=lag,
            transpose_lhs=fwd, add=add, row_ptr=ptr, dispatch=branch)

    o1, o2 = run("fused")
    c1, c2 = run("chain")
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(o1, c1) and torch.equal(o2, c2))
    del c1, c2
    p1, _ = bd.mix_flat2_plain(blocks, tbl[0], x, tbl[1], tbl[2], nb=sp.nb,
                               transpose_lhs=fwd, add=add)
    err1, ok1, rule = close_err(o1, p1, summand=add)
    del p1
    p2 = bd.mix_flat_plain(blocks, tbl[0], o1, tbl[1], tbl[2], nb=sp.nb,
                           transpose_lhs=fwd)
    err2, ok2, _ = close_err(o2, p2)
    del p2, o1, o2
    dname = str(dtype).split(".")[1]
    rec = dict(kernel="mix_flat2", dtype=dname, R=r,
               **tile_of(r, dtype), tables=tables, add=not fwd,
               max_abs_err_out1=err1, max_abs_err_out2=err2, tolerance=rule,
               bitwise_vs_chain=bitwise,
               auto=bd.fused2_dispatch(r, dtype, add=not fwd))
    require(ok1 and ok2, f"kernel 3 disagrees with its plain version: {rec}")
    require(bitwise, f"kernel 3 is not bitwise equal to the chain: {rec}")
    rec["kernel_ms"] = cuda_ms(lambda: run("fused"), 20)
    flops, nbytes = hop_cost(sp, r, torch.tensor([], dtype=dtype)
                             .element_size(), fused=True, with_add=not fwd)
    rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
    emit("kernel_check", **rec)
    del x, add
    return rec


def dcrnn_expected(cfg) -> tuple[dict, dict]:
    """One DCRNN train step's launches on fused flat supports: (block
    kernels, projection kernel). Each cell runs two projections (gate,
    candidate) over one kernel-3 pair per support; the backward runs each
    pair's transpose with add, but for the first cell's gate, whose input
    and zero state carry no gradient; the decoder's output projection runs
    once a step. Every projection takes a weight gradient, all but the
    first cell's gate an operands' gradient."""
    cells = cfg.num_rnn_layers * (cfg.seq_len + cfg.horizon)
    pairs = 2 * cells * cfg.n_supports
    blocks = {"mix_flat": 0, "mix_flat2": 2 * pairs - cfg.n_supports,
              "outer_flat": 0, "mix_padded": 0, "outer_padded": 0}
    n = 2 * cells + cfg.horizon
    return blocks, {"chan_proj": n, "chan_proj_dgrad": n - 1,
                    "chan_proj_wgrad": n}


def phase_dcrnn(graph) -> dict:
    """DCRNN's path on the card (``dcrnn-city-40k.train``): kernel 3 at its
    pairs' R (``pair_check``, bf16, both ways) on the 40,960-node RCM
    support, then one call of two graphed bf16 train steps at batch 8 (the
    first eager, the second captured) with the counters zeroed just before
    it: the captured step's block-kernel launches
    (``models.dcrnn.COUNTS``) and the call's block- and projection-kernel
    launches (twice a step's) against :func:`dcrnn_expected`. Returns the
    call's launches as windows ``dcrnn`` and ``proj_dcrnn``."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import DCRNNConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )
    from graph_wavenet_tpu_torch.models import dcrnn
    from graph_wavenet_tpu_torch.ops.block_sparse import Fused2FlatSupport
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj as cp
    from graph_wavenet_tpu_torch.train.engine import DCRNNEngine

    _, src, dst, w = graph
    perm = rcm_order_edges(src, dst, N_CITY)
    sups = [s.astype(torch.bfloat16) for s in
            doubletransition_block_supports(src, dst, w, N_CITY, perm=perm,
                                            form="flat", device="cuda")]
    require(all(isinstance(s, Fused2FlatSupport) for s in sups),
            "the RCM supports at 40,960 nodes must fuse")
    gen = torch.Generator(device="cuda").manual_seed(21)
    for r in DCRNN_R:
        for tables in ("forward", "transpose+add"):
            pair_check(sups[0], r, torch.bfloat16, tables, gen)
    torch.cuda.empty_cache()

    cfg = DCRNNConfig(num_nodes=N_CITY, dtype="bfloat16")
    engine = DCRNNEngine(cfg, TrainConfig(batch_size=DCRNN_BATCH,
                                          learning_rate=1e-5,
                                          weight_decay=0.0),
                         StandardScaler(54.4, 19.5), device="cuda", seed=0)
    samples = 2 * DCRNN_BATCH
    xs = torch.randn(samples, cfg.seq_len, N_CITY, cfg.input_dim,
                     generator=gen, device="cuda")
    ys = 54.4 + 19.5 * torch.randn(samples, cfg.horizon, N_CITY, 2,
                                   generator=gen, device="cuda")
    idx = np.arange(samples, dtype=np.int64).reshape(2, DCRNN_BATCH)
    reset_launches()
    t = time.perf_counter()
    loss = engine.train_steps_resident(xs, ys, idx, sups)["loss"]
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t
    got_blocks, got_proj = kernel_launches(), kernel_launches(cp.OPS)
    per_step = dict(dcrnn.COUNTS["step_launches"])
    want_blocks, want_proj = dcrnn_expected(cfg)
    rec = dict(batch=DCRNN_BATCH, nodes=N_CITY, dtype="bfloat16",
               losses=loss.tolist(), call_s=round(call_s, 3),
               captured_step_launches=per_step,
               expected_step_launches=want_blocks,
               call_launches=got_blocks, call_proj_launches=got_proj,
               expected_step_proj_launches=want_proj,
               peak_gib=round(torch.cuda.max_memory_reserved() / 2 ** 30, 3))
    emit("dcrnn_step", **rec)
    require(bool(torch.isfinite(loss).all()), f"DCRNN's losses: {rec}")
    require(per_step == want_blocks,
            f"a captured DCRNN step launches {per_step}, expected "
            f"{want_blocks}")
    require(got_blocks == {k: 2 * v for k, v in want_blocks.items()},
            f"two DCRNN steps launched {got_blocks}, expected twice "
            f"{want_blocks}")
    require(got_proj == {k: 2 * v for k, v in want_proj.items()},
            f"two DCRNN steps launched projections {got_proj}, expected "
            f"twice {want_proj}")
    del engine, xs, ys, sups, loss
    torch.cuda.empty_cache()
    return {"dcrnn": got_blocks, "proj_dcrnn": got_proj}


def proj_expected(cfg, forwards: int, steps: int = 0) -> dict:
    """The projection kernel's launches in ``forwards`` model forwards of
    which ``steps`` are train steps: a forward projects every layer's taps,
    skip and diffusion and the start and two end convs once; a step's
    backward runs the weight gradient of each but the last layer's
    diffusion (no loss term reads it) and the operands' gradient of those
    but the start conv (its input needs none)."""
    n = 3 * cfg.blocks * cfg.layers + 3
    return {"chan_proj": forwards * n, "chan_proj_dgrad": steps * (n - 2),
            "chan_proj_wgrad": steps * (n - 1)}


def phase_small_e2e(seed: int = 0) -> None:
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.ops import block_sparse as bsp
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
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
    reset_launches()
    card = fcs["cuda"].predict(x)
    torch.cuda.synchronize()
    fused_counts = kernel_launches()
    cpu = fcs["cpu"].predict(x)
    err = float((card.cpu() - cpu).abs().max())
    unfused = Forecaster(cfg, fcs["cuda"].model,
                         [bsp.as_unfused(s) for s in fcs["cuda"].supports],
                         scaler, node_layout=fcs["cuda"].node_layout)
    reset_launches()
    card_unfused = unfused.predict(x)
    torch.cuda.synchronize()
    unfused_counts = kernel_launches()
    bitwise = bool(torch.equal(card, card_unfused))
    ok = bool(torch.allclose(card.cpu(), cpu, rtol=2e-4, atol=2e-4))
    widths = layer_widths(cfg, x.shape[0])
    want = (forward_launches(fcs["cuda"].supports, widths, torch.float32),
            forward_launches(unfused.supports, widths, torch.float32))
    emit("small_e2e", nodes=N_SMALL, dtype="float32", shape=list(card.shape),
         max_abs_err_vs_cpu=err, tolerance="rtol/atol 2e-4",
         unfused_bitwise_equal=bitwise, widths=widths,
         launches_fused=fused_counts, expected_fused=want[0],
         launches_unfused=unfused_counts, expected_unfused=want[1])
    require(ok, f"card vs CPU forecast differ by {err}")
    require(bitwise, "unfused forecast is not bitwise equal to the fused")
    require((fused_counts, unfused_counts) == want,
            f"launch counts {fused_counts}, {unfused_counts} do not match "
            f"the layout and dispatch rule {want}")


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
        reset_launches()
        losses[where] = [float(eng.train_step(xs[i], ys[i],
                                              sups[where])["loss"])
                         for i in range(steps)]
        if where == "card":
            counts = kernel_launches()
    sd = {where: {k: v.float().cpu() for k, v in
                  eng.model.state_dict().items()}
          for where, eng in engines.items()}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"],
                                                  losses["host"]))
    worst = max(((sd["card"][k] - sd["host"][k]).abs()
                 - 1e-4 * sd["host"][k].abs()).max().item()
                for k in sd["host"])
    want = {k: steps * v for k, v in expected_step_launches(
        sups["card"], layer_widths(cfg, batch, 13), torch.float32).items()}
    emit("small_train", form=form, nodes=N_SMALL, dtype="float32",
         steps=steps, batch=batch, losses_card=losses["card"],
         losses_cpu=losses["host"], max_loss_rel_diff=rel,
         tolerance="losses rtol 1e-4; parameters and BN statistics rtol "
         "1e-4 + atol 1e-4", max_param_excess_over_rtol=worst,
         launches_card=counts, expected=want)
    require(rel <= 1e-4, f"card vs CPU losses differ: {losses}")
    require(worst <= 1e-4, f"card vs CPU parameters differ by {worst}")
    require(counts == want, f"{steps} {form} train steps launched {counts}, "
                            f"expected {want}")
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
    require(counts["outer_flat"] > 0 and counts["mix_flat2"] > 0,
            f"launch counts {counts} do not reach kernels 2 and 3")

    # one step from the same state with fused and with unfused supports
    unfused = ([bsp.as_unfused(s) for s in sup[:-1]]
               + [dataclasses.replace(mask, fuse2=None)])
    state = engine.model.state_dict()
    grads = {}
    # deterministic algorithms: a bracket kept from before the mask's sums
    # ran in a fixed order (``ops.adaptive_block``); it changes no result
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
HAND_KERNELS = {"mix_flat": "mix_flat_",
                "outer_flat": "FlatJobs",
                "mix_flat2": "mix_flat2_",
                "mix_padded": "mix_padded_",
                "outer_padded": "PaddedJobs"}


def profile_step(fn) -> dict:
    """Device time by kernel over one call of ``fn``: the busy share of the
    wall time, the device kernels launched, the kernels that take the most
    device time, the device time and launches of each hand kernel, and the
    host's operators by their own CPU time (where a host-bound call
    spends it)."""
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
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if kernels
            else None, "device_kernels": len(kernels),
            "top_kernels": [{"name": k[:90], "ms": t, "launches": n}
                            for k, (t, n) in top],
            "hand_kernels": hand,
            "top_host_ops": [{"name": e.key[:60], "self_cpu_ms":
                              e.self_cpu_time_total / 1e3, "calls": e.count}
                             for e in host]}


def trace_kernels(path: str) -> dict:
    """What a ``--profile`` trace (``train.profiling.trace``'s Chrome
    trace) holds: its size, its device kernel events, and the events of
    each hand kernel (``HAND_KERNELS``) by wrapper."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    hand = {w: sum(part in k for k in kernels)
            for w, part in HAND_KERNELS.items()}
    return {"trace_bytes": os.path.getsize(path), "events": len(events),
            "kernel_events": len(kernels),
            "hand_kernels": {k: v for k, v in hand.items() if v}}


def write_city_data(root: str, n: int, samples: dict = TRAIN_SAMPLES
                    ) -> None:
    """Synthetic ``train/val/test.npz`` in the layout ``data/metr.py``
    reads: x, y of shape (S, 12, N, 2), speeds around 50 with some missing
    (zero) readings and a time-of-day feature, from ``default_rng(0)``;
    ``samples`` per split."""
    import numpy as np

    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    for split, count in samples.items():
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


def layer_widths(cfg, batch: int, t_in: int = 12) -> list[int]:
    """R of each layer's graph convolution: batch x the time steps left
    after its gated convolution x the dilation channels (the model pads the
    input to its receptive field first; a train step's engine pads one
    step, ``t_in`` 13)."""
    t = max(t_in, cfg.receptive_field)
    widths = []
    for d in cfg.dilations():
        t -= d * (cfg.kernel_size - 1)
        widths.append(batch * t * cfg.dilation_channels)
    return widths


# kernel 3's dispatch rules the main paths are timed under, end to end
# (``dispatch_ab``): the library's own ``FUSED2_R`` (None), kernel 3 at
# every R (the rule of the commits before the dispatch seam), and kernel 3
# nowhere (``{}``: kernel 1 + add + kernel 1 for every pair)
E2E_RULES = {"auto": None,
             "fused": dict.fromkeys(
                 [(d, a) for d in ("float32", "bfloat16")
                  for a in (False, True)], (0, None)),
             "chain": {}}


@contextlib.contextmanager
def dispatch_rule(table):
    """Run the block diffusion under another ``FUSED2_R`` (keys by dtype
    name); None keeps the library's."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    saved = dict(bd.FUSED2_R)
    if table is not None:
        bd.FUSED2_R.clear()
        bd.FUSED2_R.update({(getattr(torch, d), a): v
                            for (d, a), v in table.items()})
    try:
        yield
    finally:
        bd.FUSED2_R.clear()
        bd.FUSED2_R.update(saved)


def dispatch_ab(fn, reps: int, rounds: int = 4) -> dict:
    """Wall time of ``fn`` (a predict or a train step; host clock around a
    call that ends in a sync) under each of :data:`E2E_RULES`, in
    ``rounds`` alternating orders, one warm-up call per round and rule.
    Returns per rule the median and minimum over all calls and each
    round's median."""
    import torch

    times = {name: [] for name in E2E_RULES}
    rmed = {name: [] for name in E2E_RULES}
    names = list(E2E_RULES)
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            with dispatch_rule(E2E_RULES[name]):
                fn()
                torch.cuda.synchronize()
                got = []
                for _ in range(reps):
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    got.append((time.perf_counter() - t) * 1e3)
            times[name] += got
            rmed[name].append(sorted(got)[len(got) // 2])
    return {name: {"median_ms": sorted(v)[len(v) // 2], "min_ms": min(v),
                   "round_medians_ms": rmed[name]}
            for name, v in times.items()}


def forward_launches(supports, widths: list[int], dtype) -> dict:
    """Kernel launches of one forward implied by the supports at each
    layer's R (``layer_widths``) and the activation dtype: for a fused flat
    support (or adaptive mask) kernel 3 where the dispatch rule picks the
    fused pass and two kernel-1 launches where it picks the chain, kernel 1
    per hop for an unfused one, kernel 4 per hop for a padded one."""
    from graph_wavenet_tpu_torch.ops.block_sparse import BlockSparseSupport
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    n = dict.fromkeys(bd.OPS, 0)
    for s in supports:
        for r in widths:
            if isinstance(s, BlockSparseSupport):
                n["mix_padded"] += 2
            elif (_fused(s)
                  and bd.fused2_dispatch(r, dtype, add=False) == "fused"):
                n["mix_flat2"] += 1
            else:
                n["mix_flat"] += 2
    return n


def expected_step_launches(supports, widths: list[int], dtype) -> dict:
    """Kernel launches of one train step implied by the supports: the
    forward's, then the backward of every layer but the last (whose
    diffusion output feeds only its own residual and BatchNorm, which no
    loss term reads): for a fused support whose transpose band fuses the
    pair over the transpose tables with ``add`` (kernel 3 or two kernel-1
    launches by the dispatch rule), else two kernel-1 launches, kernel 1
    per hop for an unfused one, kernel 4 per hop over the transpose tables
    for a padded one, and kernel 2 once per hop for the adaptive support
    only, the one whose blocks need a gradient. Kernel 5, the padded blocks'
    cotangent, never runs: fixed blocks need none."""
    from graph_wavenet_tpu_torch.ops.block_sparse import BlockSparseSupport
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    n = forward_launches(supports, widths, dtype)
    for s in supports:
        adaptive = getattr(s, "adaptive_mask", False)
        delay_t = (s.fuse2[2] if adaptive and _fused(s)
                   else getattr(s, "delay_t", 0))
        for r in widths[:-1]:
            if isinstance(s, BlockSparseSupport):
                n["mix_padded"] += 2
                continue
            if (_fused(s) and delay_t > 0
                    and bd.fused2_dispatch(r, dtype, add=True) == "fused"):
                n["mix_flat2"] += 1
            else:
                n["mix_flat"] += 2
            n["outer_flat"] += 2 * adaptive
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
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj as cp

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
    mcfg = engine.model_cfg
    reset_launches()
    engine.train_step(xt, yt, sups)
    torch.cuda.synchronize()
    counts["train" + tag] = kernel_launches()
    counts["proj_train" + tag] = kernel_launches(cp.OPS)
    want = expected_step_launches(
        sups, layer_widths(mcfg, TRAIN_BATCH, 13), torch.bfloat16)
    want_proj = proj_expected(mcfg, 1, 1)
    emit("train_step_launches", form=form, launches=counts["train" + tag],
         expected=want, projection=counts["proj_train" + tag],
         projection_expected=want_proj)
    require(counts["train" + tag] == want,
            f"train-step launches {counts['train' + tag]} do not match "
            f"{want}")
    require(counts["proj_train" + tag] == want_proj,
            f"train-step projection launches {counts['proj_train' + tag]} "
            f"do not match {want_proj}")

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
    emit("dispatch_e2e", path="train_step", form=form, batch=TRAIN_BATCH,
         **dispatch_ab(lambda: engine.train_step(xt, yt, sups), reps=6))
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
        reset_launches()
        answer = np.asarray(post_json(url + "/predict",
                                      {"x": raw.tolist()})["y"])
        torch.cuda.synchronize()
        counts["serve_trained" + tag] = kernel_launches()
        want = forward_launches(run["forecaster"].supports,
                                layer_widths(mcfg, 1), torch.bfloat16)
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


def serve_run(path: str, gpath: str, form: str, cfg):
    """One city checkpoint through the port's serve CLI: 4 concurrent
    requests coalesced into device calls, the launch counters held to the
    layout, predict latency at batch 1 and 8 and a profile at batch 8.
    Returns the requests' launch counts and a batch-1 forecast."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj as cp

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

        reset_launches()
        t1 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        counts = kernel_launches()
        proj = kernel_launches(cp.OPS)
        require(not errors and not any(t.is_alive() for t in threads),
                f"requests failed: {errors}")
        stats = json.loads(urllib.request.urlopen(
            url + "/stats", timeout=60).read())
        calls = stats["device_calls"]
        for a in answers:
            require(a.shape == (12, N_CITY) and np.isfinite(a).all(),
                    f"bad answer shape {a.shape} or non-finite values")
        # each device call runs the batch padded to its power-of-two bucket
        want = dict.fromkeys(bd.OPS, 0)
        for n, count in stats["batch_histogram"].items():
            bucket = batcher._bucket(int(n))
            for k, v in forward_launches(
                    fc.supports, layer_widths(cfg, bucket),
                    torch.bfloat16).items():
                want[k] += count * v
        want_proj = proj_expected(cfg, sum(stats["batch_histogram"].values()))
        emit("serve", form=form, requests=n_req, device_calls=calls,
             batch_histogram=stats["batch_histogram"],
             seconds=round(serve_s, 3), launches=counts, expected=want,
             projection=proj, projection_expected=want_proj)
        require(counts == want,
                f"launch counts {counts} do not match the layout {want}")
        require(proj == want_proj,
                f"projection launches {proj} do not match {want_proj}")

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
            if any(_fused(s) for s in fc.supports):
                emit("dispatch_e2e", path="predict", form=form, batch=b,
                     **dispatch_ab(lambda: fc.predict(xt), reps=10))
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
    return counts, proj, x1, pred


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

    counts = {}
    counts["serve"], counts["proj_serve"], x1, fused_pred = serve_run(
        paths["flat"], gpath, "flat", cfg)
    phase_block_casts(paths["flat"], gpath)
    counts["serve_padded"], counts["proj_serve_padded"], _, padded_pred = (
        serve_run(paths["pallas"], gpath, "pallas", cfg))
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
    reset_launches()
    rect_pred = rect.predict(x1)
    torch.cuda.synchronize()
    counts["rect"] = kernel_launches()
    want = forward_launches(rect.supports, layer_widths(cfg, 1),
                            torch.bfloat16)
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
                rec = dict(kernel="mix_padded", dtype=dname, R=r,
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
                flops, nbytes = padded_cost(spd, r, isz, 2 * slot.numel())
                rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
                # plain and library times at the kernels line's shape only
                # (the fp32 BSR product tunes itself for ~20 s at each new
                # shape)
                if (tl, dname, r) == (True, "bfloat16", 3072):
                    rec["plain_ms"] = cuda_ms(plain, max(2, reps // 5))
                    lib_fn, lib_name, lib_out = library_hop(
                        flat, x.reshape(-1, r), tl)
                    rec["library_max_abs_diff"], _, _ = close_err(
                        lib_out.reshape(got.shape).to(dtype), got)
                    del lib_out
                    rec["library_ms"] = cuda_ms(lib_fn, max(2, reps // 5))
                    rec["library"] = lib_name + " (as_flat_pallas tables)"
                    del lib_fn
                    summary["k4"] = rec
                emit("kernel_check", **rec)
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
            rec = dict(kernel="outer_padded", dtype=dname,
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
            if (dname, r) == ("bfloat16", 1536):
                rec["plain_ms"] = cuda_ms(k5_plain, max(2, reps // 5))
                xs = x.index_select(0, spd.block_idx[live].long())
                gs = g.index_select(0, torch.nonzero(live)[:, 0]).transpose(
                    1, 2)
                rec["library_ms"] = cuda_ms(lambda: torch.bmm(xs, gs),
                                            max(2, reps // 5))
                rec["library"] = ("torch.bmm on the live slots' operands "
                                  "gathered beforehand (gather and sentinel "
                                  "zeros excluded)")
                del xs, gs
                summary["k5"] = rec
            flops, nbytes = padded_cost(spd, r, isz, nb * mb, out_isz=isz)
            rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dname)
            emit("kernel_check", **rec)
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
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    pos, src, dst, w = city_graph(N_SMALL)
    cfg = ModelConfig(num_nodes=N_SMALL, addaptadj=False, dropout=0.0,
                      dtype="float32")
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
        reset_launches()
        preds[where, form] = fc.predict(x)
        torch.cuda.synchronize()
        counts[where, form] = kernel_launches()
    card, cpu = preds["card", "pallas"], preds["host", "pallas"]
    err = float((card.cpu() - cpu).abs().max())
    bitwise = bool(torch.equal(card, preds["card", "flat"]))
    want = forward_launches(sups["card", "pallas"],
                            layer_widths(cfg, x.shape[0]), torch.float32)
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

    small_train_run("pallas", seed)

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
        reset_launches()
        grads[where], = torch.autograd.grad(out, blocks,
                                            torch.as_tensor(cot, device=dev))
        torch.cuda.synchronize()
        if where == "card":
            k5 = kernel_launches()["outer_padded"]
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
        reset_launches()
        t0 = time.perf_counter()
        gcn_apply(weight, bias, x, grad_sups, 2).backward(cot)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = kernel_launches()
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
    want = dict.fromkeys(bd.OPS, 0)
    want.update(mix_padded=8, outer_padded=4)
    emit("kernel5_path", nodes=N_CITY, batch=TRAIN_BATCH, dtype="bfloat16",
         R=TRAIN_BATCH * t * c, launches=counts, expected=want,
         max_abs_err=errs, sentinel_slots_zero=zero, wall_ms=wall_ms)
    require(counts == want, f"kernel-5 path launched {counts}, not {want}")
    require(zero, "the sentinel slots' gradient is not zero")
    del calls, leaves, grad_sups, x, cot
    torch.cuda.empty_cache()
    return {"kernel5_path": counts}


def block_casts(fn, supports) -> dict:
    """Casts of the supports' blocks in one call of ``fn``: the profiler's
    ``aten::_to_copy`` ops on a tensor of a support's block shape, their
    count and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    shapes = [list(s.blocks_flat.shape) for s in supports
              if hasattr(s, "blocks_flat")]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    n, ms = 0, 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if (e.key == "aten::_to_copy" and e.input_shapes
                and list(e.input_shapes[0]) in shapes):
            n += e.count
            ms += getattr(e, "device_time_total",
                          getattr(e, "cuda_time_total", 0.0)) / 1e3
    return {"casts": n, "cast_ms": ms}


def phase_block_casts(path: str, gpath: str) -> None:
    """The served supports' dtype at full width: a bf16 city checkpoint
    whose layout records no support dtype serves bf16 blocks, so a batch-8
    predict casts no block; the same forecaster with its fixed supports
    stored in fp32 (what the rebuild gave before) casts them once per order-2
    pair. Counts, cast time and predict latency of both, in turns."""
    import dataclasses

    import torch

    from graph_wavenet_tpu_torch.train.serving import Forecaster

    after = Forecaster.from_city_checkpoint(path, gpath, device="cuda")
    require(all(s.blocks_flat.dtype == torch.bfloat16
                for s in after.supports),
            "a bf16 checkpoint without a recorded support dtype must serve "
            "bf16 blocks")
    before = dataclasses.replace(after, supports=[
        s.astype(torch.float32) for s in after.supports])
    x = torch.randn(8, 12, N_CITY, 2, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(12))
    rec = {}
    for name, fc in (("fp32_blocks", before), ("bf16_blocks", after)):
        fc.predict(x)
        rec[name] = block_casts(lambda: fc.predict(x), fc.supports)
    times = {"fp32_blocks": [], "bf16_blocks": []}
    for name in ("fp32_blocks", "bf16_blocks", "bf16_blocks",
                 "fp32_blocks") * 3:
        fc = before if name == "fp32_blocks" else after
        t0 = time.perf_counter()
        fc.predict(x)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
    for name, ts in times.items():
        rec[name]["predict_median_ms"] = sorted(ts)[len(ts) // 2]
    same = bool(torch.equal(before.predict(x), after.predict(x)))
    emit("predict_block_casts", batch=8, nodes=N_CITY, **rec,
         forecasts_bitwise_equal=same)
    require(rec["bf16_blocks"]["casts"] == 0 and rec["fp32_blocks"]["casts"]
            > 0, f"block casts: {rec}")
    require(same, "bf16 and fp32 stored blocks must give the same forecast "
                  "under a bf16 model (every hop casts them to bf16)")
    del before, after
    torch.cuda.empty_cache()


def phase_aptonly(tmp: str) -> dict:
    """City ``aptonly`` on the card at 2,048 nodes: the training CLI trains
    the adaptive adjacency alone (bf16, batch 4, one epoch), the serve CLI
    serves it (the mask alone, read off the checkpoint's ``n_supports``) to
    one request; the step's and the request's launches are held to the
    mask's layout. Returns the launch counts."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve, train
    from graph_wavenet_tpu_torch.graphs import city

    pos, src, dst, w = city_graph(N_SMALL)
    gpath = os.path.join(tmp, "aptonly_graph.npz")
    data_dir = os.path.join(tmp, "aptonly_data")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_SMALL)
    write_city_data(data_dir, N_SMALL)
    t0 = time.perf_counter()
    prof_dir = os.path.join(tmp, "aptonly_profile")
    out = train.main(["--graph_npz", gpath, "--data", data_dir, "--gcn_bool",
                      "--addaptadj", "--aptonly", "--dtype", "bfloat16",
                      "--batch_size", str(TRAIN_BATCH), "--seq_length", "12",
                      "--epochs", "1", "--save",
                      os.path.join(tmp, "aptonly_ckpt"), "--device", "cuda",
                      "--profile", prof_dir])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    result, engine, sups = (out["result"], out["runner"].engine,
                            out["supports"])
    require(len(sups) == 1 and getattr(sups[0], "adaptive_mask", False)
            and engine.model_cfg.n_supports == 0,
            "aptonly trains the adaptive adjacency alone")
    require(np.isfinite(result.test_metrics["mae"]), "non-finite metrics")
    ONE_PROCESS_TEST_MAE["city_aptonly_tp2"] = float(
        result.test_metrics["mae"])
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.normal(size=(TRAIN_BATCH, 12, N_SMALL, 2)
                                   ).astype(np.float32), device="cuda")
    y = torch.as_tensor(rng.normal(50.0, 10.0, size=(
        TRAIN_BATCH, 12, N_SMALL, 2)).astype(np.float32), device="cuda")
    counts = {}
    reset_launches()
    engine.train_step(x, y, sups)
    torch.cuda.synchronize()
    counts["aptonly_train"] = kernel_launches()
    want_train = expected_step_launches(
        sups, layer_widths(engine.model_cfg, TRAIN_BATCH, 13),
        torch.bfloat16)
    del engine, out
    run = serve.main(["--checkpoint", result.best_checkpoint, "--graph_npz",
                      gpath, "--device", "cuda", "--port", "0"],
                     serve_forever=False)
    server, batcher, fc = run["server"], run["batcher"], run["forecaster"]
    try:
        raw = rng.normal(50.0, 10.0, size=(12, N_SMALL, 2)).astype(
            np.float32)
        reset_launches()
        answer = np.asarray(post_json(
            f"http://127.0.0.1:{server.server_port}/predict",
            {"x": raw.tolist()})["y"])
        torch.cuda.synchronize()
        counts["aptonly_serve"] = kernel_launches()
        want_serve = forward_launches(fc.supports,
                                      layer_widths(fc.cfg, 1),
                                      torch.bfloat16)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    traced = trace_kernels(os.path.join(prof_dir, "trace.json"))
    emit("aptonly", nodes=N_SMALL, seconds=round(time.perf_counter() - t0, 3),
         test=result.test_metrics, served_supports=len(fc.supports),
         train_launches=counts["aptonly_train"], train_expected=want_train,
         serve_launches=counts["aptonly_serve"], serve_expected=want_serve,
         profiled_cli_seconds=round(cli_s, 3), profile=traced)
    launched = [k for k, v in want_train.items() if v]
    require(launched and all(traced["hand_kernels"].get(k, 0) > 0
                             for k in launched),
            f"the --profile trace names {traced['hand_kernels']}, the step "
            f"launches {launched}")
    require(answer.shape == (12, N_SMALL) and np.isfinite(answer).all(),
            f"bad aptonly forecast {answer.shape}")
    require(len(fc.supports) == 1, "aptonly serves the mask alone")
    require(counts["aptonly_train"] == want_train
            and counts["aptonly_serve"] == want_serve,
            "aptonly launches do not match the mask's layout")
    del run, fc
    torch.cuda.empty_cache()
    return counts


# the dense METR model at the width of ``bench.py:53-59``
DENSE_NODES, DENSE_BATCH = 207, 64


def dense_inputs(seed: int = 0):
    """``bench.py``'s inputs: two random row-normalized supports, x
    standard normal, y around 50, from ``default_rng(seed)``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.random((2, DENSE_NODES, DENSE_NODES)).astype(np.float32)
    sups = [s / s.sum(-1, keepdims=True) for s in a]
    x = rng.normal(size=(DENSE_BATCH, 12, DENSE_NODES, 2)).astype(np.float32)
    y = (rng.normal(size=(DENSE_BATCH, 12, DENSE_NODES, 2)) + 50.0).astype(
        np.float32)
    return sups, x, y


def phase_dense(seed: int = 0) -> dict:
    """The dense METR model at full width (207 nodes, residual/dilation
    32, skip 256, end 512, 4 x 2 layers, two supports, the SVD-initialized
    adaptive adjacency, batch 64, 12 steps): the card's fp32 forecast
    against the CPU's (2e-4), the card's bf16 forecast against its fp32
    (within 5e-2 of the fp32 forecast's largest magnitude), 12 bf16 train
    steps with finite losses, timed (median of 10 after 2), the step time
    of each ``gcn_mode``, and one profiled step. No block kernel runs on
    this path (its launch counts must stay 0); the projection kernel's
    launches in two steps are the model's. Returns both counts."""
    import dataclasses

    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj as cp
    from graph_wavenet_tpu_torch.train.engine import Engine

    sups_np, x_np, y_np = dense_inputs(seed)
    cfg = ModelConfig(num_nodes=DENSE_NODES, in_dim=2, out_dim=12,
                      residual_channels=32, dilation_channels=32,
                      skip_channels=256, end_channels=512, blocks=4,
                      layers=2, gcn_bool=True, addaptadj=True, n_supports=2,
                      dtype="bfloat16")
    f32 = dataclasses.replace(cfg, dtype="float32")
    preds = {}
    for name, c, dev in (("card_fp32", f32, "cuda"), ("cpu_fp32", f32, "cpu"),
                         ("card_bf16", cfg, "cuda")):
        model = GWNet(c, device=dev, seed=seed, aptinit=sups_np[0])
        sups = [torch.as_tensor(s, device=dev) for s in sups_np]
        with torch.inference_mode():
            preds[name] = model(torch.as_tensor(x_np, device=dev),
                                sups).float().cpu()
    scale = float(preds["card_fp32"].abs().max())
    err32 = float((preds["card_fp32"] - preds["cpu_fp32"]).abs().max())
    err16 = float((preds["card_bf16"] - preds["card_fp32"]).abs().max())
    ok32 = bool(torch.allclose(preds["card_fp32"], preds["cpu_fp32"],
                               rtol=2e-4, atol=2e-4))
    emit("dense_forecast", nodes=DENSE_NODES, batch=DENSE_BATCH,
         shape=list(preds["card_fp32"].shape), gcn_mode_bf16=
         cfg.resolved_gcn_mode, gcn_mode_fp32=f32.resolved_gcn_mode,
         max_abs_err_fp32_card_vs_cpu=err32, tolerance_fp32="rtol/atol 2e-4",
         max_abs_diff_bf16_vs_fp32=err16, fp32_max_abs=scale,
         tolerance_bf16="5e-2 x max|fp32 forecast|")
    require(ok32, f"dense fp32 card vs CPU forecast differ by {err32}")
    require(err16 <= 5e-2 * scale and bool(torch.isfinite(
        preds["card_bf16"]).all()),
            f"dense bf16 forecast differs from fp32 by {err16} (scale "
            f"{scale})")

    xt = torch.as_tensor(x_np, device="cuda")
    yt = torch.as_tensor(y_np, device="cuda")
    sups = [torch.as_tensor(s, device="cuda") for s in sups_np]
    scaler = StandardScaler(54.0, 20.0)
    steps = {}
    counts = {}
    for mode in ("auto", "fused", "stacked", "concat"):
        mcfg = dataclasses.replace(cfg, gcn_mode=mode)
        engine = Engine(mcfg, TrainConfig(), scaler, device="cuda",
                        seed=seed, aptinit=sups_np[0])
        n_timed = 10 if mode == "auto" else 5
        reset_launches()
        losses = [float(engine.train_step(xt, yt, sups)["loss"])
                  for _ in range(2)]
        torch.cuda.synchronize()
        if mode == "auto":
            counts["dense_train"] = kernel_launches()
            counts["proj_dense_train"] = kernel_launches(cp.OPS)
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            m = engine.train_step(xt, yt, sups)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        med = sorted(times)[len(times) // 2]
        steps[mode] = med
        require(all(np.isfinite(losses)), f"non-finite dense losses {losses}")
        emit("dense_train_step", gcn_mode=mode,
             resolved=mcfg.resolved_gcn_mode, batch=DENSE_BATCH,
             nodes=DENSE_NODES, dtype="bfloat16", steps=len(losses),
             losses=losses, median_ms=med, min_ms=min(times),
             max_ms=max(times),
             node_timesteps_per_s=DENSE_BATCH * 12 * DENSE_NODES
             / (med / 1e3),
             max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
        if mode == "auto":
            emit("dense_train_step_profile", gcn_mode=mcfg.resolved_gcn_mode,
                 **profile_step(lambda: engine.train_step(xt, yt, sups)))
        del engine
    want_proj = proj_expected(cfg, 2, 2)
    emit("dense_gcn_modes", step_median_ms=steps,
         launches=counts["dense_train"],
         projection=counts["proj_dense_train"],
         projection_expected=want_proj)
    require(not any(counts["dense_train"].values()),
            f"the dense path launched a block kernel: {counts}")
    require(counts["proj_dense_train"] == want_proj,
            f"dense projection launches {counts['proj_dense_train']} do not "
            f"match {want_proj}")
    torch.cuda.empty_cache()
    return counts


def write_adj_pickle(path: str, n: int, seed: int = 0) -> None:
    """A DCRNN-format ``(sensor_ids, id_to_ind, adj_mx)`` pickle of a
    random weighted graph with self loops."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    adj = ((rng.random((n, n)) < 0.05) * rng.random((n, n))).astype(
        np.float32)
    np.fill_diagonal(adj, 1.0)
    with open(path, "wb") as f:
        pickle.dump(([str(i) for i in range(n)],
                     {str(i): i for i in range(n)}, adj), f)


def phase_metr_cli(tmp: str) -> dict:
    """The METR path through its CLIs: the port's ETL writes a synthetic
    207-node dataset (2,016 five-minute readings, a week) and an adjacency
    pickle, ``gwt-torch-train`` trains the bf16 model with the adaptive
    adjacency for one epoch, and the test CLI evaluates its checkpoint (no
    plot) to the training run's own test metrics. Returns the launch
    counts (none: the dense path runs no block kernel)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import test as test_cli
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.data.traffic_etl import (
        generate_train_val_test,
    )

    rng = np.random.default_rng(14)
    t_steps = 2016
    values = (rng.normal(size=(t_steps, DENSE_NODES)) * 10 + 55).astype(
        np.float32)
    values[rng.random(values.shape) < 0.05] = 0.0
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(t_steps) * np.timedelta64(5, "m"))
    data_dir = os.path.join(tmp, "METR")
    adj = os.path.join(tmp, "adj_mx.pkl")
    t0 = time.perf_counter()
    shapes = generate_train_val_test(values, data_dir, index=index)
    write_adj_pickle(adj, DENSE_NODES)
    etl_s = time.perf_counter() - t0
    reset_launches()
    t1 = time.perf_counter()
    out = train.main(["--data", data_dir, "--adjdata", adj, "--num_nodes",
                      str(DENSE_NODES), "--gcn_bool", "--addaptadj",
                      "--dtype", "bfloat16", "--seq_length", "12",
                      "--batch_size", str(DENSE_BATCH), "--epochs", "1",
                      "--print_every", "10", "--save",
                      os.path.join(tmp, "metr_ckpt"), "--device", "cuda"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    result = out["result"]
    t2 = time.perf_counter()
    ev = test_cli.main(["--checkpoint", result.best_checkpoint, "--data",
                        data_dir, "--adjdata", adj, "--batch_size",
                        str(DENSE_BATCH), "--plotheatmap", "False",
                        "--csv_out", os.path.join(tmp, "wave.csv"),
                        "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {"metr_cli": kernel_launches()}
    hist = result.history[0]
    emit("metr_cli", nodes=DENSE_NODES, splits={k: list(v) for k, v in
                                                shapes.items()},
         etl_seconds=round(etl_s, 3), train_seconds=round(train_s, 3),
         train_epoch_seconds=round(hist.train_time, 3),
         steps=out["runner"].engine.step, train=hist.train,
         valid=hist.valid, test_train_cli=result.test_metrics,
         test_cli=ev["test_metrics"],
         test_cli_seconds=round(time.perf_counter() - t2, 3),
         launches=counts["metr_cli"])
    finite = all(np.isfinite(v) for v in (
        *hist.train.values(), *hist.valid.values(),
        *ev["test_metrics"].values()))
    require(finite and len(ev["per_horizon"]) == 12,
            "non-finite METR CLI metrics")
    require(abs(ev["test_metrics"]["mae"] - result.test_metrics["mae"])
            <= 1e-4 * abs(result.test_metrics["mae"]),
            "the test CLI does not reproduce the training run's test MAE")
    require(not any(counts["metr_cli"].values()),
            f"the METR path launched a block kernel: {counts}")
    del out
    torch.cuda.empty_cache()
    metr_cli_flags(tmp, data_dir, adj)
    return counts


def phase_data_feed(tmp: str) -> None:
    """The host feed on the METR phase's data (``phase_metr_cli``): the
    native window loader built and loaded (``native_available``), its
    window gather (a batch of 64 x and y windows of the 207-node series),
    its batch gather and its feature-0 scaling (the whole ``x_train``) bit
    for bit numpy's, each timed against numpy on the host; then
    ``Runner.fit`` (one epoch, bf16, dropout 0.3) and ``Runner.test`` of
    the host-resident dataset with ``TrainConfig(prefetch=2)`` bit for bit
    the same run with ``prefetch=0``: history, test metrics and weights."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data import metr
    from graph_wavenet_tpu_torch.data import native_loader as nl
    from graph_wavenet_tpu_torch.data.traffic_etl import build_features
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    built = nl.native_available()
    require(built, "the native window loader did not build (g++) or load")
    rng = np.random.default_rng(14)
    values = (rng.normal(size=(2016, DENSE_NODES)) * 10 + 55).astype(
        np.float32)
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(2016) * np.timedelta64(5, "m"))
    series = build_features(values, index, True, False).astype(np.float32)
    anchors = rng.integers(0, series.shape[0] - 24, size=DENSE_BATCH)
    with np.load(os.path.join(tmp, "METR", "train.npz")) as f:
        x_train = f["x"].astype(np.float32)
    idx = rng.integers(0, x_train.shape[0], size=DENSE_BATCH)

    def native_scale():
        a = x_train.copy()
        nl.standardize_feature0(a, 55.0, 10.0)
        return a

    def numpy_scale():
        a = x_train.copy()
        a[..., 0] = (a[..., 0] - np.float32(55.0)) / np.float32(10.0)
        return a

    cases = {
        "x_windows": (lambda: nl.gather_windows(series, anchors, 12),
                      lambda: series[anchors[:, None] + np.arange(12)]),
        "y_windows": (lambda: nl.gather_windows(series, anchors + 12, 12),
                      lambda: series[anchors[:, None] + 12
                                     + np.arange(12)]),
        "batch": (lambda: nl.gather_batch(x_train, idx),
                  lambda: x_train[idx]),
        "feature0_scaling": (native_scale, numpy_scale)}
    readings = {}
    for name, (native, plain) in cases.items():
        t = time.perf_counter()
        got = native()
        native_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = plain()
        readings[name] = {"shape": list(got.shape),
                          "bitwise_equal": bool(np.array_equal(got, want)),
                          "native_ms": native_ms,
                          "numpy_ms": (time.perf_counter() - t) * 1e3}
    emit("native_loader", library=str(nl._lib_path().name), **readings,
         timing_note="host clock, one call each")
    require(all(r["bitwise_equal"] for r in readings.values()),
            f"the native loader differs from numpy: {readings}")

    sups = [torch.as_tensor(a, device="cuda") for a in dense_inputs()[0]]
    cfg = ModelConfig(num_nodes=DENSE_NODES, dtype="bfloat16", dropout=0.3)
    runs = {}
    for prefetch in (0, 2):
        data = metr.load_dataset(os.path.join(tmp, "METR"), DENSE_BATCH,
                                 resident="host", device="cuda")
        tcfg = TrainConfig(epochs=1, batch_size=DENSE_BATCH,
                           print_every=1000, prefetch=prefetch,
                           save_dir=os.path.join(tmp, f"feed_{prefetch}"))
        eng = Engine(cfg, tcfg, data["scaler"], device="cuda", seed=0)
        runner = Runner(eng, tcfg, log_fn=lambda *a: None)
        with deterministic(True):
            t = time.perf_counter()
            res = runner.fit(data, sups)
            res = runner.test(data, sups, res)
            torch.cuda.synchronize()
        runs[prefetch] = (res, state_vector(eng), time.perf_counter() - t)
        del eng, runner
    (r0, s0, t0), (r2, s2, t2) = runs[0], runs[2]
    same = ([(h.train, h.valid) for h in r0.history]
            == [(h.train, h.valid) for h in r2.history]
            and r0.test_metrics == r2.test_metrics
            and all(np.array_equal(s0[k], s2[k]) for k in s0))
    emit("prefetch", nodes=DENSE_NODES, batch=DENSE_BATCH, epochs=1,
         steps=data["train_loader"].num_batch,
         train_loss=[r0.history[0].train["loss"],
                     r2.history[0].train["loss"]],
         test_mae=[r0.test_metrics["mae"], r2.test_metrics["mae"]],
         bitwise_equal=same,
         fit_and_test_seconds={"prefetch_0": round(t0, 3),
                               "prefetch_2": round(t2, 3)})
    require(same, "Runner with prefetch=2 differs from prefetch=0")
    torch.cuda.empty_cache()


def metr_cli_flags(tmp: str, data_dir: str, adj: str) -> None:
    """The runner's flags through ``gwt-torch-train`` on the METR data:
    ``--resident device --scan_steps 8`` (two fused calls and six
    remainder steps per 22-step epoch), ``--resume`` of its epoch-1
    checkpoint for epoch 2, ``--early_stop 1`` on a copy of the data whose
    validation targets are all missing (its masked loss is 0 every epoch
    and cannot improve), and ``--grad_accum 2``; each run's history and
    step count as its flag promises."""
    import glob

    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import train

    flat = os.path.join(tmp, "METR_flat_val")
    os.makedirs(flat, exist_ok=True)
    for split in ("train", "val", "test"):
        with np.load(os.path.join(data_dir, split + ".npz")) as f:
            arrays = {k: f[k] for k in f.files}
        if split == "val":
            arrays["y"][..., 0] = 0.0
        np.savez(os.path.join(flat, split + ".npz"), **arrays)
    base = ["--adjdata", adj, "--num_nodes", str(DENSE_NODES), "--gcn_bool",
            "--addaptadj", "--dtype", "bfloat16", "--seq_length", "12",
            "--batch_size", str(DENSE_BATCH), "--print_every", "100",
            "--device", "cuda"]
    runs = {}

    def run(name, *argv, data=data_dir):
        t0 = time.perf_counter()
        out = train.main(["--data", data, *base, *argv])
        torch.cuda.synchronize()
        res = out["result"]
        runs[name] = {"seconds": round(time.perf_counter() - t0, 3),
                      "epochs": [h.epoch for h in res.history],
                      "steps": out["runner"].engine.step,
                      "valid_loss": [h.valid["loss"] for h in res.history],
                      "train_epoch_seconds": [round(h.train_time, 3)
                                              for h in res.history],
                      "test_mae": res.test_metrics["mae"]}
        return out

    save = os.path.join(tmp, "metr_flags")
    run("scan_steps", "--resident", "device", "--scan_steps", "8",
        "--epochs", "1", "--save", save)
    per_epoch = runs["scan_steps"]["steps"]
    (ck,) = glob.glob(os.path.join(save, "*_epoch_1_*.pt"))
    run("resume", "--resume", ck, "--epochs", "2", "--save", save)
    run("early_stop", "--early_stop", "1", "--epochs", "3", "--save",
        os.path.join(tmp, "metr_stop"), data=flat)
    run("grad_accum", "--grad_accum", "2", "--epochs", "1", "--save",
        os.path.join(tmp, "metr_accum"))
    emit("metr_cli_flags", runs=runs, steps_per_epoch=per_epoch)
    require(per_epoch == 22 and runs["scan_steps"]["epochs"] == [1],
            f"--scan_steps 8 ran {runs['scan_steps']}")
    require(runs["resume"]["epochs"] == [2]
            and runs["resume"]["steps"] == 2 * per_epoch,
            f"--resume did not continue at epoch 2: {runs['resume']}")
    require(runs["early_stop"]["epochs"] == [1, 2]
            and runs["early_stop"]["valid_loss"] == [0.0, 0.0],
            f"--early_stop 1 did not stop at epoch 2: {runs['early_stop']}")
    require(runs["grad_accum"]["steps"] == per_epoch,
            f"--grad_accum 2 ran {runs['grad_accum']}")
    require(all(np.isfinite(r["test_mae"]) for r in runs.values()),
            f"non-finite test MAE: {runs}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# device-resident training: the fused steps as CUDA graphs
# ---------------------------------------------------------------------------

# steps per fused call: the METR CLI's epoch on phase_metr_cli's data (1,395
# training samples, batch 64) for the dense model; 4 for the city model
RESIDENT_S_DENSE = 22
RESIDENT_S_CITY = 4


def step_state(engine) -> dict:
    """Everything a train step changes: the module's state (BatchNorm
    buffers included), Adam's moments and step counts, the dropout
    generator."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in engine.model.state_dict().items()}
    for i, st in engine.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    out["generator"] = engine.generator.get_state()
    return out


def first_difference(got: dict, want: dict):
    """(name, max |diff|) of the first entry that is not bit for bit equal,
    or None."""
    import torch

    for k in want:
        if not torch.equal(got[k], want[k]):
            return k, float((got[k].double() - want[k].double()).abs().max())
    return None


def metric_rows(m: dict):
    import torch

    return torch.stack([m[k].reshape(-1) for k in ("loss", "mape", "rmse")])


def graphed_window_launches(owner, raw: dict) -> dict:
    """Hand-kernel launches of a window in which the step graphs of
    ``owner`` (an engine or a forecaster) were captured: the wrappers'
    counts ``raw`` (Python calls: each capture counts a step once, and
    launches nothing) plus each replay's launches beyond that one."""
    out = dict(raw)
    for g in owner.step_graphs():
        for k, n in g.launches.items():
            out[k] += n * (g.replays - 1)
    return out


def graphed_vs_eager(eager, graphed, xs, ys, idx, sups) -> tuple:
    """``len(idx)`` fused calls on ``graphed`` against as many eager steps
    per call on ``eager``, the batches gathered from the resident arrays
    by the rows of ``idx`` (C, S, B). Returns (the first differing state
    entry or None, the largest metric difference, the hand-kernel launches
    of both windows, the graph's per-replay launches)."""
    import torch

    reset_launches()
    got = [metric_rows(graphed.train_steps_resident(xs, ys, sel, sups))
           for sel in idx]
    torch.cuda.synchronize()
    n_graphed = graphed_window_launches(graphed, kernel_launches())
    reset_launches()
    want = []
    for sel in torch.as_tensor(idx, device="cuda"):
        ms = [eager.train_step(xs.index_select(0, r), ys.index_select(0, r),
                               sups) for r in sel]
        want.append(torch.cat([metric_rows(m) for m in ms], 1))
    torch.cuda.synchronize()
    n_eager = kernel_launches()
    # 0.0 exactly when bit for bit equal (a NaN compares as a difference)
    m_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    diff = first_difference(step_state(graphed), step_state(eager))
    (g,) = graphed.step_graphs()
    return diff, m_err, n_graphed, n_eager, dict(g.launches)


def timed_steps(fn, reps: int, steps_per_call: int = 1) -> dict:
    """Median, min and max ms per step of ``reps`` calls of ``fn`` (each
    ``steps_per_call`` steps, host clock around a call that ends in a
    sync), after one warm-up call, with the peak memory allocated and
    reserved. A replayed graph allocates nothing, so only the reserved
    peak holds its private pool (the step's activations)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / steps_per_call)
    return {"median_ms": sorted(times)[len(times) // 2], "min_ms": min(times),
            "max_ms": max(times),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "max_memory_reserved_bytes": torch.cuda.max_memory_reserved()}


def resident_dense(seed: int = 0) -> None:
    """The dense METR model at ``bench.py``'s width (207 nodes, flagship
    widths, two random row-normalized supports, the SVD-initialized
    adaptive adjacency, batch 64, bf16, dropout 0.3) on device-resident
    sample arrays: two fused calls of S = 22 steps (the first warms up,
    captures and replays; the second only replays) bit for bit against 44
    eager steps from the same start (metrics, weights, BatchNorm buffers,
    Adam, the dropout generator); then the step time, node-timesteps/s,
    profiled device idle share and peak memory of host-resident eager
    steps (numpy batches copied per step, the path before this phase),
    device-resident eager steps and graphed steps."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    sups_np, _, _ = dense_inputs(seed)
    rng = np.random.default_rng(seed + 1)
    n_samples, s, b = 4 * DENSE_BATCH, RESIDENT_S_DENSE, DENSE_BATCH
    xs_np = rng.normal(size=(n_samples, 12, DENSE_NODES, 2)).astype(
        np.float32)
    ys_np = (rng.normal(size=(n_samples, 12, DENSE_NODES, 2)) * 10
             + 55).astype(np.float32)
    ys_np[rng.random(ys_np.shape) < 0.05] = 0.0
    xs, ys = (torch.as_tensor(a, device="cuda") for a in (xs_np, ys_np))
    sups = [torch.as_tensor(a, device="cuda") for a in sups_np]
    idx = rng.integers(0, n_samples, size=(2, s, b)).astype(np.int32)
    cfg = ModelConfig(num_nodes=DENSE_NODES, in_dim=2, out_dim=12,
                      residual_channels=32, dilation_channels=32,
                      skip_channels=256, end_channels=512, blocks=4,
                      layers=2, gcn_bool=True, addaptadj=True, n_supports=2,
                      dropout=0.3, dtype="bfloat16")

    def engine():
        return Engine(cfg, TrainConfig(), StandardScaler(55.0, 10.0),
                      device="cuda", seed=seed, aptinit=sups_np[0])

    eager, graphed = engine(), engine()
    diff, m_err, _, _, per_replay = graphed_vs_eager(eager, graphed, xs, ys,
                                                     idx, sups)
    emit("resident_dense_bitwise", nodes=DENSE_NODES, batch=b,
         dtype="bfloat16", dropout=cfg.dropout, scan_steps=s, calls=2,
         replays=graphed.step_graphs()[0].replays,
         max_abs_metric_diff=m_err, first_state_difference=diff,
         per_replay_launches=per_replay, tolerance="bit for bit")
    require(diff is None and m_err == 0.0,
            f"graphed dense steps differ from eager ones: state {diff}, "
            f"metrics by {m_err}")

    host_batches = [(xs_np[r], ys_np[r]) for r in idx[0]]
    dev_rows = torch.as_tensor(idx[0], device="cuda")
    it = {"host": 0, "device": 0}

    def host_step():
        x, y = host_batches[it["host"] % s]
        it["host"] += 1
        return eager.train_step(x, y, sups)

    def device_step():
        r = dev_rows[it["device"] % s]
        it["device"] += 1
        return eager.train_step(xs.index_select(0, r), ys.index_select(0, r),
                                sups)

    def graphed_call():
        return graphed.train_steps_resident(xs, ys, idx[1], sups)

    node_steps = b * 12 * DENSE_NODES
    for mode, fn, reps, per in (("host_eager", host_step, 12, 1),
                                ("device_eager", device_step, 12, 1),
                                ("graphed", graphed_call, 3, s)):
        t = timed_steps(fn, reps, per)
        prof = profile_step(fn)
        emit("resident_dense_step", mode=mode, scan_steps=per, batch=b,
             nodes=DENSE_NODES, dtype="bfloat16", **t,
             node_timesteps_per_s=node_steps / (t["median_ms"] / 1e3),
             profiled_steps=per, profiled_wall_ms_per_step=prof["wall_ms"]
             / per, device_busy_ms_per_step=prof["device_busy_ms"] / per,
             device_idle_share=prof["device_idle_share"],
             device_kernels_per_step=prof["device_kernels"] / per,
             top_host_ops=prof["top_host_ops"][:5])
    del eager, graphed, xs, ys
    torch.cuda.empty_cache()


def resident_city(graph, form: str) -> dict:
    """The 40,960-node city model with the block-masked adaptive adjacency
    (bf16, batch 4, the training CLI's supports and widths) over ``form``
    supports on device-resident sample arrays: a fused call of S = 4 steps
    (warm-up, capture, three replays) bit for bit against four eager steps,
    under deterministic algorithms; the graph's per-replay hand-kernel
    launches held to the layout; then, in the default mode, eager and
    graphed step times and profiled idle shares. Returns the launch
    counts of the graphed window, replays counted (``train_graphed`` or
    ``train_graphed_padded``)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.train.engine import Engine

    tag = "" if form == "flat" else "_padded"
    pos, src, dst, w = graph
    sup, mask, layout = build_city_supports(src, dst, w, N_CITY, pos=pos,
                                            form=form, addaptadj=True,
                                            device="cuda")
    sups = [sp.astype(torch.bfloat16) for sp in sup] + [mask]
    n = layout["n_pad"]
    cfg = ModelConfig(num_nodes=n, addaptadj=True, dtype="bfloat16")
    rng = np.random.default_rng(8)
    n_samples, s, b = 8, RESIDENT_S_CITY, TRAIN_BATCH
    xs = torch.as_tensor(rng.normal(size=(n_samples, 12, n, 2)).astype(
        np.float32), device="cuda")
    ys_np = rng.normal(50.0, 10.0, size=(n_samples, 12, n, 2)).astype(
        np.float32)
    ys_np[rng.random(ys_np.shape) < 0.05] = 0.0
    ys = torch.as_tensor(ys_np, device="cuda")
    idx = rng.integers(0, n_samples, size=(1, s, b)).astype(np.int32)

    def engine():
        return Engine(cfg, TrainConfig(), StandardScaler(50.0, 10.0),
                      device="cuda", seed=0)

    with deterministic(True):
        eager, graphed = engine(), engine()
        diff, m_err, n_graphed, n_eager, per_replay = graphed_vs_eager(
            eager, graphed, xs, ys, idx, sups)
    want = expected_step_launches(sups, layer_widths(cfg, b, 13),
                                  torch.bfloat16)
    emit("resident_city_bitwise", form=form, nodes=N_CITY, batch=b,
         dtype="bfloat16", dropout=cfg.dropout, scan_steps=s,
         deterministic=True, max_abs_metric_diff=m_err,
         first_state_difference=diff, per_replay_launches=per_replay,
         expected_per_step=want, graphed_window_launches=n_graphed,
         eager_window_launches=n_eager, tolerance="bit for bit")
    require(diff is None and m_err == 0.0,
            f"graphed {form} city steps differ from eager ones: state "
            f"{diff}, metrics by {m_err}")
    require(per_replay == want,
            f"a replayed {form} step launches {per_replay}, expected {want}")
    require(n_graphed == n_eager,
            f"graphed window launches {n_graphed} != eager {n_eager}")
    del eager, graphed
    torch.cuda.empty_cache()

    eager, graphed = engine(), engine()
    rows = torch.as_tensor(idx[0], device="cuda")
    it = {"k": 0}

    def eager_step():
        r = rows[it["k"] % s]
        it["k"] += 1
        return eager.train_step(xs.index_select(0, r), ys.index_select(0, r),
                                sups)

    def graphed_call():
        return graphed.train_steps_resident(xs, ys, idx[0], sups)

    for mode, fn, reps, per in (("eager", eager_step, 6, 1),
                                ("graphed", graphed_call, 3, s)):
        t = timed_steps(fn, reps, per)
        prof = profile_step(fn)
        emit("resident_city_step", form=form, mode=mode, scan_steps=per,
             batch=b, nodes=N_CITY, dtype="bfloat16", **t,
             node_timesteps_per_s=b * 12 * N_CITY / (t["median_ms"] / 1e3),
             profiled_wall_ms_per_step=prof["wall_ms"] / per,
             device_busy_ms_per_step=prof["device_busy_ms"] / per,
             device_idle_share=prof["device_idle_share"],
             hand_kernels=prof["hand_kernels"])
    del eager, graphed, xs, ys, sups, sup, mask
    torch.cuda.empty_cache()
    return {"train_graphed" + tag: n_graphed}


def phase_resident(graph) -> dict:
    """Device-resident training: the dense METR model and the city model
    (flat and padded) graphed against eager steps, bit for bit, and timed.
    Returns the city windows' launch counts."""
    resident_dense()
    counts = resident_city(graph, "flat")
    counts.update(resident_city(graph, "pallas"))
    return counts


# ---------------------------------------------------------------------------
# export and streaming serving
# ---------------------------------------------------------------------------

# a fresh process that imports only torch and the op library loads an
# artifact, counts its constants off a 16-byte boundary (the bf16 kernels'
# TMA refuses them), predicts on a saved batch, times 10 more predicts and
# prints one JSON line
ARTIFACT_CHILD = r'''
import json, sys, time
import numpy as np
import torch
from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd, build

path, x_path, y_path, deterministic = sys.argv[1:5]
torch.use_deterministic_algorithms(deterministic == "1")
t0 = time.perf_counter()
ep = torch.export.load(path)
odd = [k for k, t in ep.constants.items()
       if torch.is_tensor(t) and t.data_ptr() % 16]
module = ep.module()
load_s = time.perf_counter() - t0
x = torch.as_tensor(np.load(x_path), device="cuda")
with torch.inference_mode():
    module(x)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    y = module(x)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in bd.OPS}
    times = []
    for _ in range(10):
        t = time.perf_counter()
        module(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
np.save(y_path, y.cpu().numpy())
bad = [m for m in sys.modules if m == "jax" or m.startswith((
    "jax.", "graph_wavenet_tpu.", "graph_wavenet_tpu_torch.models",
    "graph_wavenet_tpu_torch.train"))]
print(json.dumps({"load_seconds": load_s, "misaligned_constants": len(odd),
                  "constants": len(ep.constants), "launches": launches,
                  "predict_median_ms": sorted(times)[5],
                  "predict_min_ms": min(times), "foreign_modules": bad}))
'''


def only_checkpoint(save_dir: str) -> str:
    """The one checkpoint a one-epoch run wrote into ``save_dir``."""
    import glob

    (path,) = glob.glob(os.path.join(save_dir, "*.pt"))
    return path


def ab_ms(fns: dict, reps: int = 5, rounds: int = 4) -> dict:
    """Wall ms of each of ``fns`` (host clock around a call that ends in a
    sync), alternating their order over ``rounds`` after one warm-up each:
    median and minimum per name."""
    import torch

    times = {name: [] for name in fns}
    names = list(fns)
    for i in range(rounds):
        for name in (names if i % 2 == 0 else names[::-1]):
            fns[name]()
            torch.cuda.synchronize()
            for _ in range(reps):
                t = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
    return {name: {"median_ms": sorted(v)[len(v) // 2], "min_ms": min(v)}
            for name, v in times.items()}


def export_start(name: str, argv: list, tmp: str, det: bool) -> dict:
    """One checkpoint through ``gwt-torch-export`` at batch 8, and its
    artifact started in a fresh process (:data:`ARTIFACT_CHILD`) on a
    batch of 12-step windows left-padded to the artifact's window; returns
    at once, so the next export runs while the child does
    (:func:`export_check` waits). ``det``: deterministic algorithms in the
    child and in the check (a bracket the fixed-order mask no longer
    needs)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from graph_wavenet_tpu_torch.cli import export

    out = os.path.join(tmp, f"{name}.pt2")
    t0 = time.perf_counter()
    res = export.main([*argv, "--out", out, "--batch_size", "8",
                       "--device", "cuda"])
    export_s = time.perf_counter() - t0
    b, t, n, f = res["in_shape"]
    x = torch.randn(b, 12, n, f, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(9))
    xp, yp = (os.path.join(tmp, f"{name}_art_{k}.npy") for k in "xy")
    np.save(xp, F.pad(x, (0, 0, 0, 0, t - 12, 0)).cpu().numpy())
    logs = [open(os.path.join(tmp, f"{name}_art.{k}"), "w+")
            for k in ("out", "err")]
    child = subprocess.Popen(
        [sys.executable, "-c", ARTIFACT_CHILD, out, xp, yp, str(int(det))],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=logs[0],
        stderr=logs[1], text=True)
    return dict(name=name, out=out, x=x, yp=yp, det=det, child=child,
                logs=logs, export_s=export_s, in_shape=[b, t, n, f])


def export_check(run: dict, fc) -> dict:
    """Wait for :func:`export_start`'s child; its output held bit for bit
    to ``fc.predict`` on the unpadded windows and its hand-kernel launches
    to the Forecaster's; then the artifact's predict and the Forecaster's
    timed in turns in this process. Returns the artifact predict's launch
    counts."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.train import serving

    name, out, x, det = run["name"], run["out"], run["x"], run["det"]
    try:
        rc = run["child"].wait(timeout=900)
    finally:
        if run["child"].poll() is None:
            run["child"].kill()
            run["child"].wait()
    text = []
    for f in run["logs"]:
        f.seek(0)
        text.append(f.read())
        f.close()
    require(rc == 0, f"{name}: the artifact failed in a fresh process:\n"
            f"{text[1][-4000:]}")
    stats = json.loads(text[0].strip().splitlines()[-1])
    with deterministic(det):
        reset_launches()
        want = fc.predict(x)
        torch.cuda.synchronize()
        live = kernel_launches()
        got = torch.as_tensor(np.load(run["yp"]), device="cuda")
        art = serving.load_exported_forecaster(out)
        times = ab_ms({"artifact": lambda: art.predict(x),
                       "forecaster": lambda: fc.predict(x)}, reps=2,
                      rounds=2)
    diff = float((got - want).abs().max())
    emit("export", name=name, in_shape=run["in_shape"],
         export_seconds=round(run["export_s"], 3),
         artifact_bytes=os.path.getsize(out), deterministic=det,
         bitwise_equal=bool(torch.equal(got, want)), max_abs_diff=diff,
         child=stats, forecaster_launches=live, in_process=times,
         timing_note="the child's predict times ran beside the next "
                     "export")
    require(torch.equal(got, want),
            f"{name}: the artifact differs from Forecaster.predict by {diff}")
    require(stats["launches"] == live,
            f"{name}: artifact launches {stats['launches']}, the "
            f"Forecaster's {live}")
    require(not stats["foreign_modules"],
            f"{name}: the loader imported {stats['foreign_modules']}")
    require(stats["misaligned_constants"] == 0,
            f"{name}: {stats['misaligned_constants']} constants load off a "
            "16-byte boundary")
    del art
    torch.cuda.empty_cache()
    return stats["launches"]


def phase_export(tmp: str) -> dict:
    """The export path: ``phase_serve``'s 40,960-node bf16 flat checkpoint
    (no adaptive adjacency), ``phase_train``'s padded checkpoint (with the
    masked adaptive adjacency) and ``phase_metr_cli``'s dense METR
    checkpoint (``--adjdata``), each exported at batch 8
    (:func:`export_start`, each artifact's fresh process running while the
    next export does) and checked (:func:`export_check`). Returns the
    launch counts of the city artifacts' predicts (``artifact``,
    ``artifact_padded``)."""
    import torch

    from graph_wavenet_tpu_torch.train.serving import Forecaster

    counts, started = {}, []
    try:
        flat = [os.path.join(tmp, "city_flat.pt"),
                os.path.join(tmp, "city_graph.npz")]
        padded = [only_checkpoint(os.path.join(tmp, "train_ckpt_pallas")),
                  os.path.join(tmp, "train_graph.npz")]
        metr = ["--checkpoint",
                only_checkpoint(os.path.join(tmp, "metr_ckpt")),
                "--adjdata", os.path.join(tmp, "adj_mx.pkl")]
        started.append(export_start(
            "city_flat", ["--checkpoint", flat[0], "--graph_npz", flat[1]],
            tmp, det=False))
        started.append(export_start(
            "city_padded", ["--checkpoint", padded[0], "--graph_npz",
                            padded[1]], tmp, det=True))
        fc = Forecaster.from_city_checkpoint(*flat, device="cuda")
        want = forward_launches(fc.supports, layer_widths(fc.cfg, 8),
                                torch.bfloat16)
        counts["artifact"] = export_check(started[0], fc)
        require(counts["artifact"] == want,
                f"flat artifact launches {counts['artifact']}, the layout "
                f"{want}")
        del fc
        started.append(export_start("metr_dense", metr, tmp, det=False))
        fc = Forecaster.from_city_checkpoint(*padded, device="cuda")
        want = forward_launches(fc.supports, layer_widths(fc.cfg, 8),
                                torch.bfloat16)
        counts["artifact_padded"] = export_check(started[1], fc)
        require(counts["artifact_padded"] == want,
                f"padded artifact launches {counts['artifact_padded']}, the "
                f"layout {want}")
        del fc
        dense = export_check(started[2], metr_forecaster(tmp))
        require(not any(dense.values()),
                f"the dense artifact launched a block kernel: {dense}")
    finally:
        for run in started:
            if run["child"].poll() is None:
                run["child"].kill()
                run["child"].wait()
    torch.cuda.empty_cache()
    reset_launches()
    return counts


def metr_forecaster(tmp: str):
    """``phase_metr_cli``'s dense checkpoint under the serve CLI's rules."""
    import argparse

    from graph_wavenet_tpu_torch.cli import serve

    return serve.load_forecaster(argparse.Namespace(
        checkpoint=only_checkpoint(os.path.join(tmp, "metr_ckpt")),
        graph_npz=None, adjdata=os.path.join(tmp, "adj_mx.pkl"),
        adjtype="doubletransition", graph_bank=None, device="cuda"))


def serve_concurrently(argv: list, fc, n: int, seed: int):
    """``gwt-torch-serve`` on ``argv``, ``n`` concurrent raw requests; each
    answer against ``fc.predict`` on the standardized windows stacked in
    request order and padded as the batcher pads (rows in another order
    than the device call's, so held to half a bf16 ulp of the forecasts'
    largest magnitude and their bitwise equality reported). Returns the
    health and stats records, the launches and the largest difference."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve

    run = serve.main([*argv, "--port", "0", "--window_ms", "3000",
                      "--max_batch", "8"], serve_forever=False)
    server, batcher = run["server"], run["batcher"]
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        raw = np.random.default_rng(seed).normal(
            50.0, 10.0, size=(n, 12, fc.input_nodes, 2)).astype(np.float32)
        answers: list = [None] * n
        errors: list = []

        def ask(i):
            try:
                answers[i] = np.asarray(post_json(
                    url + "/predict", {"x": raw[i].tolist()})["y"])
            except Exception as e:         # reported below; fails the run
                errors.append(f"{type(e).__name__}: {e}")

        reset_launches()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = kernel_launches()
        require(not errors and not any(t.is_alive() for t in threads),
                f"requests failed: {errors}")
        stats = json.loads(urllib.request.urlopen(
            url + "/stats", timeout=60).read())
        bucket = batcher._bucket(n)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    xs = raw.copy()
    xs[..., 0] = fc.scaler.transform(xs[..., 0])
    xs = np.concatenate([xs, np.repeat(xs[-1:], bucket - n, axis=0)])
    want = fc.predict(xs).cpu().numpy()[:n]
    got = np.stack(answers)
    diff = float(np.abs(got - want).max())
    tol = 2.0 ** -9 * float(np.abs(want).max())
    return health, stats, launches, diff, bool((got == want).all()), tol


def phase_serve_artifact(tmp: str) -> dict:
    """``gwt-torch-serve --artifact`` on the flat city artifact of
    ``phase_export`` (scaler flags as the checkpoint's), 4 concurrent
    requests padded to the artifact's batch of 8, and ``gwt-torch-serve
    --checkpoint --adjdata`` on the dense METR checkpoint. Returns the
    artifact server's launch counts (``serve_artifact``)."""
    import torch

    from graph_wavenet_tpu_torch.train.serving import Forecaster

    fc = Forecaster.from_city_checkpoint(
        os.path.join(tmp, "city_flat.pt"),
        os.path.join(tmp, "city_graph.npz"), device="cuda")
    health, stats, served, diff, bitwise, tol = serve_concurrently(
        ["--artifact", os.path.join(tmp, "city_flat.pt2"), "--scaler_mean",
         str(fc.scaler.mean), "--scaler_std", str(fc.scaler.std)], fc, 4, 11)
    want = {k: v * stats["device_calls"] for k, v in forward_launches(
        fc.supports, layer_widths(fc.cfg, 8), torch.bfloat16).items()}
    emit("serve_artifact", source=health["source"], device=health["device"],
         in_shape=health["in_shape"], requests=stats["requests"],
         device_calls=stats["device_calls"],
         batch_histogram=stats["batch_histogram"], padded_to=8,
         launches=served, expected=want, max_abs_diff_vs_forecaster=diff,
         tolerance=tol, bitwise_equal=bitwise)
    require(health["source"] == "artifact" and health["in_shape"][0] == 8,
            f"healthz: {health}")
    require(stats["requests"] == 4 and served == want,
            f"artifact server launches {served}, expected {want}")
    require(diff <= tol, f"artifact answers differ from the Forecaster's by "
            f"{diff} (tolerance {tol})")
    del fc
    fc = metr_forecaster(tmp)
    health, stats, launches, diff, bitwise, tol = serve_concurrently(
        ["--checkpoint", only_checkpoint(os.path.join(tmp, "metr_ckpt")),
         "--adjdata", os.path.join(tmp, "adj_mx.pkl"), "--device", "cuda"],
        fc, 4, 12)
    emit("serve_dense", source=health["source"], device=health["device"],
         supports=health["supports"], requests=stats["requests"],
         device_calls=stats["device_calls"],
         batch_histogram=stats["batch_histogram"], launches=launches,
         max_abs_diff_vs_forecaster=diff, tolerance=tol,
         bitwise_equal=bitwise)
    require(health["source"] == "checkpoint" and stats["requests"] == 4,
            f"dense server: {health}, {stats}")
    require(diff <= tol and not any(launches.values()),
            f"dense answers differ by {diff} or launched {launches}")
    del fc
    torch.cuda.empty_cache()
    return {"serve_artifact": served}


def ar_eager(fc, x, n_rounds: int, aux=None):
    """``autoregressive_forecast``'s rounds as eager predicts: the round's
    forecast, standardized, becomes the signal of H new steps, beside the
    round's ``aux`` chunk (or the window's aux tail)."""
    import torch

    h = fc.cfg.out_dim
    state, preds = x.clone(), []
    for k in range(n_rounds):
        pred = fc.predict(state)
        tail = (state[:, -h:, :, 1:] if aux is None
                else aux[:, k * h:(k + 1) * h])
        new = torch.cat([((pred - fc.scaler.mean) / fc.scaler.std)[..., None],
                         tail], -1)
        state = torch.cat([state[:, h:], new], 1)
        preds.append(pred)
    return torch.cat(preds, 1)


def rolling_run(name: str, fc, n_origins: int) -> dict:
    """A rolling forecast over ``n_origins`` origins of a random history on
    the card: the eager loop of ``predict`` per window against the
    replayed graph (a first call that warms up, captures and replays, then
    two of replays only), bit for bit; each replay's launches held to one
    predict's; ms per origin of both (median of 3 calls) and their
    profiled idle shares (over at most 24 origins). Returns the graphed
    window's launch counts, every replay counted."""
    import torch

    from graph_wavenet_tpu_torch.train import serving

    history = torch.randn(n_origins + 11, fc.input_nodes, 2, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(13))

    def eager(h=history):
        return torch.stack([fc.predict(h[None, k:k + 12])[0]
                            for k in range(h.shape[0] - 11)])

    reset_launches()
    want = eager()
    torch.cuda.synchronize()
    one = {k: v // n_origins for k, v in kernel_launches().items()}
    reset_launches()
    got = [serving.rolling_forecast(fc, history, 12) for _ in range(3)]
    torch.cuda.synchronize()
    (g,) = fc.step_graphs()
    window = graphed_window_launches(fc, kernel_launches())
    # profiled over the first 24 origins at most: a profile of every
    # kernel of 288 origins takes minutes to read back
    short = history[:35] if n_origins > 24 else history
    times = {}
    for mode, fn, profiled in (
            ("eager", eager, lambda: eager(short)),
            ("graphed", lambda: serving.rolling_forecast(fc, history, 12),
             lambda: serving.rolling_forecast(fc, short, 12))):
        t = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3 / n_origins)
        profiled()          # a graph of the short history: captured here
        prof = profile_step(profiled)
        times[mode] = {"ms_per_origin_median": sorted(t)[1],
                       "ms_per_origin_min": min(t),
                       "profiled_origins": short.shape[0] - 11,
                       "profiled_wall_ms": prof["wall_ms"],
                       "device_busy_ms": prof["device_busy_ms"],
                       "device_idle_share": prof["device_idle_share"],
                       "hand_kernels": prof["hand_kernels"]}
    equal = all(torch.equal(r, want) for r in got)
    emit("rolling", name=name, nodes=fc.input_nodes, origins=n_origins,
         window=12, bitwise_equal=equal, replays=g.replays,
         per_replay_launches=g.launches, predict_launches=one,
         window_launches=window, **times)
    require(equal, f"{name}: the replayed rolling forecast differs from the "
            "eager loop")
    require(g.launches == one, f"{name}: a replay launches {g.launches}, a "
            f"predict {one}")
    return window


def ar_run(name: str, fc, batch: int, n_rounds: int, with_aux: bool):
    """``autoregressive_forecast`` on the card against :func:`ar_eager`,
    bit for bit, two calls (the second replays every round); round 1
    against ``predict``."""
    import torch

    from graph_wavenet_tpu_torch.train import serving

    gen = torch.Generator("cuda").manual_seed(14)
    h, n = fc.cfg.out_dim, fc.input_nodes
    x = torch.randn(batch, 12, n, 2, device="cuda", generator=gen)
    aux = (torch.rand(batch, n_rounds * h, n, 1, device="cuda",
                      generator=gen) if with_aux else None)
    want = ar_eager(fc, x, n_rounds, aux)
    before = sum(g.replays for g in fc.step_graphs())
    got = [serving.autoregressive_forecast(fc, x, n_rounds, future_aux=aux)
           for _ in range(2)]
    torch.cuda.synchronize()
    equal = all(torch.equal(r, want) for r in got)
    first = torch.equal(got[0][:, :h], fc.predict(x))
    emit("autoregressive", name=name, nodes=n, batch=batch, rounds=n_rounds,
         future_aux=with_aux, bitwise_equal=equal, round1_equals_predict=first,
         replays=sum(g.replays for g in fc.step_graphs()) - before)
    require(equal and first, f"{name}: the replayed rounds differ from the "
            "eager ones")


# the dense model's rolling origins: 8 hours of 5-minute readings
METR_ROLLING_ORIGINS = 96


def phase_rolling(tmp: str) -> dict:
    """Streaming forecasts at full width: a rolling forecast over 24
    origins of ``phase_serve``'s 40,960-node bf16 flat model and over
    ``METR_ROLLING_ORIGINS`` of the dense 207-node METR model
    (:func:`rolling_run`), then ``autoregressive_forecast``: the city model
    at batch 1 for 3 rounds (the aux tail repeated) and the dense model
    with ``future_aux`` (:func:`ar_run`). Returns the city rolling
    window's launch counts (``rolling``)."""
    import torch

    from graph_wavenet_tpu_torch.train.serving import Forecaster

    fc = Forecaster.from_city_checkpoint(
        os.path.join(tmp, "city_flat.pt"),
        os.path.join(tmp, "city_graph.npz"), device="cuda")
    counts = {"rolling": rolling_run("city_flat", fc, 24)}
    ar_run("city_flat", fc, 1, 3, with_aux=False)
    del fc
    torch.cuda.empty_cache()
    fc = metr_forecaster(tmp)
    dense = rolling_run("metr_dense", fc, METR_ROLLING_ORIGINS)
    require(not any(dense.values()),
            f"the dense rolling forecast launched a block kernel: {dense}")
    ar_run("metr_dense", fc, 4, 3, with_aux=True)
    del fc
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the per-sample-graph (diff-G) path
# ---------------------------------------------------------------------------

# README's diff-G run at full width (80 nodes, K = 48, 4 blocks of
# dilations 4 and 8: receptive field 49, batch 32, fp32, dropout 0.3), the
# subject count cut from 80/20/4 to 8/2/4 for the script's time
DIFFG_NODES, DIFFG_K, DIFFG_BATCH, DIFFG_S = 80, 48, 32, 8
DIFFG_SUBJECTS = {"n_train": 8, "n_valid": 2, "n_test": 4}
DIFFG_ARGV = ["--num_nodes", str(DIFFG_NODES), "--seq_length",
              str(DIFFG_K), "--blocks", "4", "--layers", "2", "--nhid", "32",
              "--batch_size", str(DIFFG_BATCH), "--gcn_bool", "--addaptadj",
              "--device", "cuda"]
# the --fresh_nodevec run's cut: one subject a split, one epoch
DIFFG_FRESH_ARGV = ["--n_train", "1", "--n_valid", "1", "--n_test", "1",
                    "--epochs", "1", "--fresh_nodevec"]
DIFFG_CHILD = r'''
import json, sys, time
import numpy as np
import torch
from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd, build

path, x_path, i_path, y_path = sys.argv[1:5]
t0 = time.perf_counter()
module = torch.export.load(path).module()
load_s = time.perf_counter() - t0
x = torch.as_tensor(np.load(x_path), device="cuda")
idx = torch.as_tensor(np.load(i_path), device="cuda")
with torch.inference_mode():
    module(x, idx)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    y = module(x, idx)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in bd.OPS}
np.save(y_path, y.cpu().numpy())
bad = [m for m in sys.modules if m == "jax" or m.startswith((
    "jax.", "graph_wavenet_tpu.", "graph_wavenet_tpu_torch.models",
    "graph_wavenet_tpu_torch.train"))]
print(json.dumps({"load_seconds": load_s, "launches": launches,
                  "foreign_modules": bad}))
'''


def diffg_cli(name: str, tmp: str, argv: list) -> dict:
    """``gwt-torch-train`` on ``argv`` (saving under ``tmp/name``), timed,
    its hand-kernel launches counted. Returns the CLI's dict with
    ``seconds`` and ``launches``."""
    import torch

    from graph_wavenet_tpu_torch.cli import train

    reset_launches()
    t0 = time.perf_counter()
    out = train.main(argv + ["--save", os.path.join(tmp, name)])
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, launches=kernel_launches())
    res, engine = out["result"], out["runner"].engine
    emit("diffg_train", name=name, seconds=round(out["seconds"], 3),
         diff_g=engine.diff_g, fresh_nodevec=engine.model_cfg.fresh_nodevec,
         num_nodes=engine.model_cfg.num_nodes,
         seq_length=engine.model_cfg.out_dim,
         receptive_field=engine.model_cfg.receptive_field,
         steps=engine.step,
         graphs=[{"replays": g.replays} for g in engine.step_graphs()],
         epochs=[{"epoch": h.epoch, "train_loss": h.train["loss"],
                  "valid_loss": h.valid["loss"],
                  "train_seconds": h.train_time} for h in res.history],
         test={k: v for k, v in res.test_metrics.items()
               if not hasattr(v, "shape")}, launches=out["launches"])
    require(all(math.isfinite(h.train["loss"]) for h in res.history)
            and math.isfinite(res.test_metrics["loss"]),
            f"{name}: a loss is not finite")
    return out


def diffg_engines(cfg, n: int, seed: int = 0):
    """Two diff-G engines of ``cfg`` from one seed on the card."""
    from graph_wavenet_tpu_torch.config import TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    return [Engine(cfg, TrainConfig(), StandardScaler(0.5, 0.3),
                   device="cuda", seed=seed, diff_g=True) for _ in range(n)]


def diffg_graphed(cfg, resident: dict, F_t: int, mode: str) -> None:
    """``DIFFG_S`` graphed ``train_steps_syn_resident`` steps, twice (the
    first call warms up, captures and replays; the second only replays),
    bit for bit against as many eager ``train_step_syn`` steps on the
    gathered batches (metrics, weights, BatchNorm buffers, Adam, the
    generator); then the per-step time and profiled idle share of both."""
    import numpy as np
    import torch

    xs, ys, adj = resident["xs"], resident["ys"], resident["adj"]
    sups, proj = resident["sups"], resident["proj"]
    rng = np.random.default_rng(5)
    idx = rng.integers(0, xs.shape[0], size=(2, DIFFG_S, DIFFG_BATCH)
                       ).astype(np.int32)
    eager, graphed = diffg_engines(cfg, 2)

    def eager_step(r):
        gids = adj.index_select(0, r)
        return eager.train_step_syn(
            xs.index_select(0, r), ys.index_select(0, r),
            [s.index_select(0, gids) for s in sups],
            proj.index_select(0, gids), F_t)

    got = [metric_rows(graphed.train_steps_syn_resident(
        xs, ys, sel, adj, sups, proj, F_t)) for sel in idx]
    rows = torch.as_tensor(idx, device="cuda")
    want = [torch.cat([metric_rows(eager_step(r)) for r in sel], 1)
            for sel in rows]
    torch.cuda.synchronize()
    m_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    diff = first_difference(step_state(graphed), step_state(eager))
    replays = [g.replays for g in graphed.step_graphs()]
    emit("diffg_bitwise", mode=mode, dropout=cfg.dropout,
         fresh_nodevec=cfg.fresh_nodevec, scan_steps=DIFFG_S, calls=2,
         replays=replays, max_abs_metric_diff=m_err,
         first_state_difference=diff, tolerance="bit for bit")
    require(replays == [2 * DIFFG_S - 1],
            f"the graphed diff-G steps ran {replays} replays")
    require(diff is None and m_err == 0.0,
            f"graphed diff-G steps ({mode}) differ from eager ones: state "
            f"{diff}, metrics by {m_err}")
    it = {"k": 0}

    def one_eager():
        r = rows[1, it["k"] % DIFFG_S]
        it["k"] += 1
        return eager_step(r)

    def graphed_call():
        return graphed.train_steps_syn_resident(xs, ys, idx[1], adj, sups,
                                                proj, F_t)

    node_steps = DIFFG_BATCH * DIFFG_K * DIFFG_NODES
    for kind, fn, reps, per in (("eager", one_eager, 16, 1),
                                ("graphed", graphed_call, 4, DIFFG_S)):
        t = timed_steps(fn, reps, per)
        prof = profile_step(fn)
        emit("diffg_step", mode=mode, kind=kind, scan_steps=per,
             batch=DIFFG_BATCH, nodes=DIFFG_NODES, seq_length=DIFFG_K, **t,
             node_timesteps_per_s=node_steps / (t["median_ms"] / 1e3),
             profiled_wall_ms_per_step=prof["wall_ms"] / per,
             device_busy_ms_per_step=prof["device_busy_ms"] / per,
             device_idle_share=prof["device_idle_share"],
             device_kernels_per_step=prof["device_kernels"] / per,
             top_kernels=prof["top_kernels"][:4],
             top_host_ops=prof["top_host_ops"][:4])
    del eager, graphed
    torch.cuda.empty_cache()


def diffg_vs_cpu(cfg, resident: dict, F_t: int) -> None:
    """The diff-G model on the card against the same model on the host CPU
    at full width and batch ``DIFFG_BATCH`` (dropout 0, so both draw
    nothing): from one state, ``eval_step_syn`` (loss, ``pred_F``,
    ``pred_E``), one ``train_step_syn`` (loss, the updated parameters and
    BatchNorm buffers) and the backward of a train-mode forward against a
    fixed cotangent (every parameter's gradient). Each is held at rtol
    1e-5 with atol 1e-5 x the largest magnitude of its kind, which a TF32
    product or a wrong per-sample gather would miss by orders of
    magnitude. Adam's first step is the sign of the gradient, so the
    gradients are held through the cotangent's backward, where they are a
    smooth function of the inputs."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    xs, ys, adj = resident["xs"], resident["ys"], resident["adj"]
    rows = torch.arange(DIFFG_BATCH, device="cuda") * 37 % xs.shape[0]
    gids = adj.index_select(0, rows)
    batch = {"cuda": (xs.index_select(0, rows), ys.index_select(0, rows),
                      [s.index_select(0, gids) for s in resident["sups"]],
                      resident["proj"].index_select(0, gids))}
    batch["cpu"] = (batch["cuda"][0].cpu(), batch["cuda"][1].cpu(),
                    [s.cpu() for s in batch["cuda"][2]],
                    batch["cuda"][3].cpu())
    engines = {dev: Engine(cfg, TrainConfig(), StandardScaler(0.5, 0.3),
                           device=dev, seed=0, diff_g=True)
               for dev in ("cuda", "cpu")}
    engines["cpu"].model.load_state_dict(engines["cuda"].model.state_dict())
    got: dict = {dev: {} for dev in engines}
    for dev, eng in engines.items():
        x, y, sup, proj = batch[dev]
        ev = eng.eval_step_syn(x, y, sup, proj, F_t)
        got[dev]["eval"] = {"loss": ev["loss"].reshape(1),
                            "pred_F": ev["pred_F"], "pred_E": ev["pred_E"]}
        got[dev]["train_loss"] = {"loss": eng.train_step_syn(
            x, y, sup, proj, F_t)["loss"].reshape(1)}
        got[dev]["updated_state"] = {
            k: v for k, v in eng.model.state_dict().items()
            if v.is_floating_point()}
        eng.model.train()
        params = dict(eng.model.named_parameters())
        out = eng._forward(x, sup)
        cot = np.random.default_rng(11).normal(size=tuple(out.shape))
        grads = torch.autograd.grad(
            out, list(params.values()),
            torch.as_tensor(cot, dtype=out.dtype, device=out.device),
            allow_unused=True)
        got[dev]["gradients"] = {k: g for k, g in zip(params, grads)
                                 if g is not None}
    torch.cuda.synchronize()
    readings = {}
    for kind, want in got["cpu"].items():
        card = {k: v.cpu() for k, v in got["cuda"][kind].items()}
        require(card.keys() == want.keys(),
                f"card vs CPU {kind}: the entries differ")
        scale = max(float(v.abs().max()) for v in want.values())
        ok = all(torch.allclose(card[k], v, rtol=1e-5, atol=1e-5 * scale)
                 for k, v in want.items())
        diff, at = max((float((card[k].double() - v.double()).abs().max()),
                        k) for k, v in want.items())
        readings[kind] = {"max_abs_diff": diff, "at": at,
                          "max_abs_cpu": scale,
                          "max_abs_diff_over_max_abs": diff / scale,
                          "entries": len(want), "ok": ok}
    emit("diffg_vs_cpu", batch=DIFFG_BATCH, nodes=DIFFG_NODES,
         seq_length=DIFFG_K, dropout=cfg.dropout, readings=readings,
         tolerance="rtol 1e-5, atol 1e-5 x max|cpu| of each kind")
    require(all(r["ok"] for r in readings.values()),
            f"the diff-G model on the card differs from the CPU: {readings}")
    del engines, got, batch
    torch.cuda.empty_cache()


def diffg_serve(ckpt: str, bank: str, resident: dict, F_t: int) -> dict:
    """The bank-serving checks of ``phase_diffg``; returns the launches of
    the serving window."""
    import dataclasses

    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import serve
    from graph_wavenet_tpu_torch.train import serving

    reset_launches()
    fc = serving.DiffGForecaster.from_checkpoint(ckpt, device="cuda")
    fc.bind_bank(serving.load_graph_bank(bank))
    xs, ys = resident["test_xs"], resident["test_ys"]
    n_graphs = fc.n_graphs
    rows = torch.arange(4, device="cuda") * 101 % xs.shape[0]
    x, y = xs.index_select(0, rows), ys.index_select(0, rows)
    gids = torch.arange(4, device="cuda") % n_graphs
    # predict_indexed is predict on the gathered supports
    got = fc.predict_indexed(x, gids)
    sup = [s.index_select(0, gids) for s in fc.sup_stack]
    same_gather = bool(torch.equal(got, fc.predict(x, sup)))
    # the modalities against the engine's eval step on the same batch
    cfg = fc.cfg
    (eng,) = diffg_engines(dataclasses.replace(cfg), 1)
    eng.model.load_state_dict(fc.model.state_dict())
    eng.scaler = fc.scaler
    ev = eng.eval_step_syn(x, y, sup, fc.proj_stack.index_select(0, gids),
                           F_t)
    f, e = fc.predict_modalities_indexed(x, gids)
    same_eval = bool(torch.equal(f, ev["pred_F"][:, -1].permute(0, 2, 1))
                     and torch.equal(e, ev["pred_E"][:, -1].permute(0, 2, 1)))
    # four concurrent requests naming four graphs: one device call
    run = serve.main(["--checkpoint", ckpt, "--graph_bank", bank,
                      "--device", "cuda", "--port", "0", "--window_ms",
                      "3000", "--max_batch", "8"], serve_forever=False)
    server, batcher = run["server"], run["batcher"]
    raw = x.cpu().numpy().copy()
    raw[..., 0] = fc.scaler.inverse_transform(raw[..., 0])
    answers: list = [None] * 4
    errors: list = []
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())

        def ask(i):
            try:
                answers[i] = np.asarray(post_json(
                    url + "/predict", {"x": raw[i].tolist(),
                                       "adj_idx": int(gids[i])})["y"],
                    np.float32)
            except Exception as err:       # reported below; fails the run
                errors.append(f"{type(err).__name__}: {err}")

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        mod = post_json(url + "/predict_modalities",
                        {"x": raw.tolist(), "adj_idx": gids.tolist()})
        stats = json.loads(urllib.request.urlopen(url + "/stats",
                                                  timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    require(not errors, f"diff-G requests failed: {errors}")
    # the server standardizes the raw rows again: compare its answers to
    # predict_indexed on the rows it standardized
    xs_srv = raw.copy()
    xs_srv[..., 0] = fc.scaler.transform(xs_srv[..., 0])
    want = fc.predict_indexed(xs_srv, gids.cpu().numpy()).cpu().numpy()
    served = np.stack(answers)
    serve_diff = float(np.abs(served - want).max())
    f2, e2 = fc.predict_modalities_indexed(xs_srv, gids.cpu().numpy())
    mod_diff = max(float(np.abs(np.asarray(mod["pred_F"], np.float32)
                                - f2.cpu().numpy()).max()),
                   float(np.abs(np.asarray(mod["pred_E"], np.float32)
                                - e2.cpu().numpy()).max()))
    # timed as the server calls it: host x and adj_idx
    times = {}
    for b in (1, DIFFG_BATCH):
        xb = xs[:b].cpu().numpy()
        ib = np.arange(b) % n_graphs
        times[f"batch_{b}"] = ab_ms({"predict_indexed":
                                     lambda: fc.predict_indexed(xb, ib)},
                                    reps=20, rounds=2)["predict_indexed"]
    launches = kernel_launches()
    emit("diffg_serve", health=health, requests=stats["requests"],
         device_calls=stats["device_calls"],
         batch_histogram=stats["batch_histogram"],
         max_abs_diff_served=serve_diff, max_abs_diff_modalities=mod_diff,
         tolerance="bit for bit", predict_indexed_equals_predict=same_gather,
         modalities_equal_eval_step_syn=same_eval, predict_ms=times,
         predict_inputs="host x and adj_idx, as the server passes them",
         launches=launches)
    require(health.get("diff_g") and health.get("modalities")
            and health.get("n_graphs") == n_graphs, f"healthz: {health}")
    require(stats["device_calls"] == 1 and stats["requests"] == 4,
            f"4 requests took {stats['device_calls']} device calls")
    require(serve_diff == 0.0 and mod_diff == 0.0,
            f"served answers differ by {serve_diff}, modalities by "
            f"{mod_diff} from predict_indexed (bit for bit)")
    require(same_gather and same_eval,
            "predict_indexed differs from predict on the gathered supports "
            "or the modalities from eval_step_syn")
    return launches


def diffg_export(ckpt: str, bank: str, resident: dict, tmp: str) -> dict:
    """``gwt-torch-export --graph_bank`` at batch 4, the artifact loaded in a
    fresh process and held bit for bit to ``predict_indexed``, then served
    once by ``gwt-torch-serve --artifact``. Returns the launches."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import export, serve
    from graph_wavenet_tpu_torch.train import serving

    reset_launches()
    out = os.path.join(tmp, "diffg.pt2")
    t0 = time.perf_counter()
    export.main(["--checkpoint", ckpt, "--graph_bank", bank, "--out", out,
                 "--batch_size", "4", "--device", "cuda"])
    export_s = time.perf_counter() - t0
    fc = serving.DiffGForecaster.from_checkpoint(ckpt, device="cuda")
    fc.bind_bank(serving.load_graph_bank(bank))
    x = resident["test_xs"][:4]
    idx = np.array([3, 0, 2, 1]) % fc.n_graphs
    want = fc.predict_indexed(x, idx)
    paths = [os.path.join(tmp, f"diffg_{k}.npy") for k in "xiy"]
    np.save(paths[0], x.cpu().numpy())
    np.save(paths[1], idx)
    child = subprocess.run(
        [sys.executable, "-c", DIFFG_CHILD, out, *paths], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=900)
    require(child.returncode == 0, "the diff-G artifact failed in a fresh "
            f"process:\n{child.stderr[-4000:]}")
    stats = json.loads(child.stdout.strip().splitlines()[-1])
    got = torch.as_tensor(np.load(paths[2]), device="cuda")
    art = serving.load_exported_forecaster(out)
    times = ab_ms({"artifact": lambda: art.predict(x, idx),
                   "forecaster": lambda: fc.predict_indexed(x, idx)})
    run = serve.main(["--artifact", out, "--scaler_mean",
                      str(fc.scaler.mean), "--scaler_std",
                      str(fc.scaler.std), "--port", "0"],
                     serve_forever=False)
    try:
        raw = x[:1].cpu().numpy().copy()
        raw[..., 0] = fc.scaler.inverse_transform(raw[..., 0])
        served = np.asarray(post_json(
            f"http://127.0.0.1:{run['server'].server_port}/predict",
            {"x": raw[0].tolist(), "adj_idx": int(idx[0])})["y"], np.float32)
    finally:
        run["server"].shutdown()
        run["server"].server_close()
        run["batcher"].stop()
    xs_srv = raw.copy()
    xs_srv[..., 0] = fc.scaler.transform(xs_srv[..., 0])
    want_srv = fc.predict_indexed(np.repeat(xs_srv, 4, 0),
                                  np.full(4, idx[0]))[0].cpu().numpy()
    srv_diff = float(np.abs(served - want_srv).max())
    tol = 1e-5 * float(np.abs(want_srv).max())
    launches = kernel_launches()
    emit("diffg_export", in_shape=list(art.in_shape), n_graphs=art.n_graphs,
         export_seconds=round(export_s, 3),
         artifact_bytes=os.path.getsize(out), child=stats,
         bitwise_equal=bool(torch.equal(got, want)),
         max_abs_diff=float((got - want).abs().max()), in_process=times,
         served_max_abs_diff=srv_diff, tolerance=tol, launches=launches)
    require(torch.equal(got, want), "the diff-G artifact differs from "
            "predict_indexed")
    require(not stats["foreign_modules"],
            f"the loader imported {stats['foreign_modules']}")
    require(srv_diff <= tol, f"the artifact server's answer differs by "
            f"{srv_diff} (tolerance {tol})")
    return launches


def phase_diffg(tmp: str) -> dict:
    """The per-sample-graph path on the card (``DIFFG_ARGV``): the training
    CLI's diff-G run (2 epochs, ``--scan_steps 8``: the fused steps as a
    replayed CUDA graph) and test; one ``--same_g`` epoch (K = 12, the
    shared-graph model whose receptive field is 13, 2 training subjects);
    one ``--data crash``
    epoch on the stand-in records; a ``--fresh_nodevec`` run of one
    subject (the last three's eager steps are host-bound, so their
    subjects are cut further). Then the model on the card against the
    host CPU (:func:`diffg_vs_cpu`); graphed ``train_steps_syn_resident``
    bit for bit against
    eager ``train_step_syn`` (dropout 0.3, with and without
    ``fresh_nodevec``), timed and profiled; the trained checkpoint served
    from a bank of the test split's graphs (labels and F_t) and exported.
    The hand kernels are not on this path: every window's launches must be
    0 (the ``diffg_launches`` line). Returns no kernel window."""
    import dataclasses

    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import DataConfig
    from graph_wavenet_tpu_torch.data.synthetic import (
        load_dataset_syn,
        stack_support_splits,
    )
    from graph_wavenet_tpu_torch.train import serving
    from graph_wavenet_tpu_torch.train.engine import cluster_mean_projector

    subjects = [a for k, v in DIFFG_SUBJECTS.items()
                for a in (f"--{k}", str(v))]
    windows = {}
    run = diffg_cli("diffg_ckpt", tmp, ["--data", "syn", *DIFFG_ARGV,
                                        *subjects, "--epochs", "2",
                                        "--scan_steps", str(DIFFG_S)])
    windows["train_syn"] = run["launches"]
    engine = run["runner"].engine
    require(engine.step_graphs() and all(
        g.replays > 0 for g in engine.step_graphs()),
        "the diff-G epochs replayed no CUDA graph")
    ckpt = run["result"].best_checkpoint
    cfg = engine.model_cfg
    del run, engine
    torch.cuda.empty_cache()
    same = [a if a != str(DIFFG_K) else "12" for a in DIFFG_ARGV]
    windows["same_g"] = diffg_cli("same_g_ckpt", tmp, [
        "--data", "syn", "--same_g", *same, "--n_train", "2", "--n_valid",
        "1", "--n_test", "1", "--epochs", "1"])["launches"]
    crash = diffg_cli("crash_ckpt", tmp, [
        "--data", "crash", *DIFFG_ARGV, "--epochs", "1"])
    windows["crash"] = crash["launches"]
    # what ``phase_dist_diffg``'s 2 DP ranks are held to, as a CLI prints it
    ONE_PROCESS_TEST_MAE["crash_dp2"] = float(
        f"{crash['result'].test_metrics['loss']:.4f}")
    del crash
    fresh = diffg_cli("fresh_ckpt", tmp, [
        "--data", "syn", *DIFFG_ARGV, *DIFFG_FRESH_ARGV, "--scan_steps",
        str(DIFFG_S)])
    windows["fresh_nodevec"] = fresh["launches"]
    # what ``phase_dist_time``'s torchrun run under time SP is held to
    ONE_PROCESS_TEST_MAE["syn_t2"] = float(
        f"{fresh['result'].test_metrics['loss']:.4f}")
    del fresh
    torch.cuda.empty_cache()

    # the graphs, resident stacks and test split of the checks below
    dcfg = DataConfig(num_nodes=DIFFG_NODES, seq_length=DIFFG_K,
                      n_train=2, n_valid=1, n_test=4)
    data, adjs, F_t, G = load_dataset_syn(dcfg, DIFFG_BATCH, seed=0,
                                          resident="device", device="cuda")
    stacks = stack_support_splits(adjs, dcfg.n_train, dcfg.n_test)
    n_comm = dcfg.n_communities
    loader = data["train_loader"]
    xs, ys = loader.resident_arrays()
    resident = {
        "xs": xs, "ys": ys, "adj": loader.resident_adj_idx(),
        "sups": [torch.as_tensor(s, device="cuda") for s in stacks["train"]],
        "proj": torch.as_tensor(np.stack(
            [cluster_mean_projector(g.community_labels, n_comm)
             for g in G["train"]]), device="cuda"),
        "test_xs": data["test_loader"].resident_arrays()[0],
        "test_ys": data["test_loader"].resident_arrays()[1]}

    reset_launches()
    diffg_vs_cpu(dataclasses.replace(cfg, dropout=0.0, fresh_nodevec=False),
                 resident, F_t)
    diffg_graphed(dataclasses.replace(cfg, dropout=0.3), resident, F_t,
                  "trained")
    diffg_graphed(dataclasses.replace(cfg, dropout=0.3, fresh_nodevec=True),
                  resident, F_t, "fresh_nodevec")
    windows["graphed"] = kernel_launches()
    bank = os.path.join(tmp, "diffg_bank.npz")
    serving.save_graph_bank(
        bank, np.stack([g.W for g in G["test"]]),
        labels=np.stack([g.community_labels for g in G["test"]]), F_t=F_t)
    windows["serve"] = diffg_serve(ckpt, bank, resident, F_t)
    windows["export"] = diffg_export(ckpt, bank, resident, tmp)
    emit("diffg_launches", windows=windows,
         note="the diff-G path runs no hand kernel: its diffusion is the "
              "batched dense product, outside any Pallas kernel in the "
              "JAX package too")
    require(not any(n for w in windows.values() for n in w.values()),
            f"a diff-G window launched a hand kernel: {windows}")
    del resident, data
    torch.cuda.empty_cache()
    return {}


# ---------------------------------------------------------------------------
# slice 7a: data parallelism and node-TP over torch.distributed
# ---------------------------------------------------------------------------

TP_SHARDS = (2, 4)
# the train step's first-layer R at batch 4: 4 rows x 12 steps x 32 channels
TP_R = 1536
DIST_TIMEOUT = 900
# (name, ranks, model axis, exchange form): the 2 x 2 group takes what
# halo="auto" picks (the halo at S = 2); its processes then run the
# all_gather form under model x time (``CITY_MXT``)
DIST_LAYOUTS = (("dp2_tp2", 4, 2, "auto"),)
# the CLI comparison's data: one train step, one validation and one test
# batch at the city training cell's batch
DIST_CLI_SAMPLES = {"train": TRAIN_BATCH, "val": TRAIN_BATCH,
                    "test": TRAIN_BATCH}
SHARED_CARD = "ranks sharing one card: not a scaling number"
# the one-process runs' test MAE that ``dist_cli_more`` holds its torchrun
# runs of the same flags to: ``phase_aptonly``'s and ``phase_dist_nccl1``'s
ONE_PROCESS_TEST_MAE: dict = {}
# their tolerance, relative: bf16 runs whose reductions (BatchNorm, the
# loss, the weight gradients) sum in another order and whose MAE prints
# with 4 decimals; they read 1.3e-5 and 9e-6 apart on an H100 80GB HBM3
# at 700 W
CLI_MAE_RTOL = 1e-3


def city_build(graph, device="cuda"):
    """The training CLI's city supports, mask and layout at N_CITY (the
    "best" ordering, flat form, 128-node blocks), in fp32 on ``device``."""
    from graph_wavenet_tpu_torch.graphs import city

    pos, src, dst, w = graph
    return city.build_city_supports(
        src, dst, w, N_CITY, pos=pos, ordering="best", form="flat",
        block_size=128, addaptadj=True, device=device)


def phase_tp_tables(graph) -> None:
    """The node-TP partition of the 40,960-node city supports and mask
    for S = 2 and 4: live blocks per shard, table lengths and dummy share
    of the dest and source partitions, the exchange form ``halo="auto"``
    picks, and the bytes a rank receives per hop in each form at the
    train step's first layer (bf16, R = 1,536)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.parallel.sparse_tp import partition_tables

    t0 = time.perf_counter()
    sups, mask, layout = city_build(graph)
    dev = mask.row_tbl.device
    adp = mask.materialize(torch.ones((N_CITY, 1), device=dev),
                           torch.ones((1, N_CITY), device=dev))
    build_s = time.perf_counter() - t0
    for s in TP_SHARDS:
        for name, sp in (("support0", sups[0]), ("support1", sups[1]),
                         ("mask", adp)):
            t1 = time.perf_counter()
            t = partition_tables(sp, s, "auto")
            zero_f = t["blocks_f"].shape[1] - 1
            zero_b = t["blocks_b"].shape[1] - 1
            n_local = N_CITY // s
            emit("tp_tables", shards=s, support=name, nodes=N_CITY,
                 ordering=layout["ordering"], block_rows=sp.nb,
                 nb_local=t["nb_local"], live_blocks=sp.n_live,
                 live_per_shard_dest=t["n_live"].tolist(),
                 live_per_shard_source=(t["glob_b"] < t["n_live_global"]
                                        ).sum(1).tolist(),
                 table_len_dest=int(t["row_f"].shape[1]),
                 table_len_source=int(t["row_b"].shape[1]),
                 dummy_share_dest=float((t["slot_f"] == zero_f).mean()),
                 dummy_share_source=float((t["slot_b"] == zero_b).mean()),
                 halo_auto=bool(t["halo"]),
                 hop_bytes_per_rank_gather=(s - 1) * n_local * TP_R * 2,
                 hop_bytes_per_rank_halo=2 * n_local * TP_R * 2,
                 bytes_rule="all_gather (S-1)/S x N x R, halo 2 x N/S x R; "
                            "bf16, R = 1,536",
                 partition_seconds=round(time.perf_counter() - t1, 3),
                 build_seconds=round(build_s, 3))
    del sups, mask, adp
    torch.cuda.empty_cache()


def tp_same_order(t, s_count, sp) -> tuple[bool, bool]:
    """Whether every destination row of the shards' dest tables sums the
    unsharded forward table's live entries in its order, and every row of
    the source tables the unsharded transpose table's (global slots in
    table order, shard by shard)."""
    import numpy as np

    nbl = t["nb_local"]
    n_live = sp.n_live

    def sharded(row, slot, glob):
        rows, slots = [], []
        for s in range(s_count):
            g = glob[s][slot[s]]
            live = g < t["n_live_global"]
            rows.append(row[s][live] + s * nbl)
            slots.append(g[live])
        return np.concatenate(rows), np.concatenate(slots)

    def whole(row, slot):
        row, slot = row.cpu().numpy(), slot.cpu().numpy()
        live = slot < n_live
        return row[live], slot[live]

    fwd = [np.array_equal(a, b) for a, b in zip(
        sharded(t["row_f"], t["slot_f"], t["glob_f"]),
        whole(sp.row_tbl, sp.slot_tbl))]
    bwd = [np.array_equal(a, b) for a, b in zip(
        sharded(t["row_b"], t["slot_b"], t["glob_b"]),
        whole(sp.row_t, sp.slot_t))]
    return all(fwd), all(bwd)


def phase_tp_local(graph) -> dict:
    """Node-TP's kernels per shard in one process, with no collective: the
    block-masked adaptive adjacency of the 40,960-node city (random
    embeddings) at R = 1,536, fp32 and bf16, S = 2 and 4, both exchange
    forms. Each shard's exchanged rows are built by concatenation (what
    the all_gather or the two neighbour exchanges deliver); its forward
    and dx (kernel 1 over the dest and the source tables) and its
    dest-copy weight cotangent (kernel 2, storage order, padding slots
    zeroed) are put back together and held to the unsharded support's
    hop, transpose hop and kernel-2 cotangent: bit for bit where the
    tables show every row summing the same live entries in the same order
    (``tp_same_order``), else at ``close_err``'s tolerance. Launches: 2 S
    kernel-1 and S kernel-2 per case."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
    from graph_wavenet_tpu_torch.parallel.sparse_tp import partition_tables

    sups, mask, _ = city_build(graph)
    del sups
    gen = torch.Generator(device="cuda").manual_seed(0)
    nv1 = torch.randn((N_CITY, 10), generator=gen, device="cuda")
    nv2 = torch.randn((10, N_CITY), generator=gen, device="cuda")
    adp = mask.materialize(nv1, nv2)
    bs, r = 128, TP_R
    nb = N_CITY // bs
    tables = {(s, halo): partition_tables(adp, s, halo)
              for s in TP_SHARDS for halo in (False, True)}
    counts = {"tp_local": dict.fromkeys(bd.OPS, 0)}
    for dtype in (torch.float32, torch.bfloat16):
        sp = adp.astype(dtype)
        x = torch.randn((nb, bs, r), generator=gen, device="cuda").to(dtype)
        g = torch.randn((nb, bs, r), generator=gen, device="cuda").to(dtype)
        ref_out = bd.gathered_block_mix_flat(
            sp.blocks_flat, sp.slot_tbl, x, sp.src_tbl, sp.row_tbl,
            nb=sp.nb, transpose_lhs=True, row_ptr=sp.row_ptr)
        ref_dx = bd.gathered_block_mix_flat(
            sp.blocks_flat, sp.slot_t, g, sp.src_t, sp.row_t, nb=sp.nb_t,
            transpose_lhs=False, row_ptr=sp.row_ptr_t)
        ref_dw = bd.gathered_block_outer_flat(
            x, g, sp.src_tbl, sp.row_tbl, slot=sp.slot_tbl,
            n_slots=sp.n_live + 1, out_dtype=dtype)
        torch.cuda.synchronize()
        for (s_count, halo), t in tables.items():
            if halo and not t["halo"]:
                continue
            nbl = t["nb_local"]
            same_f, same_b = tp_same_order(t, s_count, adp)
            outs, dxs = [], []
            dw = torch.zeros_like(ref_dw)
            reset_launches()
            t0 = time.perf_counter()
            for s in range(s_count):
                own = slice(s * nbl, (s + 1) * nbl)

                def exchanged(a):
                    if not halo:
                        return a
                    prev = (s - 1) % s_count * nbl
                    nxt = (s + 1) % s_count * nbl
                    return torch.cat([a[prev:prev + nbl], a[own],
                                      a[nxt:nxt + nbl]])

                blocks_f = on_card(t["blocks_f"][s]).to(dtype)
                blocks_b = on_card(t["blocks_b"][s]).to(dtype)
                row_f, row_b = on_card(t["row_f"][s]), on_card(t["row_b"][s])
                slot_f, slot_b = on_card(t["slot_f"][s]), on_card(t["slot_b"][s])
                xg = exchanged(x)
                outs.append(bd.gathered_block_mix_flat(
                    blocks_f, slot_f, xg, on_card(t["src_f"][s]), row_f, nb=nbl,
                    transpose_lhs=True, row_ptr=bd.row_pointer(row_f, nbl)))
                dxs.append(bd.gathered_block_mix_flat(
                    blocks_b, slot_b, exchanged(g), on_card(t["src_b"][s]),
                    row_b, nb=nbl, transpose_lhs=False,
                    row_ptr=bd.row_pointer(row_b, nbl)))
                dwf = bd.gathered_block_outer_flat(
                    xg, g[own].contiguous(), on_card(t["src_f"][s]), row_f,
                    slot=slot_f, n_slots=blocks_f.shape[0], out_dtype=dtype)
                n_live = int(t["n_live"][s])
                dwf[n_live:] = 0
                dw[on_card(t["glob_f"][s][:n_live]).long()] = dwf[:n_live]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = kernel_launches()
            for k, v in launches.items():
                counts["tp_local"][k] += v
            got = {"out": torch.cat(outs), "dx": torch.cat(dxs), "dw": dw}
            want = {"out": ref_out, "dx": ref_dx, "dw": ref_dw}
            bitwise = {k: bool(torch.equal(got[k], want[k])) for k in got}
            errs = {k: close_err(got[k], want[k]) for k in got}
            same = {"out": same_f, "dx": same_b, "dw": True}
            emit("tp_local", shards=s_count, form="halo" if halo
                 else "all_gather", dtype=str(dtype).split(".")[-1], r=r,
                 same_entries_same_order={"dest": same_f, "source": same_b},
                 bitwise=bitwise,
                 max_abs_err={k: e[0] for k, e in errs.items()},
                 tolerance_where_not_same_order=errs["out"][2],
                 launches=launches, host_ms=ms,
                 exchanged_rows=int(exchanged_rows(halo, s_count, nbl, nb)))
            for k in got:
                if same[k]:
                    require(bitwise[k], f"tp_local {k} S={s_count} halo="
                            f"{halo} {dtype}: not bit for bit though the "
                            "tables sum the same entries in the same order")
                else:
                    require(errs[k][1], f"tp_local {k}: {errs[k][0]}")
            want_l = {"mix_flat": 2 * s_count, "outer_flat": s_count}
            require(all(launches[k] == v for k, v in want_l.items())
                    and sum(launches.values()) == 3 * s_count,
                    f"tp_local launches {launches}, want {want_l}")
    del adp, mask, tables
    torch.cuda.empty_cache()
    return counts


def on_card(a):
    """A host array as a fresh (aligned) tensor on the card."""
    import numpy as np
    import torch

    return torch.as_tensor(np.ascontiguousarray(a), device="cuda")


def exchanged_rows(halo: bool, s: int, nbl: int, nb: int) -> int:
    """Block-rows a shard's kernel reads: 3 N/S in the halo form, N in the
    all_gather's."""
    return 3 * nbl if halo else nb


def city_batch(seed: int = 6):
    """A global batch of the city training cell: x standard normal, y
    around 50 with 5% missing (zero) readings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(TRAIN_BATCH, 12, N_CITY, 2)).astype(np.float32)
    y = rng.normal(50.0, 10.0, size=(TRAIN_BATCH, 12, N_CITY, 2)).astype(
        np.float32)
    y[..., 0][rng.random((TRAIN_BATCH, 12, N_CITY)) < 0.05] = 0.0
    return x, y


def dist_engine(kind: str, dtype: str, dropout: float, device, mesh,
                graph=None, halo: bool | str = "auto"):
    """(engine, supports, x, y) of a distributed check at full width: the
    city training cell (``graph``: the (pos, src, dst, w) edge list; the
    supports sharded where the mesh splits nodes, exchanging rows in the
    ``halo`` form), the dense METR model at batch 64 (``dense_inputs``;
    the supports whole on every rank), the diff-G model of README's run
    (``diffg_batch``; ``supports`` is then the per-sample supports, the
    projectors and F_t, of which the engine takes the rank's rows) or the
    CRASH-scale diff-G step (``kind`` "crash": K = 2,912, 13 x 3 layers
    from dilation 32, remat; "crash4": its first ``CRASH_BLOCKS_MXT``
    blocks). The dense supports go whole to every rank: the model takes
    its rows where the mesh splits nodes."""
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.parallel import sparse_tp
    from graph_wavenet_tpu_torch.train.engine import Engine

    common = dict(in_dim=2, out_dim=12, residual_channels=32,
                  dilation_channels=32, skip_channels=256, end_channels=512,
                  blocks=4, layers=2, gcn_bool=True, addaptadj=True,
                  n_supports=2, dropout=dropout, dtype=dtype)
    if kind in ("diffg", "crash", "crash4"):
        if kind == "diffg":
            cfg = ModelConfig(num_nodes=DIFFG_NODES, **dict(
                common, out_dim=DIFFG_K, start_dilation=4))
            x, y, sups_np, proj = diffg_batch()
            f_t = DIFFG_K // 12
        else:
            blocks = CRASH_BLOCKS_MXT if kind == "crash4" else 13
            cfg = crash_cfg(blocks, dtype=dtype, dropout=dropout)
            x, y, sups_np, proj = diffg_batch(b=CRASH_BATCH, k=cfg.out_dim,
                                              n=CRASH_NODES)
            f_t = CRASH_F_T
        eng = Engine(cfg, TrainConfig(), StandardScaler(0.5, 0.3),
                     device=device, seed=0, diff_g=True, mesh=mesh)
        sups = ([torch.as_tensor(a, device=device) for a in sups_np],
                torch.as_tensor(proj, device=device), f_t)
        return eng, sups, x, y
    if kind == "metr":
        sups_np, x, y = dense_inputs()
        cfg = ModelConfig(num_nodes=DENSE_NODES, **common)
        eng = Engine(cfg, TrainConfig(), StandardScaler(54.0, 20.0),
                     device=device, seed=0, aptinit=sups_np[0], mesh=mesh)
        return eng, [torch.as_tensor(s, device=device) for s in sups_np], x, y
    sups, mask, _ = city_build(graph, device)
    if dtype == "bfloat16":
        sups = [s.astype(torch.bfloat16) for s in sups]
    if mesh is not None and mesh.model > 1:
        sups = [sparse_tp.shard_flat_support(s, mesh, halo) for s in sups]
        mask = sparse_tp.shard_adaptive_mask(mask, mesh, halo)
    cfg = ModelConfig(num_nodes=N_CITY, **common)
    eng = Engine(cfg, TrainConfig(), StandardScaler(50.0, 10.0),
                 device=device, seed=0, mesh=mesh)
    x, y = city_batch()
    return eng, sups + [mask], x, y


def diffg_batch(seed: int = 6, b: int = DIFFG_BATCH, k: int = DIFFG_K,
                n: int = DIFFG_NODES):
    """A global batch of README's diff-G run (or of ``b`` windows of ``k``
    steps over ``n`` nodes): x standard normal, y around 0.5, two
    row-normalized per-sample supports and the cluster-mean projectors of
    4 random communities per sample."""
    import numpy as np

    from graph_wavenet_tpu_torch.train.engine import cluster_mean_projector

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, k, n, 2)).astype(np.float32)
    y = rng.normal(0.5, 0.3, size=(b, k, n, 2)).astype(np.float32)
    a = rng.random((2, b, n, n)).astype(np.float32)
    sups = list(a / a.sum(-1, keepdims=True))
    proj = np.stack([cluster_mean_projector(lab, 4)
                     for lab in rng.integers(0, 4, size=(b, n))])
    return x, y, sups, proj


def train_once(eng, sups, x, y, n_micro: int = 1) -> dict:
    """One train step of ``dist_engine``'s engine on a global batch
    (``train_step_accum`` over ``n_micro`` micro-batches where > 1)."""
    if eng.diff_g:
        return eng.train_step_syn(x, y, *sups)
    if n_micro > 1:
        return eng.train_step_accum(x, y, sups, n_micro)
    return eng.train_step(x, y, sups)


def state_vector(engine):
    """Every parameter and buffer of the engine's model, by name (host)."""
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in engine.model.state_dict().items()}


def dist_layout_runs(spec: dict, lay: dict, rank: int, dev, mesh,
                     graph) -> dict:
    """A ``dist_worker``'s runs on one layout of its ranks: per run (under
    the layout's name where the group runs more than one) its losses, step
    times, launches, state hash and peak memory; rank 0 writes the state
    and the first step's gradients of a ``keep_state`` run into the
    layout's directory."""
    import hashlib

    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )

    out_dir = os.path.join(spec["out"], lay["name"])
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for run in lay.get("runs", spec["runs"]):
        # a pipeline's engine has no mesh: its step takes the mesh
        eng, sups, x, y = dist_engine(lay.get("kind", spec["kind"]),
                                      run["dtype"], run["dropout"], dev,
                                      None if mesh.pipe > 1 else mesh, graph,
                                      lay.get("halo", spec["halo"]))
        xt, yt = (torch.as_tensor(a, device=dev) for a in (x, y))
        if mesh.pipe > 1:
            pipe_step = make_pipeline_train_step(eng, mesh, lay["n_micro"])

            def train_step():
                return pipe_step(xt, yt, sups)
        else:
            def train_step():
                return train_once(eng, sups, xt, yt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, times = [], []
        with deterministic(run.get("keep_state", False)):
            for k in range(run["steps"]):
                mesh.barrier()
                t0 = time.perf_counter()
                m = train_step()
                losses.append(float(m["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
                if k == 0 and rank == 0 and run.get("keep_state"):
                    np.savez(os.path.join(out_dir,
                                          f"{run['name']}_state_step1.npz"),
                             **state_vector(eng))
                    # the world-summed, clipped gradients the first update
                    # took
                    np.savez(os.path.join(out_dir,
                                          f"{run['name']}_grad_step1.npz"),
                             **{n: p.grad.cpu().numpy()
                                for n, p in eng.model.named_parameters()
                                if p.grad is not None})
        torch.cuda.synchronize()
        state = state_vector(eng)
        h = hashlib.sha256()
        for k in sorted(state):
            h.update(state[k].tobytes())
        rec = {"losses": losses, "step_ms": times,
               "launches": kernel_launches(), "state_sha256": h.hexdigest(),
               "max_memory_allocated_bytes":
               torch.cuda.max_memory_allocated(dev)}
        if rank == 0 and run.get("keep_state"):
            np.savez(os.path.join(out_dir, f"{run['name']}_state.npz"),
                     **state)
        out[layout_key(lay["name"], run["name"])] = rec
        del eng, sups, xt, yt
        torch.cuda.empty_cache()
    return out


def layout_key(layout: str, run: str) -> str:
    """A run's record key in a rank's record: the run's name, under its
    layout's where the group runs several."""
    return f"{layout}/{run}" if layout else run


def dist_worker(spec_path: str, rank: int) -> None:
    """One rank of a ``dist_*`` check (started by ``dist_group``): on each
    of the group's layouts in turn (``dist_layout_runs``), the fp32 steps
    with dropout 0 held against the single process (``keep_state``, under
    deterministic algorithms as ``single_reference``), then the timed bf16
    steps with dropout 0.3; writes its losses, launches, state hash, step
    times and peak memory (rank 0: its parameters too)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh
    from graph_wavenet_tpu_torch.parallel.pipeline import make_pipeline_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(spec["backend"], rank, spec["world"], spec["init"],
                         device="cuda", timeout_s=DIST_TIMEOUT)
    dev = multihost.rank_device("cuda")
    graph = None
    if spec["kind"] == "city":
        g = np.load(spec["graph"])
        graph = (g["pos"], g["src"], g["dst"], g["weight"])
    out = {"rank": rank, "device": str(dev)}
    meshes = []
    for lay in spec["layouts"]:
        if lay.get("pipe", 1) > 1:
            meshes.append(make_pipeline_mesh(lay["pipe"], dev,
                                             timeout_s=DIST_TIMEOUT))
        else:
            meshes.append(make_mesh(MeshConfig(model_axis=lay["model"],
                                               time_axis=lay["time"]), dev,
                                    timeout_s=DIST_TIMEOUT))
        out.update(dist_layout_runs(spec, lay, rank, dev, meshes[-1],
                                    graph))
    if spec.get("pipe_eval"):
        out["pipe_eval"] = pipe_eval_worker(spec, rank, dev)
    mesh = meshes[0]
    if spec["kind"] == "city":
        # the cost of drawing each layer's dropout mask at the global shape
        # (what a rank keeps is 1 / (D x S) of it): the first layer's draw,
        # global against the rank's own shape
        from graph_wavenet_tpu_torch.ops.diffusion import dropout_scale

        b, n = TRAIN_BATCH // mesh.data, N_CITY // mesh.model
        gen = torch.Generator(device=dev).manual_seed(0)
        out["draw_ms"] = {
            k: cuda_ms(lambda: dropout_scale(gen, 0.3, shape, torch.bfloat16,
                                             dev), 20)
            for k, shape in (("global", (b * mesh.data, 12, n * mesh.model,
                                         32)), ("local", (b, 12, n, 32)))}
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def dist_group(name: str, tmp: str, world: int, model: int, kind: str,
               runs: list, graph_path: str | None = None,
               halo: bool | str = "auto",
               worker: str = "dist_worker", time_axis: int = 1,
               more: tuple = (), pipe: int = 1, n_micro: int = 1,
               pipe_eval: bool = False) -> tuple:
    """:func:`start_dist_group`'s group, waited for: (backend, per-rank
    records, seconds)."""
    return start_dist_group(name, tmp, world, model, kind, runs, graph_path,
                            halo, worker, time_axis, more, pipe, n_micro,
                            pipe_eval).wait()


class DistGroup:
    """A started ``dist_*`` rank group; ``wait()`` bounds every process by
    DIST_TIMEOUT from the start and returns (backend, per-rank records,
    seconds), raising with a failed rank's log."""

    def __init__(self, name: str, out: str, world: int, backend: str,
                 procs: list):
        self.name, self.out, self.world = name, out, world
        self.backend, self.procs = backend, procs
        self.t0 = time.perf_counter()

    def wait(self) -> tuple:
        failed = []
        try:
            for rank, log, p in self.procs:
                left = DIST_TIMEOUT - (time.perf_counter() - self.t0)
                try:
                    rc = p.wait(timeout=max(left, 1.0))
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                if rc != 0:
                    with open(os.path.join(self.out,
                                           f"rank{rank}.log")) as f:
                        failed.append(f"rank {rank}: {rc}: "
                                      f"{f.read()[-4000:]}")
        finally:
            self.close()
        require(not failed, f"dist {self.name}: " + "\n".join(failed))
        recs = []
        for rank in range(self.world):
            with open(os.path.join(self.out, f"rank{rank}.json")) as f:
                recs.append(json.load(f))
        return self.backend, recs, time.perf_counter() - self.t0

    def close(self) -> None:
        for _, log, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def start_dist_group(name: str, tmp: str, world: int, model: int, kind: str,
                     runs: list, graph_path: str | None = None,
                     halo: bool | str = "auto",
                     worker: str = "dist_worker", time_axis: int = 1,
                     more: tuple = (), pipe: int = 1, n_micro: int = 1,
                     pipe_eval: bool = False) -> DistGroup:
    """Start ``world`` rank processes (``worker``: ``dist_worker``, or
    ``graphed_worker``) on this machine's cards, NCCL where every rank has
    a card of its own, else gloo with the ranks sharing them, and return
    at once (the caller computes its reference meanwhile, then waits).
    ``model``/``time_axis``: the mesh's model and time axes, or ``pipe``
    stages with ``n_micro`` micro-batches (``parallel.pipeline``);
    ``more``: further layouts the same processes run after it, each a dict
    with ``name``, ``model``, ``time`` and optionally ``kind``, ``runs``,
    ``halo``, ``pipe`` and ``n_micro`` (its records under ``layout_key``,
    its files in ``dist_<name>/<layout>``); ``pipe_eval``: then the
    pipelined eval forward of the 2,048-node city model
    (``pipe_eval_worker``)."""
    import torch

    out = os.path.join(tmp, f"dist_{name}")
    os.makedirs(out, exist_ok=True)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    layouts = [dict(name="", model=model, time=time_axis, pipe=pipe,
                    n_micro=n_micro), *more]
    spec = dict(world=world, model=model, time=time_axis, kind=kind,
                runs=runs, backend=backend, out=out, graph=graph_path,
                halo=halo, layouts=layouts, pipe_eval=pipe_eval,
                init=f"file://{out}/rendezvous")
    spec_path = os.path.join(out, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    code = ("import sys; sys.path.insert(0, sys.argv[3]); import chip_smoke;"
            f" chip_smoke.{worker}(sys.argv[1], int(sys.argv[2]))")
    procs = []
    try:
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH=REPO, LOCAL_RANK=str(rank),
                       OMP_NUM_THREADS="2")
            log = open(os.path.join(out, f"rank{rank}.log"), "w")
            procs.append((rank, log, subprocess.Popen(
                [sys.executable, "-c", code, spec_path, str(rank),
                 os.path.dirname(os.path.abspath(__file__))],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)))
    except BaseException:
        DistGroup(name, out, world, backend, procs).close()
        raise
    return DistGroup(name, out, world, backend, procs)


# Adam moves each element by lr * (g + wd p) / (|g + wd p| + 1e-8): where
# the L2-decayed gradient is a cancellation result (under 1e-4 of its
# tensor's largest gradient, the size of the difference two orderings of
# the same sums were measured to make) or near Adam's eps (under 1e-6),
# the update is set by the gradient's last bits, so that element's value
# is not compared
ADAM_RESOLVED = (1e-4, 1e-6)
# the first step's world-summed gradient against the single process's, per
# tensor, over its largest magnitude: a rank's share lost or counted twice
# is an error of order 1 (``grad_witness`` plants two such faults; they
# read 1.0). Both sides run under deterministic algorithms: without them
# the single process differs from itself by up to 9.7e-3 (nodevec2). The
# limit sits above fp32's floor: the single process against itself on the
# batch in reverse row order reads up to 2.9e-3 (nodevec2) and 4.5e-4
# elsewhere, node-TP 3.3e-4 (nodevec2) and 1.3e-4 elsewhere (H100 80GB
# HBM3, 700 W). The embeddings' gradient moves most, through the mask's
# cotangent: the materialization itself holds it to 6.7e-6 of fp64's
# (``embedding_witness``). The CPU tests hold every gradient at 1e-5 at
# their small size.
# Not compared: the bias of the graph convolution that feeds each
# BatchNorm, whose exact gradient is zero (the statistics remove any
# per-channel shift), so that what the two runs compute is rounding noise
GRAD_RTOL = 1e-2
BN_SHIFT_BIAS = re.compile(r"gconv\.\d+\.mlp\.mlp\.bias")


def grad_errors(grads: dict, want: dict) -> tuple[dict, float]:
    """Per tensor, max |grads - want| over max |want|, but the biases
    whose exact gradient is zero (``BN_SHIFT_BIAS``); and those biases'
    largest magnitude in either over the largest gradient."""
    import numpy as np

    gmax = max(float(np.abs(v).max()) for v in want.values())
    err, null_rel = {}, 0.0
    for k, v in want.items():
        if BN_SHIFT_BIAS.fullmatch(k):
            null_rel = max(null_rel, float(np.abs(v).max()) / gmax,
                           float(np.abs(grads[k]).max()) / gmax)
        else:
            err[k] = (float(np.abs(grads[k] - v).max())
                      / float(np.abs(v).max()))
    return err, null_rel


def top(err: dict, n: int = 5) -> list:
    """The ``n`` largest entries of a {tensor: error} dict."""
    return sorted(([k, v] for k, v in err.items()), key=lambda kv: -kv[1])[:n]


def dist_compare(name: str, recs: list, ref: dict, out: str,
                 key: str = "fp32", grad_rtol: float = GRAD_RTOL) -> dict:
    """Hold a group's fp32 run (dropout 0) to the single process and its
    ranks to each other; returns the readings and raises on a failed
    check:

    - the losses of both steps at rtol 1e-5;
    - the first step's clipped gradients, each tensor within
      ``grad_rtol`` of its largest magnitude but the biases whose exact
      gradient is zero (``BN_SHIFT_BIAS``), whose largest magnitude over
      the largest gradient is a reading (Adam's first update is near the
      gradient's sign, so the parameters alone would not show a gradient
      off by a factor);
    - after the first step, every parameter element that Adam resolves
      (``ADAM_RESOLVED``, from the single process's gradient) and every
      buffer at atol 1e-5 x the state's largest magnitude; the elements
      Adam does not resolve finite and within 2 x lr, which a finite step
      cannot exceed (what holds them is the gradient check above);
    - the state after the last step bit for bit equal across the ranks.

    Every tensor's error after the last step against its scale is a
    reading beside them, not a check: there the first step's unresolved
    elements have moved the next gradient, and Adam's normalized update
    turns that into O(lr) on small-gradient elements too (read where the
    run took as many steps as the reference). ``key``: the run's record
    (``layout_key``), whose files are in ``out``."""
    import numpy as np

    run = [r[key] for r in recs]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run[0]["losses"],
                                                       ref["losses"]))
    worst, worst_key, n_unresolved, worst_unresolved = 0.0, "", 0, 0.0
    got1 = dict(np.load(os.path.join(out, "fp32_state_step1.npz")))
    # one scale for the state: a per-tensor one is itself a cancellation
    # result for some (a channel's running mean near 0, zero-init biases
    # that moved by lr)
    scale = max(float(np.abs(v).max()) for v in ref["state1"].values())
    for k, want in ref["state1"].items():
        err = np.abs(got1[k] - want)
        resolved = ref["resolved"].get(k)
        if resolved is not None:
            n_unresolved += int((~resolved).sum())
            if (~resolved).any():
                worst_unresolved = max(worst_unresolved,
                                       float(err[~resolved].max()))
            err = err[resolved]
        e = float(err.max()) / scale if err.size else 0.0
        if e > worst:
            worst, worst_key = e, k
    grads = dict(np.load(os.path.join(out, "fp32_grad_step1.npz")))
    grad_err, null_rel = grad_errors(grads, ref["grad1"])
    grad_worst = max(grad_err, key=grad_err.get)
    last, last_worst, beyond = {"-": None}, "-", None
    if len(run[0]["losses"]) == len(ref["losses"]):
        got = dict(np.load(os.path.join(out, "fp32_state.npz")))
        last = {k: float(np.abs(got[k] - v).max())
                / max(float(np.abs(v).max()), 1e-30)
                for k, v in ref["state"].items()}
        last_worst = max(last, key=last.get)
        beyond = sum(int((np.abs(got[k] - v) > 1e-5 * np.abs(v).max()).sum())
                     for k, v in ref["state"].items())
    same = len({r["state_sha256"] for r in run}) == 1
    readings = {
        "loss_max_rel_err": loss_rel, "losses": run[0]["losses"],
        "losses_single": ref["losses"],
        "grad1_max_err_rel_tensor": grad_err[grad_worst],
        "grad1_worst": grad_worst,
        "grad1_top": top(grad_err),
        "grad1_bn_shift_bias_max_rel_largest": null_rel,
        "step1_max_err_rel_scale": worst, "step1_worst": worst_key,
        "step1_unresolved_elements": n_unresolved,
        "step1_unresolved_max_abs_err": worst_unresolved,
        "elements": ref["elements"],
        "last_max_err_rel_scale": last[last_worst],
        "last_worst": last_worst,
        "last_elements_beyond_1e-5_scale": beyond,
        "ranks_bitwise_equal": same,
        "state_scale": scale,
        "rule": f"loss rtol 1e-5; step 1's gradients {grad_rtol:g} x "
                "max|tensor| (not the biases before a BatchNorm); "
                "after step 1 the Adam-resolved elements and the buffers "
                "atol 1e-5 x max|state|, the rest <= 2 lr; ranks bitwise"}
    require(loss_rel <= 1e-5, f"dist {name}: fp32 losses {run[0]['losses']} "
            f"vs single process {ref['losses']}")
    require(set(grads) == set(ref["grad1"])
            and all(np.isfinite(v).all() for v in grads.values())
            and grad_err[grad_worst] <= grad_rtol,
            f"dist {name}: the gradient of {grad_worst} differs by "
            f"{grad_err[grad_worst]} of its scale from the single process")
    require(worst <= 1e-5, f"dist {name}: {worst_key} differs by {worst} "
            "of the scale from the single process after one step")
    require(worst_unresolved <= 2 * ref["lr"],
            f"dist {name}: an unresolved element moved {worst_unresolved}")
    require(same, f"dist {name}: parameters differ across ranks")
    return readings


def single_reference(kind: str, graph=None, steps: int = 2,
                     n_micro: int = 1) -> dict:
    """The single-process fp32 steps (dropout 0; ``train_step_accum`` over
    ``n_micro`` micro-batches where > 1, what a pipeline step is held to)
    a distributed run is held to, on the card, under deterministic
    algorithms (without them two
    identical runs differ: ``grad_witness``): the losses, the state after
    the first and the last step, the first step's clipped gradients, and per parameter the
    elements whose L2-decayed gradient Adam resolves at the first step
    (``ADAM_RESOLVED``); for the city model also ``embedding_witness``'s
    readings of the first step and the mask's shard owners at S = 2."""
    import torch

    eng, sups, x, y = dist_engine(kind, "float32", 0.0, "cuda", None, graph)
    xt, yt = (torch.as_tensor(a, device="cuda") for a in (x, y))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wd = eng.train_cfg.weight_decay
    rel, floor = ADAM_RESOLVED
    resolved = {}

    def record():
        if not resolved:
            for k, p in eng.model.named_parameters():
                if p.grad is not None:
                    least = max(floor, rel * float(p.grad.abs().max()))
                    resolved[k] = ((p.grad + wd * p).abs() >= least
                                   ).cpu().numpy()

    grad1 = recorded_grads(eng, then=record)
    losses, state1 = [], None
    with deterministic(True), mask_cotangent() as seen:
        for _ in range(steps):
            losses.append(float(train_once(eng, sups, xt, yt,
                                           n_micro)["loss"]))
            state1 = state1 or state_vector(eng)
    ref = {"losses": losses, "state1": state1, "state": state_vector(eng),
           "resolved": resolved, "grad1": grad1,
           "lr": eng.train_cfg.learning_rate,
           "elements": sum(v.size for v in state1.values()),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if kind == "city":
        with deterministic(True):
            ref["witness"] = embedding_witness(sups[-1], seen["nodevecs"],
                                               seen["g"])
        ref["owner2"] = shard_owner(sups[-1], 2)
    del eng, sups, xt, yt, seen
    torch.cuda.empty_cache()
    return ref


def recorded_grads(eng, then=None) -> dict:
    """A dict that the engine's first optimizer step fills with the
    gradients it takes (clipped, world-summed; host copies); ``then()``
    runs beside it."""
    grads, step = {}, eng.optimizer.step

    def record(*a, **kw):
        if not grads:
            grads.update({k: p.grad.cpu().numpy().copy()
                          for k, p in eng.model.named_parameters()
                          if p.grad is not None})
        if then is not None:
            then()
        return step(*a, **kw)

    eng.optimizer.step = record
    return grads


@contextlib.contextmanager
def mask_cotangent(edit=None):
    """Within the block, the first materialization of the block-masked
    adaptive adjacency in this process records its embeddings
    (``nodevecs``) and, in the backward, its blocks' cotangent (``g``) in
    the yielded dict; ``edit(g)``, where given, is the cotangent passed on
    in its place (a planted fault)."""
    from graph_wavenet_tpu_torch.ops import adaptive_block as ab

    inner, seen = ab.adaptive_blocks, {}

    def recorded(mask, nodevec1, nodevec2):
        blocks = inner(mask, nodevec1, nodevec2)
        if "nodevecs" not in seen:
            seen["nodevecs"] = (nodevec1.detach().clone(),
                                nodevec2.detach().clone())

            def hook(g):
                seen["g"] = g.detach().clone()
                return None if edit is None else edit(g)

            blocks.register_hook(hook)
        return blocks

    ab.adaptive_blocks = recorded
    try:
        yield seen
    finally:
        ab.adaptive_blocks = inner


def shard_owner(mask, s_count: int):
    """(L,) the node-TP shard that holds each live block of the mask: the
    one that owns its dest block-row (``sparse_tp._partition``)."""
    return mask.live_dst // (mask.n_dst_blocks // s_count)


def embedding_witness(mask, nodevecs, g) -> dict:
    """How far fp32 determines the embeddings' gradient at full width.
    The single process's first-step mask cotangent ``g`` goes back through
    the materialization alone (the masked row softmax and the embeddings'
    product): in fp32 as one process sums it, in fp32 as S node-TP ranks
    sum it (each rank its dest blocks' part, then the ranks' sum), in fp64,
    and in fp64 with ``g`` moved by relative noise of 1e-7 (about fp32's
    rounding of ``g``). Each reading is max |error| against fp64 over
    fp64's largest magnitude, per embedding; ``part_over_total``: the
    largest part of one of 2 ranks over the largest total."""
    import torch

    from graph_wavenet_tpu_torch.ops.adaptive_block import adaptive_blocks

    def grads(dtype, cot, parts: int = 1):
        e1, e2 = (v.detach().to(dtype).requires_grad_() for v in nodevecs)
        blocks = adaptive_blocks(mask, e1, e2)
        cot = cot.to(dtype)
        owner = shard_owner(mask, parts)
        out = [torch.autograd.grad(
            blocks, (e1, e2), cot * (owner == s).to(dtype)[:, None, None],
            retain_graph=True) for s in range(parts)]
        total = [sum(p[i] for p in out) for i in range(2)]
        return total, out

    want, _ = grads(torch.float64, g)
    names = ("nodevec1", "nodevec2")
    readings = {k: {} for k in names}

    def note(key, got):
        for i, k in enumerate(names):
            w = want[i]
            readings[k][key] = float((got[i].double() - w).abs().max()
                                     / w.abs().max())

    one, _ = grads(torch.float32, g)
    note("fp32_one_process", one)
    for s_count in TP_SHARDS:
        split, parts = grads(torch.float32, g, s_count)
        note(f"fp32_ranks_{s_count}", split)
        if s_count == 2:
            for i, k in enumerate(names):
                readings[k]["fp32_ranks_2_vs_one_process"] = float(
                    (split[i] - one[i]).abs().max() / want[i].abs().max())
                readings[k]["part_over_total"] = float(
                    max(p[i].abs().max() for p in parts)
                    / want[i].abs().max())
    gen = torch.Generator(device=g.device).manual_seed(0)
    noise = torch.randn(g.shape, generator=gen, device=g.device,
                        dtype=torch.float64)
    note("fp64_cotangent_noise_1e-7",
         grads(torch.float64, g.double() * (1 + 1e-7 * noise))[0])
    return readings


def first_step_grads(graph, x, y, edit=None, det: bool = True) -> dict:
    """The clipped gradients of a fresh single process's first fp32 step
    (dropout 0) of the city model on (x, y), on the card, under
    deterministic algorithms where ``det``; ``edit``: a planted fault in
    the mask's cotangent (``mask_cotangent``)."""
    import torch

    eng, sups, _, _ = dist_engine("city", "float32", 0.0, "cuda", None,
                                  graph)
    grads = recorded_grads(eng)
    with deterministic(det), mask_cotangent(edit):
        eng.train_step(torch.as_tensor(x, device="cuda"),
                       torch.as_tensor(y, device="cuda"), sups)
    del eng, sups
    torch.cuda.empty_cache()
    return grads


def grad_witness(graph, ref: dict) -> None:
    """The gradient rule of ``dist_compare`` against what it must pass and
    what it must reject, at full width, each a fresh single process's
    first step against ``ref``'s: the same run again, under deterministic
    algorithms and without them, both bit for bit (the mask's sums run in
    a fixed order, ``ops.adaptive_block``); the batch in reverse row
    order (the same gradient in exact arithmetic, other sums over the
    batch: fp32's floor for every tensor), which the rule must pass;
    ``embedding_witness``'s readings; and two planted node-TP faults,
    rank 1 of 2's part of the mask cotangent doubled and dropped, which
    the rule must reject. A fault in the mask's cotangent barely moves the
    parameters after one step (Adam's first update is about lr x the
    gradient's sign), so only the gradient rule sees it."""
    import numpy as np

    x, y = city_batch()
    again = first_step_grads(graph, x, y)
    differ = [k for k, v in ref["grad1"].items()
              if not np.array_equal(again[k], v)]
    loose_grads = first_step_grads(graph, x, y, det=False)
    loose, _ = grad_errors(loose_grads, ref["grad1"])
    loose_differ = [k for k, v in ref["grad1"].items()
                    if not np.array_equal(loose_grads[k], v)]
    rev, _ = grad_errors(first_step_grads(graph, x[::-1].copy(),
                                          y[::-1].copy()), ref["grad1"])
    rank1 = (ref["owner2"] == 1).float()[:, None, None]
    faults = {}
    for name, keep in (("doubled", 2.0), ("dropped", 0.0)):
        factor = 1.0 + (keep - 1.0) * rank1
        err, _ = grad_errors(first_step_grads(
            graph, x, y, lambda g, f=factor: g * f), ref["grad1"])
        faults[name] = top(err, 3)
    emit("grad_witness", rule=f"each tensor <= {GRAD_RTOL} x max|tensor|",
         repeat_differing_tensors=differ,
         nondeterministic_differing_tensors=loose_differ,
         nondeterministic_top=top(loose), batch_reversed_top=top(rev),
         batch_reversed_nodevec={k: rev[k] for k in ("nodevec1", "nodevec2")},
         embedding_stage=ref["witness"], planted_faults=faults)
    require(not differ, f"the deterministic single process does not repeat "
            f"bit for bit: {differ[:5]}")
    require(not loose_differ, f"without deterministic algorithms the single "
            f"process differs from itself: {top(loose, 3)}")
    require(max(rev.values()) <= GRAD_RTOL,
            f"the single process against itself breaks the gradient rule: "
            f"{top(rev, 3)}")
    for name, worst in faults.items():
        require(worst[0][1] > GRAD_RTOL,
                f"the gradient rule passes a planted fault ({name}): {worst}")


def phase_dist_city(graph, tmp: str, beside=None) -> dict:
    """A real process group at the full city model: 4 ranks (2 x 2 DP x
    node-TP, the halo form), NCCL where every rank has a card, else gloo
    with the ranks sharing it: 2 fp32 steps with dropout 0 against the
    single process on the card (``dist_compare``), the parameters bit for
    bit equal across the ranks, then one bf16 step with dropout 0.3
    (finite, ms, peak memory per rank); the same ranks then run the same
    steps on 2 model x 2 time in the all_gather form (``CITY_MXT``).
    Then the training CLI under torchrun with 2 node-TP ranks and in one
    process (fp32, dropout 0, one epoch): both checkpoints served in this
    process through ``Forecaster.from_city_checkpoint``, the forecasts
    within 1e-4 of their scale; ``beside()``, where given, runs in this
    process while the torchrun ranks do. ``dist_cli_more``'s runs go on
    beside all of it. Returns the launches of the bf16 steps of each layout
    (the main path: kernel 1 forward and dx per hop, kernel 2 for the
    mask)."""
    import numpy as np

    more = dist_cli_more(tmp)
    try:
        pos, src, dst, w = graph
        gpath = os.path.join(tmp, "dist_graph.npz")
        np.savez(gpath, pos=pos, src=src, dst=dst, weight=w)
        ref = single_reference("city", graph)
        grad_witness(graph, ref)
        counts = dist_city_groups(tmp, gpath, ref)
        counts.update(dist_city_cli(tmp, dist_cli_paths(tmp, graph),
                                    beside=beside))
        dist_cli_more_check(more)
    finally:
        more.close()
    return counts


def dist_city_groups(tmp: str, gpath: str, ref: dict) -> dict:
    """``phase_dist_city``'s rank groups (``DIST_LAYOUTS``, each followed
    by the model x time layout ``CITY_MXT``) against the single process
    ``ref``; returns the bf16 steps' launches of each layout."""
    import numpy as np
    import torch

    runs = [dict(name="fp32", dtype="float32", dropout=0.0, steps=2,
                 keep_state=True),
            dict(name="bf16", dtype="bfloat16", dropout=0.3, steps=1)]
    mxt = (dict(name=CITY_MXT, model=2, time=2, halo=False),)
    counts = {}
    for name, world, model, halo in DIST_LAYOUTS:
        backend, recs, secs = dist_group(name, tmp, world, model, "city",
                                         runs, gpath, halo, more=mxt)
        out = os.path.join(tmp, f"dist_{name}")
        counts.update(dist_city_layout(
            name, "", recs, ref, out, backend, ranks=world,
            data=world // model, model=model,
            exchange="all_gather" if halo is False else "halo (auto)",
            seconds=round(secs, 3), dropout_draw_ms_layer0=recs[0]["draw_ms"]))
        counts.update(dist_city_layout(
            CITY_MXT, CITY_MXT, recs, ref, os.path.join(out, CITY_MXT),
            backend, ranks=world, data=1, model=2, time=2,
            exchange="all_gather"))
    return counts


# the layout the 2 x 2 city group runs after its own: 2 model x 2 time in
# the all_gather form (the halo form is the 2 x 2 layout's), kernels 1 and
# 2 per shard on each time block
CITY_MXT = "tp2_t2"


def dist_city_layout(name: str, layout: str, recs: list, ref: dict,
                     out: str, backend: str, **where) -> dict:
    """One layout of a city rank group: its fp32 steps against the single
    process ``ref`` (``dist_compare``, files in ``out``), its bf16 step
    (dropout 0.3) finite, timed, its peak memory, and both runs' launches
    per rank (``dist_step_launches``); ``layout``: its record key
    (``layout_key``), ``where``: the mesh it ran, for the record. Returns
    the bf16 step's launches as the ``dist_<name>`` window."""
    import numpy as np
    import torch

    readings = dist_compare(name, recs, ref, out,
                            key=layout_key(layout, "fp32"))
    fp = [r[layout_key(layout, "fp32")] for r in recs]
    bf = [r[layout_key(layout, "bf16")] for r in recs]
    emit("dist_city", layout=name, backend=backend,
         cards=torch.cuda.device_count(), **where, **readings,
         bf16_losses=[r["losses"] for r in bf],
         fp32_step_ms_per_rank=[r["step_ms"] for r in fp],
         bf16_step_ms_per_rank=[r["step_ms"] for r in bf],
         timing_note=SHARED_CARD if backend == "gloo"
         and torch.cuda.device_count() < len(recs) else "one card per rank",
         peak_memory_bytes_per_rank=[r["max_memory_allocated_bytes"]
                                     for r in bf],
         launches_rank0=bf[0]["launches"])
    require(all(np.isfinite(r["losses"]).all() for r in bf),
            f"dist {name}: non-finite bf16 losses")
    for runs, steps in ((fp, len(ref["losses"])), (bf, 1)):
        want = dist_step_launches(steps)
        require(all(r["launches"] == want for r in runs),
                f"dist {name}: launches per rank "
                f"{[r['launches'] for r in runs]}, want {want}")
    return {"dist_" + name: {k: sum(r["launches"][k] for r in bf)
                             for k in want}}


def dist_step_launches(steps: int) -> dict:
    """A node-TP rank's launches in ``steps`` train steps of the city
    model (4 x 2 layers, two fixed supports and the mask, order 2): kernel
    1 per hop forward and per hop dx (the last layer's diffusion gets no
    backward), kernel 2 per hop of the mask in the backward; a sharded
    support has no fused pair, so no kernel 3."""
    layers, sups, order = 8, 3, 2
    return {"mix_flat": steps * order * sups * (2 * layers - 1),
            "mix_flat2": 0, "outer_flat": steps * order * (layers - 1),
            "mix_padded": 0, "outer_padded": 0}


def dist_cli_paths(tmp: str, graph) -> tuple:
    """The city graph the training CLI reads (``phase_train``'s, written
    here when missing) and the CLI comparison's dataset
    (``DIST_CLI_SAMPLES``)."""
    from graph_wavenet_tpu_torch.graphs import city

    pos, src, dst, w = graph
    gpath = os.path.join(tmp, "train_graph.npz")
    data_dir = os.path.join(tmp, "dist_cli_data")
    if not os.path.exists(gpath):
        city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_CITY)
    write_city_data(data_dir, N_CITY, DIST_CLI_SAMPLES)
    return gpath, data_dir


def dist_city_cli(tmp: str, paths: tuple,
                  learning_rate: float | None = None, beside=None) -> dict:
    """``torchrun --nproc_per_node 2 -m ...cli.train --mesh_model 2`` (gloo
    with one card, else NCCL) and the same run in one process, fp32,
    dropout 0, one epoch of ``DIST_CLI_SAMPLES``; both checkpoints served
    here. ``learning_rate``: the CLIs' ``--learning_rate`` (default the
    CLI's); at 0 the checkpoints differ only in BatchNorm's running
    statistics, which separates Adam's first update from node-TP's
    forward in the gap (ROADMAP.md §3), e.g.
    ``dist_city_cli(tmp, dist_cli_paths(tmp, city_graph(N_CITY)), 0.0)``
    after ``phase_card()`` and ``phase_build()``. ``beside()``, where
    given, runs in this process after the one-process run, while the
    torchrun ranks go on."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.train import serving

    gpath, data_dir = paths
    argv = ["--graph_npz", gpath, "--data", data_dir, "--gcn_bool",
            "--addaptadj", "--sparse", "flat", "--batch_size",
            str(TRAIN_BATCH), "--seq_length", "12", "--epochs", "1",
            "--dropout", "0.0", "--print_every", "100", "--device", "cuda"]
    if learning_rate is not None:
        argv += ["--learning_rate", str(learning_rate)]
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    save_tp = os.path.join(tmp, "dist_cli_tp")
    tp = Together({"tp": torchrun_argv(argv + ["--mesh_model", "2"],
                                       save_tp)}, tmp)
    try:
        t1 = time.perf_counter()
        one = train.main(argv + ["--save", os.path.join(tmp,
                                                        "dist_cli_one")])
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t1
        ck_one = one["result"].best_checkpoint
        del one
        torch.cuda.empty_cache()
        if beside is not None:
            beside()
        (stdout, tp_s), = tp.wait().values()
    finally:
        tp.close()
    x = np.random.default_rng(8).normal(
        50.0, 10.0, size=(2, 12, N_CITY, 2)).astype(np.float32)
    preds = {}
    for k, path in (("tp", only_checkpoint(save_tp)), ("one", ck_one)):
        fc = serving.Forecaster.from_city_checkpoint(path, gpath,
                                                     device="cuda")
        preds[k] = fc.predict(x).cpu().numpy()
        del fc
    torch.cuda.empty_cache()
    scale = float(np.abs(preds["one"]).max())
    err = float(np.abs(preds["tp"] - preds["one"]).max())
    emit("dist_city_cli", ranks=2, model=2, backend=backend,
         learning_rate=learning_rate,
         tp_seconds=round(tp_s, 3), one_process_seconds=round(one_s, 3),
         forecast_shape=list(preds["tp"].shape), max_abs_diff=err,
         forecast_max_abs=scale, tolerance="1e-4 x max|one-process forecast|",
         rank0_lines=[ln for ln in stdout.splitlines()
                      if ln.startswith(("mesh:", "node-TP", "Epoch"))])
    require(np.isfinite(preds["tp"]).all() and err <= 1e-4 * scale,
            f"the node-TP checkpoint's forecast differs by {err} "
            f"(scale {scale})")
    return {}


class Together:
    """Every named command (an argv, run from the repository root) started
    at once, each bounded by DIST_TIMEOUT from the start, its output in
    ``out``. ``wait()`` waits for all and returns {name: (stdout,
    seconds)}, raising with a failed command's output; ``close()`` kills
    what is left (``wait`` does on a timeout or a failure)."""

    def __init__(self, cmds: dict, out: str):
        env = dict(os.environ, PYTHONPATH=REPO)
        self.cmds, self.t0 = cmds, time.perf_counter()
        self.procs, self.logs = {}, {}
        try:
            for name, argv in cmds.items():
                self.logs[name] = [open(os.path.join(out, f"{name}.{k}"),
                                        "w+") for k in ("out", "err")]
                self.procs[name] = subprocess.Popen(
                    argv, cwd=REPO, env=env, stdout=self.logs[name][0],
                    stderr=self.logs[name][1], text=True)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self) -> dict:
        secs = {}
        try:
            while len(secs) < len(self.procs):
                for name, p in self.procs.items():
                    if name not in secs and p.poll() is not None:
                        secs[name] = time.perf_counter() - self.t0
                require(time.perf_counter() - self.t0 < DIST_TIMEOUT,
                        f"{sorted(set(self.procs) - set(secs))} outlived "
                        f"{DIST_TIMEOUT} s")
                time.sleep(0.2)
        finally:
            self.close()
        result = {}
        for name, p in self.procs.items():
            text = []
            for f in self.logs[name]:
                f.seek(0)
                text.append(f.read())
                f.close()
            require(p.returncode == 0, f"{name} ({' '.join(self.cmds[name][:6])}"
                    f" ...) failed: " + text[0][-3000:] + text[1][-3000:])
            result[name] = (text[0], secs[name])
        return result


def run_together(cmds: dict, out: str) -> dict:
    """:class:`Together`'s commands, waited for."""
    return Together(cmds, out).wait()


def torchrun_argv(argv: list, save: str, ranks: int = 2) -> list:
    """The training CLI under torchrun on this machine (NCCL where every
    rank has a card, else gloo)."""
    import torch

    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(ranks), "-m",
            "graph_wavenet_tpu_torch.cli.train", *argv, "--dist_backend",
            backend, "--save", save]


def test_mae(stdout: str) -> float:
    """The average test MAE a training CLI printed."""
    line = [ln for ln in stdout.splitlines()
            if ln.startswith("On average over seq_length horizons")][-1]
    return float(line.split("Test MAE: ")[1].split(",")[0])


def dist_cli_more(tmp: str) -> Together:
    """Three more training CLIs under torchrun with 2 ranks, started
    together (the caller waits with ``dist_cli_more_check``):
    the city model with the adaptive adjacency alone under node-TP
    (``--aptonly``, the 2,048-node graph of ``phase_aptonly``, bf16) and
    the METR model under DP (``--mesh_dp``) and under dense node-TP
    (``--mesh_model 2``: 104 + 103 nodes) on ``phase_metr_cli``'s data,
    bf16; each test MAE finite and within ``CLI_MAE_RTOL`` of the
    one-process run's of the same flags (``phase_aptonly``'s and
    ``phase_dist_nccl1``'s plain run, ``ONE_PROCESS_TEST_MAE``)."""
    from graph_wavenet_tpu_torch.graphs import city

    gpath = os.path.join(tmp, "aptonly_graph.npz")
    data_dir = os.path.join(tmp, "aptonly_data")
    if not os.path.exists(gpath):
        pos, src, dst, w = city_graph(N_SMALL)
        city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_SMALL)
        write_city_data(data_dir, N_SMALL)
    common = ["--dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
              "--seq_length", "12", "--epochs", "1", "--print_every", "100",
              "--device", "cuda"]
    dense = list(common)
    dense[3] = str(DENSE_BATCH)
    metr = ["--data", os.path.join(tmp, "METR"), "--adjdata",
            os.path.join(tmp, "adj_mx.pkl"), "--num_nodes",
            str(DENSE_NODES), "--gcn_bool", "--addaptadj", *dense]
    return Together({
        "aptonly": torchrun_argv(
            ["--graph_npz", gpath, "--data", data_dir, "--gcn_bool",
             "--addaptadj", "--aptonly", "--sparse", "flat", "--mesh_model",
             "2", *common], os.path.join(tmp, "dist_aptonly")),
        "metr_dp2": torchrun_argv(
            metr + ["--mesh_dp"], os.path.join(tmp, "dist_metr_cli")),
        "metr_tp2": torchrun_argv(
            metr + ["--mesh_model", "2"],
            os.path.join(tmp, "dist_metr_tp_cli"))}, tmp)


def dist_cli_more_check(started: Together) -> None:
    """Wait for ``dist_cli_more``'s runs and hold each test MAE to the
    one-process run's of its flags (the dense node-TP run to the plain
    METR run's)."""
    import numpy as np

    runs = started.wait()
    one = dict(ONE_PROCESS_TEST_MAE, metr_tp2=ONE_PROCESS_TEST_MAE["metr_dp2"])
    names = {"aptonly": "city_aptonly_tp2", "metr_dp2": "metr_dp2",
             "metr_tp2": "metr_tp2"}
    maes = {names[k]: test_mae(out) for k, (out, _) in runs.items()}
    rel = {k: abs(v - one[k]) / one[k] for k, v in maes.items()}
    emit("dist_cli", runs={"city_aptonly_tp2": N_SMALL,
                           "metr_dp2": DENSE_NODES, "metr_tp2": DENSE_NODES},
         test_mae=maes, test_mae_one_process=ONE_PROCESS_TEST_MAE,
         test_mae_rel_diff=rel, tolerance=f"rtol {CLI_MAE_RTOL}",
         seconds={names[k]: round(secs, 3)
                  for k, (_, secs) in runs.items()},
         mesh_lines=[ln for out, _ in runs.values()
                     for ln in out.splitlines()
                     if ln.startswith(("mesh:", "node-TP"))])
    require("exchange: reduce-scatter (dense rows, 207 nodes as [104, 103])"
            in runs["metr_tp2"][0],
            "the METR --mesh_model 2 run did not print its node ranges")
    require(all(np.isfinite(v) and rel[k] <= CLI_MAE_RTOL
                for k, v in maes.items()),
            f"test MAE under torchrun {maes} against one process "
            f"{ONE_PROCESS_TEST_MAE}")


# dense node-TP's layouts of ``dist_metr``'s 4 processes, run in turn:
# (name, model axis); the data axis takes the rest
METR_LAYOUTS = (("d2_m2", 2), ("m4", 4))
# the first step's gradients against the single process, per tensor over
# its largest magnitude (the dense model has no mask cotangent:
# ``GRAD_RTOL`` is the city's)
METR_GRAD_RTOL = 1e-4


def dense_exchange(cfg, batch: int, data: int, model: int,
                   time_axis: int = 1, t_in: int = 13) -> dict:
    """What a rank of a dense node-TP layout sends a train step through the
    node exchange (fp32 partials), from the shapes: per hop, forward, the
    reduce-scatter's (S-1)/S of the (S * ceil(N/S), B/D, T, C) partial;
    backward the all_gather of the cotangent's block to the other S-1
    ranks, for every layer but the last (whose diffusion reaches no loss);
    under remat every layer but the first exchanges again in its
    recompute. T is the layer's width (under time SP the rank's block).
    ``t_in``: the input steps after the engine's pad."""
    from graph_wavenet_tpu_torch.parallel import halo

    p = -(-cfg.num_nodes // model)
    hops = cfg.supports_len * cfg.diffusion_order
    dils = cfg.dilations()
    t = max(t_in, cfg.receptive_field)
    if time_axis > 1:
        widths = [halo.padded_width(t, time_axis) // time_axis] * len(dils)
    else:
        widths = []
        for d in dils:
            t -= d * (cfg.kernel_size - 1)
            widths.append(t)
    row = (model - 1) * p * (batch // data) * cfg.dilation_channels * 4
    fwd = row * hops * sum(widths)
    bwd = row * hops * sum(widths[:-1])
    again = row * hops * sum(widths[1:]) if cfg.remat else 0
    return {"node_exchange_bytes_sent_per_step": fwd + bwd + again,
            "forward_bytes": fwd, "backward_bytes": bwd,
            "remat_recompute_bytes": again,
            "exchanges_per_step": hops * (2 * len(dils) - 1
                                          + (len(dils) - 1) * cfg.remat)}


def node_counts(n: int, model: int) -> list:
    """The real nodes of each of ``model`` ranks (``Mesh.node_counts``)."""
    import torch

    from graph_wavenet_tpu_torch.parallel.mesh import Mesh

    return Mesh(1, model, 0, torch.device("cpu")).node_counts(n)


def phase_dist_metr() -> dict:
    """Dense node-TP of the METR model at ``bench.py``'s width (207 nodes,
    batch 64, the supports and the adaptive adjacency; fp32 ``fused``):
    one set of 4 processes (gloo, the ranks sharing the card) runs the
    layouts of ``METR_LAYOUTS`` in turn, 2 data x 2 model (104 + 103 nodes)
    and 4 model (52 + 52 + 52 + 51), each 2 fp32 steps with dropout 0
    against the single process (``dist_compare``: losses rtol 1e-5, the
    first step's gradients within ``METR_GRAD_RTOL`` of each tensor's
    largest, the ranks bit for bit), then one bf16 step with dropout 0.3
    timed per rank (not a scaling number), peak memory per rank and the
    bytes a rank sends a step (``dense_exchange``)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig

    runs = [dict(name="fp32", dtype="float32", dropout=0.0, steps=2,
                 keep_state=True),
            dict(name="bf16", dtype="bfloat16", dropout=0.3, steps=1)]
    cfg = ModelConfig(num_nodes=DENSE_NODES, residual_channels=32,
                      dilation_channels=32, skip_channels=256,
                      end_channels=512, blocks=4, layers=2)
    with tempfile.TemporaryDirectory(prefix="gwt_dist_metr_") as tmp:
        (first, s0), *rest = METR_LAYOUTS
        group = start_dist_group(
            "metr", tmp, 4, s0, "metr", runs, more=tuple(
                dict(name=n, model=m, time=1) for n, m in rest))
        try:
            ref = single_reference("metr")
        except BaseException:
            group.close()
            raise
        backend, recs, secs = group.wait()
        for i, (name, model) in enumerate(METR_LAYOUTS):
            lay = "" if i == 0 else name
            readings = dist_compare(
                f"metr {name}", recs, ref,
                os.path.join(tmp, "dist_metr", lay),
                key=layout_key(lay, "fp32"), grad_rtol=METR_GRAD_RTOL)
            bf = [r[layout_key(lay, "bf16")] for r in recs]
            shared = backend == "gloo" and torch.cuda.device_count() < 4
            emit("dist_metr", layout=name, ranks=4, data=4 // model,
                 model=model, backend=backend, nodes=DENSE_NODES,
                 node_counts=node_counts(DENSE_NODES, model),
                 batch=DENSE_BATCH, seconds_group=round(secs, 3),
                 **readings,
                 exchange=dense_exchange(cfg, DENSE_BATCH, 4 // model,
                                         model),
                 fp32_peak_memory_bytes_per_rank=[
                     r[layout_key(lay, "fp32")]["max_memory_allocated_bytes"]
                     for r in recs],
                 fp32_peak_memory_bytes_single_process=ref[
                     "max_memory_allocated_bytes"],
                 bf16_losses=[r["losses"] for r in bf],
                 bf16_step_ms_per_rank=[r["step_ms"][0] for r in bf],
                 timing_note=SHARED_CARD if shared else "one card per rank",
                 bf16_peak_memory_bytes_per_rank=[
                     r["max_memory_allocated_bytes"] for r in bf])
            require(all(np.isfinite(r["losses"]).all() for r in bf),
                    f"dist metr {name}: non-finite bf16 losses")
    return {}


# the pipeline's layouts of ``dist_pipe``'s 4 processes, run in turn:
# (name, stages, micro-batches); the data axis takes the rest
PIPE_LAYOUTS = (("d2_p2", 2, 2), ("p4", 4, 4))
# the pipelined eval forward over flat supports: ``phase_small_e2e``'s
# 2,048-node fp32 city model on 2 stages (so 2 data ranks), 2 micro-batches
# of a batch of 8: a rank's layers run at R = 2 x T x 32, from 768 down,
# so the dispatch rule launches kernel 3 for stage 0's first three layers
# (R >= 512) and two kernel-1 launches a support everywhere else
PIPE_EVAL = dict(stages=2, n_micro=2, batch=8)
# the first step's gradients of a pipeline step against one process's
# ``train_step_accum``, per tensor over its largest magnitude: the city's
# bar. At these widths the adaptive embeddings' gradients are cancellation
# results (nodevec1's largest 3.5e-8, nodevec2's 1.4e-6 on the CPU, the
# SVD-initialized embeddings): one process's accumulation step against
# itself with each micro-batch's rows in reverse order reads 8.9e-3
# (nodevec2) and 3.0e-3 (nodevec1) on the CPU, and ``accum_floor`` reads
# it on the card beside every ``dist_pipe`` line
PIPE_GRAD_RTOL = GRAD_RTOL


def accum_floor(ref: dict, n_micro: int) -> dict:
    """fp32's floor under a ``dist_pipe`` gradient check: one process's
    first ``train_step_accum`` of the METR model (dropout 0, deterministic
    algorithms) with each micro-batch's rows in reverse order, the same
    sums in another order, against ``ref`` (``single_reference``): per
    tensor, the error over its largest magnitude (``grad_errors``)."""
    import numpy as np
    import torch

    eng, sups, x, y = dist_engine("metr", "float32", 0.0, "cuda", None)
    mb = x.shape[0] // n_micro
    rows = np.concatenate([np.arange((i + 1) * mb - 1, i * mb - 1, -1)
                           for i in range(n_micro)])
    grads = recorded_grads(eng)
    with deterministic(True):
        train_once(eng, sups, *(torch.as_tensor(a[rows], device="cuda")
                                for a in (x, y)), n_micro)
    err, _ = grad_errors(grads, ref["grad1"])
    del eng, sups
    torch.cuda.empty_cache()
    return err


def pipe_eval_inputs(device):
    """(model, supports, x) of the pipelined eval forward:
    ``phase_small_e2e``'s model (seed 0) and RCM supports, and a batch of
    windows in model node order."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.models.gwnet import GWNet

    pos, src, dst, w = city_graph(N_SMALL)
    sups, _, _ = build_city_supports(src, dst, w, N_SMALL, pos=pos,
                                     ordering="rcm", device=device)
    cfg = ModelConfig(num_nodes=N_SMALL, addaptadj=False, dropout=0.0,
                      dtype="float32")
    x = np.random.default_rng(15).normal(
        size=(PIPE_EVAL["batch"], 12, N_SMALL, 2)).astype(np.float32)
    return (GWNet(cfg, device=device, seed=0).eval(), sups,
            torch.as_tensor(x, device=device))


def pipe_eval_worker(spec: dict, rank: int, dev) -> dict:
    """A ``dist_pipe`` rank's pipelined eval forward (``PIPE_EVAL``): its
    output rows to ``pipe_eval_rank<r>.npy``; its launches, rows and
    stage."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        pipeline_apply,
    )

    mesh = make_pipeline_mesh(PIPE_EVAL["stages"], dev,
                              timeout_s=DIST_TIMEOUT)
    model, sups, x = pipe_eval_inputs(dev)
    mesh.barrier()
    reset_launches()
    with torch.no_grad():
        out = pipeline_apply(model, x, sups, mesh=mesh,
                             n_micro=PIPE_EVAL["n_micro"])
    torch.cuda.synchronize()
    launches = kernel_launches()
    np.save(os.path.join(spec["out"], f"pipe_eval_rank{rank}.npy"),
            out.cpu().numpy())
    return {"launches": launches, "stage": mesh.pipe_index,
            "holds": mesh.pipe_index == mesh.pipe - 1,
            "rows": mesh.batch_rows(PIPE_EVAL["batch"],
                                    PIPE_EVAL["n_micro"]).tolist()}


def pipe_eval_check(out: str, recs: list) -> dict:
    """The pipelined eval forward's last stages against the one-process
    forward on the card: within 2e-4 of its scale of the full batch's, and
    (a reading) bit for bit the forward of the rank's micro-batches, each
    run alone; every rank's launches those its stage's layers imply at
    their R (``forward_launches``). Returns the ``dist_pipe`` window: the
    ranks' launches summed."""
    import numpy as np
    import torch

    model, sups, x = pipe_eval_inputs("cuda")
    cfg, n_micro = model.cfg, PIPE_EVAL["n_micro"]
    lps = len(cfg.dilations()) // PIPE_EVAL["stages"]
    with torch.no_grad():
        full = model(x, sups)
    scale = float(full.abs().max())
    errs, bitwise, window = [], [], {}
    for r, rec in enumerate(recs):
        ev = rec["pipe_eval"]
        share = len(ev["rows"]) // n_micro
        widths = layer_widths(cfg, share)[ev["stage"] * lps:
                                          (ev["stage"] + 1) * lps]
        want = {k: n_micro * v for k, v in forward_launches(
            sups, widths, torch.float32).items()}
        require(ev["launches"] == want,
                f"dist pipe eval rank {r}: launches {ev['launches']}, the "
                f"stage's layers imply {want}")
        for k, v in ev["launches"].items():
            window[k] = window.get(k, 0) + v
        if not ev["holds"]:
            continue
        got = torch.as_tensor(np.load(os.path.join(
            out, f"pipe_eval_rank{r}.npy")), device="cuda")
        rows = torch.as_tensor(ev["rows"], device="cuda")
        errs.append(float((got - full[rows]).abs().max()) / scale)
        with torch.no_grad():
            alone = torch.cat([model(x[part], sups)
                               for part in rows.chunk(n_micro)])
        bitwise.append(bool(torch.equal(got, alone)))
    emit("dist_pipe_eval", nodes=N_SMALL, dtype="float32", **PIPE_EVAL,
         ranks=len(recs), max_err_rel_scale=errs,
         bitwise_equal_micro_batch_forward=bitwise,
         tolerance="2e-4 x max|one-process forward|",
         launches_window=window,
         launches_per_rank=[r["pipe_eval"]["launches"] for r in recs])
    require(len(errs) == len(recs) // PIPE_EVAL["stages"]
            and max(errs) <= 2e-4,
            f"the pipelined eval forward differs by {errs} of its scale")
    return {"dist_pipe": window}


def phase_dist_pipe() -> dict:
    """The GPipe pipeline (``parallel.pipeline``) on one set of 4 processes
    (gloo, the ranks sharing the card; NCCL where every rank has a card):
    ``bench.py``'s METR model (207 nodes, batch 64, the supports and the
    adaptive adjacency) on 2 data x 2 stages with 2 micro-batches and on 4
    stages with 4 (``PIPE_LAYOUTS``), each 2 fp32 steps with dropout 0
    against one process's ``train_step_accum`` with the same ``n_micro``
    (``dist_compare``: losses rtol 1e-5, the first step's gradients within
    ``PIPE_GRAD_RTOL`` of each tensor's largest, beside fp32's floor
    ``accum_floor``, the ranks bit for bit), then one bf16 step with
    dropout 0.3 a rank timed with its peak memory (not a scaling number);
    then the pipelined eval forward over flat supports (``PIPE_EVAL``,
    ``pipe_eval_check``). The one-process references run while the ranks
    do. Returns the eval forward's
    launches (the ``dist_pipe`` window)."""
    import numpy as np
    import torch

    runs = [dict(name="fp32", dtype="float32", dropout=0.0, steps=2,
                 keep_state=True),
            dict(name="bf16", dtype="bfloat16", dropout=0.3, steps=1)]
    with tempfile.TemporaryDirectory(prefix="gwt_dist_pipe_") as tmp:
        (_, s0, m0), *rest = PIPE_LAYOUTS
        group = start_dist_group(
            "pipe", tmp, 4, 1, "metr", runs, pipe=s0, n_micro=m0,
            pipe_eval=True, more=tuple(
                dict(name=n, model=1, time=1, pipe=s, n_micro=m)
                for n, s, m in rest))
        try:
            refs = {m: single_reference("metr", n_micro=m)
                    for _, _, m in PIPE_LAYOUTS}
            floors = {m: accum_floor(refs[m], m) for m in refs}
        except BaseException:
            group.close()
            raise
        backend, recs, secs = group.wait()
        shared = backend == "gloo" and torch.cuda.device_count() < 4
        for i, (name, stages, n_micro) in enumerate(PIPE_LAYOUTS):
            lay = "" if i == 0 else name
            readings = dist_compare(
                f"pipe {name}", recs, refs[n_micro],
                os.path.join(tmp, "dist_pipe", lay),
                key=layout_key(lay, "fp32"), grad_rtol=PIPE_GRAD_RTOL)
            bf = [r[layout_key(lay, "bf16")] for r in recs]
            emit("dist_pipe", layout=name, ranks=4, data=4 // stages,
                 stages=stages, n_micro=n_micro, backend=backend,
                 nodes=DENSE_NODES, batch=DENSE_BATCH,
                 seconds_group=round(secs, 3), **readings,
                 grad1_floor_top=top(floors[n_micro]),
                 grad1_floor_note="one process against itself, each "
                 "micro-batch's rows reversed",
                 fp32_step_ms_per_rank=[r[layout_key(lay, "fp32")]["step_ms"]
                                        for r in recs],
                 fp32_peak_memory_bytes_per_rank=[
                     r[layout_key(lay, "fp32")]["max_memory_allocated_bytes"]
                     for r in recs],
                 fp32_peak_memory_bytes_single_process=refs[n_micro][
                     "max_memory_allocated_bytes"],
                 bf16_losses=[r["losses"] for r in bf],
                 bf16_step_ms_per_rank=[r["step_ms"][0] for r in bf],
                 bf16_peak_memory_bytes_per_rank=[
                     r["max_memory_allocated_bytes"] for r in bf],
                 timing_note=SHARED_CARD if shared else "one card per rank")
            require(all(np.isfinite(r["losses"]).all() for r in bf),
                    f"dist pipe {name}: non-finite bf16 losses")
        return pipe_eval_check(os.path.join(tmp, "dist_pipe"), recs)


def phase_dist_nccl1(tmp: str) -> None:
    """``--mesh_dp`` through the training CLI under torchrun with one rank
    and NCCL against the same CLI run without a process group, all at once,
    every parameter and buffer of the checkpoints equal bit for bit, so
    every step was: the METR model (bf16, dropout 0.3, one epoch on
    ``phase_metr_cli``'s data) with ``--scan_steps 1`` and, graphed, with
    ``--scan_steps 4`` (each fused step a CUDA graph with its collectives
    captured), against the plain ``--scan_steps 1`` run; and README's
    diff-G run (``--data syn``, fp32, dropout 0.3, one epoch)
    ``--mesh_dp --scan_steps 4`` against the plain ``--scan_steps 1`` run
    (``GRAPHED_CLI``)."""
    import torch

    from graph_wavenet_tpu_torch.train import checkpoint as ckpt

    data_dir = os.path.join(tmp, "METR")
    adj = os.path.join(tmp, "adj_mx.pkl")
    metr = ["--data", data_dir, "--adjdata", adj, "--num_nodes",
            str(DENSE_NODES), "--gcn_bool", "--addaptadj", "--dtype",
            "bfloat16", "--seq_length", "12", "--batch_size",
            str(DENSE_BATCH), "--epochs", "1", "--print_every", "100",
            "--device", "cuda"]
    subjects = [a for k, v in DIFFG_SUBJECTS.items()
                for a in (f"--{k}", str(v))]
    syn = ["--data", "syn", *DIFFG_ARGV, *subjects, "--epochs", "1",
           "--print_every", "100"]
    one_nccl = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m",
                "graph_wavenet_tpu_torch.cli.train"]
    plain = [sys.executable, "-m", "graph_wavenet_tpu_torch.cli.train"]
    cmds = {"nccl1": one_nccl + metr + ["--mesh_dp"],
            "plain": plain + metr,
            "nccl1_graphed": one_nccl + metr + [
                "--mesh_dp", "--scan_steps", str(GRAPHED_S)],
            "syn_nccl1_graphed": one_nccl + syn + [
                "--mesh_dp", "--scan_steps", str(GRAPHED_S)],
            "syn_plain": plain + syn}
    saves = {k: os.path.join(tmp, f"nccl1_{k}") for k in cmds}
    out = run_together(
        {k: v + (["--dist_backend", "nccl"] if "nccl1" in k else [])
         + ["--save", saves[k]] for k, v in cmds.items()}, tmp)
    runs = {k: (only_checkpoint(saves[k]), secs,
                [ln for ln in stdout.splitlines()
                 if ln.startswith(("mesh:", "Epoch"))])
            for k, (stdout, secs) in out.items()}
    ONE_PROCESS_TEST_MAE["metr_dp2"] = test_mae(out["plain"][0])

    def differing(k, ref):
        a = ckpt.load_state_dict(runs[k][0], device="cpu")
        b = ckpt.load_state_dict(runs[ref][0], device="cpu")
        require(set(a) == set(b), f"{k}: other tensors than {ref}'s")
        return [n for n in b if not torch.equal(a[n], b[n])], len(b)

    differ, n = differing("nccl1", "plain")
    emit("dist_nccl1", ranks=1, backend="nccl", tensors=n,
         differing=differ, seconds={k: round(v[1], 3)
                                    for k, v in runs.items()},
         lines={k: v[2] for k, v in runs.items()})
    require(not differ, f"--mesh_dp under one NCCL rank differs from the "
            f"plain run: {differ}")
    for kind, k, ref in (("metr", "nccl1_graphed", "plain"),
                         ("diffg", "syn_nccl1_graphed", "syn_plain")):
        differ, n = differing(k, ref)
        GRAPHED_CLI[kind] = {"argv": "--mesh_dp --scan_steps "
                             f"{GRAPHED_S} against --scan_steps 1",
                             "tensors": n, "differing": differ,
                             "seconds": round(runs[k][1], 3),
                             "plain_seconds": round(runs[ref][1], 3)}
        require(not differ, f"{k}: the graphed CLI under one NCCL rank "
                f"differs from the plain run: {differ}")

# ---------------------------------------------------------------------------
# slices 7b.1 and 7b.2: the fused steps under a process group, diff-G and
# CRASH under DP, and the city step that repeats
# ---------------------------------------------------------------------------

# S of the graphed steps under the one-rank NCCL group, and of the CLIs'
# --scan_steps there
GRAPHED_S = 4
# the CLIs ``phase_dist_nccl1`` runs graphed under one NCCL rank, by the
# kind of the ``dist_graphed`` line that reports them
GRAPHED_CLI: dict = {}


def determinism_worker(graph_path: str, out: str) -> None:
    """One fresh fp32 city train step with the mask (40,960 nodes, batch 4,
    flat, dropout 0) in this process, without deterministic algorithms:
    its loss, the clipped gradients it took and the state after it, to the
    ``.npz`` at ``out``."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = np.load(graph_path)
    eng, sups, x, y = dist_engine(
        "city", "float32", 0.0, "cuda", None,
        (g["pos"], g["src"], g["dst"], g["weight"]))
    grads = recorded_grads(eng)
    require(not torch.are_deterministic_algorithms_enabled(),
            "the determinism check runs without deterministic algorithms")
    loss = float(eng.train_step(torch.as_tensor(x, device="cuda"),
                                torch.as_tensor(y, device="cuda"),
                                sups)["loss"])
    np.savez(out, loss=np.asarray(loss),
             **{"grad:" + k: v for k, v in grads.items()},
             **{"state:" + k: v for k, v in state_vector(eng).items()})


def phase_determinism(graph, tmp: str) -> None:
    """The city training step with the mask repeats bit for bit: two fresh
    child processes, started together, each take one fp32 step
    (:func:`determinism_worker`) without deterministic algorithms, and
    their losses, gradients and states must be equal bit for bit."""
    import numpy as np
    import torch

    pos, src, dst, w = graph
    gpath = os.path.join(tmp, "determinism_graph.npz")
    np.savez(gpath, pos=pos, src=src, dst=dst, weight=w)
    torch.cuda.empty_cache()
    code = ("import sys; sys.path.insert(0, sys.argv[3]); import chip_smoke;"
            " chip_smoke.determinism_worker(sys.argv[1], sys.argv[2])")
    outs = [os.path.join(tmp, f"determinism_{i}.npz") for i in range(2)]
    done = run_together({
        f"determinism_{i}": [sys.executable, "-c", code, gpath, out,
                             os.path.dirname(os.path.abspath(__file__))]
        for i, out in enumerate(outs)}, tmp)
    secs = [round(s, 3) for _, s in done.values()]
    runs = [dict(np.load(out)) for out in outs]
    a, b = runs
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    worst = {k: float(np.abs(a[k] - b[k]).max()) for k in differ}
    emit("determinism", nodes=N_CITY, batch=TRAIN_BATCH, dtype="float32",
         dropout=0.0, form="flat", deterministic_algorithms=False,
         processes=2, losses=[float(r["loss"]) for r in runs],
         tensors=len(a), differing=differ, max_abs_diff=top(worst),
         child_seconds=secs, tolerance="bit for bit")
    require(not differ, f"two fresh city steps differ without deterministic "
            f"algorithms: {top(worst, 3)}")


def graphed_case(eager, graphed, fused_call, eager_step, s: int,
                 node_steps: int, eager_reps: int = 6) -> dict:
    """``fused_call()`` (S graphed steps) on ``graphed`` against S calls of
    ``eager_step(k)`` on ``eager`` from the same start, bit for bit
    (metrics, weights, buffers, Adam, the generator), with the hand-kernel
    launches of both windows; then ms per step, node-timesteps/s and the
    profiled device idle share of each."""
    import torch

    reset_launches()
    got = metric_rows(fused_call())
    torch.cuda.synchronize()
    n_graphed = graphed_window_launches(graphed, kernel_launches())
    reset_launches()
    want = torch.cat([metric_rows(eager_step(k)) for k in range(s)], 1)
    torch.cuda.synchronize()
    rec = {"scan_steps": s,
           "max_abs_metric_diff": float((got - want).abs().max()),
           "first_state_difference": first_difference(step_state(graphed),
                                                       step_state(eager)),
           "graphed_window_launches": n_graphed,
           "eager_window_launches": kernel_launches(),
           "per_replay_launches": dict(graphed.step_graphs()[0].launches)}
    it = {"k": 0}

    def one_eager():
        it["k"] += 1
        return eager_step(it["k"] % s)

    for mode, fn, reps, per in (("eager", one_eager, eager_reps, 1),
                                ("graphed", fused_call, 2, s)):
        t = timed_steps(fn, reps, per)
        prof = profile_step(fn)
        rec[mode] = {"median_ms": t["median_ms"], "min_ms": t["min_ms"],
                     "node_timesteps_per_s": node_steps
                     / (t["median_ms"] / 1e3),
                     "device_busy_ms_per_step": prof["device_busy_ms"] / per,
                     "device_idle_share": prof["device_idle_share"],
                     "max_memory_reserved_bytes":
                     t["max_memory_reserved_bytes"]}
    return rec


def graphed_worker(spec_path: str, rank: int) -> None:
    """The one rank of an NCCL group (started by ``dist_group``): on a
    one-rank mesh, the graphed train steps (``GRAPHED_S`` replayed per
    fused call, the step's collectives captured) against eager ones, bit
    for bit and timed, without deterministic algorithms, for the METR
    model at ``bench.py``'s width (bf16, dropout 0.3), the city training
    cell (flat, the mask, bf16, dropout 0.3: kernels 1, 2 and 3 in the
    replays) and README's diff-G run (fp32, dropout 0.3)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.config import MeshConfig, ModelConfig
    from graph_wavenet_tpu_torch.config import TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh
    from graph_wavenet_tpu_torch.train.engine import Engine

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layout = multihost.initialize(spec["backend"], rank, spec["world"],
                                  spec["init"], device="cuda",
                                  timeout_s=DIST_TIMEOUT)
    import torch.distributed as dist

    dev = multihost.rank_device("cuda")
    mesh = make_mesh(MeshConfig(), dev, timeout_s=DIST_TIMEOUT)
    out = {"backend": dist.get_backend(), "ranks": layout["process_count"],
           "deterministic_algorithms":
           torch.are_deterministic_algorithms_enabled()}
    s = GRAPHED_S
    rng = np.random.default_rng(12)

    def pair(cfg, scaler, **kw):
        return [Engine(cfg, TrainConfig(), scaler, device=dev, seed=0,
                       mesh=mesh, **kw) for _ in range(2)]

    # the METR model
    sups_np, _, _ = dense_inputs()
    n_samples = 4 * DENSE_BATCH
    xs = torch.as_tensor(rng.normal(size=(
        n_samples, 12, DENSE_NODES, 2)).astype(np.float32), device=dev)
    ys = torch.as_tensor((rng.normal(size=(
        n_samples, 12, DENSE_NODES, 2)) * 10 + 55).astype(np.float32),
        device=dev)
    sups = [torch.as_tensor(a, device=dev) for a in sups_np]
    idx = rng.integers(0, n_samples, size=(s, DENSE_BATCH)).astype(np.int32)
    rows = torch.as_tensor(idx, device=dev)
    common = dict(in_dim=2, residual_channels=32, dilation_channels=32,
                  skip_channels=256, end_channels=512, blocks=4, layers=2,
                  gcn_bool=True, addaptadj=True, n_supports=2, dropout=0.3)
    eager, graphed = pair(ModelConfig(num_nodes=DENSE_NODES, out_dim=12,
                                      dtype="bfloat16", **common),
                          StandardScaler(55.0, 10.0), aptinit=sups_np[0])
    out["metr"] = graphed_case(
        eager, graphed,
        lambda: graphed.train_steps_resident(xs, ys, idx, sups),
        lambda k: eager.train_step(xs.index_select(0, rows[k]),
                                   ys.index_select(0, rows[k]), sups),
        s, DENSE_BATCH * 12 * DENSE_NODES, eager_reps=12)
    out["metr"].update(nodes=DENSE_NODES, batch=DENSE_BATCH,
                       dtype="bfloat16")
    del eager, graphed, xs, ys, sups
    torch.cuda.empty_cache()

    # the city training cell
    g = np.load(spec["graph"])
    sup, mask, lay = build_city_supports(
        g["src"], g["dst"], g["weight"], N_CITY, pos=g["pos"], form="flat",
        addaptadj=True, device=dev)
    sups = [sp.astype(torch.bfloat16) for sp in sup] + [mask]
    n = lay["n_pad"]
    xs = torch.as_tensor(rng.normal(size=(8, 12, n, 2)).astype(np.float32),
                         device=dev)
    ys_np = rng.normal(50.0, 10.0, size=(8, 12, n, 2)).astype(np.float32)
    ys_np[rng.random(ys_np.shape) < 0.05] = 0.0
    ys = torch.as_tensor(ys_np, device=dev)
    idx = rng.integers(0, 8, size=(s, TRAIN_BATCH)).astype(np.int32)
    rows = torch.as_tensor(idx, device=dev)
    cfg = ModelConfig(num_nodes=n, addaptadj=True, dtype="bfloat16")
    eager, graphed = pair(cfg, StandardScaler(50.0, 10.0))
    out["city"] = graphed_case(
        eager, graphed,
        lambda: graphed.train_steps_resident(xs, ys, idx, sups),
        lambda k: eager.train_step(xs.index_select(0, rows[k]),
                                   ys.index_select(0, rows[k]), sups),
        s, TRAIN_BATCH * 12 * N_CITY)
    out["city"].update(nodes=N_CITY, batch=TRAIN_BATCH, dtype="bfloat16",
                       expected_per_step=expected_step_launches(
                           sups, layer_widths(cfg, TRAIN_BATCH, 13),
                           torch.bfloat16))
    del eager, graphed, xs, ys, sups, sup, mask
    torch.cuda.empty_cache()

    # README's diff-G run
    x, y, sups_np, proj = diffg_batch(7)
    n_graphs = len(proj)
    xs, ys = (torch.as_tensor(a, device=dev) for a in (x, y))
    adj = torch.as_tensor(rng.integers(0, n_graphs, size=len(x)).astype(
        np.int32), device=dev)
    sups = [torch.as_tensor(a, device=dev) for a in sups_np]
    proj = torch.as_tensor(proj, device=dev)
    idx = rng.integers(0, len(x), size=(s, DIFFG_BATCH)).astype(np.int32)
    rows = torch.as_tensor(idx, device=dev)
    f_t = DIFFG_K // 12
    cfg = ModelConfig(num_nodes=DIFFG_NODES, out_dim=DIFFG_K,
                      start_dilation=4, **common)
    eager, graphed = pair(cfg, StandardScaler(0.5, 0.3), diff_g=True)

    def eager_step(k):
        gids = adj.index_select(0, rows[k])
        return eager.train_step_syn(
            xs.index_select(0, rows[k]), ys.index_select(0, rows[k]),
            [a.index_select(0, gids) for a in sups],
            proj.index_select(0, gids), f_t)

    out["diffg"] = graphed_case(
        eager, graphed,
        lambda: graphed.train_steps_syn_resident(xs, ys, idx, adj, sups,
                                                 proj, f_t),
        eager_step, s, DIFFG_BATCH * DIFFG_K * DIFFG_NODES, eager_reps=12)
    out["diffg"].update(nodes=DIFFG_NODES, batch=DIFFG_BATCH,
                        seq_length=DIFFG_K, dtype="float32")
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_dist_graphed(graph, tmp: str) -> dict:
    """The fused steps as CUDA graphs over a process group: one NCCL rank
    (a card of its own) runs :func:`graphed_worker`, the METR model, the
    city training cell and the diff-G model graphed against eager steps,
    bit for bit, with ms per step and idle share of both; each line also
    carries its CLI's check from ``phase_dist_nccl1`` (METR, diff-G). The
    city window's replays launch kernels 1, 2 and 3. Returns that
    window's launches (``dist_graphed``)."""
    import numpy as np

    pos, src, dst, w = graph
    gpath = os.path.join(tmp, "graphed_graph.npz")
    np.savez(gpath, pos=pos, src=src, dst=dst, weight=w)
    backend, recs, secs = dist_group("graphed", tmp, 1, 1, "graphed", [],
                                     gpath, worker="graphed_worker")
    rec = recs[0]
    for kind in ("metr", "city", "diffg"):
        r = rec[kind]
        emit("dist_graphed", kind=kind, backend=rec["backend"],
             ranks=rec["ranks"],
             deterministic_algorithms=rec["deterministic_algorithms"],
             seconds=round(secs, 3), cli=GRAPHED_CLI.get(kind), **r,
             graphed_over_eager=r["graphed"]["median_ms"]
             / r["eager"]["median_ms"])
        require(rec["backend"] == "nccl" and rec["ranks"] == 1,
                f"dist_graphed ran on {rec['backend']} x {rec['ranks']}")
        require(r["first_state_difference"] is None
                and r["max_abs_metric_diff"] == 0.0,
                f"graphed {kind} steps under NCCL differ from eager ones: "
                f"{r['first_state_difference']}, metrics by "
                f"{r['max_abs_metric_diff']}")
        require(r["graphed_window_launches"] == r["eager_window_launches"],
                f"{kind}: graphed window launches "
                f"{r['graphed_window_launches']} != eager "
                f"{r['eager_window_launches']}")
    city = rec["city"]
    require(city["per_replay_launches"] == city["expected_per_step"],
            f"a replayed city step under NCCL launches "
            f"{city['per_replay_launches']}, expected "
            f"{city['expected_per_step']}")
    # kernel 2 for the mask, and the order-2 pairs through kernel 1 or 3 as
    # the dispatch rule picks (the count itself is held above)
    per = city["per_replay_launches"]
    require(per["outer_flat"] > 0
            and per["mix_flat"] + per["mix_flat2"] > 0,
            f"the replays under NCCL missed kernel 2 or the pair kernels: "
            f"{per}")
    return {"dist_graphed": city["graphed_window_launches"]}


def phase_dist_diffg(tmp: str) -> None:
    """diff-G and CRASH under data parallelism, two gloo ranks sharing the
    card: README's diff-G run, 2 fp32 steps with dropout 0, against the
    single process (``dist_compare``: losses, first-step gradients, the
    state; the ranks bit for bit); and ``--data crash --mesh_dp`` under
    torchrun, its test MAE within ``CLI_MAE_RTOL`` of ``phase_diffg``'s
    one-process run of the same flags, run beside the group."""
    import torch

    # the CLI runs beside the rank group
    cli = Together({"crash": torchrun_argv(
        ["--data", "crash", *DIFFG_ARGV, "--epochs", "1", "--mesh_dp"],
        os.path.join(tmp, "dist_crash"))}, tmp)
    try:
        ref = single_reference("diffg")
        runs = [dict(name="fp32", dtype="float32", dropout=0.0, steps=2,
                     keep_state=True)]
        backend, recs, secs = dist_group("diffg", tmp, 2, 1, "diffg", runs)
        readings = dist_compare("diffg", recs, ref,
                                os.path.join(tmp, "dist_diffg"))
        (stdout, crash_s), = cli.wait().values()
    finally:
        cli.close()
    mae = test_mae(stdout)
    want = ONE_PROCESS_TEST_MAE["crash_dp2"]
    rel = abs(mae - want) / want
    shared = backend == "gloo" and torch.cuda.device_count() < 2
    emit("dist_diffg", ranks=2, data=2, model=1, backend=backend,
         nodes=DIFFG_NODES, seq_length=DIFFG_K, batch=DIFFG_BATCH,
         seconds=round(secs, 3), **readings,
         timing_note=SHARED_CARD if shared else "one card per rank",
         crash_test_mae=mae, crash_test_mae_one_process=want,
         crash_test_mae_rel_diff=rel, crash_tolerance=f"rtol {CLI_MAE_RTOL}",
         crash_seconds=round(crash_s, 3),
         mesh_lines=[ln for ln in stdout.splitlines()
                     if ln.startswith("mesh:")])
    require(math.isfinite(mae) and rel <= CLI_MAE_RTOL,
            f"--data crash under 2 DP ranks: test MAE {mae}, one process "
            f"{want}")


# ---------------------------------------------------------------------------
# slice 7b.3: time-halo sequence parallelism
# ---------------------------------------------------------------------------

# the CRASH-scale diff-G step: JAX tests/test_parallel.py:288-335's stack
# (K = 2,912, the reference's window; 13 blocks x 3 layers from dilation
# 32, receptive field 2,913) at the CLI's widths (nhid 32: 32/32/256/512)
# over 200 regions, per-sample supports and the adaptive adjacency, remat
# on both sides; batch 4 (JAX's test batch, F_t 4 as there)
CRASH_K, CRASH_NODES, CRASH_BATCH, CRASH_F_T = 2912, 200, 4, 4
# the data x model x time layout's depth: 4 of the 13 blocks (K = 896,
# receptive field 897). Under remat its node exchanges run three times a
# step (forward, recompute, backward), all through host memory on gloo:
# at 13 blocks ~26 GB a rank a step, at 4 about a tenth
CRASH_BLOCKS_MXT = 4
# (name, ranks, model axis, time axis, kind): 4 time ranks at the full
# depth, and 2 data x 2 model x 2 time at ``CRASH_BLOCKS_MXT`` blocks
TIME_LAYOUTS = (("t4", 4, 1, 4, "crash"), ("d2_m2_t2", 8, 2, 2, "crash4"))


def crash_cfg(blocks: int = 13, **kw):
    """The CRASH-scale diff-G configuration (``CRASH_*``), or its first
    ``blocks`` blocks with the window their receptive field collapses
    (K = 224 x blocks)."""
    from graph_wavenet_tpu_torch.config import ModelConfig

    k = 224 * blocks
    return ModelConfig(
        num_nodes=CRASH_NODES, in_dim=2, out_dim=k,
        residual_channels=32, dilation_channels=32, skip_channels=256,
        end_channels=512, blocks=blocks, layers=3, start_dilation=32,
        gcn_bool=True, addaptadj=True, n_supports=2, remat=True, **kw)


def time_exchange(cfg, batch: int, data: int, time_axis: int,
                  params: int, nodes: int | None = None) -> dict:
    """What a rank of a data (x model) x time layout moves a train step
    (fp32 activations), from the shapes: the halo steps it sends forward
    and their cotangents backward (``dilation * (k-1)`` steps of (B/D,
    ``nodes``, C) a layer and direction, ``nodes`` the rank's, default
    all; the first rank sends none back, the last none forward),
    BatchNorm's two sums and their cotangents a layer, the gradient
    all-reduce; and the share of the steps the stack computes that are
    garbage (static blocks of the padded axis against the single process's
    valid steps)."""
    from graph_wavenet_tpu_torch.parallel import halo

    halos = [d * (cfg.kernel_size - 1) for d in cfg.dilations()]
    l0 = max(cfg.out_dim + 1, cfg.receptive_field)
    width = halo.padded_width(l0, time_axis) // time_axis
    nodes = cfg.num_nodes if nodes is None else nodes
    row = batch // data * nodes * cfg.residual_channels * 4
    valid, t = 0, l0
    for h in halos:
        t -= h
        valid += t
    return {"halo_bytes_sent_per_step": row * sum(halos),
            "halo_bytes_sent_per_step_both_directions":
            2 * row * sum(halos),
            "batchnorm_allreduce_bytes": 4 * 4 * cfg.residual_channels
            * len(halos),
            "gradient_allreduce_bytes": 4 * params,
            "block_steps": width, "padded_steps": width * time_axis,
            "garbage_step_share": 1.0 - valid / (width * time_axis
                                                 * len(halos)),
            "single_process_steps_per_layer_mean": valid / len(halos)}


def dist_time_groups(tmp: str) -> None:
    """``phase_dist_time``'s rank groups (``TIME_LAYOUTS``), each against
    the single process of its depth."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch.models.gwnet_diff_g import GWNetDiffG

    runs = [dict(name="fp32", dtype="float32", dropout=0.0, steps=2,
                 keep_state=True),
            dict(name="bf16", dtype="bfloat16", dropout=0.3, steps=1)]
    for name, world, model, time_axis, kind in TIME_LAYOUTS:
        # the single process of the group's depth runs while its ranks do
        group = start_dist_group(name, tmp, world, model, kind, runs,
                                 time_axis=time_axis)
        try:
            ref = single_reference(kind)
        except BaseException:
            group.close()
            raise
        cfg = crash_cfg(13 if kind == "crash" else CRASH_BLOCKS_MXT)
        params = sum(p.numel() for p in GWNetDiffG(cfg, device="cpu")
                     .parameters())
        data = world // (model * time_axis)
        backend, recs, secs = group.wait()
        readings = dist_compare(name, recs, ref,
                                os.path.join(tmp, f"dist_{name}"))
        bf = [r["bf16"] for r in recs]
        shared = backend == "gloo" and torch.cuda.device_count() < world
        exchange = time_exchange(cfg, CRASH_BATCH, data, time_axis, params,
                                 max(node_counts(CRASH_NODES, model)))
        if model > 1:
            exchange.update(dense_exchange(cfg, CRASH_BATCH, data, model,
                                           time_axis, cfg.out_dim + 1))
        emit("dist_time", layout=name, ranks=world, data=data, model=model,
             time=time_axis, backend=backend,
             cards=torch.cuda.device_count(), seconds=round(secs, 3),
             seq_length=cfg.out_dim, blocks=cfg.blocks, nodes=CRASH_NODES,
             node_counts=node_counts(CRASH_NODES, model), batch=CRASH_BATCH,
             receptive_field=cfg.receptive_field, remat=cfg.remat,
             **readings, exchange=exchange,
             fp32_peak_memory_bytes_per_rank=[
                 r["fp32"]["max_memory_allocated_bytes"] for r in recs],
             fp32_peak_memory_bytes_single_process=ref[
                 "max_memory_allocated_bytes"],
             bf16_losses=[r["losses"] for r in bf],
             bf16_step_ms_per_rank=[r["step_ms"][0] for r in bf],
             bf16_peak_memory_bytes_per_rank=[
                 r["max_memory_allocated_bytes"] for r in bf],
             timing_note=SHARED_CARD if shared else "one card per rank")
        require(readings["loss_max_rel_err"] <= 1e-6,
                f"dist {name}: fp32 losses {readings['losses']} against "
                f"{readings['losses_single']}: over 1e-6 relative")
        require(all(np.isfinite(r["losses"]).all() for r in bf),
                f"dist {name}: non-finite bf16 losses")


def phase_dist_time(tmp: str) -> None:
    """Time-halo sequence parallelism on one card (gloo, the ranks sharing
    it): the CRASH-scale diff-G step (``CRASH_*``) on 4 time ranks, and its
    first ``CRASH_BLOCKS_MXT`` blocks on 2 data x 2 model x 2 time (8 ranks;
    dense node-TP of the per-sample supports and the adaptive adjacency on
    each time block), 2 fp32 steps with dropout 0 against the single
    process of the same depth (``dist_compare``, and the losses within 1e-6
    relative), each rank's peak memory beside the single process's, one
    bf16 step (dropout 0.3) a rank timed (not a scaling number), the bytes
    a rank exchanges a step (halo and node exchange) and the share of
    garbage steps; then ``--data syn --mesh_time 2`` under torchrun
    (``phase_diffg``'s ``--fresh_nodevec`` run of README's widths), its
    test MAE within ``CLI_MAE_RTOL`` of the one-process run's, run beside
    the groups (``dist_time_groups``)."""
    # the CLI runs beside the rank groups
    cli = Together({"syn_t2": torchrun_argv(
        ["--data", "syn", *DIFFG_ARGV, *DIFFG_FRESH_ARGV, "--mesh_time",
         "2"], os.path.join(tmp, "dist_syn_t2"))}, tmp)
    try:
        dist_time_groups(tmp)
        (stdout, secs), = cli.wait().values()
    finally:
        cli.close()
    mae = test_mae(stdout)
    want = ONE_PROCESS_TEST_MAE["syn_t2"]
    rel = abs(mae - want) / want
    emit("dist_time_cli", ranks=2, time=2, test_mae=mae,
         test_mae_one_process=want, test_mae_rel_diff=rel,
         tolerance=f"rtol {CLI_MAE_RTOL}", seconds=round(secs, 3),
         mesh_lines=[ln for ln in stdout.splitlines()
                     if ln.startswith("mesh:")])
    require("'time': 2" in stdout,
            "the torchrun run did not print a time axis of 2")
    require(math.isfinite(mae) and rel <= CLI_MAE_RTOL,
            f"--data syn --mesh_time 2 under torchrun: test MAE {mae}, one "
            f"process {want}")


# ---------------------------------------------------------------------------
# the benchmark module
# ---------------------------------------------------------------------------

BENCH_STEPS = 6
# each sparse row: its launch window, the kernels of which one at least
# must launch there (the flat row's pairs go to kernel 1 or kernel 3 as the
# dispatch rule picks), and the row's arguments
BENCH_SPARSE = (
    ("bench_flat", ("mix_flat", "mix_flat2"),
     dict(form="block-flat", graph="spatial", ordering="rcm")),
    ("bench_pallas", ("mix_padded",), dict(form="block-pallas")))
# the wrappers of kernels 1, 3 and 4, each with its op
BENCH_WRAPPERS = {"gathered_block_mix_flat": "mix_flat",
                  "gathered_block_mix_flat2": "mix_flat2",
                  "gathered_block_mix": "mix_padded"}
PLAIN = ("mix_flat_plain", "mix_flat2_plain", "outer_flat_plain",
         "mix_padded_plain", "outer_padded_plain")


@contextlib.contextmanager
def bench_watch():
    """Inside the block: the five plain versions count their calls
    (``plain``), and the kernel wrappers of 1, 3 and 4 record the first
    call of each that launched its kernel (``first``: args, kwargs,
    output), in ``block_diffusion`` and where ``block_sparse`` imported
    them."""
    from graph_wavenet_tpu_torch.ops import block_sparse as bsp
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    plain, first, saved = dict.fromkeys(PLAIN, 0), {}, []

    def counting(name, fn):
        def wrapped(*a, **kw):
            plain[name] += 1
            return fn(*a, **kw)
        return wrapped

    def recording(op, fn):
        def wrapped(*a, **kw):
            before = kernel_launches()[op]
            out = fn(*a, **kw)
            if op not in first and kernel_launches()[op] > before:
                first[op] = (a, kw, out)
            return out
        return wrapped

    for name in PLAIN:
        saved.append((bd, name, getattr(bd, name)))
        setattr(bd, name, counting(name, getattr(bd, name)))
    for name, op in BENCH_WRAPPERS.items():
        for mod in (bd, bsp):
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, recording(op, getattr(mod, name)))
    try:
        yield plain, first
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def bench_kernel_checks(first: dict) -> dict:
    """Each recorded launch of the bench path (:func:`bench_watch`) against
    its plain version on the same inputs, on the card: {launch key: max abs
    error}."""
    import torch

    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

    errs = {}
    with torch.no_grad():
        for key, (a, kw, out) in first.items():
            kw = {k: v for k, v in kw.items()
                  if k not in ("row_ptr", "dispatch", "lag")}
            if key == "mix_flat":
                err, ok, rule = close_err(out, bd.mix_flat_plain(*a, **kw))
            elif key == "mix_padded":
                err, ok, rule = close_err(out,
                                          bd.mix_padded_plain(*a, **kw))
            else:
                # hop 2 against the plain hop over the kernel's own out1
                blocks, slot, _, src, row = a
                e1, ok1, rule = close_err(out[0],
                                          bd.mix_flat2_plain(*a, **kw)[0],
                                          summand=kw.get("add"))
                e2, ok2, _ = close_err(out[1], bd.mix_flat_plain(
                    blocks, slot, out[0], src, row, nb=kw["nb"],
                    transpose_lhs=kw["transpose_lhs"]))
                err, ok = max(e1, e2), ok1 and ok2
            errs[key] = err
            require(ok, f"{key} on the bench path disagrees with its plain "
                        f"version: {err} ({rule})")
    torch.cuda.synchronize()
    return errs


def phase_bench() -> dict:
    """``graph_wavenet_tpu_torch.benchmarks`` on the card: the flagship
    train step (bench.py's config in bf16, batch 64, S = 25 graphed steps a
    call) and inference (fp32, batch 1 and 64, and the autoregressive
    rollout); the 40,960-node sparse train step (bf16, batch 4) over the
    RCM spatial graph in flat blocks (kernels 1 and 3, as the dispatch
    rule picks) and over random padded blocks (kernel 4),
    each of 6 timed steps. Checks: each sparse row's launches hold its
    kernels and no plain version runs on any row (the dense rows launch no
    hand kernel), the first launch of each kernel on the path agrees with
    its plain version on the same inputs, ``0 < mfu <= 1.05`` on every
    counted row, the flagship step's FLOP count equals the same step's
    count on the host CPU exactly, and ``band_check`` refuses the TPU's
    record (``fig/perf_table.json``) by device name. Returns the sparse
    rows' launch windows."""
    import dataclasses

    import torch

    from graph_wavenet_tpu_torch import benchmarks as B

    cfg = dataclasses.replace(B.FLAGSHIP, dtype="bfloat16")
    reset_launches()
    with bench_watch() as (plain, _):
        dense = B.bench_train_step(cfg, batch=64, steps=25)
        infer = B.bench_inference(B.FLAGSHIP, batches=(1, 64))
    dense_launches = kernel_launches()
    host_flops = B.train_step_flops(cfg, batch=64, device="cpu")
    emit("bench_train_step", config="metr-la-full", dtype="bfloat16",
         batch=64, row=dense, launches=dense_launches, plain_calls=plain,
         cpu_flops_per_step=host_flops)
    emit("bench_inference", config="metr-la-full", dtype="float32",
         rows=infer)
    require(not any(dense_launches.values()) and not any(plain.values()),
            f"the dense rows launched {dense_launches}, plain {plain}")
    require(dense["flops_per_step"] == host_flops,
            f"the flagship step counts {dense['flops_per_step']} FLOPs on "
            f"the card and {host_flops} on the CPU")
    rows, counts = {"dense": dense}, {}
    for key, kernels, kw in BENCH_SPARSE:
        with bench_watch() as (plain, first):
            reset_launches()
            row = B.bench_sparse_train_step(n_nodes=N_CITY,
                                            steps=BENCH_STEPS, **kw)
            counts[key] = kernel_launches()
        launched = {k for k, v in counts[key].items() if v}
        require(launched <= set(first),
                f"{key}: {sorted(launched - set(first))} launched with no "
                f"first launch recorded to hold against its plain version")
        errs = bench_kernel_checks(first)
        emit("bench_sparse_train_step", window=key, nodes=N_CITY, batch=4,
             dtype="bfloat16", row=row, launches=counts[key],
             plain_calls=plain, max_abs_err=errs)
        require(any(counts[key][k] > 0 for k in kernels)
                and not any(plain.values()),
                f"{key}: launches {counts[key]}, plain calls {plain}")
        rows[key] = row
        torch.cuda.empty_cache()
    require(counts["bench_flat"]["mix_flat2"] > 0,
            "the flat bench step launched no kernel 3")
    for key, row in rows.items():
        require(row["mfu"] is not None and 0 < row["mfu"] <= 1.05,
                f"{key}: mfu {row['mfu']} outside (0, 1.05]")
    refusal = None
    try:
        B.band_check(os.path.join(REPO, "fig", "perf_table.json"))
    except SystemExit as e:
        refusal = str(e)
    kind = torch.cuda.get_device_name(0)
    emit("bench_band_check", record="fig/perf_table.json", refusal=refusal)
    require(refusal is not None and "TPU v5 lite" in refusal
            and kind in refusal,
            f"band_check did not refuse the TPU record: {refusal!r}")
    return counts


# the kernels that run an order-2 pair, each the other's alternative under
# the dispatch rule, and the main-path windows whose pairs follow the rule
PAIR_KERNELS = {"mix_flat": "mix_flat2", "mix_flat2": "mix_flat"}
RULED_WINDOWS = ("serve", "train", "train_graphed", "artifact",
                 "serve_artifact", "rolling", "dist_graphed", "dist_pipe",
                 "bench_flat")
# the windows whose projection-kernel launches the kernels line counts,
# each held to the model's count where it was read
PROJ_TRAIN_WINDOWS = ("proj_train", "proj_train_padded", "proj_dense_train",
                      "proj_dcrnn")
PROJ_SERVE_WINDOWS = ("proj_serve", "proj_serve_padded")
PROJ_SYMBOLS = {"chan_proj": ["chan_proj_kernel"],
                "chan_proj_dgrad": ["chan_proj_kernel"],
                "chan_proj_wgrad": ["chan_proj_wgrad", "chan_proj_reduce"]}


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

    seconds: dict = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    smi = timed("card", phase_card)
    timed("build", phase_build)
    graph = timed("city_graph", city_graph, N_CITY)
    summary = timed("kernel_check", phase_kernels, graph)
    summary.update(timed("train_kernels", phase_train_kernels, graph))
    padded, padded_summary = timed("padded_kernels", phase_padded_kernels,
                                   graph)
    summary.update(padded_summary)
    summary.update(timed("chan_proj", phase_chan_proj))
    summary.update(timed("layer_tail", phase_layer_tail, graph))
    timed("dispatch", phase_dispatch, graph)
    dcrnn_counts = timed("dcrnn", phase_dcrnn, graph)
    timed("small_e2e", phase_small_e2e)
    timed("small_train", phase_small_train)
    timed("small_padded", phase_small_padded)
    with tempfile.TemporaryDirectory(prefix="gwt_chip_smoke_") as tmp:
        counts = timed("serve", phase_serve, graph, tmp)
        counts.update(dcrnn_counts)
        counts.update(timed("train_flat", phase_train, graph, tmp, "flat"))
        counts.update(timed("train_pallas", phase_train, graph, tmp,
                            "pallas"))
        counts.update(timed("aptonly", phase_aptonly, tmp))
        counts.update(timed("metr_cli", phase_metr_cli, tmp))
        timed("data_feed", phase_data_feed, tmp)
        counts.update(timed("export", phase_export, tmp))
        counts.update(timed("serve_artifact", phase_serve_artifact, tmp))
        counts.update(timed("rolling", phase_rolling, tmp))
        counts.update(timed("diffg", phase_diffg, tmp))
        timed("dist_nccl1", phase_dist_nccl1, tmp)
        counts.update(timed("dist_graphed", phase_dist_graphed, graph, tmp))
        timed("dist_diffg", phase_dist_diffg, tmp)
        timed("dist_time", phase_dist_time, tmp)
        # dist_metr and dist_pipe run beside dist_city's torchrun pair,
        # inside its time
        beside_counts = {}

        def beside():
            timed("dist_metr", phase_dist_metr)
            beside_counts.update(timed("dist_pipe", phase_dist_pipe))

        counts.update(timed("dist_city", phase_dist_city, graph, tmp,
                            beside))
        counts.update(beside_counts)
        counts.update(timed("dense", phase_dense))
        counts.update(timed("resident", phase_resident, graph))
        timed("determinism", phase_determinism, graph, tmp)
    counts.update(timed("kernel5_path", phase_kernel5_path, padded))
    timed("tp_tables", phase_tp_tables, graph)
    timed("tp_local", phase_tp_local, graph)
    counts.update(timed("bench", phase_bench))

    # launches on the main paths (each window driven with the counts set to
    # 0 just before it and read just after): kernel 1 serving the 128x512
    # layout and,
    # as the chain the dispatch rule picks, serving and in a train step,
    # eager and graphed, in the flat and the padded artifact's predicts
    # (the padded one's adaptive support), serving the artifact and
    # replaying the rolling forecast, kernel 2 in a train step, eager and
    # graphed, kernel 3 serving, in a train step and in the rolling
    # forecast where the dispatch rule picks it (the last layers in bf16)
    # and in DCRNN's graphed steps,
    # kernel 4 serving and training the padded form, eager and graphed, and
    # in the padded artifact, kernel 5 on the gradient through padded
    # blocks; kernels 1 and 2 per shard in the node-TP train steps (every
    # rank's launches), also under model x time; kernels 1, 2 and 3 in the
    # city step graphed under one NCCL rank; kernels 1 and 3 in the
    # pipelined eval forward over flat supports (every rank's launches);
    # kernels 1 and 3 in the benchmark module's flat city step and kernel 4
    # in its padded one; a graphed window counts every replay
    kernels = []
    for key, name, src, tpu, windows in (
            ("k1", "mix_flat", K1_SRC, K1_TPU,
             ("rect", "serve", "train", "train_graphed", "artifact",
              "artifact_padded", "serve_artifact", "rolling",
              "dist_dp2_tp2", "dist_tp2_t2", "dist_graphed", "dist_pipe",
              "bench_flat")),
            ("k2", "outer_flat", K2_SRC, K2_TPU,
             ("train", "train_graphed", "dist_dp2_tp2", "dist_tp2_t2",
              "dist_graphed")),
            ("k3", "mix_flat2", K3_SRC, K3_TPU,
             ("serve", "train", "train_graphed", "rolling", "dist_graphed",
              "dist_pipe", "bench_flat", "dcrnn")),
            ("k4", "mix_padded", K4_SRC, K4_TPU,
             ("serve_padded", "train_padded", "train_graphed_padded",
              "artifact_padded", "bench_pallas")),
            ("k5", "outer_padded", K5_SRC, K5_TPU,
             ("kernel5_path",))):
        rec = summary[key]
        launches = sum(counts[w][name] for w in windows)
        # where the dispatch rule sends a window's order-2 pairs to the
        # other of kernels 1 and 3, that one must have run there instead
        other = PAIR_KERNELS.get(name)
        require(launches > 0 and all(
                    counts[w][name] > 0
                    or (other is not None and w in RULED_WINDOWS
                        and counts[w][other] > 0) for w in windows),
                f"{name} was not launched on the main path: "
                f"{ {w: counts[w][name] for w in windows} }")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches,
            "max_abs_err": rec.get("max_abs_err",
                                   rec.get("max_abs_err_out2")),
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    # the projection kernel's three ops, a dense-ops kernel with no Pallas
    # counterpart (the JAX package leaves channel matmuls to XLA): times at
    # the city step's sparse diffusion (7 x 32 -> 32, 1.97 M rows),
    # launches in the flat and padded train steps, the dense METR steps
    # and (forward only) the flat and padded serving windows
    for op, windows in (
            ("chan_proj", PROJ_TRAIN_WINDOWS + PROJ_SERVE_WINDOWS),
            ("chan_proj_dgrad", PROJ_TRAIN_WINDOWS),
            ("chan_proj_wgrad", PROJ_TRAIN_WINDOWS)):
        rec = summary[op]
        n = sum(counts[w][op] for w in windows)
        require(all(counts[w][op] > 0 for w in windows),
                f"{op} was not launched on the main path: "
                f"{ {w: counts[w][op] for w in windows} }")
        kernels.append({
            "name": op, "route": "cuda", "source": PROJ_SRC,
            "replaces": None, "symbols": PROJ_SYMBOLS[op],
            "launches": n, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"]})
    # the layer-tail kernel's ops, a dense-ops kernel with no Pallas
    # counterpart (the JAX package leaves BatchNorm to XLA's fusion): times
    # at the city step's first layer (4 x 12 x 40,960 x 32), launches in
    # the graphed city train call and the batch-8 serving forward
    windows = summary["tail_windows"]
    for op in TAIL_TRAIN_OPS + ("bn_tail_eval",):
        rec = summary[op]
        n = sum(w[op] for w in windows.values())
        require(n > 0, f"{op} was not launched on the main path: {windows}")
        kernels.append({
            "name": op, "route": "cuda", "source": TAIL_SRC,
            "replaces": None, "symbols": TAIL_SYMBOLS[op],
            "launches": n, "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None})
    emit("done", seconds=round(time.perf_counter() - t0, 3))
    print(json.dumps({"phase_seconds": seconds}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
