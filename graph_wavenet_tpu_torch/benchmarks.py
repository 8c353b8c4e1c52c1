"""Benchmark suite on the card: the five BASELINE.json configurations, the
city-scale sparse train step, inference, and the sharded and weak-scaling
harnesses.

Counterpart of ``graph_wavenet_tpu/benchmarks.py``, with its names,
arguments (plus ``device``) and returned keys. Configs (BASELINE.json
"configs"):

  1. temporal-only WaveNet, METR-LA shapes (no gcn)
  2. METR-LA + diffusion GCN over fixed doubletransition supports
  3. METR-LA full model (+ learned adaptive adjacency)      <- flagship
  4. PEMS-BAY full model (325 nodes)
  5. large synthetic graph (>=5k nodes), node-sharded diffusion

Each benchmark times the whole train step (forward, backward, Adam) and
reports node-timesteps/s, the step's FLOPs and MFU against the card's bf16
peak.

- **FLOPs** come from ``torch.utils.flop_counter.FlopCounterMode`` over one
  eager ``Engine.train_step`` (the first warm-up step), where the reference
  reads XLA's cost model of the compiled program. The mode counts matrix
  products (``mm``, ``bmm``, ``addmm``, convolutions) and the hand kernels'
  ops by their formulas (``ops.cuda.block_diffusion``: the reference
  kernels' ``CostEstimate`` flops); XLA also counts elementwise work, so a
  dense step's count is a little below the reference's. The formulas read
  shapes only: a step counts the same on the CPU and on the card.
- **Timing** is differential: chains of n1 and n2 calls, each ended by a
  ``.item()`` of the last metric (which waits for the card), and seconds per
  step from the difference, so the fixed launch and fetch cost cancels.
  ``bench_train_step`` times ``Engine.train_steps_resident`` over S = 25
  steps a call: one step's CUDA graph replayed per step, the counterpart of
  the reference's fused scan (which it needed to get past a tunneled
  transport's per-dispatch noise; here it is the production resident
  path). The sparse, sharded and weak-scaling rows time eager steps, as the
  reference does.
- **MFU** divides by :data:`PEAK_TFLOPS`, the card's dense bf16 rate, fp32
  rows too (the reference's stated convention), so columns stay comparable.
  A CPU device, or a card not in the table, gives ``None``.

A measuring function asked for ``cuda`` on a machine without a card raises
(``resolve_device``); it never times the CPU in its place.

``weak_scaling`` and ``bench_sharded_train_step`` run one process per rank
under an initialized process group (``parallel.multihost.initialize``), each
rank calling them with the same arguments. ``weak_scaling`` grows a
data-parallel mesh over the first 1, 2, 4 ... ranks; only ranks with a card
each and NCCL between them give a scaling number (gloo ranks sharing one
card check the harness, nothing more).

Run on the card:

    python -m graph_wavenet_tpu_torch.benchmarks --save fig/perf_table_torch.json
    python -m graph_wavenet_tpu_torch.benchmarks --band_check
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import replace

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from graph_wavenet_tpu_torch import resolve_device
from graph_wavenet_tpu_torch.config import MeshConfig, ModelConfig, \
    TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.train.engine import Engine

FLAGSHIP = ModelConfig(num_nodes=207, in_dim=2, out_dim=12,
                       residual_channels=32, dilation_channels=32,
                       skip_channels=256, end_channels=512, blocks=4,
                       layers=2, gcn_bool=True, addaptadj=True, n_supports=2)

# tiny config for harness smokes
SMALL_SMOKE = ModelConfig(num_nodes=12, out_dim=6, residual_channels=4,
                          dilation_channels=4, skip_channels=8,
                          end_channels=8, blocks=1, layers=2, dropout=0.0,
                          n_supports=2)

CONFIGS: dict[str, ModelConfig] = {
    "metr-la-temporal": replace(FLAGSHIP, gcn_bool=False, addaptadj=False),
    "metr-la-gcn": replace(FLAGSHIP, addaptadj=False),
    "metr-la-full": FLAGSHIP,
    "pems-bay-full": replace(FLAGSHIP, num_nodes=325),
    "syn-5k-nodes": replace(FLAGSHIP, num_nodes=5120, skip_channels=256,
                            end_channels=512),
}

# dense bf16 tensor-core TFLOPS by device name (matched by prefix): the H100
# SXM's data-sheet rate. MFU of every row, fp32 ones too, is against it.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}

# the port's own record (``run_all`` on the card, ``--save``)
RECORD = "fig/perf_table_torch.json"


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _peak_tflops(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device)
    for k, v in PEAK_TFLOPS.items():
        if kind.startswith(k):
            return v
    return None


def _power_limit_w(device: torch.device) -> float | None:
    """The card's power limit in watts (``nvidia-smi``), None elsewhere."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _count_step(step_fn, *args) -> tuple:
    """(output, flops | None): one call of ``step_fn`` under
    ``FlopCounterMode`` (matrix products and the hand kernels' formulas).
    Pass an eager step: a fused call's graph replays are not dispatched, and
    its capture would count a step twice. Zero counts as None."""
    with FlopCounterMode(display=False) as counter:
        out = step_fn(*args)
    flops = float(counter.get_total_flops())
    return out, (flops if flops > 0 else None)


def _rate_fields(per_step_s: float, flops: float | None,
                 device: torch.device) -> dict:
    eff = (flops / per_step_s / 1e12) if flops else None
    peak = _peak_tflops(device)
    return {
        "step_ms": per_step_s * 1e3,
        "flops_per_step": flops,
        "eff_tflops": None if eff is None else round(eff, 2),
        "peak_tflops_bf16": peak,
        "mfu": (None if eff is None or peak is None
                else round(eff / peak, 4)),
    }


def _random_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, seq, cfg.num_nodes, 2)).astype(np.float32)
    y = rng.normal(size=(batch, seq, cfg.num_nodes, 2)).astype(
        np.float32) + 50.0
    supports = None
    if cfg.gcn_bool:
        a = rng.random((cfg.n_supports, cfg.num_nodes,
                        cfg.num_nodes)).astype(np.float32)
        supports = [s / s.sum(-1, keepdims=True) for s in a]
    return x, y, supports


def _on(device: torch.device, x, y, supports) -> tuple:
    """The inputs of :func:`_random_inputs` as tensors on ``device``."""
    sup = (None if supports is None
           else [torch.as_tensor(s, device=device) for s in supports])
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device), sup)


def _engine(cfg: ModelConfig, device: torch.device, mesh=None) -> Engine:
    return Engine(cfg, TrainConfig(), StandardScaler(54.0, 20.0),
                  device=device, mesh=mesh)


def train_step_flops(cfg: ModelConfig, batch: int = 64, seq: int = 12,
                     device: str = "cuda") -> float | None:
    """The FLOP count :func:`bench_train_step` reads for ``cfg``: one eager
    train step of a fresh engine on the same inputs, on ``device``."""
    dev = resolve_device(device)
    return _count_step(_engine(cfg, dev).train_step,
                       *_on(dev, *_random_inputs(cfg, batch, seq)))[1]


def _differential_time(run_steps, n1: int, n2: int) -> float:
    """Time n2 and n1 step-chains (each ended by a scalar fetch, which waits
    for the device) and return seconds/step from the difference, cancelling
    the fixed launch/fetch overhead."""
    if n2 <= n1:
        # degenerate smoke runs (steps=1): raw average incl. fixed overhead
        return run_steps(n2) / n2
    t1 = run_steps(n1)
    t2 = run_steps(n2)
    per_step = (t2 - t1) / (n2 - n1)
    if per_step <= 0:
        # timing noise exceeded the step cost (tiny smoke runs): fall back
        # to the raw average, which includes the fixed overhead
        per_step = t2 / n2
    return per_step


def _repeat_differential(run_steps, n1: int, n2: int,
                         repeats: int = 1) -> float:
    """Min of ``repeats`` differential timings on the same warm step, after
    one discarded measurement: host-side noise only ever adds time, so the
    min is the stable statistic, and the first measurement in a process
    can be an outlier either way."""
    if repeats <= 1:
        return _differential_time(run_steps, n1, n2)
    _differential_time(run_steps, n1, n2)   # discarded
    return min(_differential_time(run_steps, n1, n2)
               for _ in range(repeats))


def bench_train_step(cfg: ModelConfig, batch: int = 64, seq: int = 12,
                     steps: int = 50, warmup: int = 3,
                     repeats: int = 1, device: str = "cuda") -> dict:
    """Throughput of the train step for one config.

    The dataset (``batch`` samples) is resident on the device and a call
    of :meth:`Engine.train_steps_resident` takes S = min(steps, 25) steps
    over an (S, B) index matrix: on the card one step's CUDA graph replayed
    per step. The per-step time is the differential per-call time over S.
    The FLOP count is one eager ``train_step`` on the same batch, the first
    warm-up step."""
    dev = resolve_device(device)
    engine = _engine(cfg, dev)
    xs, ys, sup = _on(dev, *_random_inputs(cfg, batch, seq))
    scan_steps = max(min(steps, 25), 1)
    idx = torch.arange(batch, dtype=torch.int32,
                       device=dev)[None].repeat(scan_steps, 1)
    _, flops = _count_step(engine.train_step, xs, ys, sup)
    for _ in range(max(warmup, 1)):
        metrics = engine.train_steps_resident(xs, ys, idx, sup)
    metrics["loss"][-1].item()

    def run_calls(n):
        t0 = time.perf_counter()
        for _ in range(n):
            m = engine.train_steps_resident(xs, ys, idx, sup)
        m["loss"][-1].item()
        return time.perf_counter() - t0

    per_call = _repeat_differential(run_calls, 1, 3, repeats)
    per_step = per_call / scan_steps
    return {
        "steps_per_s": 1.0 / per_step,
        "node_timesteps_per_s": batch * cfg.num_nodes * seq / per_step,
        **_rate_fields(per_step, flops, dev),
    }


def _eager_steps(engine: Engine, x, y, sup, n: int) -> float:
    """Seconds of ``n`` eager train steps ended by a loss fetch."""
    t0 = time.perf_counter()
    for _ in range(n):
        m = engine.train_step(x, y, sup)
    m["loss"].item()
    return time.perf_counter() - t0


def _rank_device(device: str) -> torch.device:
    from graph_wavenet_tpu_torch.parallel.multihost import rank_device

    return rank_device(resolve_device(device))


def bench_sharded_train_step(cfg: ModelConfig, mesh_cfg: MeshConfig,
                             batch: int = 64, seq: int = 12,
                             steps: int = 20, warmup: int = 3,
                             device: str = "cuda") -> dict:
    """Config-5 style: the train step over a mesh of every rank of the
    process group (node-TP for the large graph, DP over the rest). Every
    rank calls it with the same arguments; each feeds the global batch and
    the whole dense supports, and the engine keeps its rows and nodes. The
    FLOP count and the times are this rank's (``devices`` ranks)."""
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    dev = _rank_device(device)
    mesh = make_mesh(mesh_cfg, dev)
    engine = _engine(cfg, dev, mesh)
    x, y, sup = _on(dev, *_random_inputs(cfg, batch, seq))
    m, flops = _count_step(engine.train_step, x, y, sup)
    for _ in range(max(warmup, 1) - 1):
        m = engine.train_step(x, y, sup)
    m["loss"].item()
    per_step = _differential_time(
        lambda n: _eager_steps(engine, x, y, sup, n), max(steps // 3, 1),
        steps)
    return {
        "devices": mesh.world_size,
        "steps_per_s": 1.0 / per_step,
        "node_timesteps_per_s": batch * cfg.num_nodes * seq / per_step,
        **_rate_fields(per_step, flops, dev),
    }


def weak_scaling(cfg: ModelConfig = FLAGSHIP, per_device_batch: int = 64,
                 seq: int = 12, steps: int = 20,
                 device: str = "cuda") -> dict:
    """Weak scaling: fixed per-rank batch, a data-parallel mesh over the
    first n = 1, 2, 4 ... ranks of the process group (one rank without
    one); efficiency = throughput_n / (n * throughput_1). Every rank calls
    it and gets rank 0's readings. Ranks outside a mesh wait. A number of
    scaling needs a card per rank; ranks sharing one card (gloo) check the
    harness only."""
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    dev = _rank_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    results = {}
    base = None
    n = 1
    while n <= world:
        mesh = make_mesh(MeshConfig(), dev, ranks=n)
        reading = [None]
        if mesh is not None:
            engine = _engine(cfg, dev, mesh)
            x, y, sup = _on(dev, *_random_inputs(cfg, per_device_batch * n,
                                                 seq))
            _eager_steps(engine, x, y, sup, 3)
            per_step = _differential_time(
                lambda k: _eager_steps(engine, x, y, sup, k),
                max(steps // 3, 1), steps)
            reading[0] = (per_device_batch * n * cfg.num_nodes * seq
                          / per_step)
        if world > 1:
            dist.broadcast_object_list(reading, src=0)
        tput = reading[0]
        if base is None:
            base = tput
        results[n] = {"node_timesteps_per_s": tput,
                      "efficiency": tput / (n * base)}
        n *= 2
    return results


def bench_inference(cfg: ModelConfig = FLAGSHIP, seq: int = 12,
                    batches: tuple = (1, 64, 512), steps: int = 50,
                    horizon_steps: int = 8, device: str = "cuda") -> dict:
    """Serving-path benchmarks: ``Forecaster.predict`` latency and
    throughput per batch size, and the closed-loop autoregressive rollout
    (``train.serving.autoregressive_forecast``: on the card one round's
    CUDA graph replayed per round)."""
    from graph_wavenet_tpu_torch.train.serving import (
        Forecaster,
        autoregressive_forecast,
    )

    dev = resolve_device(device)
    engine = _engine(cfg, dev)
    engine.model.eval()
    x, y, supports = _random_inputs(cfg, max(batches), seq)
    x, _, sup = _on(dev, x, y, supports)
    fc = Forecaster(cfg, engine.model, sup, engine.scaler)
    out = {}
    for b in batches:
        xb = x[:b]
        fc.predict(xb).sum().item()     # warm-up

        def run_steps(n):
            t0 = time.perf_counter()
            for _ in range(n):
                acc = fc.predict(xb)
            acc.sum().item()
            return time.perf_counter() - t0

        per = _differential_time(run_steps, max(steps // 3, 1), steps)
        out[f"batch_{b}"] = {
            "latency_ms": per * 1e3,
            "forecasts_per_s": b / per,
            "node_timesteps_per_s": b * cfg.num_nodes * seq / per,
        }

    xb = x[:max(batches) // 8 or 1]
    autoregressive_forecast(fc, xb, horizon_steps).sum().item()

    def run_ar(n):
        t0 = time.perf_counter()
        for _ in range(n):
            acc = autoregressive_forecast(fc, xb, horizon_steps)
        acc.sum().item()
        return time.perf_counter() - t0

    per = _differential_time(run_ar, 3, 9)
    out["autoregressive"] = {
        "batch": int(xb.shape[0]),
        "rollout_steps": horizon_steps,
        "rollout_ms": per * 1e3,
        "forecast_timesteps_per_s":
            xb.shape[0] * horizon_steps * cfg.out_dim / per,
    }
    return out


BLOCK_FORMS = ("block", "block-pallas", "block-flat", "block-rect")


def sparse_supports(n_nodes: int, form: str, degree: int = 8,
                    blocks_per_row: int = 4, graph: str = "random",
                    ordering: str = "identity",
                    device: str = "cuda") -> list:
    """The two supports of :func:`bench_sparse_train_step`: block-sparse
    (``form`` one of :data:`BLOCK_FORMS`) over a random block structure or
    a k-NN spatial graph under ``ordering`` (identity, rcm, hilbert or
    best), or ``"ell"``, padded neighbor tables. The reference's seeds: the
    same arguments give its supports."""
    from graph_wavenet_tpu_torch.ops import block_sparse, sparse

    dev = resolve_device(device)
    if form not in BLOCK_FORMS:
        if form != "ell":
            raise ValueError(f"unknown sparse form {form!r}")
        return [sparse.random_sparse_support(
            n_nodes, degree, np.random.default_rng(s), device=dev)
            for s in (1, 2)]
    sub_form = {"block": "block", "block-pallas": "pallas",
                "block-flat": "flat", "block-rect": "flat-rect"}[form]
    if graph == "spatial":
        from graph_wavenet_tpu_torch.graphs import ordering as ordering_mod
        from graph_wavenet_tpu_torch.graphs import spatial

        pos = np.random.default_rng(0).random((n_nodes, 2))
        src, dst, w = spatial.knn_graph_edges(pos, degree)
        perm = {
            "best": lambda: ordering_mod.best_block_ordering(
                src, dst, n_nodes, pos=pos)[0],
            "rcm": lambda: ordering_mod.rcm_order_edges(src, dst, n_nodes),
            "hilbert": lambda: ordering_mod.hilbert_order_points(pos),
        }.get(ordering, lambda: None)()
        return spatial.doubletransition_block_supports(
            src, dst, w, n_nodes, perm=perm, form=sub_form, device=dev)
    if sub_form == "flat-rect":
        raise ValueError("block-rect builds from an edge list; use "
                         "graph='spatial'")
    wrap = {"block": lambda s: s, "pallas": block_sparse.as_pallas,
            "flat": block_sparse.as_flat_pallas}[sub_form]
    return [wrap(block_sparse.random_block_support(
        n_nodes // 128, blocks_per_row, 128, np.random.default_rng(s),
        device=dev)) for s in (1, 2)]


def _live_blocks(sp) -> int:
    """Live (non-sentinel) blocks of a flat or a padded support."""
    if hasattr(sp, "blocks_flat"):
        return sp.n_live
    return int((sp.block_idx < sp.block_idx.shape[0]).sum())


def bench_sparse_train_step(n_nodes: int = 40960, batch: int = 4,
                            seq: int = 12, steps: int = 24,
                            form: str = "block", degree: int = 8,
                            blocks_per_row: int = 4,
                            graph: str = "random",
                            ordering: str = "identity",
                            repeats: int = 1, device: str = "cuda") -> dict:
    """Large-graph sparse-support train step (bf16, no adaptive adjacency):
    form "block" and "block-pallas" = padded 128x128 blocks (kernel 4),
    "block-flat" = live blocks (kernel 1, and kernel 3 where the layout
    fuses and ``fused2_dispatch`` picks it), "block-rect" = 128x512 flat
    blocks (kernel 1; ``graph="spatial"``), "ell" = padded neighbor tables
    (plain PyTorch gathers). Dense supports at these sizes do not fit.

    ``graph="spatial"`` swaps the uniform random block structure for a
    k-NN road-network graph (``graphs.spatial``) under ``ordering``
    (``graphs.ordering``: rcm, hilbert, or best of both). The fixed
    supports need no gradient for their blocks, so kernels 2 and 5 are not
    on this path. Eager steps, timed differentially."""
    dev = resolve_device(device)
    cfg = replace(FLAGSHIP, num_nodes=n_nodes, out_dim=seq,
                  dtype="bfloat16", addaptadj=False)
    sup = sparse_supports(n_nodes, form, degree, blocks_per_row, graph,
                          ordering, device=dev)
    engine = _engine(cfg, dev)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(batch, seq, n_nodes, 2)).astype(
        np.float32), device=dev)
    y = torch.as_tensor(rng.normal(size=(batch, seq, n_nodes, 2)).astype(
        np.float32) + 50.0, device=dev)
    _, flops = _count_step(engine.train_step, x, y, sup)
    _eager_steps(engine, x, y, sup, 2)
    per = _repeat_differential(
        lambda n: _eager_steps(engine, x, y, sup, n), max(steps // 3, 1),
        steps, repeats)
    return {
        "form": form,
        "graph": graph,
        "ordering": ordering,
        "n_blocks": (sum(map(_live_blocks, sup)) if form in BLOCK_FORMS
                     else None),
        "node_timesteps_per_s": batch * n_nodes * seq / per,
        **_rate_fields(per, flops, dev),
    }


# a deliberate 10% regression must trip; min-of-3 differential timing on
# the warm step keeps run-to-run spread well inside this
STEP_MS_BAND = 1.08
FLOPS_RTOL = 0.02


def check_band(row: dict, best_step_ms: float, flops: float | None,
               name: str = "train step"):
    """Raise AssertionError if a measurement regressed past the band vs
    the recorded row of the port's record (``fig/perf_table_torch.json``).
    Pure logic; ``python -m graph_wavenet_tpu_torch.benchmarks
    --band_check`` feeds it fresh measurements on the card."""
    assert best_step_ms <= row["step_ms"] * STEP_MS_BAND, (
        f"{name} regressed: {best_step_ms:.2f} ms vs "
        f"recorded {row['step_ms']:.2f} ms (band x{STEP_MS_BAND}); if "
        f"this is an intentional trade, re-record {RECORD}")
    if row.get("flops_per_step") and flops:
        assert abs(flops - row["flops_per_step"]) \
            <= FLOPS_RTOL * row["flops_per_step"], (
            "counted FLOP count drifted: the train step's compute graph "
            f"changed; re-record {RECORD} if intended")


def remeasure_row(name: str, row: dict, batch: int, steps: int,
                  dtype: str, device: str = "cuda") -> dict:
    """Re-run the benchmark that produced one recorded row (min of 3
    differential timings on one warm step, after a discarded one)."""
    if "form" in row:     # the sparse city row records its own geometry
        return bench_sparse_train_step(
            steps=max(steps // 3, 6), form=row["form"], graph=row["graph"],
            ordering=row["ordering"], repeats=3, device=device)
    cfg = replace(CONFIGS[name], dtype=dtype)
    return bench_train_step(cfg, batch=batch, steps=steps, repeats=3,
                            device=device)


def band_check(artifact_path: str, only: list[str] | None = None,
               device: str = "cuda") -> None:
    """Re-measure every recorded row (or the rows named in ``only``) on
    ``device`` and assert each is inside its band; prints a verdict per
    row and exits non-zero if any regressed. A record of another device
    (by name) is refused with ``SystemExit``."""
    import json as _json

    rec = _json.loads(open(artifact_path).read())
    dev = resolve_device(device)
    name_here = _device_name(dev)
    if rec.get("device") != name_here:
        raise SystemExit(f"artifact recorded on {rec.get('device')!r}, "
                         f"running on {name_here!r}: bands not comparable")
    batch, steps = rec.get("batch", 64), rec.get("steps", 30)
    dtype = rec.get("dtype", "bfloat16")
    failures = []
    for name, row in rec["configs"].items():
        if only and name not in only:
            continue
        meas = remeasure_row(name, row, batch, steps, dtype, device=dev)
        try:
            check_band(row, meas["step_ms"], meas["flops_per_step"], name)
            print(f"band check OK: {name} min {meas['step_ms']:.2f} ms "
                  f"vs recorded {row['step_ms']:.2f} ms "
                  f"(x{STEP_MS_BAND} band), FLOPs match")
        except AssertionError as e:
            failures.append(name)
            print(f"band check FAIL: {name}: {e}")
    if failures:
        raise SystemExit(f"regressed rows: {', '.join(failures)}")


METHODOLOGY = (
    "dense rows: train_steps_resident calls of 25 steps (one step's CUDA "
    "graph replayed per step) differentially timed over call counts, min "
    "of 3 after a discarded measurement; sparse row: eager steps, "
    "differential per-step timing; every chain ends in a .item() of the "
    "last loss. FLOPs: torch.utils.flop_counter.FlopCounterMode over one "
    "eager train_step, matrix products plus the hand kernels' formulas "
    "(the reference kernels' CostEstimate flops, R unpadded); elementwise "
    "work is not counted. MFU vs the card's dense bf16 peak (PEAK_TFLOPS), "
    "fp32 rows too")


def run_all(batch: int = 64, steps: int = 30,
            dtype: str = "bfloat16",
            include_sparse: bool | None = None,
            device: str = "cuda") -> dict:
    """The four dense BASELINE rows (config 5 runs through
    :func:`bench_sharded_train_step`) and the city-scale sparse row
    (40,960 nodes, spatial graph, best ordering, flat blocks), one
    methodology for every row. The returned record is the port's perf
    artifact (``--save fig/perf_table_torch.json``), which ``--band_check``
    re-measures. ``include_sparse`` defaults to True on a card and False
    on the CPU (the 40,960-node step runs the plain hops there)."""
    dev = resolve_device(device)
    rows = {}
    for name, cfg in CONFIGS.items():
        if cfg.num_nodes > 1000:
            continue
        rows[name] = bench_train_step(replace(cfg, dtype=dtype), batch=batch,
                                      steps=steps, repeats=3, device=dev)
    if include_sparse is None:
        include_sparse = dev.type == "cuda"
    if include_sparse:
        rows["city-40k-block-flat"] = bench_sparse_train_step(
            steps=max(steps // 3, 6), form="block-flat", graph="spatial",
            ordering="best", repeats=3, device=dev)
    return {
        "device": _device_name(dev),
        "power_limit_w": _power_limit_w(dev),
        "backend": dev.type,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "dtype": dtype,
        "batch": batch,
        "steps": steps,
        "methodology": METHODOLOGY,
        "configs": rows,
    }


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json
    import pathlib

    ap = argparse.ArgumentParser(
        prog="python -m graph_wavenet_tpu_torch.benchmarks",
        description="Time the BASELINE configurations and the city-scale "
                    "sparse step on the card, or re-measure the recorded "
                    "rows against their bands.")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default=None,
                    help=f"also write the record to this JSON path "
                         f"({RECORD} is the port's record)")
    ap.add_argument("--band_check", action="store_true",
                    help=f"instead of sweeping: re-measure every row of "
                         f"{RECORD} and assert each is inside its band "
                         "(per-row verdicts, non-zero exit on a "
                         "regression)")
    ap.add_argument("--band_only", nargs="+", default=None,
                    help="restrict --band_check to these row names")
    a = ap.parse_args(argv)
    if a.band_check:
        band_check(str(pathlib.Path(__file__).resolve().parent.parent
                       / RECORD), only=a.band_only, device=a.device)
        return
    rec = run_all(batch=a.batch, steps=a.steps, dtype=a.dtype,
                  device=a.device)
    if a.save:
        with open(a.save, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
