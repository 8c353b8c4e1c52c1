"""Data-parallel training on device-resident windows over ``ranks``
processes, one card each: ``Engine.train_steps_resident`` under a mesh
(``parallel.mesh``, the data axis only), the step and its gradient
all-reduce captured as one CUDA graph on an NCCL group (gloo on the CPU,
where a fused call is the eager loop) and replayed.

The run's process starts the ranks (this file, run as a script) and
waits for them. Every rank builds the graph, draws the weights and the
``samples`` resident windows from the seed and takes rank 0's by
broadcast, and is given the same global (S, ``batch``) index matrices
from the seed, keeping its ``batch / ranks`` columns (``Mesh.index_share``;
the dropout masks are drawn at the global batch's shape and sliced). The
first three steps run through the window's own call, as in
``train_resident.py``; rank 0 reads the first gradient as Adam took it
and the weights after the third step (every rank holds the same). The
window then runs ``steps_per_call`` steps a call on every rank until rank
0's clock passes ``--seconds`` (its decision broadcast after each call);
``train_samples_per_s`` counts the global batch. With ``--trace 1`` rank
0 traces ``trace_calls`` more calls while the others run them. After the
ranks exit, the run's process follows the first three steps with the
plain reference at the global batch on one card, every layer recomputed
in the backward (``torch.utils.checkpoint``): batch normalization couples
the global batch, so it is not split.

Mix parameters: ``batch`` (global), ``ranks``, ``samples``,
``steps_per_call``, ``trace_calls``, and ``family``: the traced
segment's records kind (rank 0's trace; its counted work is a rank's
share of the step).
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    BENCH = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from gwbench import compare, count, graph, inputs  # noqa: E402

FIRST_STEPS = 3
E2E = "train_samples_per_s"
WAIT_S = 300.0
EXIT_S = 30.0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(ctx, cache: dict | None = None) -> dict:
    cache = {} if cache is None else cache
    mix = ctx.traffic
    ranks = mix["ranks"]
    wall0 = time.time() - (time.perf_counter() - ctx.t0)
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"cell": {"workload": ctx.workload, "config": ctx.config,
                         "traffic": ctx.traffic},
                "seed": ctx.seed, "seconds": ctx.seconds,
                "trace": ctx.trace, "device": ctx.device.type,
                "port": _free_port(), "out": tmp}
        path = os.path.join(tmp, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        procs = []
        try:
            for r in range(ranks):
                env = dict(os.environ, LOCAL_RANK=str(r))
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), path,
                     str(r)], env=env))
            _wait(procs, tmp, ctx.seconds + WAIT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        with open(os.path.join(tmp, "rank0.pkl"), "rb") as f:
            res = pickle.load(f)
    dev = ctx.device
    b = mix["batch"]
    out = {"setup_s": res["t_start_wall"] - wall0,
           "window_s": res["elapsed"], "attempted": res["steps"],
           "e2e": {E2E: (res["steps"] * b / res["elapsed"], "samples/s")},
           "peak_bytes": res["peak_bytes"], "failed": res["failed"]}
    if ctx.trace:
        pg = {k: v for k, v in ctx.config["graph"].items()}
        work = count.step_work(ctx.config, pg, b // ranks, train=True)
        out["records"] = {"kind": mix["family"], "trace": res["trace"],
                          "work": [work] * (mix["trace_calls"]
                                            * mix["steps_per_call"]),
                          "flops_window": work.flops * res["steps"],
                          "window_s": res["elapsed"]}
    # the inputs again, on the run's card: the draws rank 0 made and sent
    gen = inputs.generator(ctx.seed, dev)
    w0 = inputs.weights({k: tuple(v.shape) for k, v in
                         res["weights"].items()}, gen, dev)
    m, sc = ctx.config["model"], ctx.config["scaler"]
    xs, ys = inputs.readings(mix["samples"], ctx.config["graph"]["nodes"],
                             m["seq_length"], m["out_dim"], sc, gen, dev)
    if not (torch.equal(xs[:1].cpu(), res["x0"]) and all(
            torch.equal(v.cpu(), res["weights"][k]) for k, v in w0.items())):
        raise RuntimeError("the run's process drew other inputs than "
                           "rank 0")
    out["program"] = {k: res[k] for k in ("losses", "grad1", "moved")}
    out["inputs"] = {"weights": w0, "batches": [
        (xs[r].clone(), ys[r].clone()) for r in
        (torch.as_tensor(f, device=dev) for f in res["first"])]}
    del xs, ys
    ctx.free()
    out["numbers"] = numbers(ctx, cache, out)
    return out


def _wait(procs, out: str, limit_s: float) -> None:
    """Every rank's done mark in ``out``, within ``limit_s``; a rank that
    fails or a group that overruns raises at once (the others are killed
    by the caller). A rank that has marked done and not exited within
    ``EXIT_S`` is killed: its work is over."""
    t0 = time.monotonic()
    done_at = None
    while True:
        codes = [p.poll() for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad and done_at is None:
            raise RuntimeError(f"rank {bad[0][0]} exited with {bad[0][1]}")
        if all(c is not None for c in codes):
            return
        if done_at is None and all(
                os.path.exists(os.path.join(out, f"done{r}"))
                for r in range(len(procs))):
            done_at = time.monotonic()
        if done_at is not None and time.monotonic() - done_at > EXIT_S:
            return
        if time.monotonic() - t0 > limit_s:
            raise RuntimeError(f"the ranks ran past {limit_s:.0f} s")
        time.sleep(0.2)


def worker(spec_path: str, rank: int) -> None:
    """One rank: its process group, engine and steps; rank 0 writes what
    the run's process reads."""
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.config import MeshConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh
    from graph_wavenet_tpu_torch.train.engine import Engine

    import run as harness
    from gwbench import program, trace

    with open(spec_path) as f:
        spec = json.load(f)
    cell, mix = spec["cell"], spec["cell"]["traffic"]
    ranks = mix["ranks"]
    cuda = spec["device"] == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // ranks))
    t0 = time.perf_counter()

    def log(what):
        print(f"[rank {rank} +{time.perf_counter() - t0:.1f} s] {what}",
              file=sys.stderr, flush=True)

    multihost.initialize("nccl" if cuda else "gloo", rank, ranks,
                         f"tcp://127.0.0.1:{spec['port']}", device=dev)
    try:
        mesh = make_mesh(MeshConfig(), device=dev)
        log("group up")
        ctx = harness.Ctx(cell, spec["seed"], spec["seconds"],
                          spec["trace"], dev=str(dev))
        cfg = ctx.config
        m, opt, sc = cfg["model"], cfg["optimizer"], cfg["scaler"]
        b, samples, s = mix["batch"], mix["samples"], mix["steps_per_call"]
        sups = graph.program(ctx, {})["supports"]
        engine = Engine(program.model_config(cfg), TrainConfig(
            batch_size=b, learning_rate=opt["learning_rate"],
            weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]),
            StandardScaler(sc["mean"], sc["std"]), device=dev,
            seed=ctx.seed, mesh=mesh)
        gen = inputs.generator(ctx.seed, dev)
        w0 = inputs.weights(program.shapes(engine.model), gen, dev)
        xs, ys = inputs.readings(samples, cfg["graph"]["nodes"],
                                 m["seq_length"], m["out_dim"], sc, gen,
                                 dev)
        for t in list(w0.values()) + [xs, ys]:
            dist.broadcast(t, 0)
        program.load(engine.model, w0)
        log("graph, weights and windows")
        rng = np.random.default_rng(ctx.seed)
        first = rng.permutation(samples)[:FIRST_STEPS * b].reshape(
            FIRST_STEPS, b)
        params = dict(engine.model.named_parameters())
        losses = [engine.train_steps_resident(xs, ys, first[:1], sups)
                  ["loss"]]
        state = engine.optimizer.state
        grad1 = compare.norms({k: (state[p]["exp_avg"] / (1.0 - 0.9))
                               if p in state else None
                               for k, p in params.items()})
        losses.append(engine.train_steps_resident(xs, ys, first[1:], sups)
                      ["loss"])
        moved = compare.norms({k: p.detach() - w0[k]
                               for k, p in params.items()})
        losses = torch.cat(losses).tolist()
        log("first steps (the capture)")

        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        _sync(dev)
        mesh.barrier()
        t_start = time.perf_counter()
        t_start_wall = time.time()
        calls, window_losses = 0, []
        while True:
            idx = rng.integers(0, samples, size=(s, b))
            window_losses.append(engine.train_steps_resident(
                xs, ys, idx, sups)["loss"])
            _sync(dev)
            calls += 1
            elapsed = time.perf_counter() - t_start
            flag.fill_(int(elapsed >= ctx.seconds))
            dist.broadcast(flag, 0)
            if int(flag):
                break
        log(f"window: {calls} calls")
        tr = None
        if ctx.trace:
            def traced():
                for _ in range(mix["trace_calls"]):
                    engine.train_steps_resident(
                        xs, ys, rng.integers(0, samples, size=(s, b)), sups)

            if rank == 0:
                tr, _ = trace.capture(traced)
            else:
                traced()
                _sync(dev)
            log("traced calls")
        failed = int((~torch.isfinite(torch.cat(window_losses))).sum())
        if rank == 0:
            res = {"losses": losses, "grad1": grad1, "moved": moved,
                   "steps": calls * s, "elapsed": elapsed,
                   "t_start_wall": t_start_wall, "trace": tr,
                   "failed": failed, "first": first,
                   "peak_bytes": (torch.cuda.max_memory_reserved(dev)
                                  if cuda else 0),
                   "weights": {k: v.cpu() for k, v in w0.items()},
                   "x0": xs[:1].cpu()}
            part = os.path.join(spec["out"], "rank0.part")
            with open(part, "wb") as f:
                pickle.dump(res, f)
            os.replace(part, os.path.join(spec["out"], "rank0.pkl"))
        # no rank leaves before rank 0 has written its results: a peer's
        # exit can make the group's watchdog end the others
        t_wait = time.monotonic()
        while not os.path.exists(os.path.join(spec["out"], "rank0.pkl")):
            if time.monotonic() - t_wait > WAIT_S:
                raise RuntimeError("rank 0 wrote no results")
            time.sleep(0.1)
        with open(os.path.join(spec["out"], f"done{rank}"), "w"):
            pass
        log("done")
        code = 0
    except BaseException:
        traceback.print_exc()
        code = 1
    # every collective this rank took part in has completed (it synced
    # its card after its last call): leave without tearing the group down
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def reference(ctx, cache: dict, out: dict, q=None, batches=None) -> dict:
    """The reference's first steps at the global batch from the run's
    weights and batches (or ``batches``), rounded by ``q`` (default:
    float32): ``gwnet_ref.train_steps`` with every layer of its forward
    recomputed in the backward (``reference.remat_ref``)."""
    from reference import gwnet_ref, remat_ref

    rg = graph.reference(ctx, cache)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    with remat_ref.layers_recomputed():
        res = gwnet_ref.train_steps(
            out["inputs"]["weights"], batches or out["inputs"]["batches"],
            rg["fixed"], rg["pairs"], ctx.config["model"],
            ctx.config["optimizer"], ctx.config["scaler"], gen,
            q or gwnet_ref.identity)
    w0 = out["inputs"]["weights"]
    return {"losses": res["losses"],
            "grad1": compare.norms(res["first_grad"]),
            "moved": compare.norms({k: v - w0[k]
                                    for k, v in res["params"].items()})}


def gaps(side: dict, ref: dict) -> dict:
    """The compared numbers of one side (the program, or the control)
    against the reference."""
    return {"loss_gap": compare.loss_gap(side["losses"], ref["losses"]),
            "grad_gap": compare.leaf_gap(side["grad1"], ref["grad1"],
                                         ref["grad1"])[0],
            "step_gap": compare.leaf_gap(side["moved"], ref["moved"],
                                         ref["grad1"])[0]}


def numbers(ctx, cache: dict, out: dict) -> dict:
    """:func:`gaps` less ``step_gap``, which no limit separates here: the
    float8 control reads 1.3 times the program's largest reading."""
    ref = reference(ctx, cache, out)
    out["reference"] = ref
    nums = gaps(out["program"], ref)
    del nums["step_gap"]
    return nums


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]))
