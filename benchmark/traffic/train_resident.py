"""Training on device-resident windows: ``Engine.train_steps_resident``,
one CUDA graph of a step replayed, each step on a seeded random batch of
the resident windows.

Set-up makes the weights and ``samples`` windows on the card from the
seed, builds one engine and drives it through its first three steps on
rows that all differ, through the window's own call (the first call
captures the graph), reading the first gradient as Adam took it and the
weights after the third step. The window then calls the same engine with
``steps_per_call`` steps a call until ``--seconds`` have passed. After
it the program is freed and the reference follows the first three steps
from the same weights, batches and dropout stream.

Mix parameters: ``batch``, ``samples`` (resident windows),
``steps_per_call``, ``trace_calls`` (calls in the traced segment), and
``family``: the run reports ``<family>_samples_per_s``, and the per-layer
readers of that family read its traced segment.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gwbench import compare, count, graph, inputs

FIRST_STEPS = 3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _first_rows(rng, samples: int, batch: int) -> np.ndarray:
    if samples < FIRST_STEPS * batch:
        raise ValueError("the first steps need samples >= 3 x batch")
    return rng.permutation(samples)[:FIRST_STEPS * batch].reshape(
        FIRST_STEPS, batch)


def run(ctx, cache: dict | None = None) -> dict:
    from graph_wavenet_tpu_torch.config import TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    from gwbench import program

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    m, opt, sc = cfg["model"], cfg["optimizer"], cfg["scaler"]
    b, samples, s = mix["batch"], mix["samples"], mix["steps_per_call"]
    cache = {} if cache is None else cache
    pg = graph.program(ctx, cache)
    sups = pg["supports"]
    engine = Engine(program.model_config(cfg), TrainConfig(
        batch_size=b, learning_rate=opt["learning_rate"],
        weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]),
        StandardScaler(sc["mean"], sc["std"]), device=dev, seed=ctx.seed)
    gen = inputs.generator(ctx.seed, dev)
    w0 = inputs.weights(program.shapes(engine.model), gen, dev)
    program.load(engine.model, w0)
    xs, ys = inputs.readings(samples, cfg["graph"]["nodes"],
                             m["seq_length"], m["out_dim"], sc, gen, dev)
    rng = np.random.default_rng(ctx.seed)
    first = _first_rows(rng, samples, b)

    # the first steps, through the window's call
    params = dict(engine.model.named_parameters())
    losses = [engine.train_steps_resident(xs, ys, first[:1], sups)["loss"]]
    state = engine.optimizer.state
    grad1 = {k: (state[p]["exp_avg"] / (1.0 - 0.9)) if p in state else None
             for k, p in params.items()}
    grad1 = compare.norms(grad1)
    losses.append(engine.train_steps_resident(xs, ys, first[1:], sups)
                  ["loss"])
    moved = compare.norms({k: p.detach() - w0[k] for k, p in params.items()})
    losses = torch.cat(losses).tolist()

    _sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    calls, window_losses = 0, []
    with ctx.clocks():
        while True:
            idx = rng.integers(0, samples, size=(s, b))
            window_losses.append(engine.train_steps_resident(
                xs, ys, idx, sups)["loss"])
            _sync(dev)
            calls += 1
            elapsed = time.perf_counter() - t_start
            if elapsed >= ctx.seconds:
                break
    steps = calls * s
    out = {"setup_s": setup_s, "window_s": elapsed, "attempted": steps}
    out["e2e"] = {f"{mix['family']}_samples_per_s": (steps * b / elapsed,
                                                     "samples/s")}
    if ctx.trace:
        def traced():
            for _ in range(mix["trace_calls"]):
                engine.train_steps_resident(
                    xs, ys, rng.integers(0, samples, size=(s, b)), sups)

        tr, _ = ctx.capture(traced)
        work = count.step_work(cfg, pg | cfg["graph"], b, train=True)
        out["records"] = {"kind": mix["family"], "trace": tr, "work": [work] * (
            mix["trace_calls"] * s), "flops_window": work.flops * steps,
            "window_s": elapsed}
    out["peak_bytes"] = ctx.peak_bytes()
    out["failed"] = int((~torch.isfinite(torch.cat(window_losses))).sum())
    batches = [(xs[r].clone(), ys[r].clone()) for r in
               (torch.as_tensor(f, device=dev) for f in first)]
    del engine, xs, ys, params, state, window_losses
    ctx.free()
    out["program"] = {"losses": losses, "grad1": grad1, "moved": moved}
    out["inputs"] = {"weights": w0, "batches": batches}
    out["numbers"] = numbers(ctx, cache, out)
    return out


def reference(ctx, cache: dict, out: dict, q=None, batches=None) -> dict:
    """The reference's first steps from the run's weights and batches (or
    ``batches``), rounded by ``q`` (default: float32)."""
    from reference import gwnet_ref

    rg = graph.reference(ctx, cache)
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
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
    ref = reference(ctx, cache, out)
    out["reference"] = ref
    return gaps(out["program"], ref)

