"""DCRNN training on device-resident windows: ``DCRNNEngine``'s
``train_steps_resident``, one CUDA graph of a seq2seq step replayed, each
step on a seeded random batch of the resident windows, the decoder's
curriculum coins drawn on the card.

As ``train_resident.py`` runs Graph WaveNet: set-up makes the weights and
``samples`` windows on the card from the seed, builds one engine at the
curriculum's global step ``cl_start_step``, and drives it through its
first three steps on rows that all differ, through the window's own call
(the first call captures the graph, inside the program's span
``dcrnn.capture``), reading the first gradient
as Adam took it and the weights after the third step. The window then
calls the engine with ``steps_per_call`` steps a call until ``--seconds``
have passed. After it the program is freed and the reference follows the
first three steps from the same weights, batches and coins, in pieces of
the batch (``reference/dcrnn_ref.py``).

Mix parameters: ``batch``, ``samples`` (resident windows),
``steps_per_call``, ``trace_calls`` (calls in the traced segment),
``cl_start_step``, and ``family``: the traced segment's records kind,
which the ``*.<family>`` per-layer readers read. The run reports
``train_samples_per_s``, and in ``info.counters`` the program's
``models.dcrnn.COUNTS``: a replay's block-kernel launches and the
decoder inputs teacher-forced and fed back over the run.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gwbench import compare, count_dcrnn, graph, inputs

FIRST_STEPS = 3
E2E = "train_samples_per_s"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def weights(shapes: dict, gen: torch.Generator, device) -> dict:
    """fp32 weights for the parameter names in ``shapes``, as DCRNN
    initializes them: Xavier-uniform projection weights drawn from
    ``gen``, the gate biases 1 and the others 0."""
    uni = [(k, s) for k, s in shapes.items() if k.endswith(".weight")]
    u = torch.rand(sum(math.prod(s) for _, s in uni), generator=gen,
                   device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in uni:
        k = math.prod(shape)
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        out[name] = (u[at:at + k] * bound).reshape(shape)
        at += k
    for name, shape in shapes.items():
        if name.endswith(".bias"):
            fill = 1.0 if name.endswith("gate.bias") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def capture_s() -> float | None:
    """Seconds in the program's last ``dcrnn.capture`` span (the call
    that captured the step graph), or None."""
    from gwbench import spans

    found = spans.named("dcrnn.capture")
    return (found[-1]["end_ns"] - found[-1]["start_ns"]) * 1e-9 \
        if found else None


def run(ctx, cache: dict | None = None) -> dict:
    # a program without DCRNN fails here, at once
    from graph_wavenet_tpu_torch.config import DCRNNConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.models import dcrnn
    from graph_wavenet_tpu_torch.train.engine import DCRNNEngine

    from gwbench import program

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    m, opt, sc = cfg["model"], cfg["optimizer"], cfg["scaler"]
    b, samples, s = mix["batch"], mix["samples"], mix["steps_per_call"]
    cache = {} if cache is None else cache
    pg = graph.program(ctx, cache)
    sups = pg["supports"][:m["n_supports"]]
    mcfg = DCRNNConfig(
        num_nodes=cfg["graph"]["nodes"], input_dim=m["input_dim"],
        output_dim=m["output_dim"], rnn_units=m["rnn_units"],
        num_rnn_layers=m["num_rnn_layers"],
        max_diffusion_step=m["max_diffusion_step"],
        n_supports=m["n_supports"], seq_len=m["seq_len"],
        horizon=m["horizon"], cl_decay_steps=m["cl_decay_steps"],
        dtype=cfg["precision"]["activations"],
        param_dtype=cfg["precision"]["parameters"])
    engine = DCRNNEngine(mcfg, TrainConfig(
        batch_size=b, learning_rate=opt["learning_rate"],
        weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"]),
        StandardScaler(sc["mean"], sc["std"]), device=dev, seed=ctx.seed)
    engine.set_global_step(mix["cl_start_step"])
    gen = inputs.generator(ctx.seed, dev)
    w0 = weights(program.shapes(engine.model), gen, dev)
    program.load(engine.model, w0)
    xs, ys = inputs.readings(samples, cfg["graph"]["nodes"], m["seq_len"],
                             m["horizon"], sc, gen, dev)
    rng = np.random.default_rng(ctx.seed)
    if samples < FIRST_STEPS * b:
        raise ValueError("the first steps need samples >= 3 x batch")
    first = rng.permutation(samples)[:FIRST_STEPS * b].reshape(
        FIRST_STEPS, b)

    # the first steps, through the window's call; the first captures
    params = dict(engine.model.named_parameters())
    losses = [engine.train_steps_resident(xs, ys, first[:1], sups)["loss"]]
    state = engine.optimizer.state
    grad1 = compare.norms({k: (state[p]["exp_avg"] / (1.0 - 0.9))
                           if p in state else None
                           for k, p in params.items()})
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
    out = {"setup_s": setup_s, "window_s": elapsed, "attempted": steps,
           "e2e": {E2E: (steps * b / elapsed, "samples/s")}}
    work = count_dcrnn.step_work(cfg, pg | cfg["graph"], b)
    if ctx.trace:
        def traced():
            for _ in range(mix["trace_calls"]):
                engine.train_steps_resident(
                    xs, ys, rng.integers(0, samples, size=(s, b)), sups)

        tr, _ = ctx.capture(traced)
        out["records"] = {"kind": mix["family"], "trace": tr,
                          "work": [work] * (mix["trace_calls"] * s),
                          "flops_window": work.flops * steps,
                          "window_s": elapsed}
    out["counters"] = dict(dcrnn.read_counts(engine.model),
                           capture_s=capture_s())
    if ctx.trace:
        out["records"]["counters"] = out["counters"]
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
    ``batches``), rounded by ``q`` (default: float32), with the coins the
    program drew: the engine's generator is seeded with the seed and draws
    nothing else."""
    from reference import dcrnn_ref

    rg = graph.reference(ctx, cache)
    m = ctx.config["model"]
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    start = ctx.traffic["cl_start_step"]
    teachers = [dcrnn_ref.coins(gen, start + i, m, ctx.device)
                for i in range(FIRST_STEPS)]
    res = dcrnn_ref.train_steps(
        out["inputs"]["weights"], batches or out["inputs"]["batches"],
        rg["fixed"][:m["n_supports"]], m, ctx.config["optimizer"],
        ctx.config["scaler"], teachers, q or dcrnn_ref.identity)
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
