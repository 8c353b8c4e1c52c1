"""City-wide forecasts served open loop: requests come at the times of a
fixed schedule, whether or not earlier ones have been answered, each one
window over every sensor, through ``MicroBatcher`` to
``Forecaster.predict`` in original node order.

The schedule offers ``rate_per_s`` requests a second in arrivals of
``burst`` requests each, spaced by a Poisson process. It is drawn from
the mix's own
``schedule_seed``, so every ``--seed`` sends the same requests at the
same times; the seed draws the weights, the windows and their order.

Set-up makes the weights and a pool of ``pool`` windows from the seed,
builds the forecaster (eval mode, every support) and the batcher, calls
the forecaster twice at every batch the batcher can form, and serves
``warm_s`` of schedule. A request's time runs from its due time to its
answer in the client's hand. The window's requests are those due within
``--seconds``; every answer is waited for, up to a minute past the close,
and the window ends at the last answer. A seeded sample of ``sample``
requests keep their answers, which the reference recomputes once the
program is freed.

Mix parameters: ``rate_per_s``, ``burst``, ``schedule_seed``, ``max_batch``, ``window_ms`` (the batcher's), ``pool``,
``sample``, ``threads`` (client threads: ``submit`` blocks until its
answer), ``warm_s``, ``trace_s`` (schedule seconds in the traced
segment), ``family`` (the per-layer readers' name for the records) and
``tail``: whether the run reports ``forecast_p95_ms`` (below the knee,
where the answered rate is the offered one) or ``forecasts_per_s``
(above it, where the queue grows all through the window and the tail
swings with it).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time

import numpy as np
import torch

from gwbench import compare, count, graph, inputs

WAIT_PAST_CLOSE_S = 60.0


def _bucket(n: int, most: int) -> int:
    """The batch a call of ``n`` requests runs at: the batcher pads to the
    next power of two, at most ``most``."""
    b = 1
    while b < n:
        b *= 2
    return min(b, most)


def due_times(mix: dict, seconds: float, part: int = 0) -> np.ndarray:
    """Each request's due time, in seconds from the schedule's start: the
    arrivals within ``seconds``, ``burst`` requests each. ``part`` draws
    the warm-up (1) and the traced segment (2) apart from the window
    (0)."""
    gap = mix["burst"] / mix["rate_per_s"]
    n = max(1, int(np.ceil(seconds / gap)))
    rng = np.random.default_rng([mix["schedule_seed"], part])
    t = np.cumsum(rng.exponential(gap, size=4 * n + 64)) - gap
    return np.repeat(t[(t >= 0) & (t < seconds)], mix["burst"])


def _growth(lat: np.ndarray) -> float:
    """The median latency of the last fifth of answers over the first
    fifth's: about 1 where the queue holds steady, above where it grows."""
    k = max(1, lat.size // 5)
    return float(np.median(lat[-k:]) / np.median(lat[:k]))


def _schedule(batcher, pool: np.ndarray, order: np.ndarray,
              due: np.ndarray, threads: int, keep: set,
              first_id: int = 0) -> dict:
    """Send each request at its due time; returns each request's latency,
    lateness, answer (for ids in ``keep``) and failures."""
    lock = threading.Lock()
    res = {"latency": [], "late": [], "answers": {}, "failed": 0}

    def one(j: int, due: float):
        sent = time.perf_counter()
        try:
            y = batcher.submit(pool[order[j % len(order)]])
            ok = bool(np.isfinite(y).all())
        except Exception:                      # counted as failed
            y, ok = None, False
        done = time.perf_counter()
        with lock:
            res["latency"].append(done - due)
            res["late"].append(sent - due)
            res["last"] = max(res.get("last", done), done)
            if not ok:
                res["failed"] += 1
            elif j in keep:
                res["answers"][j] = y

    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        futs = []
        t0 = time.perf_counter()
        for i, d in enumerate(due):
            at = t0 + d
            wait = at - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futs.append(ex.submit(one, first_id + i, at))
        done, pending = concurrent.futures.wait(
            futs, timeout=WAIT_PAST_CLOSE_S + float(due[-1]))
        for f in futs:
            if f in done:
                f.result()
    res.update(t0=t0, sent=len(futs), unanswered=len(pending))
    return res


def run(ctx, cache: dict | None = None) -> dict:
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.train.serving import Forecaster, MicroBatcher

    from gwbench import program

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    m, sc, g = cfg["model"], cfg["scaler"], cfg["graph"]
    cache = {} if cache is None else cache
    pg = graph.program(ctx, cache)
    mcfg = program.model_config(cfg)
    model = GWNet(mcfg, device=dev)
    gen = inputs.generator(ctx.seed, dev)
    w0 = inputs.weights(program.shapes(model), gen, dev)
    program.load(model, w0)
    model.eval()
    fc = Forecaster(mcfg, model, pg["supports"],
                    StandardScaler(sc["mean"], sc["std"]),
                    node_layout=pg["layout"])
    x_pool, _ = inputs.readings(mix["pool"], g["nodes"], m["seq_length"],
                                m["out_dim"], sc, gen, dev)
    pool = x_pool.cpu().numpy()
    del x_pool
    rng = np.random.default_rng(ctx.seed)
    order = rng.permutation(mix["pool"])
    due = due_times(mix, ctx.seconds)
    total = len(due)
    keep = set(rng.choice(total, size=min(mix["sample"], total),
                          replace=False).tolist())
    b = 1
    while True:                             # every batch the batcher forms
        for _ in range(2):
            fc.predict(pool[:b]).cpu()
        if b >= mix["max_batch"]:
            break
        b = min(2 * b, mix["max_batch"])
    threads = mix["threads"]
    with MicroBatcher(fc.predict, max_batch=mix["max_batch"],
                      window_ms=mix["window_ms"]) as batcher:
        _schedule(batcher, pool, order, due_times(mix, mix["warm_s"], 1),
                  threads, set(), total)
        h0 = dict(batcher.stats["batch_histogram"])
        setup_s = time.perf_counter() - ctx.t0
        with ctx.clocks():
            res = _schedule(batcher, pool, order, due, threads, keep)
        calls = {n: c - h0.get(n, 0)
                 for n, c in batcher.stats["batch_histogram"].items()}
        out = {"setup_s": setup_s}
        answered = len(res["latency"]) - res["failed"]
        window = res.get("last", res["t0"]) - res["t0"]
        lat = np.asarray(res["latency"]) * 1e3
        out["window_s"] = window
        out["attempted"] = res["sent"]
        out["failed"] = res["failed"] + res["unanswered"]
        rate = answered / window
        out["e2e"] = ({"forecast_p95_ms": (float(np.percentile(lat, 95)),
                                           "ms")} if mix["tail"] else
                      {"forecasts_per_s": (rate, "forecasts/s")})
        q = (50, 75, 90, 95, 99, 100)
        out["latency_ms"] = dict(zip(
            (f"p{p}" for p in q), np.percentile(lat, q).tolist()),
            count=int(lat.size), late_max=1e3 * max(res["late"]),
            growth=_growth(lat), answered_per_s=rate)
        out["counters"] = {
            "requests": sum(n * c for n, c in calls.items()),
            "device_calls": sum(calls.values()),
            "calls_by_batch": {n: c for n, c in sorted(calls.items()) if c}}
        if ctx.trace:
            h1 = dict(batcher.stats["batch_histogram"])
            tr, _ = ctx.capture(lambda: _schedule(
                batcher, pool, order, due_times(mix, mix["trace_s"], 2),
                threads, set(), total))
            work = []
            for n, c in batcher.stats["batch_histogram"].items():
                wk = count.step_work(cfg, pg | g,
                                     _bucket(n, mix["max_batch"]),
                                     train=False)
                work += [wk] * (c - h1.get(n, 0))
            flops = sum(c * count.step_work(cfg, pg | g, n,
                                            train=False).flops
                        for n, c in calls.items())
            out["records"] = {
                "kind": mix["family"], "tail": mix["tail"], "trace": tr,
                "work": work,
                "flops_window": flops, "window_s": window,
                "counters": out["counters"]}
    out["peak_bytes"] = ctx.peak_bytes()
    answers = res["answers"]
    del fc, model, batcher
    ctx.free()
    out["inputs"] = {"weights": w0, "pool": pool, "order": order,
                     "answers": answers, "keep": sorted(keep)}
    out["numbers"] = numbers(ctx, cache, out)
    return out


def reference(ctx, cache: dict, out: dict, ids, q=None) -> dict:
    """The reference's forecasts of requests ``ids``, rounded by ``q``."""
    from reference import gwnet_ref

    rg = graph.reference(ctx, cache)
    pool, order = out["inputs"]["pool"], out["inputs"]["order"]
    ids = list(ids)
    got = {}
    step = ctx.traffic["max_batch"]
    for lo in range(0, len(ids), step):
        part = ids[lo:lo + step]
        x = torch.as_tensor(np.stack([pool[order[j % len(order)]]
                                      for j in part]), device=ctx.device)
        y = gwnet_ref.predict(out["inputs"]["weights"], x, rg["fixed"],
                              rg["pairs"], ctx.config["model"],
                              ctx.config["scaler"], rg["perm"],
                              q or gwnet_ref.identity)
        for j, row in zip(part, y):
            got[j] = row
    return got


def gaps(side: dict, ref: dict, scaler: dict) -> dict:
    """The worst of the sampled answers' gaps; an answer missing from
    ``side`` reads infinite."""
    nrmse = widest = 0.0
    for j, r in ref.items():
        if j not in side:
            return {"forecast_nrmse": float("inf"),
                    "forecast_max_gap": float("inf")}
        p = torch.as_tensor(side[j], device=r.device)
        a, w = compare.forecast_gaps(p, r, scaler)
        nrmse, widest = max(nrmse, a), max(widest, w)
    return {"forecast_nrmse": nrmse, "forecast_max_gap": widest}


def numbers(ctx, cache: dict, out: dict) -> dict:
    ref = reference(ctx, cache, out, out["inputs"]["keep"])
    return gaps(out["inputs"]["answers"], ref, ctx.config["scaler"])
