"""The benchmark of ``graph_wavenet_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell (``workloads/<cell>.json``) from the root of a checkout:
makes its weights and inputs from ``--seed``, sets the program up, warms
it, measures it for ``--seconds``, and checks what the timed path produced
against the plain reference (``reference/``). With ``--trace 1`` a traced
segment follows the window and the line carries the per-layer metrics
(``metrics/``) in place of the end-to-end ones. The last line of standard
output is one JSON object; the compared numbers and their limits are the
last lines of standard error. A run exits non-zero, printing no result,
without a CUDA card, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from gwbench import device, guard, registry, trace  # noqa: E402


class Ctx:
    """One run: the cell's files, the seed and window, and the device
    hooks the traffic kinds call."""

    def __init__(self, cell: dict, seed: int, seconds: float, traced: bool,
                 dev: str = "cuda", t0: float | None = None):
        self.workload = cell["workload"]
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed, self.seconds, self.trace = seed, seconds, traced
        self.device = torch.device(dev)
        self.t0 = T0 if t0 is None else t0
        self.cuda = self.device.type == "cuda"
        self.sampler = None

    def clocks(self):
        if not self.cuda:
            return contextlib.nullcontext()
        self.sampler = device.ClockSampler()
        return self.sampler

    def capture(self, fn):
        return trace.capture(fn)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_reserved() if self.cuda else 0

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def per_layer(out: dict, kernels: list, peaks: dict | None) -> dict:
    """Every per-layer metric whose reader finds something to read."""
    rec = dict(out["records"], kernels=kernels, peaks=peaks)
    found = {}
    for name, mod in registry.metric_readers().items():
        value = mod.read(rec)
        if value is not None:
            found[name] = {"value": value, "unit": mod.UNIT}
    return found


def result(ctx: Ctx, out: dict, correct: bool, compared: dict) -> dict:
    """The result line: metrics by name with units, the device, and the
    compared numbers last."""
    if ctx.trace:
        metrics = per_layer(out, registry.kernels(),
                            device.peaks(torch.cuda.get_device_name(0)))
    else:
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in out["e2e"].items()}
        metrics["peak_mem_gib"] = {"value": out["peak_bytes"] / 2 ** 30,
                                   "unit": "GiB"}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    dev = device.info(ctx.workload["chips"], out["peak_bytes"])
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if ctx.trace:
        tr = out["records"]["trace"]
        dev["busy_s"] = trace.busy_s(tr)
        dev["window_s"] = tr.window_s
        line["breakdown"] = trace.breakdown(tr)
    if ctx.sampler is not None:
        dev["clocks"] = ctx.sampler.summary()
    line["info"] = {k: out[k] for k in ("latency_ms", "counters", "window_s")
                    if k in out}
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = registry.cell(args.workload)
    try:
        device.require_cards(cell["workload"]["chips"])
    except device.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace))
    kind = registry.traffic_kind(ctx.traffic["kind"])
    out = kind.run(ctx)
    found = guard.loaded()
    if found:
        print(f"no result: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    correct, compared = judge(ctx, out)
    line = result(ctx, out, correct, compared)
    print(json.dumps(line))
    sys.stdout.flush()
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return 0


def judge(ctx: Ctx, out: dict) -> tuple[bool, dict]:
    """``correct``: every compared number within the cell's limit, and no
    step or request failed."""
    from gwbench import compare

    ok, compared = compare.judge(out["numbers"],
                                 ctx.workload.get("limits", {}))
    return ok and out["failed"] == 0, compared


if __name__ == "__main__":
    sys.exit(main())
