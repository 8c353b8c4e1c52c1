"""The sweep that finds a serving mix's knee, on the card, in one process:

    python3 benchmark/sweep.py --workload city-40k.serve \
        --rates 30 40 50 55 60 65 70 80 --seconds 15

Runs the cell's traffic at each offered rate (requests a second) and
prints the forecasts answered per second, the latency quantiles, how far
the latency grew over the window (``growth``), and the batches the calls
ran at. The knee is the highest offered rate answered in full with a
latency that does not grow over the window. A rate given twice runs
twice, on another seed. The benchmark's own runs never run this; a cell
fixes its rate.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

import run  # noqa: E402
from gwbench import registry  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=4_200_000_001)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = registry.cell(args.workload)
    mod = registry.traffic_kind(base["traffic"]["kind"])
    cache: dict = {}
    for i, rate in enumerate(args.rates):
        cell = copy.deepcopy(base)
        cell["traffic"]["rate_per_s"] = rate
        ctx = run.Ctx(cell, args.seed + 7919 * i, args.seconds, False,
                      t0=time.perf_counter())
        out = mod.run(ctx, cache)
        print(json.dumps({
            "offered_per_s": rate, "seed": ctx.seed,
            "latency_ms": out["latency_ms"], "counters": out["counters"],
            "failed": out["failed"], "numbers": out["numbers"]}),
            flush=True)
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
