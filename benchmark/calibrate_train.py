"""``calibrate.py``'s training readings for every training kind: the
program's compared numbers for each seed, and for the first
``--control`` seeds the control (the reference in per-tensor scaled
float8 where the program rounds to bf16) and the fault of half the batch
left out (planted in the reference), all against the float32
reference, on the card at the cell's own size, in one process (the graph
built once):

    python3 benchmark/calibrate_train.py --workload <cell> --seeds 12 \
        --control 3 [--seconds 2]

A training kind is a traffic kind whose mix has a ``batch`` and whose
module has ``run``, ``reference(ctx, cache, out, q=None, batches=None)``
and ``gaps`` (``train_resident``, ``train_dcrnn``,
``train_resident_dp``); ``calibrate.py`` reads the training branch for
``train_resident`` alone. One JSON line per reading. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first_seed", type=int, default=4_100_000_000)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from reference import gwnet_ref

    cell = registry.cell(args.workload)
    mod = registry.traffic_kind(cell["traffic"]["kind"])
    cache: dict = {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        ctx = run.Ctx(cell, seed, args.seconds, False, t0=t0)
        out = mod.run(ctx, cache)
        print(json.dumps({"seed": seed, "side": "program", **out["numbers"],
                          "failed": out["failed"],
                          "run_s": time.perf_counter() - t0}), flush=True)
        if i < args.control:
            ref = out["reference"]
            t1 = time.perf_counter()
            ctrl = mod.reference(ctx, cache, out, q=gwnet_ref.fp8_rounding)
            print(json.dumps({"seed": seed, "side": "control",
                              **mod.gaps(ctrl, ref),
                              "run_s": time.perf_counter() - t1}),
                  flush=True)
            b = cell["traffic"]["batch"] // 2
            half = [(x[:b], y[:b]) for x, y in out["inputs"]["batches"]]
            fault = mod.reference(ctx, cache, out, batches=half)
            print(json.dumps({"seed": seed, "side": "fault_half_batch",
                              **mod.gaps(fault, ref)}), flush=True)
        del out
        ctx.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
