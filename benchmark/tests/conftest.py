"""The benchmark's tests: CPU tests of its arithmetic, its files and its
comparison (the program's CPU path at small sizes), and tests marked
``cuda`` that decide inside a fixture whether a card is there.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_cell(name: str, **traffic) -> dict:
    """A cell of the benchmark cut to a size the CPU runs in seconds: 1,024
    city sensors in 64-node blocks, or 50 dense ones."""
    from gwbench import registry

    cell = copy.deepcopy(registry.cell(name))
    g = cell["config"]["graph"]
    if g["kind"] == "knn_city":
        g.update(nodes=1024, block_size=64)
        g.pop("live_blocks", None)
        g.pop("adaptive_live_blocks", None)
    else:
        g.update(nodes=50)
    tr = cell["traffic"]
    if tr["kind"] == "train_resident":
        tr.update(batch=4, samples=16, steps_per_call=2, trace_calls=1)
    else:
        tr.update(rate_per_s=16.0, pool=8, sample=8, max_batch=4,
                  threads=8, warm_s=0.25, trace_s=0.25)
    tr.update(traffic)
    return cell


def run_small(cell: dict, seed: int = 3_000_000_017, seconds: float = 0.5):
    """Drive a cell's traffic on the CPU, past the look for a card; returns
    (correct, compared, run output)."""
    import run

    ctx = run.Ctx(cell, seed, seconds, False, dev="cpu",
                  t0=time.perf_counter())
    from gwbench import registry

    out = registry.traffic_kind(cell["traffic"]["kind"]).run(ctx)
    ok, compared = run.judge(ctx, out)
    return ok, compared, out
