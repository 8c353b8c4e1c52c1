"""The two cells that train DCRNN (``dcrnn-city-40k.train``) and the city
model data-parallel over four cards (``city-40k.train-dp4``), driven on
the CPU at a small size as ``test_bench_correct.py`` drives the others:
the program agrees with the reference within the cell's limits and
reports the metrics ``BENCHMARK.json`` gives the cell; the control (the
reference in float8) and half the batch left out come out not correct;
the benchmark's count of a DCRNN step is what ``torch.utils.flop_counter``
counts over the reference; the data-parallel kind runs two gloo ranks."""

from __future__ import annotations

import copy
import json

import pytest
import torch
from conftest import BENCH, run_small

from gwbench import count_dcrnn, graph, registry

DCRNN = "dcrnn-city-40k.train"
DP = "city-40k.train-dp4"


def small(name: str, **traffic) -> dict:
    """The cell at 1,024 city sensors in 64-node blocks (512 for the
    data-parallel kind, two ranks), DCRNN over 4 steps in and out."""
    cell = copy.deepcopy(registry.cell(name))
    g = cell["config"]["graph"]
    g.update(nodes=1024, block_size=64)
    g.pop("live_blocks")
    g.pop("adaptive_live_blocks")
    tr = cell["traffic"]
    if tr["kind"] == "train_dcrnn":
        cell["config"]["model"].update(seq_len=4, horizon=4)
        tr.update(batch=4, samples=16, steps_per_call=2, trace_calls=1)
    else:
        g.update(nodes=512)
        cell["config"]["model"].update(blocks=1)
        cell["config"]["precision"]["activations"] = "float32"
        tr.update(batch=4, ranks=2, samples=12, steps_per_call=2,
                  trace_calls=1)
    tr.update(traffic)
    return cell


def limits(name: str) -> dict:
    return registry.workload(name)["limits"]


def _ctx(cell):
    import time

    import run

    return run.Ctx(cell, 3_000_000_017, 0.5, False, dev="cpu",
                   t0=time.perf_counter())


@pytest.fixture(scope="module")
def dcrnn_run():
    cell = small(DCRNN)
    return cell, run_small(cell)


def test_dcrnn_agrees_and_reports_its_metrics(dcrnn_run):
    _, (ok, compared, out) = dcrnn_run
    assert out["failed"] == 0
    assert ok, compared
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if DCRNN in m.get("workloads", [DCRNN])}
    assert set(out["e2e"]) | {"peak_mem_gib", "setup_s"} == want
    # the coins both ways, counted on the device
    c = out["counters"]
    assert c["teacher_forced"] > 0 and c["fed_back"] > 0


def test_dcrnn_control_fails(dcrnn_run):
    from reference import gwnet_ref

    cell, (_, _, out) = dcrnn_run
    mod = registry.traffic_kind("train_dcrnn")
    ctx, cache = _ctx(cell), {}
    ctrl = mod.reference(ctx, cache, out, q=gwnet_ref.fp8_rounding)
    nums = mod.gaps(ctrl, out["reference"])
    lim = limits(DCRNN)
    assert any(nums[k] > lim[k] for k in nums), (nums, lim)


def test_dcrnn_half_the_batch_left_out(monkeypatch):
    from graph_wavenet_tpu_torch.train.engine import Engine

    rows_of = Engine._rows_of

    def half(self, xs, ys, sel):
        return rows_of(self, xs, ys, sel[: sel.shape[0] // 2])

    monkeypatch.setattr(Engine, "_rows_of", half)
    ok, compared, _ = run_small(small(DCRNN, batch=8, samples=32))
    assert not ok
    assert any(c["value"] > c["limit"] for c in compared.values())


def test_the_dcrnn_count_is_the_flop_counters_over_the_reference():
    """One step of the reference, forward and backward, in pieces of the
    batch: every matrix product it runs is one the count counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from reference import dcrnn_ref

    cell = small(DCRNN)
    ctx = _ctx(cell)
    cfg, m = cell["config"], cell["config"]["model"]
    rg = graph.reference(ctx, {})
    b, n = 3, cfg["graph"]["nodes"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, m["seq_len"], n, m["input_dim"]), generator=gen)
    y = 50.0 + torch.randn((b, m["horizon"], n, 2), generator=gen)
    from graph_wavenet_tpu_torch.models.dcrnn import DCRNN as Model
    from graph_wavenet_tpu_torch.config import DCRNNConfig

    model = Model(DCRNNConfig(num_nodes=n, seq_len=m["seq_len"],
                              horizon=m["horizon"]), device="cpu")
    p0 = {k: v.detach() for k, v in model.named_parameters()}
    teacher = [[True, False, True]]
    with FlopCounterMode(display=False) as fc:
        dcrnn_ref.train_steps(p0, [(x, y)], rg["fixed"], m,
                              cfg["optimizer"], cfg["scaler"], teacher)
    work = count_dcrnn.step_work(cfg, cfg["graph"] | {
        "live_blocks": [s.n_live for s in rg["fixed"]]}, b)
    assert fc.get_total_flops() == work.flops
    # a cell: 2 convolutions x 2 supports x (forward + transpose), less
    # the first cell's gate transposes
    cells = m["num_rnn_layers"] * (m["seq_len"] + m["horizon"])
    assert len(work.hop_units) == 8 * cells - 2


def test_the_data_parallel_kind_runs_two_gloo_ranks():
    """Two ranks of the data-parallel kind on the CPU (gloo, the fused
    calls as eager loops) against the reference at the global batch."""
    ok, compared, out = run_small(small(DP), seconds=0.1)
    assert out["failed"] == 0
    assert ok, compared
    assert set(out["e2e"]) == {"train_samples_per_s"}
    assert out["attempted"] >= 2
