"""The comparison that decides ``correct``, driven through a run on the
CPU at a small size (past the look for a card): the program's CPU path
agrees with the reference within each cell's limits; the control (the
reference in float8) and each fault planted under the timed path come
out not correct."""

from __future__ import annotations

import json

import pytest
from conftest import BENCH, run_small, small_cell

from gwbench import registry

TRAIN = ["city-40k.train", "metr-la.train"]
SERVE = ["city-40k.serve", "city-40k.serve-sat"]


def limits(name: str) -> dict:
    return registry.workload(name)["limits"]


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_the_program_agrees_with_the_reference(name):
    """...and the run reports the end-to-end metrics that BENCHMARK.json
    gives its cell."""
    ok, compared, out = run_small(small_cell(name))
    assert out["failed"] == 0
    assert ok, compared
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(out["e2e"]) | {"peak_mem_gib", "setup_s"} == want


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_fails(name):
    """The reference in per-tensor scaled float8 in the program's place,
    against the float32 reference."""
    from reference import gwnet_ref

    cell = small_cell(name)
    ok, _, out = run_small(cell)
    mod = registry.traffic_kind("train_resident")
    ctx, cache = _ctx(cell), {}
    ref = mod.reference(ctx, cache, out)
    ctrl = mod.reference(ctx, cache, out, q=gwnet_ref.fp8_rounding)
    nums = mod.gaps(ctrl, ref)
    lim = limits(name)
    assert any(nums[k] > lim[k] for k in nums), (nums, lim)


def test_the_serving_control_fails():
    from reference import gwnet_ref

    cell = small_cell("city-40k.serve")
    _, _, out = run_small(cell)
    mod = registry.traffic_kind("open_loop_serve")
    ctx, cache = _ctx(cell), {}
    ids = out["inputs"]["keep"]
    ref = mod.reference(ctx, cache, out, ids)
    ctrl = mod.reference(ctx, cache, out, ids, q=gwnet_ref.fp8_rounding)
    nums = mod.gaps({j: v.numpy() for j, v in ctrl.items()}, ref,
                    cell["config"]["scaler"])
    lim = limits("city-40k.serve")
    assert any(nums[k] > lim[k] for k in nums), (nums, lim)


def _ctx(cell):
    import time

    import run

    return run.Ctx(cell, 3_000_000_017, 0.5, False, dev="cpu",
                   t0=time.perf_counter())


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_returns_its_state_unchanged(name, monkeypatch):
    from graph_wavenet_tpu_torch.train.engine import Engine

    monkeypatch.setattr(Engine, "_update", lambda self: None)
    ok, compared, _ = run_small(small_cell(name))
    assert not ok
    assert compared["step_gap"]["value"] > compared["step_gap"]["limit"]


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name, monkeypatch):
    from graph_wavenet_tpu_torch.train.engine import Engine

    rows_of = Engine._rows_of

    def half(self, xs, ys, sel):
        return rows_of(self, xs, ys, sel[: sel.shape[0] // 2])

    monkeypatch.setattr(Engine, "_rows_of", half)
    ok, compared, _ = run_small(small_cell(name, batch=8, samples=32))
    assert not ok
    assert any(c["value"] > c["limit"] for c in compared.values())


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    predict = Forecaster.predict

    def altered(self, x):
        out = predict(self, x).clone()
        out[:, 0, 7] += 5.0 * 15.0          # one sensor, five std off
        return out

    monkeypatch.setattr(Forecaster, "predict", altered)
    ok, compared, _ = run_small(small_cell("city-40k.serve"))
    assert not ok
    assert compared["forecast_max_gap"]["value"] > \
        compared["forecast_max_gap"]["limit"]

