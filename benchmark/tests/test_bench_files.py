"""The benchmark finds its parts by name, and a part is added by adding a
file; BENCHMARK.json and the files agree; the import guard and the look
for a card."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import BENCH

from gwbench import guard, registry

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())


def test_cells_configs_and_traffic_found_by_name():
    for w in SPEC["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert cell["workload"]["traffic"] == w["traffic"]
        assert cell["workload"]["chips"] == w["chips"]
        assert cell["workload"]["why"] == w["why"]
        registry.traffic_kind(cell["traffic"]["kind"])
        registry.graph_kind(cell["config"]["graph"]["kind"])
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert registry.config(c["name"])["reduced"] == c["reduced"]
        assert registry.config(c["name"])["source"] == c["source"]
        assert registry.config(c["name"])["why"] == c["why"]


def test_every_per_layer_metric_has_a_reader_with_its_unit():
    readers = registry.metric_readers()
    for m in SPEC["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"], m["name"]
    assert set(readers) == {m["name"] for m in SPEC["per_layer"]}


def test_kernels_found():
    ks = registry.kernels()
    assert {k["kernel"] for k in ks} == {1, 2, 3, 4, 5}
    assert all(k["pattern"] for k in ks)


@pytest.mark.parametrize("part", ["config", "cell", "traffic", "metric",
                                  "kernel"])
def test_a_part_is_added_by_adding_a_file(tmp_path, part):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    if part == "config":
        src = json.loads((root / "configs/gwnet-metr-la.json").read_text())
        src["graph"]["nodes"] = 325
        (root / "configs/gwnet-pems-bay.json").write_text(json.dumps(src))
        assert registry.config("gwnet-pems-bay", root)["graph"]["nodes"] \
            == 325
    elif part == "cell":
        (root / "workloads/metr-la.train-b32.json").write_text(json.dumps(
            {"config": "gwnet-metr-la", "traffic": "train_b64", "chips": 1,
             "why": "a test"}))
        assert registry.cell("metr-la.train-b32", root)["traffic"][
            "batch"] == 64
    elif part == "traffic":
        (root / "traffic/train_b16.json").write_text(json.dumps(
            {"kind": "train_resident", "batch": 16, "samples": 64,
             "steps_per_call": 8, "trace_calls": 1}))
        assert registry.traffic("train_b16", root)["batch"] == 16
    elif part == "metric":
        (root / "metrics/steps_traced.train.py").write_text(
            'UNIT = "steps"\n\n\ndef read(rec):\n'
            '    return len(rec["work"]) if rec["kind"] == "train" '
            'else None\n')
        mod = registry.metric_readers(root)["steps_traced.train"]
        assert mod.read({"kind": "train", "work": [1, 2]}) == 2
        assert mod.read({"kind": "serve", "work": []}) is None
    else:
        (root / "kernels/mix_new.json").write_text(json.dumps(
            {"pattern": "mix_new_", "kernel": 6, "work": "a test"}))
        assert "mix_new" in {k["name"] for k in registry.kernels(root)}
    with pytest.raises(KeyError):
        registry.config("no-such-config", root)


@pytest.mark.parametrize("names,found", [
    (["torch", "graph_wavenet_tpu_torch.models.gwnet"], []),
    (["graph_wavenet_tpu.ops.diffusion"], ["graph_wavenet_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_extra", "flaxen"], []),
])
def test_import_guard_compares_top_level_names(names, found):
    assert guard.loaded(names) == found


def test_the_harness_and_reference_load_no_jax():
    import importlib
    import sys

    for mod in ("run", "gwbench.count", "gwbench.trace",
                "reference.gwnet_ref", "reference.graph_ref"):
        importlib.import_module(mod)
    assert guard.loaded(sys.modules) == []


def test_no_card_no_result(capsys):
    import torch

    import run

    if torch.cuda.is_available():
        pytest.skip("a card is there")
    rc = run.main(["--workload", "metr-la.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and not set(s) & {
        "\n", "\r", "\t"}


def _cells_of(metric):
    return set(metric.get("workloads", [w["name"] for w in SPEC["workloads"]]))


def test_benchmark_json_shape():
    assert (BENCH.parent / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(cmd) <= 32 and all(map(_line, cmd))
    assert not any(w.startswith("/") or ".." in w.split("/") for w in cmd)
    assert 1 <= len(paths) <= 16
    assert all(PATH.fullmatch(p) and ".." not in p.split("/") for p in paths)
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    cfgs, cells = SPEC["configs"], SPEC["workloads"]
    assert 1 <= len(cfgs) <= 24 and 1 <= len(cells) <= 24
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and _line(c["why"])
        assert _line(c["source"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in paths)
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    assert len({c["file"] for c in cfgs}) == len(cfgs)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert {w["config"] for w in cells} == {c["name"] for c in cfgs}
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)

    e2e, per_layer = SPEC["end_to_end"], SPEC["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    names = [x["name"] for x in cfgs] + [x["name"] for x in cells]
    metrics = e2e + per_layer
    assert len({x["name"] for x in cfgs}) == len(cfgs)
    assert len({x["name"] for x in cells}) == len(cells)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        names.append(m["name"])
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert _cells_of(m) <= {w["name"] for w in cells}
    assert all(NAME.fullmatch(n) for n in names)

    by_name = {m["name"]: m for m in e2e}
    assert "setup_s" in by_name and "workloads" not in by_name["setup_s"]
    for m in per_layer:
        assert _cells_of(m) <= _cells_of(by_name[m["moves"]])
    for w in cells:
        reported = {m["name"] for m in e2e if w["name"] in _cells_of(m)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in _cells_of(m) for m in per_layer)
