"""The readers of the program's spans (``gwbench/spans.py`` and the
``program_span`` metrics) on a made-up trace and span list with known
answers; each reads nothing in the other cells' records, nor where the
program has no span store."""

from __future__ import annotations

import pytest

from gwbench import registry, trace

SPAN_METRICS = {"queue_wait_p95_ms.serve_tail", "call_p95_ms.serve_tail",
                "host_gap_ms.serve", "stack_ms.serve", "predict_ms.serve"}
NS = 1_000_000_000


@pytest.fixture
def ring():
    from graph_wavenet_tpu_torch.train import profiling

    profiling.clear()
    yield profiling
    profiling.clear()


def _at(s: float) -> int:
    return int(round(s * NS))


def made_up_run(ring) -> trace.Trace:
    """A traced segment on [100, 110] s, the card idle on [101, 101.5] and
    [103, 104]; spans before it (the window) and overlapping it."""
    for i in range(20):                         # waits of 1..20 ms
        ring.record("serve.queued", _at(50 + i),
                    _at(50 + i) + (i + 1) * 10 ** 6)
    for i, ms in enumerate((30, 10, 20, 40, 50)):
        ring.record("serve.call", _at(60 + i), _at(60 + i) + ms * 10 ** 6)
    for i, ms in enumerate((2, 6, 4)):
        ring.record("serve.stack", _at(70 + i), _at(70 + i) + ms * 10 ** 6,
                    bytes=8)
    for i, (ms, b) in enumerate(((120, 8), (100, 8), (10, 4), (110, 8))):
        ring.record("serve.predict", _at(80 + i), _at(80 + i) + ms * 10 ** 6,
                    bucket=b)
    # inside the segment, read by host_gap_ms alone
    ring.record("serve.queued", _at(100.5), _at(100.6))
    ring.record("serve.stack", _at(100.95), _at(101.4), bytes=8)
    for s, e in ((99.0, 100.2), (100.9, 101.6), (103.2, 103.8),
                 (109.5, 111.0)):
        ring.record("serve.call", _at(s), _at(e))
    dev = [(100.0, 101.0, "gemm"), (101.5, 103.0, "mix_flat2_bf16"),
           (104.0, 110.0, "gemm")]
    return trace.Trace((100.0, 110.0), dev, [])


def _read(rec) -> dict:
    readers = registry.metric_readers()
    return {k: readers[k].read(rec) for k in SPAN_METRICS}


@pytest.mark.parametrize("tail", [True, False])
def test_span_readers_on_a_made_up_run(ring, tail):
    tr = made_up_run(ring)
    got = _read({"kind": "serve", "tail": tail, "trace": tr})
    if tail:
        want = {"queue_wait_p95_ms.serve_tail": 19.05,
                "call_p95_ms.serve_tail": 48.0}
    else:
        # idle gaps with middles 101.25 and 103.5 lie in two of the four
        # calls that overlap the segment: 1.5 s over 4 calls
        want = {"host_gap_ms.serve": 1e3 * 1.5 / 4, "stack_ms.serve": 4.0,
                "predict_ms.serve": 110.0}
    assert {k for k, v in got.items() if v is not None} == set(want)
    assert {k: got[k] for k in want} == pytest.approx(want)


def test_span_readers_read_nothing_elsewhere(ring, monkeypatch):
    tr = made_up_run(ring)
    for kind in ("train", "metr_train"):
        assert set(_read({"kind": kind, "trace": tr}).values()) == {None}
    # a segment traced before every span: nothing ended before it, and no
    # call overlaps it
    early = trace.Trace((0.0, 10.0), tr.device, [])
    for tail in (True, False):
        got = _read({"kind": "serve", "tail": tail, "trace": early})
        assert set(got.values()) == {None}
    # a program without the span store
    monkeypatch.delattr(ring, "spans")
    for tail in (True, False):
        got = _read({"kind": "serve", "tail": tail, "trace": tr})
        assert set(got.values()) == {None}


def test_span_metrics_are_in_the_benchmark():
    import json

    from conftest import BENCH

    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in spec["per_layer"]
           if m["source"] == "program_span"}
    assert set(got) == SPAN_METRICS
    for name, m in got.items():
        cell = "city-40k.serve" if name.endswith("_tail") else \
            "city-40k.serve-sat"
        assert m["workloads"] == [cell]
