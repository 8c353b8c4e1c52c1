"""The port's auxiliary modules against their JAX counterparts, on the CPU:

- ``train/profiling.py``: ``trace`` writes a Chrome trace naming the ops
  it saw; the train CLI's ``--profile``; the span store (its bound and
  order, intervals kept across threads, the profiler's clock), the
  ``MicroBatcher``'s spans of a call and of a failed one, and
  ``gwt-torch-serve``'s ``/stats`` percentiles of them;
- ``utils/misc.py`` against JAX ``utils/misc.py`` on
  ``tests/test_e2e.py``'s cases, with ``torch.Generator`` states in the
  place of JAX keys;
- ``graphs/coarsening.py`` against JAX's, bit for bit;
- ``data/native_loader.py``: the C++ library built here, its window and
  batch gathers and feature-0 scaling bit for bit numpy's and JAX's, its
  ``WindowDataLoader`` JAX's batch for batch, the numpy path where the
  library is missing, and ``csrc/windowloader.cpp`` the JAX package's
  ``native/windowloader.cpp`` from its first ``#include`` on;
- ``data/prefetch.py``: order, elements that pass through, a producer's
  exception raised again, the thread gone when the consumer stops, and
  ``Runner.fit``/``test`` with ``prefetch=2`` bit for bit ``prefetch=0``;
- ``convert.load_pth`` of a ``.pth`` written from JAX
  ``utils/torch_import.export_state_dict``: the forward against JAX
  ``apply_gwnet`` at 2e-4, and its refusals;
- ``metrics.batch_time_l1``/``batch_time_mse`` and
  ``MultiModalityPrediction.evaluate``/``astype``/``to`` against JAX.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_chrome_trace(tmp_path):
    from graph_wavenet_tpu_torch.train.profiling import TRACE_FILE, trace

    a = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")):
        (a @ a).sum()
    with open(tmp_path / "prof" / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.fixture
def ring():
    """The span store, emptied before and after the test."""
    from graph_wavenet_tpu_torch.train import profiling

    profiling.clear()
    yield profiling
    profiling.clear()


def test_span_ring_keeps_the_last_spans_in_order(ring):
    first = ring.now_ns()
    for i in range(ring.SPANS + 3):
        ring.record("s", first + i, first + i + 1, i=i)
    got = ring.spans()
    assert len(got) == ring.SPANS
    assert [s["attrs"]["i"] for s in got] == list(range(3, ring.SPANS + 3))
    assert got[0]["start_ns"] == first + 3
    with ring.span("outer", k="v") as outer:
        with pytest.raises(KeyError):
            with ring.span("inner", outer):
                raise KeyError("x")
    inner, out = ring.spans()[-2:]
    assert (inner["name"], inner["parent"], inner["attrs"]) == (
        "inner", outer, {"error": True})
    assert (out["name"], out["id"], out["parent"], out["attrs"]) == (
        "outer", outer, None, {"k": "v"})
    assert out["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= out["end_ns"]
    ring.clear()
    assert ring.spans() == []


def test_record_across_threads(ring):
    """An interval read on one thread is kept by another, under that
    thread's name; many threads recording at once lose no span."""
    import sys

    opened = []
    t = threading.Thread(target=lambda: opened.append(ring.now_ns()),
                         name="client")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and opened

    def close():
        ring.record("queued", opened[0], ring.now_ns(), 7, span_id=99,
                    why="test")

    w = threading.Thread(target=close, name="worker")
    w.start()
    w.join(timeout=10)
    assert not w.is_alive()
    (s,) = ring.spans()
    assert (s["name"], s["id"], s["parent"], s["thread"], s["attrs"]) == (
        "queued", 99, 7, "worker", {"why": "test"})
    assert opened[0] == s["start_ns"] <= s["end_ns"]
    ring.clear()

    def many():
        for _ in range(500):
            with ring.span("busy"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=many) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got = ring.spans()
    assert len(got) == 16 * 500
    assert len({s["id"] for s in got}) == len(got)


def test_span_is_on_the_profilers_clock(ring):
    """An op run inside a span has its profiler event inside the span."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ring.span("mm"):
            torch.mm(a, a)
    (s,) = ring.spans()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert s["start_ns"] <= ev.start_ns()
    assert ev.start_ns() + ev.duration_ns() <= s["end_ns"]


def _batcher_calls(ring):
    by_name = {}
    for s in ring.spans():
        by_name.setdefault(s["name"], []).append(s)
    return by_name


def test_micro_batcher_spans_a_call_and_its_requests(ring):
    """Three concurrent requests in one call: the call's span with its
    bucket, the stack and predict inside it, each request's wait under
    it."""
    from graph_wavenet_tpu_torch.train.serving import MicroBatcher

    def predict(x):
        time.sleep(0.02)
        return torch.as_tensor(x * 2.0)

    xs = np.arange(3 * 5, dtype=np.float32).reshape(3, 5)
    answers = [None] * 3
    with MicroBatcher(predict, max_batch=8, window_ms=300.0) as mb:
        def ask(i):
            answers[i] = mb.submit(xs[i])

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.stack(answers), xs * 2.0)
    got = _batcher_calls(ring)
    (call,) = got["serve.call"]
    assert call["attrs"]["requests"] == 3 and call["attrs"]["bucket"] == 4
    assert call["thread"] == "gwt-microbatcher" and call["parent"] is None
    queued = got["serve.queued"]
    assert sorted(q["id"] for q in queued) == sorted(
        call["attrs"]["request_ids"])
    for q in queued:
        assert q["parent"] == call["id"]
        assert q["start_ns"] <= q["end_ns"] <= call["end_ns"]
    assert min(q["end_ns"] for q in queued) == call["start_ns"]
    (stack,), (pred,) = got["serve.stack"], got["serve.predict"]
    assert stack["attrs"] == {"bytes": 4 * 5 * 4}
    assert pred["attrs"] == {"bucket": 4}
    assert call["start_ns"] <= stack["start_ns"] <= stack["end_ns"] \
        <= pred["start_ns"] <= pred["end_ns"] <= call["end_ns"]
    assert stack["parent"] == pred["parent"] == call["id"]
    assert pred["end_ns"] - pred["start_ns"] >= 0.02e9


def test_micro_batcher_failed_call_closes_its_span(ring):
    from graph_wavenet_tpu_torch.train.serving import MicroBatcher

    def predict(x):
        raise RuntimeError("no card")

    with MicroBatcher(predict, window_ms=1.0) as mb:
        with pytest.raises(RuntimeError, match="no card"):
            mb.submit(np.zeros(3, np.float32))
        assert mb.stats["device_calls"] == 0
    got = _batcher_calls(ring)
    (call,) = got["serve.call"]
    assert call["attrs"]["error"] is True
    assert call["attrs"]["requests"] == 1
    assert got["serve.predict"][0]["attrs"]["error"] is True
    assert got["serve.queued"][0]["parent"] == call["id"]


def test_serve_stats_reports_queue_wait_and_call_ms(ring):
    """``GET /stats``: the batcher's counters, and the percentiles of the
    spans of its requests' waits and of its calls."""
    import urllib.request

    from graph_wavenet_tpu_torch.cli import serve
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler

    assert serve.span_ms("serve.call") == {"p50": None, "p95": None,
                                           "count": 0}
    server, batcher = serve.make_server(
        lambda x: torch.as_tensor(x[:, :2, :, 0]), StandardScaler(0.0, 1.0),
        {}, "127.0.0.1", 0, max_batch=4, window_ms=50.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        req = urllib.request.Request(
            url + "/predict", data=json.dumps(
                {"x": np.ones((3, 12, 5, 2)).tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert np.asarray(json.loads(r.read())["y"]).shape == (3, 2, 5)
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    assert stats["requests"] == 3
    assert stats["queue_wait_ms"]["count"] == 3
    assert stats["call_ms"]["count"] == stats["device_calls"] == 3
    for k in ("queue_wait_ms", "call_ms"):
        assert 0 <= stats[k]["p50"] <= stats[k]["p95"]


def test_train_cli_profile_writes_a_trace(tmp_path):
    """``gwt-torch-train --profile DIR`` on the synthetic task: the trace
    of the whole run, naming a train step's ops."""
    from graph_wavenet_tpu_torch.cli import train

    prof = tmp_path / "prof"
    train.main(["--data", "syn", "--num_nodes", "8", "--nhid", "4",
                "--n_train", "1", "--n_valid", "1", "--n_test", "1",
                "--num_timestep", "100", "--batch_size", "8", "--epochs",
                "1", "--seq_length", "24", "--blocks", "2", "--gcn_bool",
                "--device", CPU, "--save", str(tmp_path / "ck"),
                "--profile", str(prof)])
    with open(prof / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"aten::addmm", "Optimizer.step#Adam.step"} & names


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x,d", [(2.0, "_"), (0.1, "_"), (0.25, "-"),
                                 (3, "_"), (1e-3, "_")])
def test_num2filename_matches_jax(x, d):
    from graph_wavenet_tpu.utils import misc as jmisc
    from graph_wavenet_tpu_torch.utils import misc

    assert misc.num2filename(x, d) == jmisc.num2filename(x, d)


@pytest.mark.parametrize("bitgen", ["PCG64", "MT19937"])
def test_seed_round_trip(tmp_path, bitgen):
    """numpy Generators of the saved bit generator and a torch Generator's
    state come back live; JAX's ``load_seed`` reads the numpy entries the
    port wrote."""
    from graph_wavenet_tpu.utils import misc as jmisc
    from graph_wavenet_tpu_torch.utils import misc

    gen = np.random.Generator(getattr(np.random, bitgen)(42))
    gen.random(5)
    tgen = torch.Generator().manual_seed(7)
    torch.rand(4, generator=tgen)
    misc.save_seed(str(tmp_path), [
        {"module": "numpy", "state": gen},
        {"module": "torch", "state": tgen}])
    states = misc.load_seed(str(tmp_path))
    jstates = jmisc.load_seed(str(tmp_path))
    want_np = gen.random(3)
    np.testing.assert_array_equal(states[0]["state"].random(3), want_np)
    np.testing.assert_array_equal(jstates[0]["state"].random(3), want_np)
    assert states[1]["kind"] == "torch"
    torch.testing.assert_close(torch.rand(3, generator=states[1]["state"]),
                               torch.rand(3, generator=tgen), rtol=0, atol=0)


def test_write_var_values_matches_jax(tmp_path):
    from graph_wavenet_tpu.utils import misc as jmisc
    from graph_wavenet_tpu_torch.utils import misc

    values = {"lr": 0.001, "epoch": 3, "name": "gwnet"}
    misc.write_var_values(str(tmp_path / "t.txt"), values)
    jmisc.write_var_values(str(tmp_path / "j.txt"), values)
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert "lr = 0.001" in text and "epoch = 3" in text


# ---------------------------------------------------------------------------
# coarsening
# ---------------------------------------------------------------------------

def _sbm(seed: int = 0, n: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)) * (rng.random((n, n)) < 0.3)
    return np.triu(w, 1) + np.triu(w, 1).T


@pytest.mark.parametrize("levels", [1, 3])
def test_coarsening_matches_jax(levels):
    from graph_wavenet_tpu.graphs import coarsening as jc
    from graph_wavenet_tpu_torch.graphs import coarsening as tc

    w = _sbm(levels)
    got = tc.coarsen(w, levels, rng=np.random.default_rng(3))
    want = jc.coarsen(w, levels, rng=np.random.default_rng(3))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1]
    perm = tc.compute_perm(got[1])
    assert perm == jc.compute_perm(want[1])
    np.testing.assert_array_equal(tc.perm_adjacency(w, perm[0]),
                                  jc.perm_adjacency(w, perm[0]))
    x = np.random.default_rng(1).normal(size=(5, w.shape[0]))
    np.testing.assert_array_equal(tc.perm_coarsening(x, perm[0]),
                                  jc.perm_coarsening(x, perm[0]))


def test_spline_basis_matches_jax():
    from graph_wavenet_tpu.graphs import coarsening as jc
    from graph_wavenet_tpu_torch.graphs import coarsening as tc

    x = np.random.default_rng(2).normal(size=40)
    for k, degree in ((6, 3), (4, 1)):
        np.testing.assert_array_equal(tc.spline_basis(k, x, degree),
                                      jc.spline_basis(k, x, degree))


# ---------------------------------------------------------------------------
# the native loader
# ---------------------------------------------------------------------------

def test_native_library_builds_from_the_port_source():
    from graph_wavenet_tpu_torch.data import native_loader as nl

    assert nl.native_available(), "g++ is here; the library should build"
    assert nl._lib_path().exists()
    assert nl._lib_path().parent.name == "_build"


def test_port_source_is_the_jax_package_source():
    """``csrc/windowloader.cpp`` is ``native/windowloader.cpp`` byte for
    byte from the first ``#include <`` on (its header comment is its
    own)."""
    def code(path):
        text = open(path, "rb").read()
        return text[text.index(b"#include <"):]

    assert code(os.path.join(REPO, "graph_wavenet_tpu_torch", "csrc",
                             "windowloader.cpp")) == code(
        os.path.join(REPO, "native", "windowloader.cpp"))


def test_native_gathers_match_numpy_and_jax():
    from graph_wavenet_tpu.data import native_loader as jnl
    from graph_wavenet_tpu_torch.data import native_loader as nl

    rng = np.random.default_rng(0)
    series = rng.normal(size=(50, 7, 2)).astype(np.float32)
    anchors = rng.integers(0, 50 - 8, size=33)
    got = nl.gather_windows(series, anchors, 8)
    np.testing.assert_array_equal(
        got, series[anchors[:, None] + np.arange(8)[None, :]])
    np.testing.assert_array_equal(got, jnl.gather_windows(series, anchors, 8))
    samples = rng.normal(size=(20, 5, 3)).astype(np.float32)
    idx = rng.integers(0, 20, size=12)
    np.testing.assert_array_equal(nl.gather_batch(samples, idx),
                                  samples[idx])
    for bad in ([15], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            nl.gather_windows(series[:20], np.array(bad), 8)


def test_native_standardize_matches_numpy():
    from graph_wavenet_tpu_torch.data import native_loader as nl
    from graph_wavenet_tpu_torch.data.scaler import (
        StandardScaler,
        apply_feature0_scaling,
    )

    arr = np.random.default_rng(1).normal(size=(30, 6, 3)).astype(
        np.float32)
    want = arr.copy()
    want[..., 0] = (want[..., 0] - np.float32(2.5)) / np.float32(1.5)
    assert nl.standardize_feature0(arr, 2.5, 1.5)
    np.testing.assert_array_equal(arr, want)
    assert not nl.standardize_feature0(arr.transpose(1, 0, 2), 0.0, 1.0)
    data = {"x_train": np.ascontiguousarray(want.copy())}
    ref = want.copy()
    ref[..., 0] = StandardScaler(0.5, 2.0).transform(ref[..., 0])
    apply_feature0_scaling(data, StandardScaler(0.5, 2.0))
    np.testing.assert_array_equal(data["x_train"], ref)


def test_window_loader_matches_jax_batch_for_batch():
    from graph_wavenet_tpu.data import native_loader as jnl
    from graph_wavenet_tpu_torch.data import native_loader as nl

    series = np.random.default_rng(2).normal(size=(80, 5, 2)).astype(
        np.float32)
    y_series = series * 3.0 + 1.0
    loaders = [m.WindowDataLoader(series, window=12, horizon=12,
                                  batch_size=8, y_series=y_series,
                                  rng=np.random.default_rng(0))
               for m in (nl, jnl)]
    for dl in loaders:
        dl.shuffle()
    assert loaders[0].num_real == loaders[1].num_real
    for (xt, yt), (xj, yj) in zip(loaders[0].get_iterator(),
                                  loaders[1].get_iterator()):
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


def test_numpy_path_without_the_library(monkeypatch):
    from graph_wavenet_tpu_torch.data import native_loader as nl

    rng = np.random.default_rng(3)
    series = rng.normal(size=(30, 4, 2)).astype(np.float32)
    anchors = rng.integers(0, 22, size=9)
    want = nl.gather_windows(series, anchors, 8)
    monkeypatch.setattr(nl, "_load_library", lambda: None)
    assert not nl.native_available()
    np.testing.assert_array_equal(nl.gather_windows(series, anchors, 8),
                                  want)
    arr = series.copy()
    assert not nl.standardize_feature0(arr, 0.0, 1.0)


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def test_prefetch_keeps_batches_and_order():
    from graph_wavenet_tpu_torch.data.loader import DataLoader
    from graph_wavenet_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(40, 4, 3, 2)).astype(np.float32)
    ys = rng.normal(size=(40, 4, 3, 2)).astype(np.float32)
    dl = DataLoader(xs, ys, batch_size=8, rng=rng)
    direct = list(dl.get_iterator())
    fetched = list(prefetch_to_device(dl.get_iterator(), size=2,
                                      device=CPU))
    assert len(fetched) == len(direct)
    for (xd, yd), (xf, yf) in zip(direct, fetched):
        assert torch.is_tensor(xf) and xf.device.type == CPU
        np.testing.assert_array_equal(xf.numpy(), xd)
        np.testing.assert_array_equal(yf.numpy(), yd)


def test_prefetch_passes_through_non_arrays():
    from graph_wavenet_tpu_torch.data.prefetch import prefetch_to_device

    t = torch.ones(2)
    out = list(prefetch_to_device(
        iter([(np.ones((2, 2), np.float32), "tag", 7, t)]), size=1,
        device=CPU))
    assert out[0][1] == "tag" and out[0][2] == 7 and out[0][3] is t


def test_prefetch_raises_the_producers_exception():
    from graph_wavenet_tpu_torch.data.prefetch import prefetch_to_device

    def bad():
        yield (np.ones((2,), np.float32),)
        raise RuntimeError("boom")

    it = prefetch_to_device(bad(), size=1, device=CPU)
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_thread_ends_when_the_consumer_stops():
    from graph_wavenet_tpu_torch.data.prefetch import prefetch_to_device

    batches = [(np.ones((4, 2), np.float32),) for _ in range(50)]
    it = prefetch_to_device(iter(batches), size=2, device=CPU)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline and any(
            t.name == "gwnet-prefetch" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "gwnet-prefetch" and t.is_alive()
                   for t in threading.enumerate())


@pytest.mark.parametrize("feed", ["arrays", "windows"])
def test_runner_with_prefetch_equals_without(tmp_path, feed):
    """``Runner.fit`` (2 epochs, dropout 0.3) and ``Runner.test`` over a
    host-resident dataset with ``prefetch=2`` and ``prefetch=0``: the same
    history, weights and test metrics, bit for bit."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data import metr
    from graph_wavenet_tpu_torch.data.loader import DataLoader
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    n = 6
    rng = np.random.default_rng(0)
    a = rng.random((2, n, n)).astype(np.float32)
    sups = [torch.as_tensor(s / s.sum(-1, keepdims=True)) for s in a]
    cfg = ModelConfig(num_nodes=n, in_dim=2, out_dim=12,
                      residual_channels=4, dilation_channels=4,
                      skip_channels=8, end_channels=16, blocks=1, layers=2,
                      dropout=0.3, n_supports=2)
    runs = []
    for prefetch in (0, 2):
        if feed == "arrays":
            rng = np.random.default_rng(1)
            xs = rng.normal(size=(40, 12, n, 2)).astype(np.float32)
            ys = (rng.normal(size=(40, 12, n, 2)) + 50).astype(np.float32)
            loaders = np.random.default_rng(2)
            data = {"scaler": StandardScaler(50.0, 1.0), "y_test": ys[:8]}
            for split, sl in (("train", slice(0, 32)), ("val", slice(32, 40)),
                              ("test", slice(0, 8))):
                data[split + "_loader"] = DataLoader(xs[sl], ys[sl], 8,
                                                     loaders)
        else:
            values = (np.random.default_rng(1).normal(size=(150, n)) * 5
                      + 60).astype(np.float32)
            index = (np.datetime64("2012-03-01T00:00")
                     + np.arange(150) * np.timedelta64(5, "m"))
            data = metr.load_dataset_streaming(values, index=index,
                                               batch_size=8, seed=0)
        tcfg = TrainConfig(epochs=2, batch_size=8, print_every=1000,
                           save_dir=str(tmp_path / f"p{prefetch}"),
                           prefetch=prefetch)
        eng = Engine(cfg, tcfg, data["scaler"], device=CPU, seed=0)
        runner = Runner(eng, tcfg, log_fn=lambda *a: None)
        res = runner.test(data, sups, runner.fit(data, sups))
        runs.append((res, eng))
    (want, weng), (got, geng) = runs
    assert [(h.train, h.valid) for h in got.history] == [
        (h.train, h.valid) for h in want.history]
    assert got.test_metrics == want.test_metrics
    for k, v in weng.model.state_dict().items():
        assert torch.equal(geng.model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# reference checkpoints
# ---------------------------------------------------------------------------

def _jax_model(n: int = 10, **kw):
    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.engine import Engine as JEngine

    cfg_kw = dict(num_nodes=n, in_dim=2, out_dim=12, residual_channels=8,
                  dilation_channels=8, skip_channels=16, end_channels=32,
                  blocks=2, layers=2, n_supports=2, **kw)
    jeng = JEngine(JConfig(**cfg_kw), JTrainConfig(), JScaler(0.0, 1.0),
                   seed=3)
    return jeng, cfg_kw


def _write_pth(path, jeng, cfg_kw) -> None:
    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.utils.torch_import import export_state_dict

    sd = export_state_dict(jeng.state.params, jeng.state.model_state,
                           JConfig(**cfg_kw))
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
               path)


@pytest.mark.parametrize("addaptadj", [True, False])
def test_load_pth_forward_matches_jax(tmp_path, addaptadj):
    import jax.numpy as jnp

    from graph_wavenet_tpu.models.gwnet import apply_gwnet
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.convert import load_pth

    jeng, cfg_kw = _jax_model(addaptadj=addaptadj)
    path = tmp_path / "ref.pth"
    _write_pth(path, jeng, cfg_kw)
    model = load_pth(str(path), ModelConfig(**cfg_kw), device=CPU)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 12, 10, 2)).astype(np.float32)
    a = rng.random((2, 10, 10)).astype(np.float32)
    sups = [s / s.sum(-1, keepdims=True) for s in a]
    want, _ = apply_gwnet(jeng.model_cfg, jeng.state.params,
                          jeng.state.model_state, jnp.asarray(x),
                          [jnp.asarray(s) for s in sups], train=False)
    with torch.no_grad():
        got = model(torch.as_tensor(x), [torch.as_tensor(s) for s in sups])
    assert not model.training
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_load_pth_refuses_what_the_config_does_not_make(tmp_path):
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.convert import load_pth

    jeng, cfg_kw = _jax_model()
    path = tmp_path / "ref.pth"
    _write_pth(path, jeng, cfg_kw)
    with pytest.raises(ValueError, match="unexpected"):
        load_pth(str(path), ModelConfig(**dict(cfg_kw, addaptadj=False)),
                 device=CPU)
    with pytest.raises(ValueError, match="missing"):
        load_pth(str(path), ModelConfig(**dict(cfg_kw, blocks=3)),
                 device=CPU)
    with pytest.raises(ValueError, match=r"start_conv.weight \(8, 2, 1, 1\)"):
        load_pth(str(path), ModelConfig(**dict(cfg_kw, residual_channels=4,
                                                dilation_channels=4)),
                 device=CPU)


# ---------------------------------------------------------------------------
# the restored metrics and synthetic surface
# ---------------------------------------------------------------------------

def test_batch_time_metrics_match_jax():
    import jax.numpy as jnp

    from graph_wavenet_tpu.train import metrics as jm
    from graph_wavenet_tpu_torch.train import metrics as tm

    rng = np.random.default_rng(5)
    yhat = rng.normal(size=(4, 6, 5, 2)).astype(np.float32)
    y = (rng.normal(size=(4, 6, 5, 2)) + 3).astype(np.float32)
    for name in ("batch_time_l1", "batch_time_mse"):
        got = getattr(tm, name)(torch.as_tensor(yhat), torch.as_tensor(y))
        want = getattr(jm, name)(jnp.asarray(yhat), jnp.asarray(y))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=name)


def test_multimodality_prediction_surface_matches_jax():
    from graph_wavenet_tpu.data import synthetic as jsyn
    from graph_wavenet_tpu.graphs import generate as jgen
    from graph_wavenet_tpu_torch.data import synthetic as tsyn
    from graph_wavenet_tpu_torch.graphs import generate as tgen

    opts = {"nCommunities": 2, "probIntra": 0.8, "probInter": 0.2}
    made = []
    for gen, syn in ((tgen, tsyn), (jgen, jsyn)):
        rng = np.random.default_rng(6)
        g = gen.Graph("SBM", 8, opts, rng=rng)
        made.append(syn.MultiModalityPrediction(
            g, 5, 1, 1, 1, 20, F_t=5, rng=rng))
    tdata, jdata = made
    np.testing.assert_array_equal(tdata.get_samples("train")[0],
                                  jdata.get_samples("train")[0])
    x, y = tdata.get_samples("train")
    y_hat = y + np.random.default_rng(7).normal(size=y.shape)
    got = tdata.evaluate(torch.as_tensor(y_hat), torch.as_tensor(y))
    np.testing.assert_allclose(float(got), float(jdata.evaluate(y_hat, y)),
                               rtol=1e-6)
    tdata.astype(np.float64)
    jdata.astype(np.float64)
    np.testing.assert_array_equal(tdata.get_samples("val")[1],
                                  jdata.get_samples("val")[1])
    assert tdata.samples["val"]["y"].dtype == np.float64
    tdata.to(CPU)
    xt, yt = tdata.get_samples("train")
    assert torch.is_tensor(xt) and xt.dtype == torch.float64
    np.testing.assert_array_equal(xt.numpy(), jdata.get_samples("train")[0])
    tdata.astype(np.float32)
    assert tdata.samples["test"]["x"].dtype == torch.float32
