"""The benchmark's arithmetic: the union of device intervals and the idle
gaps on a made-up trace, the per-layer readers, the analytic FLOP count
held to ``FlopCounterMode`` over the plain reference, and the shape of
the result line."""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gwbench import count, layers, registry, trace


def made_up_trace() -> trace.Trace:
    # two streams overlap on [2, 3]; the card is idle on [0, 1], [4, 5]
    # and [7, 10]
    dev = [(1.0, 3.0, "gemm"), (2.0, 4.0, "mix_flat2_bf16<128>"),
           (5.0, 7.0, "outer_bf16<FlatJobs>"), (9.5, 11.0, "late")]
    host = [(0.0, 10.0, "cudaGraphLaunch"), (6.5, 8.5, "aten::copy_"),
            (3.5, 4.6, "aten::cat")]
    return trace.Trace((0.0, 10.0), dev, host)


def test_union_counts_overlap_once():
    tr = made_up_trace()
    assert trace.union(tr.device) == [(1.0, 4.0), (5.0, 7.0), (9.5, 11.0)]
    assert trace.busy_s(tr) == pytest.approx(3.0 + 2.0 + 0.5)
    assert trace.idle_gaps(tr) == [(0.0, 1.0), (4.0, 5.0), (7.0, 9.5)]


def test_idle_gaps_named_by_the_innermost_host_op():
    bd = trace.breakdown(made_up_trace())
    gaps = dict(map(tuple, bd["idle_gaps"]))
    assert gaps == {"aten::copy_": pytest.approx(2.5),
                    "aten::cat": pytest.approx(1.0),
                    "cudaGraphLaunch": pytest.approx(1.0)}
    ops = dict(map(tuple, bd["device_ops"]))
    assert ops["late"] == pytest.approx(0.5)       # clipped to the window


@pytest.mark.parametrize("family,other", [("train", "metr_train"),
                                          ("metr_train", "train")])
def test_readers_on_a_made_up_trace(family, other):
    tr = made_up_trace()
    work = count.Work(flops=10.0, hop_units=[("forward", 2.0e12, 0.0)])
    rec = {"kind": family, "trace": tr, "work": [work, work],
           "flops_window": 989e12 * 0.5, "window_s": 10.0,
           "kernels": registry.kernels(),
           "peaks": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}}
    readers = registry.metric_readers()
    got = {k: m.read(rec) for k, m in readers.items()}
    assert got[f"device_idle.{family}"] == pytest.approx(45.0)
    assert got[f"mfu.{family}"] == pytest.approx(5.0)
    # hand kernels ran on [2, 4] and [5, 7]: 4 s
    assert layers.hand_s(rec) == pytest.approx(4.0)
    assert got[f"dense_ops_ms.{family}"] == pytest.approx(1e3 * 1.5 / 2)
    if family == "train":
        assert got["kernel_roofline.train"] == pytest.approx(
            100 * 2 * (2.0e12 / 989e12) / 4.0)
    for name in (f"mfu.{other}", f"device_idle.{other}",
                 f"dense_ops_ms.{other}", "dense_ops_ms.serve",
                 "batch_occupancy.serve"):
        assert got[name] is None, name


@pytest.mark.parametrize("tail", [True, False])
def test_serving_readers_split_by_the_tail(tail):
    work = count.Work(flops=10.0, hop_units=[("forward", 2.0e12, 0.0)])
    rec = {"kind": "serve", "tail": tail, "trace": made_up_trace(),
           "work": [work], "flops_window": 989e12 * 0.5, "window_s": 10.0,
           "counters": {"requests": 30, "device_calls": 6},
           "kernels": registry.kernels(),
           "peaks": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}}
    got = {k: m.read(rec) for k, m in registry.metric_readers().items()}
    below = {"batch_occupancy.serve": 5.0, "device_idle.serve_tail": 45.0}
    above = {"mfu.serve": 5.0, "device_idle.serve": 45.0,
             "dense_ops_ms.serve": 1e3 * 1.5,
             "kernel_roofline.serve": 100 * (2.0e12 / 989e12) / 4.0}
    want = below if tail else above
    assert {k for k, v in got.items() if v is not None} == set(want)
    assert {k: got[k] for k in want} == pytest.approx(want)


def test_the_schedule_is_fixed_by_the_mix():
    mod = registry.traffic_kind("open_loop_serve")
    mix = registry.traffic(registry.workload("city-40k.serve")["traffic"])
    due = mod.due_times(mix, 40.0)
    assert (due == mod.due_times(mix, 40.0)).all()
    assert (due[1:] >= due[:-1]).all() and 0 <= due[0] and due[-1] < 40.0
    assert len(due) == pytest.approx(40.0 * mix["rate_per_s"], rel=0.1)
    assert not (mod.due_times(mix, 40.0, part=2)[:50] == due[:50]).all()
    bursts = mod.due_times(dict(mix, burst=4), 40.0)
    assert (bursts.reshape(-1, 4) == bursts[::4, None]).all()
    assert len(bursts) == pytest.approx(len(due), rel=0.2)


def _small(name: str, nodes: int):
    cfg = copy.deepcopy(registry.config(name))
    cfg["graph"]["nodes"] = nodes
    cfg["graph"].pop("live_blocks", None)
    cfg["graph"].pop("adaptive_live_blocks", None)
    return cfg


def _reference_graph(cfg):
    from reference import graph_ref

    g = cfg["graph"]
    gk = registry.graph_kind(g["kind"])
    rg = gk.reference(gk.raw(g), g, "cpu")
    counts = {"nodes": g["nodes"]}
    if g["kind"] == "knn_city":
        counts.update(block_size=g["block_size"],
                      live_blocks=rg["live_blocks"],
                      adaptive_live_blocks=rg["adaptive_live_blocks"])
    assert all(isinstance(s, (torch.Tensor, graph_ref.BlockSupport))
               for s in rg["fixed"])
    return rg, counts


@pytest.mark.parametrize("name,nodes,train", [
    ("gwnet-city-40k", 512, True), ("gwnet-city-40k", 512, False),
    ("gwnet-metr-la", 40, True), ("gwnet-metr-la", 40, False)])
def test_count_equals_flop_counter_over_the_reference(name, nodes, train):
    from reference import gwnet_ref

    cfg = _small(name, nodes)
    if cfg["graph"]["kind"] == "knn_city":
        cfg["graph"]["block_size"] = 64
    rg, counts = _reference_graph(cfg)
    m = cfg["model"]
    b = 3
    gen = torch.Generator().manual_seed(0)
    shapes = _param_shapes(m, nodes)
    from gwbench import inputs

    p = inputs.weights(shapes, gen, "cpu")
    x, y = inputs.readings(b, nodes, m["seq_length"], m["out_dim"],
                           cfg["scaler"], gen, "cpu")
    with FlopCounterMode(display=False) as fc:
        if train:
            pl = {k: v.clone().requires_grad_(not k.startswith("bn."))
                  for k, v in p.items()}
            masks = gwnet_ref.dropout_masks(gen, m, b, 13, nodes, "cpu")
            loss = gwnet_ref.loss_of(pl, x, y, rg["fixed"], rg["pairs"], m,
                                     cfg["scaler"], masks, gwnet_ref.identity)
            torch.autograd.grad(loss, [v for k, v in pl.items()
                                       if v.requires_grad], allow_unused=True)
        else:
            gwnet_ref.predict(p, x, rg["fixed"], rg["pairs"], m,
                              cfg["scaler"], rg["perm"])
    want = count.step_work(cfg, counts, b, train).flops
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-12)


def _param_shapes(m: dict, n: int) -> dict:
    """The model's parameter names and shapes, as the reference names
    them (the published state dict)."""
    c, d = m["residual_channels"], m["dilation_channels"]
    n_sup = m["n_supports"] + (1 if m["addaptadj"] else 0)
    hops = m["diffusion_order"] * n_sup + 1
    out = {"start_conv.weight": (c, m["in_dim"], 1, 1),
           "start_conv.bias": (c,)}
    for i in range(m["blocks"] * m["layers"]):
        for conv in ("filter_convs", "gate_convs"):
            out[f"{conv}.{i}.weight"] = (d, c, 1, m["kernel_size"])
            out[f"{conv}.{i}.bias"] = (d,)
        out[f"skip_convs.{i}.weight"] = (m["skip_channels"], d, 1, 1)
        out[f"skip_convs.{i}.bias"] = (m["skip_channels"],)
        out[f"gconv.{i}.mlp.mlp.weight"] = (c, hops * d, 1, 1)
        out[f"gconv.{i}.mlp.mlp.bias"] = (c,)
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"bn.{i}.{k}"] = (c,)
    out["end_conv_1.weight"] = (m["end_channels"], m["skip_channels"], 1, 1)
    out["end_conv_1.bias"] = (m["end_channels"],)
    out["end_conv_2.weight"] = (m["out_dim"], m["end_channels"], 1, 1)
    out["end_conv_2.bias"] = (m["out_dim"],)
    if m["addaptadj"]:
        out["nodevec1"] = (n, m["adapt_rank"])
        out["nodevec2"] = (m["adapt_rank"], n)
    return out


def test_the_result_line(monkeypatch):
    import run
    from gwbench import device

    monkeypatch.setattr(device, "info", lambda count, peak: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count,
        "memory_peak_bytes": peak})
    cell = registry.cell("city-40k.serve")
    ctx = run.Ctx(cell, 1, 1.0, False, dev="cpu")
    out = {"attempted": 10, "failed": 0, "peak_bytes": 2 ** 31,
           "setup_s": 30.0, "e2e": {"forecasts_per_s": (66.0, "forecasts/s"),
                                    "forecast_p95_ms": (110.0, "ms")},
           "numbers": {"forecast_nrmse": 0.01, "forecast_max_gap": 0.1}}
    ok, compared = run.judge(ctx, out)
    line = run.result(ctx, out, ok, compared)
    assert list(line)[-1] == "compared"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["metrics"]["peak_mem_gib"] == {"value": 2.0, "unit": "GiB"}
    assert set(line["metrics"]) == {"forecasts_per_s", "forecast_p95_ms",
                                    "peak_mem_gib", "setup_s"}
    assert set(line["compared"]) == {"forecast_nrmse", "forecast_max_gap"}
    assert line["device"]["platform"] == "gpu"


def test_reference_block_hop_equals_the_dense_product():
    """The reference's chunked block hop and its hand-written backward
    (input gradient and block cotangent) against dense autograd."""
    from reference import gwnet_ref, graph_ref

    torch.manual_seed(0)
    n, bs = 64, 16
    src = torch.randint(0, n, (300,)).numpy()
    dst = torch.randint(0, n, (300,)).numpy()
    sup = graph_ref.BlockSupport.from_edges(
        src, dst, torch.rand(300).double().numpy(), n, bs, "cpu")
    sup.blocks.requires_grad_(True)
    x = torch.randn(2, 3, n, 5, requires_grad=True)
    gwnet_ref.CHUNK_BYTES, old = 4096, gwnet_ref.CHUNK_BYTES
    try:
        out = gwnet_ref.hop(x, sup, gwnet_ref.identity)
    finally:
        gwnet_ref.CHUNK_BYTES = old
    dense = sup.dense()
    want = torch.einsum("btvc,vw->btwc", x, dense)
    torch.testing.assert_close(out, want)
    g = torch.randn_like(out)
    gx, gb = torch.autograd.grad(out, [x, sup.blocks], g)
    wx, wd = torch.autograd.grad(want, [x, dense], g)
    torch.testing.assert_close(gx, wx)
    nb = n // bs
    blocks = wd.reshape(nb, bs, nb, bs).permute(0, 2, 1, 3)
    torch.testing.assert_close(gb, blocks[sup.vb, sup.wb])
