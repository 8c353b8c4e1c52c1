"""Two repaired faults of the port's city path, held on the CPU:

1. the served supports take the dtype the checkpoint trained with (the
   layout's ``support_dtype``; for checkpoints without it, bf16 under a bf16
   model and fp32 otherwise): a checkpoint trained with fp32 activations and
   bf16 supports serves what the engine predicted on its training supports;
2. ``aptonly`` on the city path: a JAX aptonly city checkpoint serves within
   2e-4 of the JAX ``Forecaster(aptonly=True)`` (the port reads aptonly off
   the checkpoint's ``n_supports``), and the port's training CLI trains one
   that its serve CLI serves."""

import dataclasses
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.graphs import spatial as jspatial

CPU = "cpu"
N_RAW = 40


def write_city(tmp, rng):
    """A 40-node graph and a METR-format dataset in raw node order."""
    from graph_wavenet_tpu_torch.graphs import city

    pos = rng.random((N_RAW, 2))
    src, dst, w = jspatial.knn_graph_edges(pos, 3)
    gpath = str(tmp / "g.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_RAW)
    data = tmp / "data"
    data.mkdir()
    for split, s in (("train", 8), ("val", 4), ("test", 5)):
        x = rng.normal(5.0, 2.0, size=(s, 12, N_RAW, 2)).astype(np.float32)
        y = rng.normal(5.0, 2.0, size=(s, 12, N_RAW, 2)).astype(np.float32)
        np.savez(data / f"{split}.npz", x=x, y=y)
    return dict(gpath=gpath, data=str(data), src=src, dst=dst, w=w, pos=pos)


def train_city(tmp, graph, *extra):
    from graph_wavenet_tpu_torch.cli import train

    return train.main([
        "--graph_npz", graph["gpath"], "--data", graph["data"], "--device",
        CPU, "--gcn_bool", "--block_size", "16", "--ordering", "rcm",
        "--seq_length", "12", "--nhid", "4", "--blocks", "2", "--layers",
        "2", "--batch_size", "4", "--epochs", "1", "--dropout", "0.0",
        "--save", str(tmp / "ckpt"), *extra])


# ---------------------------------------------------------------------------
# fault 1: the support dtype of the served supports
# ---------------------------------------------------------------------------

def test_served_supports_take_the_training_support_dtype(tmp_path):
    """--dtype float32 --support_dtype bfloat16: the layout records the
    supports' dtype, and the served forecast equals the engine's
    ``predict_step`` on the supports it trained on (it differed before:
    the rebuild used fp32 blocks)."""
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    graph = write_city(tmp_path, np.random.default_rng(0))
    with pytest.warns(UserWarning, match="rounds the supports"):
        out = train_city(tmp_path, graph, "--support_dtype", "bfloat16")
    path = out["result"].best_checkpoint
    layout = tckpt.load_metadata(path)["extra"]["graph_layout"]
    assert layout["support_dtype"] == "bfloat16"
    fc = Forecaster.from_city_checkpoint(path, graph["gpath"], device=CPU)
    assert all(s.blocks_flat.dtype == torch.bfloat16 for s in fc.supports)

    x = np.random.default_rng(1).normal(size=(3, 12, N_RAW, 2)).astype(
        np.float32)
    engine, sups = out["runner"].engine, out["supports"]
    model_x = city.apply_node_layout(x, layout, axis=2)
    raw = engine.predict_step(model_x, sups)[:, -1].permute(0, 2, 1)
    want = city.invert_node_layout(raw.numpy(), layout, axis=2)
    want = want * fc.scaler.std + fc.scaler.mean
    got = fc.predict(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model_dtype,recorded,want", [
    ("float32", None, "float32"), ("bfloat16", None, "bfloat16"),
    ("float32", "bfloat16", "bfloat16"), ("bfloat16", "float32", "float32")])
def test_layout_support_dtype_rule(tmp_path, model_dtype, recorded, want):
    """A layout without ``support_dtype`` (the JAX package's, older port
    checkpoints) serves bf16 blocks to a bf16 model, fp32 ones otherwise;
    a recorded dtype wins."""
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.graphs import city

    graph = write_city(tmp_path, np.random.default_rng(2))
    _, _, layout = city.build_city_supports(
        graph["src"], graph["dst"], graph["w"], N_RAW, pos=graph["pos"],
        ordering="rcm", block_size=16, device=CPU)
    if recorded is not None:
        layout["support_dtype"] = recorded
    assert city.layout_support_dtype(layout, model_dtype) == want
    cfg = ModelConfig(num_nodes=layout["n_pad"], dtype=model_dtype,
                      addaptadj=True)
    sups = city.supports_from_layout(graph["gpath"], layout, cfg,
                                     device=CPU)
    assert [s.blocks_flat.dtype for s in sups[:2]] == [getattr(torch,
                                                               want)] * 2
    assert getattr(sups[2], "adaptive_mask", False)


# ---------------------------------------------------------------------------
# fault 2: aptonly on the city path
# ---------------------------------------------------------------------------

def test_jax_aptonly_city_checkpoint_serves_like_jax(tmp_path):
    from flax import serialization

    from graph_wavenet_tpu.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler
    from graph_wavenet_tpu.graphs import city as jcity
    from graph_wavenet_tpu.train import checkpoint as jckpt
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu.train.engine import Engine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train import serving as tserving

    rng = np.random.default_rng(3)
    graph = write_city(tmp_path, rng)
    _, _, layout = jcity.build_city_supports(
        graph["src"], graph["dst"], graph["w"], N_RAW, pos=graph["pos"],
        ordering="rcm", form="flat", block_size=16, addaptadj=True,
        adaptive_hops=2)
    cfg = ModelConfig(num_nodes=layout["n_pad"], out_dim=6,
                      residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=32, blocks=2, layers=2,
                      dropout=0.0, n_supports=0, addaptadj=True)
    scaler = StandardScaler(3.0, 2.0)
    engine = Engine(cfg, TrainConfig(), scaler, seed=0)
    ms = {"bn": [{"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
                  "var": jnp.asarray(rng.random(8) + 0.5, jnp.float32)}
                 for _ in engine.state.model_state["bn"]]}
    engine.state = dataclasses.replace(engine.state, model_state=ms)
    jpath = str(tmp_path / "apt.msgpack")
    jckpt.save_checkpoint(jpath, engine.state, model_cfg=cfg,
                          train_cfg=TrainConfig(), scaler=scaler,
                          extra={"graph_layout": layout})
    with open(jpath, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    meta = tckpt.load_metadata(jpath)
    tpath = str(tmp_path / "apt.pt")
    tckpt.save_checkpoint(tpath, convert.params_from_jax(
        tree["params"], tree["model_state"], meta["model_cfg"]),
        model_cfg=meta["model_cfg"], train_cfg=meta["train_cfg"],
        scaler=meta["scaler"], extra=meta["extra"])

    jfc = jserving.Forecaster.from_city_checkpoint(jpath, graph["gpath"],
                                                   aptonly=True)
    tfc = tserving.Forecaster.from_city_checkpoint(tpath, graph["gpath"],
                                                   device=CPU)
    assert len(tfc.supports) == 1
    assert getattr(tfc.supports[0], "adaptive_mask", False)
    x = rng.normal(size=(3, 12, N_RAW, 2)).astype(np.float32)
    want = np.asarray(jfc.predict(jnp.asarray(x)))
    np.testing.assert_allclose(tfc.predict(x).numpy(), want, rtol=2e-4,
                               atol=2e-4)


def test_train_cli_trains_and_serve_cli_serves_aptonly(tmp_path):
    from graph_wavenet_tpu_torch.cli import serve
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt

    graph = write_city(tmp_path, np.random.default_rng(4))
    out = train_city(tmp_path, graph, "--addaptadj", "--aptonly")
    assert [getattr(s, "adaptive_mask", False)
            for s in out["supports"]] == [True]
    path = out["result"].best_checkpoint
    cfg = tckpt.load_metadata(path)["model_cfg"]
    assert cfg.n_supports == 0 and cfg.supports_len == 1
    assert tckpt.load_state_dict(path)["gconv.0.mlp.mlp.weight"].shape[1] \
        == 3 * 4
    assert np.isfinite(out["result"].test_metrics["mae"])

    run = serve.main(["--checkpoint", path, "--graph_npz", graph["gpath"],
                      "--device", CPU, "--port", "0"],
                     serve_forever=False)
    server, batcher, fc = run["server"], run["batcher"], run["forecaster"]
    try:
        assert len(fc.supports) == 1
        raw = np.random.default_rng(5).normal(
            5.0, 2.0, size=(12, N_RAW, 2)).astype(np.float32)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_port}/predict",
            data=json.dumps({"x": raw.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = np.asarray(json.loads(r.read())["y"])
        xs = raw[None].copy()
        xs[..., 0] = fc.scaler.transform(xs[..., 0])
        np.testing.assert_allclose(answer, fc.predict(xs).numpy()[0],
                                   rtol=1e-5, atol=1e-5)
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
