"""The slice as a whole on the CPU: a city checkpoint written by the JAX
package, converted to the port's format, served by the port in original
node order and held to the JAX Forecaster (fp32, 2e-4, the bar of
test_model_parity.py); the port's serve CLI; and the package's guards."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.config import ModelConfig, TrainConfig
from graph_wavenet_tpu.data.scaler import StandardScaler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAW = 40


@pytest.fixture(scope="module")
def city_ckpt(tmp_path_factory):
    """A JAX city checkpoint (msgpack + sidecar), its graph, and the same
    weights converted into a port checkpoint."""
    from flax import serialization

    from graph_wavenet_tpu.graphs import city
    from graph_wavenet_tpu.graphs.spatial import knn_graph_edges
    from graph_wavenet_tpu.train import checkpoint as jckpt
    from graph_wavenet_tpu.train.engine import Engine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt

    tmp = tmp_path_factory.mktemp("city")
    rng = np.random.default_rng(0)
    pos = rng.random((N_RAW, 2))
    src, dst, w = knn_graph_edges(pos, 3)
    gpath = str(tmp / "g.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_RAW)
    _, _, layout = city.build_city_supports(
        src, dst, w, N_RAW, pos=pos, ordering="rcm", form="flat",
        block_size=16, addaptadj=False)
    cfg = ModelConfig(num_nodes=layout["n_pad"], out_dim=6,
                      residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=32, blocks=2,
                      layers=2, dropout=0.0, n_supports=2, addaptadj=False)
    scaler = StandardScaler(3.0, 2.0)
    engine = Engine(cfg, TrainConfig(), scaler, seed=0)
    # random BN statistics, so the eval-mode normalization is exercised
    ms = engine.state.model_state
    ms = {"bn": [{"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
                  "var": jnp.asarray(rng.random(8) + 0.5, jnp.float32)}
                 for _ in ms["bn"]]}
    engine.state = dataclasses.replace(engine.state, model_state=ms)
    jpath = str(tmp / "city.msgpack")
    jckpt.save_checkpoint(jpath, engine.state, model_cfg=cfg,
                          train_cfg=TrainConfig(), scaler=scaler,
                          extra={"graph_layout": layout})

    # the port reads the JAX payload with flax and the sidecar itself
    with open(jpath, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    meta = tckpt.load_metadata(jpath)
    sd = convert.params_from_jax(tree["params"], tree["model_state"],
                                 meta["model_cfg"])
    tpath = str(tmp / "city.pt")
    tckpt.save_checkpoint(tpath, sd, model_cfg=meta["model_cfg"],
                          train_cfg=meta["train_cfg"], scaler=meta["scaler"],
                          extra=meta["extra"])
    return dict(jpath=jpath, tpath=tpath, gpath=gpath, src=src, dst=dst,
                w=w, pos=pos, tmp=tmp)


def test_city_forecast_matches_jax(city_ckpt):
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.ops.block_sparse import Fused2FlatSupport
    from graph_wavenet_tpu_torch.train import serving as tserving

    jfc = jserving.Forecaster.from_city_checkpoint(city_ckpt["jpath"],
                                                   city_ckpt["gpath"])
    tfc = tserving.Forecaster.from_city_checkpoint(
        city_ckpt["tpath"], city_ckpt["gpath"], device="cpu")
    assert tfc.input_nodes == jfc.input_nodes == N_RAW
    assert tfc.node_layout == jfc.node_layout
    assert all(isinstance(s, Fused2FlatSupport) for s in tfc.supports)
    x = np.random.default_rng(1).normal(
        size=(3, 12, N_RAW, 2)).astype(np.float32)
    want = np.asarray(jfc.predict(jnp.asarray(x)))
    got = tfc.predict(x)
    assert got.shape == (3, 6, N_RAW) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_city_checkpoint_refuses_wrong_graph(city_ckpt):
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train import serving as tserving

    wrong = str(city_ckpt["tmp"] / "wrong.npz")
    city.save_graph_npz(wrong, city_ckpt["src"], city_ckpt["dst"],
                        city_ckpt["w"] * 2.0, pos=city_ckpt["pos"],
                        n_nodes=N_RAW)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tserving.Forecaster.from_city_checkpoint(
            city_ckpt["tpath"], wrong, device="cpu")
    # a JAX payload is refused with a pointer to the converter
    with pytest.raises(ValueError, match="params_from_jax"):
        tckpt.load_state_dict(city_ckpt["jpath"])


def test_serve_cli_predicts_like_forecaster(city_ckpt):
    from graph_wavenet_tpu_torch.cli import serve

    run = serve.main(["--checkpoint", city_ckpt["tpath"], "--graph_npz",
                      city_ckpt["gpath"], "--device", "cpu", "--port", "0",
                      "--window_ms", "50"], serve_forever=False)
    server, batcher, fc = run["server"], run["batcher"], run["forecaster"]
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["num_nodes"] == N_RAW
        assert health["device"] == "cpu"
        raw = np.random.default_rng(2).normal(
            5.0, 2.0, size=(4, 12, N_RAW, 2)).astype(np.float32)
        answers = [None] * 4

        def post(i):
            req = urllib.request.Request(
                url + "/predict", data=json.dumps(
                    {"x": raw[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                answers[i] = np.asarray(json.loads(r.read())["y"])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        xs = raw.copy()
        xs[..., 0] = fc.scaler.transform(xs[..., 0])
        want = fc.predict(xs).numpy()
        for i in range(4):
            assert answers[i].shape == (6, N_RAW)
            np.testing.assert_allclose(answers[i], want[i], rtol=1e-5,
                                       atol=1e-5)
        assert batcher.stats["requests"] == 4
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()


def test_package_imports_no_jax():
    """Every module of the port imports without jax, flax or the JAX
    package (in a fresh interpreter: this test process has imported JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import graph_wavenet_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, 'graph_wavenet_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', "
        "'graph_wavenet_tpu') or m.startswith(('jax.', 'flax.', "
        "'graph_wavenet_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 51, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 51


def test_default_device_is_cuda_and_raises_without_it(monkeypatch,
                                                      city_ckpt):
    from graph_wavenet_tpu_torch import resolve_device
    from graph_wavenet_tpu_torch.config import ModelConfig as TConfig
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.train import serving as tserving

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GWNet(TConfig(num_nodes=16, addaptadj=False))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tserving.Forecaster.from_city_checkpoint(city_ckpt["tpath"],
                                                 city_ckpt["gpath"])
    assert resolve_device("cpu") == torch.device("cpu")
