"""Export and streaming serving on the CPU: the port's rolling and
autoregressive forecasts, ``reconstruct_sequence`` and ``torch.export``
artifacts held to the JAX package's (fp32, 2e-4, the bar of
test_model_parity.py; 1e-6 for the averaging), each forecast and artifact
to the port's own ``Forecaster.predict`` bit for bit, the five kernel ops
through ``torch.library.opcheck``, and the export and serve CLIs."""

import dataclasses
import json
import os
import pickle
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
CPU = "cpu"
N_DENSE = 12
N_RAW = 40
TOL = dict(rtol=2e-4, atol=2e-4)
# 2 x 2 layers: a receptive field of 7 steps
WIDTHS = dict(residual_channels=4, dilation_channels=4, skip_channels=8,
              end_channels=16, blocks=2, layers=2, dropout=0.0)
RF = 7


def _jax_checkpoint(tmp, name, cfg, scaler, rng, extra=None):
    """A JAX checkpoint of random weights and BatchNorm statistics, and the
    same weights converted into a port checkpoint. Returns both paths and
    the JAX engine state."""
    from flax import serialization

    from graph_wavenet_tpu.train import checkpoint as jckpt
    from graph_wavenet_tpu.train.engine import Engine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt

    engine = Engine(cfg, TrainConfig(), scaler, seed=0)
    c = cfg.residual_channels
    ms = {"bn": [{"mean": jnp.asarray(rng.normal(size=c), jnp.float32),
                  "var": jnp.asarray(rng.random(c) + 0.5, jnp.float32)}
                 for _ in engine.state.model_state["bn"]]}
    engine.state = dataclasses.replace(engine.state, model_state=ms)
    jpath = str(tmp / f"{name}.msgpack")
    jckpt.save_checkpoint(jpath, engine.state, model_cfg=cfg,
                          train_cfg=TrainConfig(), scaler=scaler,
                          extra=extra)
    with open(jpath, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    meta = tckpt.load_metadata(jpath)
    tpath = str(tmp / f"{name}.pt")
    tckpt.save_checkpoint(tpath, convert.params_from_jax(
        tree["params"], tree["model_state"], meta["model_cfg"]),
        model_cfg=meta["model_cfg"], train_cfg=meta["train_cfg"],
        scaler=meta["scaler"], extra=meta.get("extra"))
    return jpath, tpath, engine.state


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """JAX and port forecasters of a dense 12-node model (two
    doubletransition supports and the adaptive adjacency) and of a 40-node
    city model (flat supports and the block-masked adaptive adjacency),
    plus the port checkpoints and the graph and adjacency files."""
    from graph_wavenet_tpu.graphs import city as jcity
    from graph_wavenet_tpu.graphs.spatial import knn_graph_edges
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.graphs.normalize import load_adj
    from graph_wavenet_tpu_torch.train import serving as tserving

    tmp = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(0)
    adj = (rng.random((N_DENSE, N_DENSE)) < 0.4) * rng.random(
        (N_DENSE, N_DENSE))
    np.fill_diagonal(adj, 1.0)
    adj_path = str(tmp / "adj.pkl")
    with open(adj_path, "wb") as f:
        pickle.dump(([str(i) for i in range(N_DENSE)],
                     {str(i): i for i in range(N_DENSE)},
                     adj.astype(np.float32)), f)
    _, _, sups = load_adj(adj_path, "doubletransition")
    dcfg = ModelConfig(num_nodes=N_DENSE, out_dim=4, n_supports=2,
                       addaptadj=True, **WIDTHS)
    scaler = StandardScaler(50.0, 10.0)
    d_jpath, d_tpath, d_state = _jax_checkpoint(tmp, "dense", dcfg, scaler,
                                                rng)

    pos = rng.random((N_RAW, 2))
    src, dst, w = knn_graph_edges(pos, 3)
    gpath = str(tmp / "g.npz")
    jcity.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_RAW)
    _, _, layout = jcity.build_city_supports(
        src, dst, w, N_RAW, pos=pos, ordering="rcm", form="flat",
        block_size=16, addaptadj=True)
    ccfg = ModelConfig(num_nodes=layout["n_pad"], out_dim=4, n_supports=2,
                       addaptadj=True, **WIDTHS)
    c_jpath, c_tpath, _ = _jax_checkpoint(tmp, "city", ccfg, scaler, rng,
                                          extra={"graph_layout": layout})
    return {
        "dense": (jserving.Forecaster(dcfg, d_state.params,
                                      d_state.model_state,
                                      [jnp.asarray(s) for s in sups], scaler),
                  tserving.Forecaster.from_checkpoint(d_tpath, sups,
                                                      device=CPU)),
        "city": (jserving.Forecaster.from_city_checkpoint(c_jpath, gpath),
                 tserving.Forecaster.from_city_checkpoint(c_tpath, gpath,
                                                          device=CPU)),
        "tmp": tmp, "adj": adj_path, "graph": gpath, "layout": layout,
        "dense_ckpt": d_tpath, "city_ckpt": c_tpath, "scaler": scaler}


def _inputs(fc, seed, *shape):
    return np.random.default_rng(seed).normal(
        size=shape[:-2] + (fc.input_nodes, shape[-1])).astype(np.float32)


@pytest.mark.parametrize("kind", ["dense", "city"])
def test_rolling_forecast_matches_jax_and_predict(models, kind):
    """Every origin of the port's rolling forecast is ``predict`` on its
    window, bit for bit, and the whole is within 2e-4 of JAX's scan."""
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.train import serving as tserving

    jfc, tfc = models[kind]
    history = _inputs(tfc, 1, 17, 0, 2)                 # (T, N, F)
    got = tserving.rolling_forecast(tfc, history, 12)
    assert got.shape == (6, 4, tfc.input_nodes)
    for k in range(6):
        assert torch.equal(got[k], tfc.predict(history[None, k:k + 12])[0])
    want = jserving.rolling_forecast(jfc, jnp.asarray(history), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,aux", [("dense", False), ("dense", True)])
def test_autoregressive_forecast_matches_jax(models, kind, aux):
    """Three rounds, with the aux channel's tail repeated or given as
    ``future_aux``: within 2e-4 of JAX; round 1 is ``predict`` bit for
    bit."""
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.train import serving as tserving

    jfc, tfc = models[kind]
    x = _inputs(tfc, 2, 2, 12, 0, 2)
    future = _inputs(tfc, 3, 2, 12, 0, 1) if aux else None
    got = tserving.autoregressive_forecast(tfc, x, 3, future_aux=future)
    assert got.shape == (2, 12, tfc.input_nodes)
    assert torch.equal(got[:, :4], tfc.predict(x))
    want = jserving.autoregressive_forecast(
        jfc, jnp.asarray(x), 3,
        future_aux=None if future is None else jnp.asarray(future))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if aux:     # the given calendar differs from the repeated tail
        tail = tserving.autoregressive_forecast(tfc, x, 3)
        assert not torch.equal(tail[:, 4:], got[:, 4:])


def test_autoregressive_city_feeds_back_in_original_order(models):
    """On the city layout round 2 is ``predict`` on the window rolled by H
    steps, the standardized round-1 forecast as its signal and the given
    calendar as its aux channel, all in original node order."""
    from graph_wavenet_tpu_torch.train import serving as tserving

    tfc = models["city"][1]
    x = _inputs(tfc, 2, 2, 12, 0, 2)
    future = _inputs(tfc, 3, 2, 8, 0, 1)
    got = tserving.autoregressive_forecast(tfc, x, 2, future_aux=future)
    r1 = tfc.predict(x)
    assert torch.equal(got[:, :4], r1)
    new = np.concatenate([tfc.scaler.transform(r1.numpy())[..., None],
                          future[:, :4]], axis=-1)
    x2 = np.concatenate([x[:, 4:], new], axis=1)
    np.testing.assert_allclose(got[:, 4:].numpy(), tfc.predict(x2).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_reconstruct_sequence_matches_jax_and_windows():
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.data.windows import reverse_sliding_window
    from graph_wavenet_tpu_torch.train import serving as tserving

    rolling = np.random.default_rng(5).normal(
        size=(9, 4, 7)).astype(np.float32)
    got = tserving.reconstruct_sequence(rolling).numpy()
    assert got.shape == (12, 7)
    np.testing.assert_allclose(
        got, np.asarray(jserving.reconstruct_sequence(jnp.asarray(rolling))),
        rtol=1e-6, atol=1e-6)
    (ref,) = reverse_sliding_window([rolling.transpose(0, 2, 1)])
    np.testing.assert_allclose(got, ref.T, rtol=1e-6, atol=1e-6)


def _padded_forecaster(models):
    """The city checkpoint under the padded (``"pallas"``) layout."""
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train import serving as tserving

    path = str(models["tmp"] / "city_pallas.pt")
    meta = tckpt.load_metadata(models["city_ckpt"])
    tckpt.save_checkpoint(
        path, tckpt.load_state_dict(models["city_ckpt"]),
        model_cfg=meta["model_cfg"], scaler=meta["scaler"],
        extra={"graph_layout": dict(models["layout"], form="pallas")})
    return tserving.Forecaster.from_city_checkpoint(path, models["graph"],
                                                    device=CPU)


@pytest.fixture(scope="module")
def artifacts(models):
    """Batch-3 artifacts of the default window (the receptive field) of the
    city model (flat supports, the masked adaptive adjacency) and of the
    city model under the padded layout, and ``gwt-torch-export``'s batch-4
    artifact of the dense model with a 12-step window, each beside the
    Forecaster it was exported from."""
    from graph_wavenet_tpu_torch.cli import export
    from graph_wavenet_tpu_torch.train import serving as tserving

    out = {}
    for kind, fc in (("city", models["city"][1]),
                     ("city_padded", _padded_forecaster(models))):
        path = str(models["tmp"] / f"{kind}.pt2")
        tserving.export_forecaster(fc, path, batch_size=3)
        out[kind] = (path, fc)
    # the dense artifact through the CLI, at batch 4 and a 12-step window
    path = str(models["tmp"] / "dense.pt2")
    out["dense_cli"] = export.main([
        "--checkpoint", models["dense_ckpt"], "--adjdata", models["adj"],
        "--out", path, "--batch_size", "4", "--seq_len", "12", "--device",
        CPU])
    out["dense"] = (path, models["dense"][1])
    return out


@pytest.mark.parametrize("kind", ["dense", "city", "city_padded"])
def test_export_round_trip_equals_predict(models, artifacts, kind):
    """A city artifact's window is the receptive field by default; a
    shorter window is left-padded by the loader and the forecast equals
    ``predict`` bit for bit, as does one of the full window; another batch
    or a longer window is refused; the city artifact is within 2e-4 of
    JAX's artifact, in original node order."""
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.ops.block_sparse import (
        BlockSparseSupport,
        Fused2FlatSupport,
    )
    from graph_wavenet_tpu_torch.train import serving as tserving

    path, tfc = artifacts[kind]
    if kind == "city":
        assert isinstance(tfc.supports[0], Fused2FlatSupport)
        assert getattr(tfc.supports[-1], "adaptive_mask", False)
    if kind == "city_padded":
        assert isinstance(tfc.supports[0], BlockSparseSupport)
    art = tserving.load_exported_forecaster(path)
    batch, window = (4, 12) if kind == "dense" else (3, RF)
    assert art.in_shape == (batch, window, tfc.input_nodes, 2)
    assert art.device == torch.device(CPU) and art.n_inputs == 1
    x = _inputs(tfc, 6, batch, window, 0, 2)
    for window in (x[:, 2:], x):
        got = art.predict(window)
        assert torch.equal(got, tfc.predict(window))
    with pytest.raises(ValueError, match="takes"):
        art.predict(x[:2])
    with pytest.raises(ValueError, match="takes"):
        art.predict(np.concatenate([x, x], axis=1))
    if kind == "city":
        jpath = str(models["tmp"] / "city.jaxexp")
        jserving.export_forecaster(models["city"][0], jpath, batch_size=3)
        want = jserving.load_exported_forecaster(jpath).predict(
            jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_artifact_refuses_another_device(artifacts, tmp_path):
    import zipfile

    from graph_wavenet_tpu_torch.train import serving as tserving

    path = artifacts["dense"][0]
    assert artifacts["dense_cli"] == {
        "path": path, "in_shape": (4, 12, N_DENSE, 2), "device": "cpu"}
    assert tserving.artifact_metadata(path) == {
        "in_shape": [4, 12, N_DENSE, 2], "device": "cpu"}
    with pytest.raises(ValueError, match="runs only there"):
        tserving.load_exported_forecaster(path, device="cuda")
    other = str(tmp_path / "other.pt2")
    with zipfile.ZipFile(other, "w") as z:
        z.writestr("m/archive_format", "pt2")
    with pytest.raises(ValueError, match="not an artifact"):
        tserving.artifact_metadata(other)


def test_artifact_loads_in_a_fresh_interpreter(models, artifacts):
    """A process that imports only torch and the op library loads the city
    artifact with ``torch.export.load`` and predicts what the Forecaster
    predicts, bit for bit; the model code and JAX stay unimported."""
    path, tfc = artifacts["city"]
    x = _inputs(tfc, 7, 3, RF, 0, 2)
    xf, yf = models["tmp"] / "fresh_x.npy", models["tmp"] / "fresh_y.npy"
    np.save(xf, x)
    code = (
        "import sys, numpy as np, torch\n"
        "import graph_wavenet_tpu_torch.ops.cuda.block_diffusion\n"
        f"ep = torch.export.load({path!r})\n"
        f"x = torch.as_tensor(np.load({str(xf)!r}))\n"
        "with torch.inference_mode():\n"
        "    y = ep.module()(x)\n"
        f"np.save({str(yf)!r}, y.numpy())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(("
        "'jax.', 'graph_wavenet_tpu.', 'graph_wavenet_tpu_torch.models', "
        "'graph_wavenet_tpu_torch.train'))]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_array_equal(np.load(yf), tfc.predict(x).numpy())


def _flat_case():
    """A 16-node flat support of 4x4 blocks that fuses, and x (4, 4, 3)."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    rng = np.random.default_rng(8)
    src = rng.integers(0, 16, size=40)
    dst = np.clip(src + rng.integers(-3, 4, size=40), 0, 15)
    sp = tbs.as_fused2(tbs.from_edges_flat(
        src, dst, rng.random(40).astype(np.float32), 16, 4, 4, device=CPU))
    x = torch.as_tensor(rng.normal(size=(4, 4, 3)).astype(np.float32))
    return sp, x


def _padded_case():
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    rng = np.random.default_rng(9)
    sp = tbs.random_block_support(4, 2, 4, rng=rng, device=CPU)
    x = torch.as_tensor(rng.normal(size=(4, 4, 3)).astype(np.float32))
    return sp, x


def _op_case(name):
    sp, x = _padded_case() if "padded" in name else _flat_case()
    ops = torch.ops.gwt_torch
    if name == "mix_flat":
        return ops.mix_flat, (sp.blocks_flat, sp.slot_tbl, x, sp.src_tbl,
                              sp.row_tbl, sp.row_ptr, sp.nb, True)
    if name == "mix_flat2":
        return ops.mix_flat2, (sp.blocks_flat, sp.slot_tbl, x, sp.src_tbl,
                               sp.row_tbl, sp.row_ptr, x.flip(0), sp.nb,
                               sp.lag, True)
    if name == "outer_flat":
        return ops.outer_flat, (x, x.flip(2), sp.src_tbl, sp.row_tbl, None,
                                None, None)
    if name == "outer_flat_slots":
        return ops.outer_flat, (x, x.flip(2), sp.src_tbl, sp.row_tbl,
                                sp.slot_tbl, sp.blocks_flat.shape[0],
                                torch.bfloat16)
    nb, mb = sp.block_idx.shape
    blocks = sp.blocks.reshape(nb * mb, 4, 4)
    if name == "mix_padded":
        return ops.mix_padded, (blocks, sp.slot, x, sp.block_idx, True)
    return ops.outer_padded, (x, x.flip(2), sp.block_idx, torch.float32)


@pytest.mark.parametrize("name", ["mix_flat", "mix_flat2", "outer_flat",
                                  "outer_flat_slots", "mix_padded",
                                  "outer_padded"])
def test_kernel_ops_pass_opcheck(name):
    """Each kernel's op: schema, autograd registration, fake kernel and
    AOT dispatch with dynamic shapes, at small shapes on the CPU."""
    op, args = _op_case(name)
    torch.library.opcheck(op, args)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _ask_concurrently(url, raws):
    answers = [None] * len(raws)

    def post(i):
        answers[i] = np.asarray(_post(url + "/predict",
                                      {"x": raws[i].tolist()})["y"])

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(raws))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return answers


def _serve(argv):
    from graph_wavenet_tpu_torch.cli import serve

    run = serve.main([*argv, "--port", "0", "--window_ms", "300"],
                     serve_forever=False)
    return run, f"http://127.0.0.1:{run['server'].server_port}"


def _stop(run):
    run["server"].shutdown()
    run["server"].server_close()
    run["batcher"].stop()


def test_artifact_serving_pads_to_the_baked_batch(models, artifacts):
    """``gwt-torch-serve --artifact`` on the dense artifact of
    ``gwt-torch-export --adjdata``, with the scaler flags, pads every device
    call to the artifact's batch (4) and answers 3 concurrent requests as
    the Forecaster does; ``--checkpoint --adjdata`` answers the same."""
    out, tfc = artifacts["dense"]
    raws = np.random.default_rng(10).normal(
        50.0, 10.0, size=(3, 12, N_DENSE, 2)).astype(np.float32)
    xs = raws.copy()
    xs[..., 0] = tfc.scaler.transform(xs[..., 0])
    want = tfc.predict(xs).numpy()
    sc = models["scaler"]
    run, url = _serve(["--artifact", out, "--scaler_mean", str(sc.mean),
                       "--scaler_std", str(sc.std)])
    try:
        health = json.loads(urllib.request.urlopen(url + "/healthz").read())
        assert health["source"] == "artifact" and health["device"] == "cpu"
        assert health["in_shape"] == [4, 12, N_DENSE, 2]
        assert run["batcher"].fixed_batch == 4
        assert [run["batcher"]._bucket(n) for n in (1, 3, 4)] == [4, 4, 4]
        answers = _ask_concurrently(url, raws)
        stats = json.loads(urllib.request.urlopen(url + "/stats").read())
        assert stats["requests"] == 3
    finally:
        _stop(run)
    for a, w in zip(answers, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5)
    run, url = _serve(["--checkpoint", models["dense_ckpt"], "--adjdata",
                       models["adj"], "--device", CPU])
    try:
        health = json.loads(urllib.request.urlopen(url + "/healthz").read())
        assert health["source"] == "checkpoint" and health["supports"] == 2
        answers = _ask_concurrently(url, raws)
    finally:
        _stop(run)
    for a, w in zip(answers, want):
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5)


def test_temporal_only_checkpoint_serves_and_exports(tmp_path):
    """A checkpoint trained without ``--gcn_bool`` needs no graph flag: the
    serve CLI answers with the temporal-only model, and its artifact equals
    it."""
    from graph_wavenet_tpu_torch.cli import export
    from graph_wavenet_tpu_torch.config import ModelConfig as TConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler as TScaler
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train import serving as tserving

    cfg = TConfig(num_nodes=N_DENSE, out_dim=4, gcn_bool=False,
                  addaptadj=False, **WIDTHS)
    path = str(tmp_path / "temporal.pt")
    tckpt.save_checkpoint(path, GWNet(cfg, device=CPU, seed=3).state_dict(),
                          model_cfg=cfg, scaler=TScaler(50.0, 10.0))
    raw = np.random.default_rng(11).normal(
        50.0, 10.0, size=(12, N_DENSE, 2)).astype(np.float32)
    run, url = _serve(["--checkpoint", path, "--device", CPU])
    try:
        health = json.loads(urllib.request.urlopen(url + "/healthz").read())
        assert health["supports"] == "none"
        y = np.asarray(_post(url + "/predict", {"x": raw.tolist()})["y"])
    finally:
        _stop(run)
    fc = tserving.Forecaster.from_checkpoint(path, None, device=CPU)
    x = raw[None].copy()
    x[..., 0] = fc.scaler.transform(x[..., 0])
    np.testing.assert_allclose(y, fc.predict(x)[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    out = str(tmp_path / "temporal.pt2")
    export.main(["--checkpoint", path, "--out", out, "--batch_size", "1",
                 "--seq_len", "12", "--device", CPU])
    art = tserving.load_exported_forecaster(out)
    assert torch.equal(art.predict(x), fc.predict(x))


def test_clis_refuse_graph_banks_and_missing_adjacency(models):
    from graph_wavenet_tpu_torch.cli import export, serve

    # a graph bank serves diff-G checkpoints only, and an artifact holds
    # its own
    bank = ["--graph_bank", "bank.npz"]
    with pytest.raises(SystemExit, match="shared-graph one"):
        serve.main(["--checkpoint", models["dense_ckpt"], *bank, "--device",
                    CPU], serve_forever=False)
    with pytest.raises(SystemExit, match="holds its bank"):
        serve.main(["--artifact", "x.pt2", *bank], serve_forever=False)
    with pytest.raises(SystemExit, match="shared-graph one"):
        export.main(["--checkpoint", models["dense_ckpt"], "--out", "x.pt2",
                     "--device", CPU, *bank])
    with pytest.raises(SystemExit, match="--adjdata"):
        export.main(["--checkpoint", models["dense_ckpt"], "--out", "x.pt2",
                     "--device", CPU])
    with pytest.raises(SystemExit, match="--graph_npz"):
        serve.main(["--checkpoint", models["city_ckpt"], "--device", CPU],
                   serve_forever=False)
    with pytest.raises(SystemExit):         # one source only
        serve.build_parser().parse_args(["--checkpoint", "a", "--artifact",
                                         "b"])
