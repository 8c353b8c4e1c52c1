"""The port's METR data path and CLIs held to the JAX package on the CPU:
windows, graph normalizers, the traffic ETL and both dataset loaders
array-equal to the JAX ones on a synthetic series; the training CLI's METR
branch and the new test CLI end to end on a tiny dataset the port's own ETL
writes; and the test CLI's per-horizon metrics on a converted JAX METR
checkpoint within 2e-4 of JAX ``cli/test.py`` on the same data. METR-LA
itself is not in the repository: every dataset here is written from a
seeded synthetic series."""

import dataclasses
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.data import metr as jmetr
from graph_wavenet_tpu.data import traffic_etl as jetl
from graph_wavenet_tpu.data import windows as jwindows
from graph_wavenet_tpu.graphs import normalize as jnorm
from graph_wavenet_tpu_torch.data import metr as tmetr
from graph_wavenet_tpu_torch.data import traffic_etl as tetl
from graph_wavenet_tpu_torch.data import windows as twindows
from graph_wavenet_tpu_torch.graphs import normalize as tnorm

CPU = "cpu"
N_NODES = 12
T_STEPS = 160


def series(rng, n=N_NODES, t=T_STEPS):
    values = (rng.normal(size=(t, n)) * 5 + 60).astype(np.float32)
    values[rng.random(values.shape) < 0.05] = 0.0
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(t) * np.timedelta64(5, "m"))
    return values, index


def write_adj(path, rng, n=N_NODES):
    adj = (rng.random((n, n)) < 0.4).astype(np.float32) * rng.random((n, n))
    np.fill_diagonal(adj, 1.0)
    with open(path, "wb") as f:
        pickle.dump(([str(i) for i in range(n)],
                     {str(i): i for i in range(n)}, adj.astype(np.float32)),
                    f)
    return adj


@pytest.fixture(scope="module")
def metr_data(tmp_path_factory):
    """A METR-format dataset written by the port's ETL, and an adjacency
    pickle."""
    tmp = tmp_path_factory.mktemp("metr")
    rng = np.random.default_rng(0)
    values, index = series(rng)
    data_dir = str(tmp / "DATA")
    tetl.generate_train_val_test(values, data_dir, index=index)
    adj_path = str(tmp / "adj_mx.pkl")
    write_adj(adj_path, rng)
    return dict(tmp=tmp, data=data_dir, adj=adj_path, values=values,
                index=index)


# ---------------------------------------------------------------------------
# host-side modules
# ---------------------------------------------------------------------------

def test_windows_match_jax(rng):
    a = rng.normal(size=(20, 3, 4))
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(
            twindows.sliding_windows(a, 3, axis=axis),
            jwindows.sliding_windows(a, 3, axis=axis))
    wins = [rng.normal(size=(9, 3, 4)), rng.normal(size=(5, 2, 6))]
    for got, want in zip(twindows.reverse_sliding_window(wins),
                         jwindows.reverse_sliding_window(wins)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("adjtype", ["scalap", "normlap", "symnadj",
                                     "transition", "doubletransition",
                                     "identity"])
def test_normalize_matches_jax(tmp_path, rng, adjtype):
    """Every ``adjtype`` on a directed weighted graph, and ``load_adj`` of
    a pickle, array-equal to the JAX package."""
    adj = (rng.random((10, 10)) < 0.5) * rng.random((10, 10))
    adj[3] = 0.0                                   # a node with no edges
    for got, want in zip(tnorm.mod_adj(adj, adjtype),
                         jnorm.mod_adj(adj, adjtype)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "adj.pkl")
    write_adj(path, rng, 10)
    got, want = tnorm.load_adj(path, adjtype), jnorm.load_adj(path, adjtype)
    assert got[0] == want[0] and got[1] == want[1]
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        tnorm.scaled_laplacian(adj, lambda_max=None),
        jnorm.scaled_laplacian(adj, lambda_max=None))
    with pytest.raises(ValueError, match="adj type not defined"):
        tnorm.mod_adj(adj, "nope")


def test_traffic_etl_matches_jax(tmp_path, rng):
    values, index = series(rng)
    for dow in (False, True):
        np.testing.assert_array_equal(
            tetl.build_features(values, index, add_day_in_week=dow),
            jetl.build_features(values, index, add_day_in_week=dow))
    feats = jetl.build_features(values, index)
    xo, yo = np.arange(-11, 1), np.arange(1, 13)
    for got, want in zip(tetl.make_windows(feats, xo, yo),
                         jetl.make_windows(feats, xo, yo)):
        np.testing.assert_array_equal(got, want)
    shapes_t = tetl.generate_train_val_test(values, str(tmp_path / "t"),
                                            index=index, y_start=2)
    shapes_j = jetl.generate_train_val_test(values, str(tmp_path / "j"),
                                            index=index, y_start=2)
    assert shapes_t == shapes_j
    for split in ("train", "val", "test"):
        with np.load(tmp_path / "t" / f"{split}.npz") as a, \
                np.load(tmp_path / "j" / f"{split}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="too few"):
        tetl.generate_train_val_test(values[:25], str(tmp_path / "x"),
                                     index=index[:25])


def batches(loader, shuffle=True):
    if shuffle:
        loader.shuffle()
    return [tuple(np.asarray(a) for a in b) for b in loader.get_iterator()]


@pytest.mark.parametrize("given_scaler", [False, True],
                         ids=["fitted", "given"])
def test_load_dataset_matches_jax(metr_data, given_scaler):
    scaler = None
    if given_scaler:
        scaler = (tmetr.StandardScaler(55.0, 7.0),
                  jmetr.StandardScaler(55.0, 7.0))
    got = tmetr.load_dataset(metr_data["data"], 8, seed=3,
                             scaler=scaler and scaler[0])
    want = jmetr.load_dataset(metr_data["data"], 8, seed=3, resident="host",
                              scaler=scaler and scaler[1])
    assert (got["scaler"].mean, got["scaler"].std) == (
        want["scaler"].mean, want["scaler"].std)
    for k in ("x_train", "y_train", "x_val", "y_test"):
        np.testing.assert_array_equal(got[k], want[k])
    for split in ("train", "val", "test"):
        g, w = got[split + "_loader"], want[split + "_loader"]
        assert (g.num_batch, g.num_real) == (w.num_batch, w.num_real)
        for bg, bw in zip(batches(g), batches(w)):
            for a, b in zip(bg, bw):
                np.testing.assert_array_equal(a, b)
    # resident on the device (here the CPU): the same batches, shuffled
    # by the same seeded Generator
    dev = tmetr.load_dataset(metr_data["data"], 8, seed=3, resident="device",
                             scaler=scaler and scaler[0], device=CPU)
    host = tmetr.load_dataset(metr_data["data"], 8, seed=3,
                              scaler=scaler and scaler[0])
    for split in ("train", "val", "test"):
        d, h = dev[split + "_loader"], host[split + "_loader"]
        assert (d.num_batch, d.num_real) == (h.num_batch, h.num_real)
        for bd_, bh in zip(batches(d), batches(h)):
            for a, b in zip(bd_, bh):
                np.testing.assert_array_equal(a, b)


def test_load_dataset_streaming_matches_jax(metr_data):
    """The streaming loaders give the JAX package's batches, scaler and
    test targets (the JAX loader takes its numpy gather or its native one:
    both copy the same rows)."""
    v, idx = metr_data["values"], metr_data["index"]
    got = tmetr.load_dataset_streaming(v, idx, batch_size=8, seed=2)
    want = jmetr.load_dataset_streaming(v, idx, batch_size=8, seed=2,
                                        resident="host")
    assert (got["scaler"].mean, got["scaler"].std) == (
        want["scaler"].mean, want["scaler"].std)
    np.testing.assert_array_equal(got["y_test"], want["y_test"])
    for split in ("train", "val", "test"):
        g, w = got[split + "_loader"], want[split + "_loader"]
        assert (g.num_batch, g.num_real) == (w.num_batch, w.num_real)
        for bg, bw in zip(batches(g), batches(w)):
            for a, b in zip(bg, bw):
                np.testing.assert_array_equal(a, b)
    materialized = tmetr.load_dataset(metr_data["data"], 8)
    assert got["scaler"].mean == pytest.approx(materialized["scaler"].mean,
                                               rel=1e-6)
    assert got["scaler"].std == pytest.approx(materialized["scaler"].std,
                                              rel=1e-6)


def test_generate_training_data_cli_refuses_to_overwrite(tmp_path, rng):
    from graph_wavenet_tpu_torch.cli import generate_training_data as gen

    values, index = series(rng)
    tetl.generate_train_val_test(values, str(tmp_path), index=index)
    with pytest.raises(SystemExit, match="pass --force"):
        gen.main(["--output_dir", str(tmp_path),
                  "--traffic_df_filename", str(tmp_path / "none.h5")])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_metr(metr_data):
    """One epoch of the port's training CLI on the METR-format data, SVD
    aptinit from the first support."""
    from graph_wavenet_tpu_torch.cli import train

    save = str(metr_data["tmp"] / "garage")
    out = train.main([
        "--data", metr_data["data"], "--adjdata", metr_data["adj"],
        "--gcn_bool", "--addaptadj", "--adjtype", "doubletransition",
        "--num_nodes", str(N_NODES), "--seq_length", "12", "--nhid", "4",
        "--blocks", "2", "--layers", "2", "--batch_size", "8", "--epochs",
        "1", "--save", save, "--device", CPU])
    return out


def test_metr_train_cli_trains_and_test_cli_reproduces(trained_metr,
                                                       metr_data, tmp_path):
    from graph_wavenet_tpu_torch.cli import test as test_cli
    from graph_wavenet_tpu_torch.graphs.normalize import load_adj
    from graph_wavenet_tpu_torch.ops.adaptive import svd_nodevecs

    result = trained_metr["result"]
    assert len(result.history) == 1 and len(result.per_horizon) == 12
    assert np.isfinite(result.test_metrics["mae"])
    assert all(s.shape == (N_NODES, N_NODES)
               for s in trained_metr["supports"])
    # the embeddings started from the SVD of the first support
    first = torch.load(result.best_checkpoint, weights_only=True)
    assert first["step"] == trained_metr["runner"].engine.step
    _, _, adj = load_adj(metr_data["adj"], "doubletransition")
    e1, _ = svd_nodevecs(adj[0], 10)
    assert e1.shape == first["model"]["nodevec1"].shape

    ev = test_cli.main([
        "--checkpoint", result.best_checkpoint, "--data", metr_data["data"],
        "--adjdata", metr_data["adj"], "--batch_size", "8", "--device", CPU,
        "--heatmap_out", str(tmp_path / "emb.pdf"),
        "--csv_out", str(tmp_path / "wave.csv")])
    assert ev["test_metrics"]["mae"] == pytest.approx(
        result.test_metrics["mae"], rel=1e-5)
    adp = ev["adaptive_adjacency"]
    assert adp.shape == (N_NODES, N_NODES)
    np.testing.assert_allclose(adp.sum(1), 1.0, rtol=1e-5)
    with open(tmp_path / "wave.csv") as f:
        assert f.readline().strip().split(",") == ["real12", "pred12",
                                                   "real3", "pred3"]
    table = np.loadtxt(tmp_path / "wave.csv", delimiter=",", skiprows=1)
    assert table.shape[1] == 4 and np.isfinite(table).all()
    ev = test_cli.main([
        "--checkpoint", result.best_checkpoint, "--data", metr_data["data"],
        "--adjdata", metr_data["adj"], "--device", CPU, "--plotheatmap",
        "False", "--csv_out", ""])
    assert "adaptive_adjacency" not in ev and len(ev["per_horizon"]) == 12


@pytest.mark.parametrize("aptonly", [False, True], ids=["fixed", "aptonly"])
def test_test_cli_matches_jax_on_a_converted_checkpoint(metr_data, tmp_path,
                                                        aptonly):
    """A JAX METR checkpoint (random weights and BN statistics; aptonly:
    n_supports 0) evaluated by JAX ``cli/test.py`` and, converted, by the
    port's test CLI on the same data: per-horizon MAE/MAPE/RMSE within
    2e-4."""
    from flax import serialization

    from graph_wavenet_tpu.cli import test as jtest_cli
    from graph_wavenet_tpu.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler
    from graph_wavenet_tpu.train import checkpoint as jckpt
    from graph_wavenet_tpu.train.engine import Engine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.cli import test as ttest_cli
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt

    rng = np.random.default_rng(4)
    cfg = ModelConfig(num_nodes=N_NODES, out_dim=12, residual_channels=4,
                      dilation_channels=4, skip_channels=8, end_channels=16,
                      blocks=2, layers=2, dropout=0.0, addaptadj=True,
                      n_supports=0 if aptonly else 2)
    scaler = StandardScaler(58.0, 9.0)
    engine = Engine(cfg, TrainConfig(), scaler, seed=1)
    ms = {"bn": [{"mean": jnp.asarray(rng.normal(size=4), jnp.float32),
                  "var": jnp.asarray(rng.random(4) + 0.5, jnp.float32)}
                 for _ in engine.state.model_state["bn"]]}
    engine.state = dataclasses.replace(engine.state, model_state=ms)
    jpath = str(tmp_path / "metr.msgpack")
    jckpt.save_checkpoint(jpath, engine.state, model_cfg=cfg,
                          train_cfg=TrainConfig(), scaler=scaler)
    with open(jpath, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    meta = tckpt.load_metadata(jpath)
    tpath = str(tmp_path / "metr.pt")
    tckpt.save_checkpoint(tpath, convert.params_from_jax(
        tree["params"], tree["model_state"], meta["model_cfg"]),
        model_cfg=meta["model_cfg"], train_cfg=meta["train_cfg"],
        scaler=meta["scaler"])

    common = ["--data", metr_data["data"], "--adjdata", metr_data["adj"],
              "--batch_size", "8", "--plotheatmap", "False"]
    common += ["--aptonly"] if aptonly else []
    want = jtest_cli.main(["--checkpoint", jpath, *common, "--csv_out",
                           str(tmp_path / "j.csv")])
    got = ttest_cli.main(["--checkpoint", tpath, *common, "--csv_out",
                          str(tmp_path / "t.csv"), "--device", CPU])
    np.testing.assert_allclose(np.asarray(got["per_horizon"]),
                               np.asarray(want["per_horizon"]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / "t.csv", delimiter=",", skiprows=1),
        np.loadtxt(tmp_path / "j.csv", delimiter=",", skiprows=1),
        rtol=2e-4, atol=2e-4)


def test_train_cli_checks_horizon_and_nodes(metr_data, tmp_path):
    from graph_wavenet_tpu_torch.cli import train

    base = ["--data", metr_data["data"], "--adjdata", metr_data["adj"],
            "--gcn_bool", "--device", CPU, "--epochs", "1"]
    with pytest.raises(SystemExit, match="--seq_length 12"):
        train.main(base + ["--num_nodes", str(N_NODES)])
    with pytest.raises(SystemExit, match="--num_nodes 5"):
        train.main(base + ["--num_nodes", "5", "--seq_length", "12"])
    # the device-resident feed (the default) trains where both match
    out = train.main(base + ["--num_nodes", str(N_NODES), "--seq_length",
                             "12", "--resident", "device", "--save",
                             str(tmp_path / "ckpt")])
    hist = out["result"].history
    assert len(hist) == 1 and np.isfinite(hist[0].valid["loss"])
    assert out["runner"].engine.step > 0
