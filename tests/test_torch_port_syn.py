"""The port's synthetic two-modality task held to the JAX package on the
CPU: the graph generator, the synthetic dataset (one shared graph and one
graph per subject), ``stack_support_splits`` and the loaders' ``adj_idx``
against the JAX arrays for one seed, exactly (numpy against numpy); the
pooling ops against the JAX ones to 1e-5; the runner's syn loops (two
epochs, the ``diff_g`` sidecar record, resume, early stop, the fused feed
against the per-step one); and the training CLI's ``--data syn`` branches
end to end."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.config import DataConfig as JDataConfig
from graph_wavenet_tpu.data import synthetic as jsyn
from graph_wavenet_tpu.graphs import generate as jgen
from graph_wavenet_tpu.train import engine as jeng
from graph_wavenet_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from graph_wavenet_tpu_torch.data import synthetic as tsyn
from graph_wavenet_tpu_torch.graphs import generate as tgen
from graph_wavenet_tpu_torch.train import engine as teng
from graph_wavenet_tpu_torch.train.runner import Runner

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
# 12 nodes, K = 24 (F_t 2), 2 subjects of 100 steps for training
SYN = dict(num_nodes=12, seq_length=24, n_train=2, n_valid=1, n_test=1,
           num_timestep=100)


def assert_trees_equal(got, want, path="root"):
    """Nested dicts/lists/arrays equal exactly."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


# ---------------------------------------------------------------------------
# the graph generator
# ---------------------------------------------------------------------------

def _graph_case(mod, name, seed):
    rng = np.random.default_rng(seed)
    if name == "sbm":
        g = mod.Graph("SBM", 30, {"nCommunities": 4, "probIntra": 0.7,
                                  "probInter": 0.1}, rng=rng)
        g.computeGFT()
        return [g.W, g.E, g.V, g.community_labels, g.lambda_max(),
                g.assign_dict]
    if name == "small_world":
        g = mod.Graph("SmallWorld", 20, {"probEdge": 0.3,
                                         "probRewiring": 0.2}, rng=rng)
        return [g.W, g.D, g.M]
    w = mod.create_sbm(16, 2, 0.9, 0.3, rng=rng)[0]
    if name == "edge_fail":
        return [mod.edge_fail_sampling(w, 0.3, rng=rng)]
    if name == "sparsify":
        wr = w * rng.random(w.shape)
        wr = wr + wr.T
        return [mod.sparsify_graph(wr, "threshold", 0.5),
                mod.sparsify_graph(wr, "NN", 3)]
    if name == "fuse":
        stack = rng.random((3, 10, 10)) * (rng.random((3, 10, 10)) < 0.3)
        nodes, extra = [], []
        fused = mod.fuse_edges(stack, "avg", "rows", isolated_nodes=False,
                               force_undirected=True, force_connected=True,
                               node_list=nodes, extra_components=extra)
        return [fused, nodes, extra]
    if name == "normalize":
        g = mod.Graph("SBM", 16, {"nCommunities": 2, "probIntra": 0.9,
                                  "probInter": 0.3}, rng=rng)
        g.setGSO(mod.normalize_adjacency(g.W), GFT="increasing")
        return [g.S, g.E, g.V,
                mod.normalize_laplacian(mod.adjacency_to_laplacian(w))]
    return [mod.matrix_powers(w, 3), mod.k_hop_neighborhood(w, 2),
            mod.compute_nonzero_rows(w, 2), mod.is_connected(w)]


@pytest.mark.parametrize("name", ["sbm", "small_world", "edge_fail",
                                  "sparsify", "fuse", "normalize",
                                  "powers"])
def test_graph_generator_matches_jax(name):
    """One seed draws the same graphs and spectra, bit for bit."""
    assert_trees_equal(_graph_case(tgen, name, 3), _graph_case(jgen, name, 3))


# ---------------------------------------------------------------------------
# the synthetic dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooltype", ["avg", "weighted", "selectOne"])
def test_modality_pools_and_rollout_match_jax(pooltype):
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    opts = {"nCommunities": 3, "probIntra": 0.8, "probInter": 0.2}
    gt = tgen.Graph("SBM", 15, opts, rng=rng_t)
    gj = jgen.Graph("SBM", 15, opts, rng=rng_j)
    xt = tsyn.diffusion_rollout(gt, 4, 40, 0.1, 0.1, 0.05, 0.05, rng_t)
    xj = jsyn.diffusion_rollout(gj, 4, 40, 0.1, 0.1, 0.05, 0.05, rng_j)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(tsyn.pool_temporal(xt, 4, pooltype),
                                  jsyn.pool_temporal(xj, 4, pooltype))
    np.testing.assert_array_equal(tsyn.pool_spatial(xt, gt, pooltype),
                                  jsyn.pool_spatial(xj, gj, pooltype))
    with pytest.raises(ValueError, match="divisible"):
        tsyn.pool_temporal(xt, 7, pooltype)


def _syn_pair(same_g: bool, resident: str, seed: int = 0):
    kw = dict(SYN, same_g=same_g)
    tdata = tsyn.load_dataset_syn(DataConfig(**kw), 8, seed=seed,
                                  resident=resident, device=CPU)
    jdata = jsyn.load_dataset_syn(JDataConfig(**kw), 8, seed=seed,
                                  resident=resident)
    return tdata, jdata


@pytest.mark.parametrize("resident", ["host", "device"])
@pytest.mark.parametrize("same_g", [True, False], ids=["same_g", "per_sample"])
def test_load_dataset_syn_matches_jax(same_g, resident):
    """The splits, scaler, supports, F_t and graphs, and two shuffled
    epochs of batches (with their ``adj_idx``), equal the JAX package's
    for one seed."""
    (td, tadjs, tft, tG), (jd, jadjs, jft, jG) = _syn_pair(same_g, resident)
    assert tft == jft == 2
    for k in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert td["scaler"].mean == jd["scaler"].mean
    assert td["scaler"].std == jd["scaler"].std
    assert_trees_equal(tadjs, jadjs)
    if same_g:
        np.testing.assert_array_equal(tG.community_labels,
                                      jG.community_labels)
    else:
        for split in ("train", "val", "test"):
            assert len(tG[split]) == len(jG[split])
            for a, b in zip(tG[split], jG[split]):
                np.testing.assert_array_equal(a.W, b.W)
                np.testing.assert_array_equal(a.community_labels,
                                              b.community_labels)
    for split in ("train", "val", "test"):
        tl, jl = td[split + "_loader"], jd[split + "_loader"]
        assert (tl.num_batch, tl.num_real) == (jl.num_batch, jl.num_real)
        for _ in range(2):
            tl.shuffle()
            jl.shuffle()
            for bt, bj in zip(tl.get_iterator(), jl.get_iterator()):
                assert len(bt) == len(bj) == (2 if same_g else 3)
                for a, b in zip(bt, bj):
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))


@pytest.mark.parametrize("n_test", [1, 0])
def test_stack_support_splits_matches_jax(rng, n_test):
    adjs = [[rng.random((5, 5)).astype(np.float32) for _ in range(2)]
            for _ in range(6)]
    assert_trees_equal(tsyn.stack_support_splits(adjs, 3, n_test),
                       jsyn.stack_support_splits(adjs, 3, n_test))


def test_device_loader_fused_feed_with_adj_idx_matches_jax(rng):
    """Superbatches, remainders (as triples) and the resident ``adj_idx``
    of the device batcher against the JAX one."""
    from graph_wavenet_tpu.data.device_loader import (
        DeviceArrayLoader as JLoader,
    )
    from graph_wavenet_tpu_torch.data.device_loader import DeviceArrayLoader

    xs = rng.normal(size=(37, 6, 4, 2)).astype(np.float32)
    ys = rng.normal(size=(37, 6, 4, 2)).astype(np.float32)
    adj = np.repeat(np.arange(5), 8)[:37]
    tl = DeviceArrayLoader(xs, ys, 8, rng=np.random.default_rng(2),
                           device=CPU, adj_idx=adj)
    jl = JLoader(xs, ys, 8, adj_idx=adj, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(tl.resident_adj_idx().numpy(), adj)
    tl.shuffle()
    jl.shuffle()
    for a, b in zip(tl.superbatches(2), jl.superbatches(2)):
        np.testing.assert_array_equal(a, b)
    rt, rj = list(tl.remainder_batches(2)), list(jl.remainder_batches(2))
    assert len(rt) == len(rj) == 1
    for a, b in zip(rt[0], rj[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="one graph per sample"):
        DeviceArrayLoader(xs, ys, 8, device=CPU, adj_idx=adj[:5])


# ---------------------------------------------------------------------------
# the pooling ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False], ids=["shared", "batched"])
def test_pool_ops_match_jax(rng, shared):
    b, n, k = 3, 10, 12
    pred = rng.normal(size=(b, 1, n, k)).astype(np.float32)
    labels = rng.integers(0, 4, size=(n,) if shared else (b, n))
    if shared:
        pj = jeng.cluster_mean_projector(labels, 4)
        pt = teng.cluster_mean_projector(labels, 4)
    else:
        pj = np.stack([jeng.cluster_mean_projector(la, 4) for la in labels])
        pt = np.stack([teng.cluster_mean_projector(la, 4) for la in labels])
    np.testing.assert_allclose(pt, pj, **TOL)
    np.testing.assert_allclose(
        teng.pool_E(torch.as_tensor(pred), torch.as_tensor(pt)).numpy(),
        np.asarray(jeng.pool_E(jnp.asarray(pred), jnp.asarray(pj))), **TOL)
    np.testing.assert_allclose(
        teng.pool_F(torch.as_tensor(pred), 3).numpy(),
        np.asarray(jeng.pool_F(jnp.asarray(pred), 3)), **TOL)
    y = rng.normal(size=(b, k, n, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        teng.modality_target(torch.as_tensor(y)).numpy(),
        np.asarray(jeng.modality_target(jnp.asarray(y))))
    with pytest.raises(ValueError, match="divisible"):
        teng.pool_F(torch.as_tensor(pred), 5)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(num_nodes=12, out_dim=24, residual_channels=4,
                dilation_channels=4, skip_channels=8, end_channels=16,
                blocks=2, layers=2, start_dilation=4, dropout=0.3,
                n_supports=2)
    base.update(kw)
    return ModelConfig(**base)


def _syn_runner(tmp_path, name, data, **tc):
    """A diff-G runner of ``_cfg`` on the CPU saving under ``name``."""
    tcfg = TrainConfig(**{"epochs": 2, "save_dir": str(tmp_path / name),
                          "batch_size": 8, **tc})
    engine = teng.Engine(_cfg(), tcfg, data["scaler"], device=CPU, seed=0,
                         diff_g=True)
    return Runner(engine, tcfg, log_fn=lambda *a: None)


def _per_sample(resident="device"):
    data, adjs, F_t, G = tsyn.load_dataset_syn(
        DataConfig(**SYN), 8, seed=0, resident=resident, device=CPU)
    return data, tsyn.stack_support_splits(adjs, 2, 1), F_t, G


def test_fit_syn_two_epochs_sidecar_resume_and_early_stop(tmp_path):
    data, sups, F_t, G = _per_sample()
    runner = _syn_runner(tmp_path, "a", data)
    res = runner.fit_syn(data, sups, G, F_t, 5)
    assert [h.epoch for h in res.history] == [1, 2]
    with open(res.best_checkpoint + ".json") as f:
        assert json.load(f)["extra"]["diff_g"] is True
    test = runner.test_syn(data, sups, G, F_t, 5, res)
    n_test = data["test_loader"].size      # padded, as in the JAX loop
    assert test.test_metrics["pred_F"].shape == (n_test, 12, 24)
    assert test.test_metrics["pred_E"].shape == (n_test, 12, 24)
    assert test.test_metrics["reals"].shape == (n_test, 24, 12, 2)
    assert np.isfinite(test.test_metrics["loss"])
    # resume the first epoch's checkpoint: the run continues at epoch 2
    # and reaches the uninterrupted run's second epoch
    first = [p for p in os.listdir(tmp_path / "a")
             if p.startswith("exp1_epoch_1_") and p.endswith(".pt")][0]
    data2, sups2, _, G2 = _per_sample()
    data2["train_loader"].shuffle()     # the first epoch's shuffle
    resumed = _syn_runner(tmp_path, "b", data2)
    res2 = resumed.fit_syn(data2, sups2, G2, F_t, 5,
                           resume_from=str(tmp_path / "a" / first))
    assert [h.epoch for h in res2.history] == [2]
    np.testing.assert_allclose(res2.history[0].train["loss"],
                               res.history[1].train["loss"], rtol=1e-6)
    # a validation plateau from epoch 1 on stops at epoch 1 + patience
    data3, sups3, _, G3 = _per_sample()
    stop = _syn_runner(tmp_path, "c", data3, epochs=5,
                       early_stop_patience=1)
    stop.engine.eval_step_syn = lambda *a, **k: {
        "loss": torch.tensor(1.0), "mape": torch.tensor(0.1),
        "rmse": torch.tensor(1.0)}
    res3 = stop.fit_syn(data3, sups3, G3, F_t, 5)
    assert [h.epoch for h in res3.history] == [1, 2]
    assert res3.best_epoch == 1


def test_fit_syn_watchdog_writes_emergency_dump(tmp_path):
    from graph_wavenet_tpu_torch.train.runner import DeviceWedgedError

    data, sups, F_t, G = _per_sample()
    runner = _syn_runner(tmp_path, "w", data, epoch_timeout_s=1e-3)
    with pytest.raises(DeviceWedgedError, match="exceeded"):
        runner.fit_syn(data, sups, G, F_t, 5)
    with open(tmp_path / "w" / "emergency.json") as f:
        assert json.load(f)["epoch"] == 1


def test_fit_syn_fused_feed_equals_per_step_feed(tmp_path):
    """On the CPU the fused diff-G feed (superbatches through
    ``train_steps_syn_resident``, then the leftover batches) runs the same
    steps in the same order as the per-step feed, bit for bit."""
    out = []
    for name, scan in (("per_step", 1), ("fused", 3)):
        data, sups, F_t, G = _per_sample()
        runner = _syn_runner(tmp_path, name, data, scan_steps=scan,
                             epochs=1)
        out.append(runner.fit_syn(data, sups, G, F_t, 5).history[0])
        out.append(runner.engine.model.state_dict())
    assert out[0].train == out[2].train
    for k in out[1]:
        assert torch.equal(out[1][k], out[3][k]), k
    with pytest.raises(ValueError, match="grad_accum"):
        _syn_runner(tmp_path, "x", data, scan_steps=3,
                    grad_accum=2).fit_syn(data, sups, G, F_t, 5)


def test_fit_syn_shared_two_epochs(tmp_path):
    data, adjs, F_t, G = tsyn.load_dataset_syn(
        DataConfig(**dict(SYN, same_g=True, seq_length=12)), 8, seed=0,
        resident="host", device=CPU)
    tcfg = TrainConfig(epochs=2, save_dir=str(tmp_path / "s"), batch_size=8,
                       grad_accum=2)
    cfg = _cfg(out_dim=12, start_dilation=1, blocks=4)
    engine = teng.Engine(cfg, tcfg, data["scaler"], device=CPU)
    runner = Runner(engine, tcfg, log_fn=lambda *a: None)
    res = runner.fit_syn_shared(data, adjs, G, F_t, 5)
    assert len(res.history) == 2
    with open(res.best_checkpoint + ".json") as f:
        assert json.load(f)["extra"]["diff_g"] is False
    runner.test_syn_shared(data, adjs, G, F_t, 5, res)
    assert np.isfinite(res.test_metrics["rmse"])


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

SYN_ARGV = ["--data", "syn", "--num_nodes", "10", "--nhid", "4",
            "--n_train", "2", "--n_valid", "1", "--n_test", "1",
            "--num_timestep", "100", "--batch_size", "8", "--epochs", "1",
            "--device", CPU]


@pytest.mark.parametrize("variant", ["diffg", "same_g", "aptonly", "fresh"])
def test_train_cli_syn(tmp_path, variant):
    from graph_wavenet_tpu_torch.cli import train

    extra = {"diffg": ["--seq_length", "24", "--blocks", "2", "--gcn_bool",
                       "--addaptadj", "--scan_steps", "3"],
             "same_g": ["--same_g", "--seq_length", "12", "--gcn_bool",
                        "--addaptadj"],
             "aptonly": ["--seq_length", "24", "--blocks", "2", "--gcn_bool",
                         "--addaptadj", "--aptonly", "--resident", "host"],
             "fresh": ["--seq_length", "24", "--blocks", "2", "--gcn_bool",
                       "--addaptadj", "--fresh_nodevec", "--plot",
                       str(tmp_path / "rec.png")]}[variant]
    out = train.main(SYN_ARGV + ["--save", str(tmp_path)] + extra)
    res, runner = out["result"], out["runner"]
    assert len(res.history) == 1 and np.isfinite(res.test_metrics["loss"])
    cfg = runner.engine.model_cfg
    assert runner.engine.diff_g is (variant != "same_g")
    assert cfg.start_dilation == (1 if variant == "same_g" else 4)
    assert cfg.fresh_nodevec is (variant == "fresh")
    assert cfg.n_supports == (0 if variant == "aptonly" else 2)
    if variant == "fresh":
        assert "nodevec1" not in runner.engine.model.state_dict()
