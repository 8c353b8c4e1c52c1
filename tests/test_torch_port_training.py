"""The port's training path held to the JAX package on the CPU: train-mode
BatchNorm, the masked metrics, dropout, a five-step ``Engine`` trajectory
of the city model with the block-masked adaptive adjacency against the
JAX ``Engine``, and the training CLI whose checkpoint serves the same
forecast as the JAX ``Forecaster``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.config import ModelConfig as JConfig
from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
from graph_wavenet_tpu.graphs import spatial as jspatial
from graph_wavenet_tpu.ops import adaptive_block as jab
from graph_wavenet_tpu.train import metrics as jmetrics
from graph_wavenet_tpu_torch import convert
from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.graphs import spatial as tspatial
from graph_wavenet_tpu_torch.ops import adaptive_block as tab
from graph_wavenet_tpu_torch.ops.diffusion import GCN, dropout_scale
from graph_wavenet_tpu_torch.ops.normalization import BatchNorm
from graph_wavenet_tpu_torch.train import metrics as tmetrics
from graph_wavenet_tpu_torch.train.engine import Engine

CPU = "cpu"


def test_train_batch_norm_matches_jax(rng):
    from graph_wavenet_tpu.ops.normalization import batch_norm_apply

    c = 5
    params = {"scale": rng.normal(size=c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.random(c).astype(np.float32) + 0.5}
    x = (rng.normal(size=(3, 4, 6, c)) * 2 + 1).astype(np.float32)
    bn = BatchNorm(c, device=CPU).train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(params["scale"]))
        bn.bias.copy_(torch.as_tensor(params["bias"]))
        bn.running_mean.copy_(torch.as_tensor(state["mean"]))
        bn.running_var.copy_(torch.as_tensor(state["var"]))
    want, new = batch_norm_apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x),
        train=True)
    got = bn(torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    # bf16 activations over fp32 statistics: the output keeps x's dtype
    # and the running statistics theirs
    assert bn(torch.as_tensor(x).bfloat16()).dtype == torch.bfloat16
    assert bn.running_var.dtype == torch.float32


@pytest.mark.parametrize("null_val", [0.0, float("nan")], ids=["zero", "nan"])
def test_masked_metrics_match_jax(rng, null_val):
    preds = rng.normal(size=(4, 1, 7, 3)).astype(np.float32) + 5
    labels = rng.normal(size=(4, 1, 7, 3)).astype(np.float32) + 5
    labels[0, 0, :3] = 0.0
    labels[1, 0, 2] = np.nan
    for name in ("masked_mae", "masked_mse", "masked_rmse", "masked_mape"):
        want = getattr(jmetrics, name)(jnp.asarray(preds),
                                       jnp.asarray(labels), null_val)
        got = getattr(tmetrics, name)(torch.as_tensor(preds),
                                      torch.as_tensor(labels), null_val)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    clean = np.nan_to_num(labels)
    for a, b in zip(tmetrics.metric(torch.as_tensor(preds),
                                    torch.as_tensor(clean)),
                    jmetrics.metric(jnp.asarray(preds), jnp.asarray(clean))):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6, atol=1e-6)


def test_dropout_keep_rate_scale_and_stream():
    p, shape = 0.3, (64, 1000)
    gen = torch.Generator().manual_seed(7)
    m = dropout_scale(gen, p, shape, torch.float32, torch.device(CPU))
    keep = (m > 0).float().mean().item()
    n = m.numel()
    assert abs(keep - (1 - p)) < 3 * np.sqrt(p * (1 - p) / n)
    zero, scale = torch.unique(m).tolist()
    assert zero == 0.0 and scale == pytest.approx(1 / 0.7)
    again = dropout_scale(torch.Generator().manual_seed(7), p, shape,
                          torch.float32, torch.device(CPU))
    assert torch.equal(m, again)
    bf = dropout_scale(torch.Generator().manual_seed(7), p, shape,
                       torch.bfloat16, torch.device(CPU))
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf > 0, m > 0)


def test_gcn_dropout_only_in_train_mode(rng):
    n = 32
    src, dst, w = jspatial.knn_graph_edges(rng.random((n, 2)), 3)
    sups = tspatial.doubletransition_block_supports(
        src, dst, w, n, form="flat", block_size=16, device=CPU)
    gcn = GCN(4, 6, 2, generator=torch.Generator().manual_seed(0))
    x = torch.as_tensor(rng.normal(size=(2, 3, n, 4)).astype(np.float32))
    plain = gcn(x, sups)
    gcn.eval()
    assert torch.equal(gcn(x, sups, 0.5, torch.Generator()), plain)
    gcn.train()
    out = gcn(x, sups, 0.5, torch.Generator().manual_seed(1))
    kept = out != 0
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(out[kept], plain[kept] * 2.0)


def test_model_refuses_what_waits_and_what_is_wrong(rng):
    """The dense adaptive adjacency (no mask) waits for the dense slice; a
    mask without addaptadj and two masks are errors, as in the reference."""
    from graph_wavenet_tpu_torch.models.gwnet import GWNet

    n = 32
    src, dst, w = jspatial.knn_graph_edges(rng.random((n, 2)), 3)
    sups = tspatial.doubletransition_block_supports(
        src, dst, w, n, form="flat", block_size=16, device=CPU)
    mask = tab.mask_from_supports(sups)
    cfg = ModelConfig(num_nodes=n, residual_channels=4, dilation_channels=4,
                      skip_channels=8, end_channels=8, blocks=1, layers=2,
                      out_dim=3)
    x = torch.zeros(1, 4, n, 2)
    with pytest.raises(NotImplementedError, match="dense slice"):
        GWNet(cfg, device=CPU)(x, sups)
    with pytest.raises(ValueError, match="exactly one learned adjacency"):
        GWNet(cfg, device=CPU)(x, sups + [mask, mask])
    off = dataclasses.replace(cfg, addaptadj=False)
    with pytest.raises(ValueError, match="BlockAdaptiveMask"):
        GWNet(off, device=CPU)(x, sups + [mask])
    model = GWNet(cfg, device=CPU)
    assert model.nodevec1.shape == (n, cfg.adapt_rank)
    assert model(x, sups + [mask]).shape == (1, 1, n, 3)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

N_CITY, BLOCK = 256, 32


def city_cfg(**kw):
    base = dict(num_nodes=N_CITY, in_dim=2, out_dim=12, residual_channels=8,
                dilation_channels=8, skip_channels=16, end_channels=16,
                blocks=2, layers=2, dropout=0.0, gcn_bool=True,
                addaptadj=True, n_supports=2)
    base.update(kw)
    return base


def test_engine_trajectory_matches_jax(rng):
    """Five train steps of the city model (flat supports plus the union
    mask, addaptadj) from the same weights on the same batches: losses to
    5e-4, parameters and BN statistics to rtol 1e-3 / atol 1e-4, the JAX
    suite's bar for its torch twin (the gap is clip_grad_norm_'s +1e-6)."""
    from graph_wavenet_tpu.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu.train.engine import Engine as JEngine

    src, dst, w = jspatial.knn_graph_edges(rng.random((N_CITY, 2)), 4)
    perm = rcm_order_edges(src, dst, N_CITY)
    j_sups = jspatial.doubletransition_block_supports(
        src, dst, w, N_CITY, perm=perm, form="flat", block_size=BLOCK)
    t_sups = tspatial.doubletransition_block_supports(
        src, dst, w, N_CITY, perm=perm, form="flat", block_size=BLOCK,
        device=CPU)
    j_sup = list(j_sups) + [jab.mask_from_supports(j_sups)]
    t_sup = list(t_sups) + [tab.mask_from_supports(t_sups)]
    assert t_sup[-1].n_live < (N_CITY // BLOCK) ** 2

    tc = dict(learning_rate=1e-3, weight_decay=1e-4, grad_clip=5.0)
    jeng = JEngine(JConfig(**city_cfg()), JTrainConfig(**tc),
                   JScaler(31.0, 9.5), seed=3)
    state = jeng.state
    init_p = jax.tree.map(np.asarray, state.params)
    init_s = jax.tree.map(np.asarray, state.model_state)
    teng = Engine(ModelConfig(**city_cfg()), TrainConfig(**tc),
                  StandardScaler(31.0, 9.5), device=CPU, seed=0)
    teng.model.load_state_dict(convert.params_from_jax(
        init_p, init_s, teng.model_cfg))

    steps, batch = 5, 4
    xs = rng.normal(size=(steps, batch, 12, N_CITY, 2)).astype(np.float32)
    ys = (rng.normal(size=(steps, batch, 12, N_CITY, 2)) * 9.5
          + 31.0).astype(np.float32)
    ys[:, :, :, :7, 0] = 0.0
    losses_j, losses_t = [], []
    for s in range(steps):
        state, m = jeng.train_step(state, jnp.asarray(xs[s]),
                                   jnp.asarray(ys[s]), j_sup)
        losses_j.append(float(m["loss"]))
        losses_t.append(float(teng.train_step(xs[s], ys[s], t_sup)["loss"]))
    np.testing.assert_allclose(losses_t, losses_j, rtol=5e-4, atol=5e-4)
    assert losses_t[-1] < losses_t[0]

    sd = teng.model.state_dict()
    want = convert.params_from_jax(jax.tree.map(np.asarray, state.params),
                                   jax.tree.map(np.asarray,
                                                state.model_state),
                                   teng.model_cfg)
    for k in ("nodevec1", "nodevec2", "end_conv_2.weight",
              "bn.1.running_mean", "bn.1.running_var"):
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    assert int(sd["bn.1.num_batches_tracked"]) == steps
    assert not np.allclose(sd["nodevec1"].numpy(), init_p["nodevec1"])


@pytest.fixture(scope="module")
def trained_city(tmp_path_factory):
    """A tiny graph and dataset trained one epoch by the port's CLI."""
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.graphs import city

    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    n_raw = 40
    pos = rng.random((n_raw, 2))
    src, dst, w = jspatial.knn_graph_edges(pos, 3)
    gpath = str(tmp / "g.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=n_raw)
    data = tmp / "data"
    data.mkdir()
    for split, s in (("train", 10), ("val", 4), ("test", 5)):
        x = rng.normal(5.0, 2.0, size=(s, 12, n_raw, 2)).astype(np.float32)
        y = rng.normal(5.0, 2.0, size=(s, 12, n_raw, 2)).astype(np.float32)
        y[:, :, :2, 0] = 0.0
        np.savez(data / f"{split}.npz", x=x, y=y)
    save = tmp / "ckpt"
    out = train.main([
        "--graph_npz", gpath, "--data", str(data), "--device", CPU,
        "--gcn_bool", "--addaptadj", "--adaptive_hops", "2",
        "--block_size", "16", "--ordering", "rcm", "--seq_length", "12",
        "--nhid", "4", "--blocks", "2", "--layers", "2", "--batch_size",
        "4", "--epochs", "1", "--print_every", "1", "--save", str(save)])
    return dict(out=out, gpath=gpath, save=save, src=src, dst=dst, w=w,
                pos=pos)


def test_train_cli_writes_a_servable_checkpoint(trained_city):
    result = trained_city["out"]["result"]
    assert len(result.history) == 1 and len(result.per_horizon) == 12
    assert np.isfinite(result.test_metrics["mae"])
    ckpt = result.best_checkpoint
    assert os.path.exists(ckpt)
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    assert meta["extra"]["graph_layout"]["adaptive_hops"] == 2
    assert meta["model_cfg"]["addaptadj"]
    payload = torch.load(ckpt, weights_only=True)
    assert payload["step"] == 3 and "state" in payload["optimizer"]
    assert "nodevec1" in payload["model"]
    with open(trained_city["save"] / "history.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["start_epoch"] == 1 and lines[1]["epoch"] == 1


def test_trained_checkpoint_forecasts_like_jax(trained_city):
    from graph_wavenet_tpu.graphs import city as jcity
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu.utils import torch_import
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train import serving as tserving

    path = trained_city["out"]["result"].best_checkpoint
    tfc = tserving.Forecaster.from_city_checkpoint(path,
                                                   trained_city["gpath"],
                                                   device=CPU)
    assert getattr(tfc.supports[-1], "adaptive_mask", False)
    meta = tckpt.load_metadata(path)
    layout = meta["extra"]["graph_layout"]
    jcfg = JConfig(**dataclasses.asdict(meta["model_cfg"]))
    params, ms = torch_import.import_state_dict(
        tckpt.load_state_dict(path), jcfg)
    sups, mask, j_layout = jcity.build_city_supports(
        trained_city["src"], trained_city["dst"], trained_city["w"], 40,
        pos=trained_city["pos"], ordering="rcm", form="flat",
        block_size=16, addaptadj=True, adaptive_hops=2)
    assert j_layout == layout
    jfc = jserving.Forecaster(
        jcfg, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, ms), list(sups) + [mask],
        JScaler(meta["scaler"].mean, meta["scaler"].std), node_layout=layout)
    x = np.random.default_rng(1).normal(size=(3, 12, 40, 2)).astype(
        np.float32)
    want = np.asarray(jfc.predict(jnp.asarray(x)))
    got = tfc.predict(x).numpy()
    assert got.shape == (3, 12, 40)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_train_cli_refuses_what_waits():
    from graph_wavenet_tpu_torch.cli import train

    with pytest.raises(SystemExit, match="--grad_accum, --resume"):
        train.main(["--graph_npz", "g.npz", "--gcn_bool", "--grad_accum",
                    "2", "--resume", "x.pt"])
    with pytest.raises(SystemExit, match="dense slice"):
        train.main(["--data", "syn", "--device", CPU])
