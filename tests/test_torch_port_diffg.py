"""The port's per-sample-graph (diff-G) model held to the JAX package on
the CPU: the forward (shared, injected, adaptive-only and temporal-only
embeddings) within 2e-4 of ``apply_gwnet_diff_g`` in fp32; the syn train
step's loss and gradients and a 10-step trajectory (dropout 0) to the bar
of ``tests/test_training_parity.py``; gradient accumulation, the eval
step's pooled predictions, the fused resident steps against single steps
bit for bit (with dropout and with ``fresh_nodevec``); and the serving
path: a converted JAX diff-G checkpoint served from a graph bank within
2e-4 of the JAX ``DiffGForecaster``, bank files across the two packages,
the server's ``adj_idx`` errors against the JAX server's, and the
``(x, adj_idx)`` artifact."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.config import ModelConfig as JConfig
from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
from graph_wavenet_tpu.models import gwnet_diff_g as jdiffg
from graph_wavenet_tpu.train import engine as jeng
from graph_wavenet_tpu.train import serving as jserving
from graph_wavenet_tpu_torch import convert
from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models import gwnet_diff_g as tdiffg
from graph_wavenet_tpu_torch.models.gwnet import GWNet
from graph_wavenet_tpu_torch.train import checkpoint as tckpt
from graph_wavenet_tpu_torch.train import engine as teng
from graph_wavenet_tpu_torch.train import serving as tserving

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K, F_T = 10, 24, 2
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = dict(rtol=5e-4, atol=5e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
# dilations 4, 8, 4, 8: a receptive field of 25 = K + 1
WIDTHS = dict(num_nodes=N, out_dim=K, residual_channels=8,
              dilation_channels=8, skip_channels=16, end_channels=32,
              blocks=2, layers=2, start_dilation=4, dropout=0.0,
              n_supports=2)
CHECK_KEYS = ("nodevec1", "nodevec2", "gconv.1.mlp.mlp.weight",
              "end_conv_2.weight", "bn.1.running_mean", "bn.1.running_var")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_engine(seed=1, **kw):
    cfg = dict(WIDTHS, **kw)
    eng = jeng.Engine(JConfig(**cfg), JTrainConfig(), JScaler(3.0, 2.0),
                      diff_g=True, seed=seed)
    return eng, cfg


def port_engine(jeng_, cfg, **tkw):
    """A port diff-G engine holding the JAX engine's weights."""
    eng = teng.Engine(ModelConfig(**cfg), TrainConfig(**tkw),
                      StandardScaler(3.0, 2.0), device=CPU, diff_g=True)
    eng.model.load_state_dict(convert.params_from_jax(
        np_tree(jeng_.state.params), np_tree(jeng_.state.model_state),
        eng.model_cfg))
    return eng


def batch(rng, b=4, n_comm=3, shared=False):
    """x, y, two per-sample (B, N, N) row-normalized supports and the
    per-sample (or shared) cluster-mean projector."""
    x = rng.normal(size=(b, K, N, 2)).astype(np.float32)
    y = (rng.normal(size=(b, K, N, 2)) * 2 + 3).astype(np.float32)
    y[:, :, :2, 0] = 0.0                    # masked entries
    shape = (N, N) if shared else (b, N, N)
    sups = []
    for _ in range(2):
        a = rng.random(shape).astype(np.float32) + np.eye(N, dtype=np.float32)
        sups.append(a / a.sum(-1, keepdims=True))
    if shared:
        proj = teng.cluster_mean_projector(rng.integers(0, n_comm, N),
                                           n_comm)
    else:
        proj = np.stack([teng.cluster_mean_projector(la, n_comm)
                         for la in rng.integers(0, n_comm, (b, N))])
    return x, y, sups, proj


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["shared", "aptinit", "aptonly",
                                     "temporal"])
def test_diffg_forward_matches_jax(rng, variant):
    """Eval-mode forward within 2e-4 of ``apply_gwnet_diff_g``."""
    kw = {"aptonly": dict(n_supports=0)}.get(variant, {})
    cfg = JConfig(**dict(WIDTHS, **kw))
    params, ms = jdiffg.init_gwnet_diff_g(jax.random.key(2), cfg)
    ms = {"bn": [{"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
                  "var": jnp.asarray(rng.random(8) + 0.5, jnp.float32)}
                 for _ in ms["bn"]]}
    model = tdiffg.GWNetDiffG(ModelConfig(**dict(WIDTHS, **kw)), device=CPU)
    model.load_state_dict(convert.params_from_jax(
        np_tree(params), np_tree(ms), model.cfg))
    x, _, sups, _ = batch(rng, b=3)
    nv = None
    if variant in ("shared", "aptinit"):
        jsup, tsup = [jnp.asarray(s) for s in sups], [torch.as_tensor(s)
                                                      for s in sups]
    elif variant == "aptonly":
        jsup, tsup = [], []
    else:
        jsup = tsup = None
    if variant == "aptinit":
        nv = tdiffg.svd_nodevecs_batched(sups[0], 10)
    want, _ = jdiffg.apply_gwnet_diff_g(cfg, params, ms, jnp.asarray(x),
                                        jsup, aptinit_nodevecs=nv)
    got = model(torch.as_tensor(x), tsup, aptinit_nodevecs=nv)
    assert got.shape == (3, 1, N, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)


def test_svd_nodevecs_batched_matches_jax(rng):
    a = rng.random((3, N, N)).astype(np.float32)
    for g, w in zip(tdiffg.svd_nodevecs_batched(a, 4),
                    jdiffg.svd_nodevecs_batched(a, 4)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_fresh_nodevec_draws_from_the_generator(rng):
    """``fresh_nodevec`` draws (B, N, r) then (B, r, N) standard normals
    from the generator passed in: the forward equals one given those
    draws as ``aptinit_nodevecs``, which is how it is held to JAX. The
    model has no embedding parameters, the converted JAX tree none either,
    and the shared-graph model refuses the flag."""
    cfg = ModelConfig(**dict(WIDTHS, fresh_nodevec=True))
    jcfg = JConfig(**dict(WIDTHS, fresh_nodevec=True))
    params, ms = jdiffg.init_gwnet_diff_g(jax.random.key(0), jcfg)
    assert "nodevec1" not in params
    model = tdiffg.GWNetDiffG(cfg, device=CPU)
    model.load_state_dict(convert.params_from_jax(np_tree(params),
                                                  np_tree(ms), cfg))
    assert not any(k.startswith("nodevec") for k in model.state_dict())
    x, _, sups, _ = batch(rng, b=3)
    tsup = [torch.as_tensor(s) for s in sups]
    got = model(torch.as_tensor(x), tsup,
                generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    nv = (torch.randn((3, N, 10), generator=g),
          torch.randn((3, 10, N), generator=g))
    assert torch.equal(got, model(torch.as_tensor(x), tsup,
                                  aptinit_nodevecs=nv))
    want, _ = jdiffg.apply_gwnet_diff_g(
        jcfg, params, ms, jnp.asarray(x), [jnp.asarray(s) for s in sups],
        aptinit_nodevecs=tuple(np.asarray(v) for v in nv))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    with pytest.raises(ValueError, match="generator"):
        model(torch.as_tensor(x), tsup)
    with pytest.raises(ValueError, match="fresh_nodevec"):
        GWNet(cfg, device=CPU)(torch.as_tensor(x), tsup)


# ---------------------------------------------------------------------------
# the syn steps against the JAX engine
# ---------------------------------------------------------------------------

def test_train_step_syn_loss_and_gradients_match_jax(rng):
    jeng_, cfg = jax_engine()
    teng_ = port_engine(jeng_, cfg)
    x, y, sups, proj = batch(rng)
    st = jeng_.state
    grads, (e_hat, real, _) = jax.grad(jeng_._loss_syn, has_aux=True)(
        st.params, st.model_state, jnp.asarray(x), jnp.asarray(y),
        [jnp.asarray(s) for s in sups], jnp.asarray(proj), F_T,
        jax.random.key(0))
    loss_j, _ = jeng_._loss_syn(st.params, st.model_state, jnp.asarray(x),
                                jnp.asarray(y),
                                [jnp.asarray(s) for s in sups],
                                jnp.asarray(proj), F_T, jax.random.key(0))
    teng_.model.train()
    loss_t, m = teng_._syn_loss(torch.as_tensor(x), torch.as_tensor(y),
                                [torch.as_tensor(s) for s in sups],
                                torch.as_tensor(proj), F_T)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **LOSS_TOL)
    want = convert.params_from_jax(np_tree(grads),
                                   np_tree(st.model_state), teng_.model_cfg)
    for k, p in teng_.model.named_parameters():
        # the residual 1x1s of a graph-conv layer reach no loss term: JAX
        # differentiates them to zeros, PyTorch leaves no gradient
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=2e-5, err_msg=k)


def test_syn_trajectory_matches_jax(rng):
    """Ten diff-G syn steps (per-sample supports and projectors) from the
    same weights on the same batches: losses to 5e-4, parameters and
    BatchNorm statistics to rtol 1e-3 / atol 1e-4."""
    jeng_, cfg = jax_engine()
    teng_ = port_engine(jeng_, cfg)
    state = jeng_.state
    init = teng_.model.state_dict()["nodevec1"].clone()
    lj, lt = [], []
    for _ in range(10):
        x, y, sups, proj = batch(rng)
        state, m = jeng_.train_step_syn(state, jnp.asarray(x), jnp.asarray(y),
                                        [jnp.asarray(s) for s in sups],
                                        jnp.asarray(proj), F_T)
        lj.append(float(m["loss"]))
        lt.append(float(teng_.train_step_syn(
            x, y, [torch.as_tensor(s) for s in sups], proj, F_T)["loss"]))
    np.testing.assert_allclose(lt, lj, **LOSS_TOL)
    sd = teng_.model.state_dict()
    assert not torch.equal(sd["nodevec1"], init)
    want = convert.params_from_jax(np_tree(state.params),
                                   np_tree(state.model_state),
                                   teng_.model_cfg)
    for k in CHECK_KEYS:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_train_step_syn_accum_matches_jax_and_full_batch(rng, shared):
    """Four micro-batches (per-sample supports and projectors sliced with
    them, shared ones whole) match the JAX accumulated step, and the full
    batch to the JAX package's own tolerance (``tests/test_engine.py``)."""
    jeng_, cfg = jax_engine(seed=4)
    acc = port_engine(jeng_, cfg)
    full = port_engine(jeng_, cfg)
    x, y, sups, proj = batch(rng, b=8, shared=shared)
    jsup = [jnp.asarray(s) for s in sups]
    sj, mj = jeng_.train_step_syn_accum(jeng_.state, jnp.asarray(x),
                                        jnp.asarray(y), jsup,
                                        jnp.asarray(proj), F_T, 4)
    tsup = [torch.as_tensor(s) for s in sups]
    ma = acc.train_step_syn_accum(x, y, tsup, proj, F_T, 4)
    mf = full.train_step_syn(x, y, tsup, proj, F_T)
    np.testing.assert_allclose(float(ma["loss"]), float(mj["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(ma["loss"]), float(mf["loss"]),
                               rtol=5e-3)
    want = convert.params_from_jax(np_tree(sj.params),
                                   np_tree(sj.model_state), acc.model_cfg)
    sa, sf = acc.model.state_dict(), full.model.state_dict()
    for k in CHECK_KEYS:
        np.testing.assert_allclose(sa[k].numpy(), want[k].numpy(),
                                   **PARAM_TOL, err_msg=k)
    for k, p in acc.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), sf[k].numpy(),
                                   atol=2.5e-3, err_msg=k)
    with pytest.raises(ValueError, match="n_micro"):
        acc.train_step_syn_accum(x, y, tsup, proj, F_T, 3)


def test_eval_step_syn_matches_jax(rng):
    jeng_, cfg = jax_engine()
    teng_ = port_engine(jeng_, cfg)
    x, y, sups, proj = batch(rng)
    want = jeng_.eval_step_syn(jeng_.state, jnp.asarray(x), jnp.asarray(y),
                               [jnp.asarray(s) for s in sups],
                               jnp.asarray(proj), F_T)
    got = teng_.eval_step_syn(x, y, [torch.as_tensor(s) for s in sups],
                              proj, F_T)
    for k in ("pred_F", "pred_E"):
        assert got[k].shape == (4, 1, N, K)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **MODEL_TOL, err_msg=k)
    for k in ("loss", "mape", "rmse"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_syn_collapse_check():
    """A stack that does not collapse time to one step is refused with the
    fix, before any update."""
    eng = teng.Engine(ModelConfig(**dict(WIDTHS, start_dilation=1)),
                      TrainConfig(), None, device=CPU, diff_g=True)
    x = np.zeros((2, K, N, 2), np.float32)
    with pytest.raises(ValueError, match="collapse time to one step"):
        eng.train_step_syn(x, x, None, np.eye(N, dtype=np.float32), F_T)
    assert eng.step == 0


@pytest.mark.parametrize("mode", ["dropout", "fresh_nodevec"])
def test_fused_syn_steps_equal_single_steps(rng, mode):
    """``train_steps_syn_resident`` (the eager loop on the CPU) equals the
    same steps as ``train_step_syn`` calls on the gathered batches, bit for
    bit: metrics, weights, Adam and the generator, with dropout 0.3 and
    with the embeddings drawn every step."""
    cfg = ModelConfig(**dict(WIDTHS, dropout=0.3,
                             fresh_nodevec=mode == "fresh_nodevec"))
    n, n_graphs, s, b = 20, 5, 3, 4
    xs = torch.as_tensor(rng.normal(size=(n, K, N, 2)).astype(np.float32))
    ys = torch.as_tensor((rng.normal(size=(n, K, N, 2)) + 3).astype(
        np.float32))
    adj = torch.as_tensor(rng.integers(0, n_graphs, n).astype(np.int32))
    _, _, sups, proj = batch(rng, b=n_graphs)
    sup_stack = [torch.as_tensor(a) for a in sups]
    proj_stack = torch.as_tensor(proj)
    idx = rng.integers(0, n, (s, b)).astype(np.int32)
    engines = [teng.Engine(cfg, TrainConfig(), StandardScaler(3.0, 2.0),
                           device=CPU, diff_g=True) for _ in range(2)]
    fused = engines[0].train_steps_syn_resident(xs, ys, idx, adj, sup_stack,
                                                proj_stack, F_T)
    eager = []
    for sel in torch.as_tensor(idx).long():
        gids = adj[sel].long()
        eager.append(engines[1].train_step_syn(
            xs[sel], ys[sel], [a[gids] for a in sup_stack],
            proj_stack[gids], F_T))
    for k in ("loss", "mape", "rmse"):
        assert torch.equal(fused[k], torch.stack([m[k] for m in eager])), k
    sa, sb = (e.model.state_dict() for e in engines)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert engines[0].step == engines[1].step == s
    assert torch.equal(engines[0].generator.get_state(),
                       engines[1].generator.get_state())
    oa, ob = (e.optimizer.state_dict()["state"] for e in engines)
    for p in oa:
        for k in oa[p]:
            assert torch.equal(oa[p][k], ob[p][k])


# ---------------------------------------------------------------------------
# serving from a graph bank, and the artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def diffg_ckpt(tmp_path_factory):
    """A JAX diff-G checkpoint of random weights and BatchNorm statistics,
    the same weights as a port checkpoint, and a graph bank with labels
    and F_t (written by the JAX package)."""
    from flax import serialization

    from graph_wavenet_tpu.train import checkpoint as jckpt

    tmp = tmp_path_factory.mktemp("diffg")
    rng = np.random.default_rng(11)
    jeng_, cfg = jax_engine(seed=3)
    ms = {"bn": [{"mean": jnp.asarray(rng.normal(size=8), jnp.float32),
                  "var": jnp.asarray(rng.random(8) + 0.5, jnp.float32)}
                 for _ in jeng_.state.model_state["bn"]]}
    jeng_.state = dataclasses.replace(jeng_.state, model_state=ms)
    scaler = JScaler(1.5, 0.5)
    jpath = str(tmp / "diffg.msgpack")
    jckpt.save_checkpoint(jpath, jeng_.state, model_cfg=JConfig(**cfg),
                          train_cfg=JTrainConfig(), scaler=scaler,
                          extra={"diff_g": True})
    with open(jpath, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    meta = tckpt.load_metadata(jpath)
    tpath = str(tmp / "diffg.pt")
    tckpt.save_checkpoint(tpath, convert.params_from_jax(
        tree["params"], tree["model_state"], meta["model_cfg"]),
        model_cfg=meta["model_cfg"], train_cfg=meta["train_cfg"],
        scaler=meta["scaler"], extra=meta["extra"])
    W = (rng.random((4, N, N)) < 0.4).astype(np.float32)
    W = np.maximum(W, W.transpose(0, 2, 1)) + np.eye(N, dtype=np.float32)
    labels = rng.integers(0, 3, size=(4, N)).astype(np.int32)
    bank = str(tmp / "bank.npz")
    jserving.save_graph_bank(bank, W, labels=labels, F_t=F_T)
    return {"jpath": jpath, "tpath": tpath, "bank": bank, "tmp": tmp,
            "scaler": scaler}


def _forecasters(ck):
    jfc = jserving.DiffGForecaster.from_checkpoint(ck["jpath"]).bind_bank(
        jserving.load_graph_bank(ck["bank"]))
    tfc = tserving.DiffGForecaster.from_checkpoint(
        ck["tpath"], device=CPU).bind_bank(
            tserving.load_graph_bank(ck["bank"]))
    return jfc, tfc


def test_bank_serving_matches_jax(diffg_ckpt):
    jfc, tfc = _forecasters(diffg_ckpt)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, K, N, 2)).astype(np.float32)
    idx = np.array([0, 3, 1, 1, 2], np.int32)
    want = np.asarray(jfc.predict_indexed(jnp.asarray(x), idx))
    got = tfc.predict_indexed(x, idx)
    assert got.shape == (5, K, N)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    for g, w in zip(tfc.predict_modalities_indexed(x, idx),
                    jfc.predict_modalities_indexed(jnp.asarray(x), idx)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)
    # predict_indexed is predict on the gathered supports
    sup = [s[torch.as_tensor(idx).long()] for s in tfc.sup_stack]
    assert torch.equal(tfc.predict(x, sup), got)
    with pytest.raises(ValueError, match="out of range"):
        tfc.predict_indexed(x, idx + 4)


def test_forecaster_modalities_equal_the_engine_eval(diffg_ckpt):
    """``predict_modalities`` is ``eval_step_syn``'s pred_F/pred_E on the
    same batch, bit for bit, with the trained embeddings and with
    ``fresh_nodevec`` (both draw from a generator seeded 0)."""
    rng = np.random.default_rng(2)
    x, y, sups, proj = batch(rng, b=3)
    tsup = [torch.as_tensor(s) for s in sups]
    for fresh in (False, True):
        fc = tserving.DiffGForecaster.from_checkpoint(diffg_ckpt["tpath"],
                                                      device=CPU)
        cfg = dataclasses.replace(fc.cfg, fresh_nodevec=fresh)
        eng = teng.Engine(cfg, TrainConfig(), fc.scaler, device=CPU,
                          diff_g=True)
        sd = {k: v for k, v in fc.model.state_dict().items()
              if not (fresh and k.startswith("nodevec"))}
        eng.model.load_state_dict(sd)
        fc = tserving.DiffGForecaster(cfg, eng.model, fc.scaler)
        ev = eng.eval_step_syn(x, y, tsup, proj, F_T)
        f, e = fc.predict_modalities(x, tsup, proj, F_T)
        assert torch.equal(f, ev["pred_F"][:, -1].permute(0, 2, 1))
        assert torch.equal(e, ev["pred_E"][:, -1].permute(0, 2, 1))
        assert torch.equal(fc.predict(x, tsup), fc.predict(x, tsup))


def test_graph_banks_load_in_either_package(tmp_path, rng):
    W = rng.random((2, 6, 6)).astype(np.float32)
    labels = rng.integers(0, 2, (2, 6))
    for save, load in ((tserving.save_graph_bank, jserving.load_graph_bank),
                       (jserving.save_graph_bank, tserving.load_graph_bank)):
        for kw in ({}, {"labels": labels, "F_t": 3}):
            path = str(tmp_path / "b.npz")
            save(path, W, **kw)
            bank = load(path)
            np.testing.assert_array_equal(bank["W"], W)
            assert bank["F_t"] == kw.get("F_t")
            if "labels" in kw:
                np.testing.assert_array_equal(bank["labels"], labels)
            else:
                assert bank["labels"] is None
    with pytest.raises(ValueError, match="labels must be"):
        tserving.save_graph_bank(str(tmp_path / "c.npz"), W,
                                 labels=labels[:, :3])


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stop(run):
    run["server"].shutdown()
    run["batcher"].stop()
    run["server"].server_close()


def test_bank_server_answers_and_errors_match_jax(diffg_ckpt):
    """``gwt-torch-serve --graph_bank``: concurrent requests naming
    different graphs share one device call and equal ``predict_indexed``;
    ``/predict_modalities`` equals ``predict_modalities_indexed``;
    ``/healthz`` reports the bank; and a missing, misshapen or
    out-of-range ``adj_idx`` gets the JAX server's status and message."""
    from graph_wavenet_tpu.cli import serve as jserve
    from graph_wavenet_tpu_torch.cli import serve as tserve

    ck = diffg_ckpt
    with pytest.raises(SystemExit, match="graph_bank"):
        tserve.main(["--checkpoint", ck["tpath"], "--device", CPU],
                    serve_forever=False)
    trun = tserve.main(["--checkpoint", ck["tpath"], "--graph_bank",
                        ck["bank"], "--device", CPU, "--port", "0",
                        "--window_ms", "200"], serve_forever=False)
    jrun = jserve.main(["--checkpoint", ck["jpath"], "--graph_bank",
                        ck["bank"], "--port", "0"], serve_forever=False)
    try:
        tport, jport = (r["server"].server_port for r in (trun, jrun))
        fc = trun["forecaster"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{tport}/healthz") as r:
            health = json.loads(r.read())
        assert (health["diff_g"], health["n_graphs"],
                health["modalities"]) == (True, 4, True)
        rng = np.random.default_rng(3)
        raw = (rng.normal(size=(4, K, N, 2)) * 0.5 + 1.5).astype(np.float32)
        std = raw.copy()
        std[..., 0] = ck["scaler"].transform(std[..., 0])
        answers = [None] * 4

        def ask(i):
            answers[i] = _post(tport, "/predict",
                               {"x": raw[i].tolist(), "adj_idx": 3 - i})

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        want = fc.predict_indexed(std, [3, 2, 1, 0]).numpy()
        for i, (code, body) in enumerate(answers):
            assert code == 200
            np.testing.assert_array_equal(np.asarray(body["y"], np.float32),
                                          want[i])
        assert trun["batcher"].stats["batch_histogram"] == {4: 1}
        code, body = _post(tport, "/predict_modalities",
                           {"x": raw[:2].tolist(), "adj_idx": [1, 2]})
        f, e = fc.predict_modalities_indexed(std[:2], [1, 2])
        np.testing.assert_array_equal(np.asarray(body["pred_F"], np.float32),
                                      f.numpy())
        np.testing.assert_array_equal(np.asarray(body["pred_E"], np.float32),
                                      e.numpy())
        for bad in ({"x": raw[0].tolist()},
                    {"x": raw[:2].tolist(), "adj_idx": [0, 1, 2]},
                    {"x": raw[0].tolist(), "adj_idx": 4},
                    {"x": raw[0].tolist(), "adj_idx": -1}):
            for path in ("/predict", "/predict_modalities"):
                assert _post(tport, path, bad) == _post(jport, path, bad)
    finally:
        _stop(trun)
        _stop(jrun)


def test_diffg_artifact_round_trip_and_serving(diffg_ckpt):
    """``gwt-torch-export --graph_bank`` writes an ``(x, adj_idx)``
    artifact equal to ``predict_indexed``; it loads in a fresh interpreter
    (torch and the op library only) and serves ``adj_idx`` requests padded
    to its batch."""
    from graph_wavenet_tpu_torch.cli import export as texport
    from graph_wavenet_tpu_torch.cli import serve as tserve

    ck = diffg_ckpt
    out = str(ck["tmp"] / "diffg.pt2")
    texport.main(["--checkpoint", ck["tpath"], "--graph_bank", ck["bank"],
                  "--out", out, "--batch_size", "4", "--device", CPU])
    _, fc = _forecasters(ck)
    art = tserving.load_exported_forecaster(out)
    assert (art.n_inputs, art.n_graphs, art.in_shape) == (2, 4, (4, K, N, 2))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, K, N, 2)).astype(np.float32)
    idx = np.array([2, 0, 3, 3])
    want = fc.predict_indexed(x, idx)
    assert torch.equal(art.predict(x, idx), want)
    with pytest.raises(ValueError, match="adj_idx"):
        art.predict(x)
    with pytest.raises(ValueError, match="bank of 4"):
        art.predict(x, idx + 1)
    np.save(ck["tmp"] / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "from graph_wavenet_tpu_torch.ops.cuda import block_diffusion\n"
        "ep = torch.export.load(sys.argv[1])\n"
        "x = torch.as_tensor(np.load(sys.argv[2]))\n"
        "idx = torch.tensor([2, 0, 3, 3])\n"
        "with torch.no_grad():\n"
        "    np.save(sys.argv[3], ep.module()(x, idx).numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'graph_wavenet_tpu')]\n"
        "bad += [m for m in sys.modules if m.startswith("
        "'graph_wavenet_tpu_torch.models')]\n"
        "assert not bad, bad\n")
    res = subprocess.run(
        [sys.executable, "-c", code, out, str(ck["tmp"] / "x.npy"),
         str(ck["tmp"] / "y.npy")], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(ck["tmp"] / "y.npy"), want.numpy())
    run = tserve.main(["--artifact", out, "--scaler_mean", "1.5",
                       "--scaler_std", "0.5", "--port", "0"],
                      serve_forever=False)
    try:
        port = run["server"].server_port
        raw = x.copy()
        raw[..., 0] = raw[..., 0] * 0.5 + 1.5
        code, body = _post(port, "/predict", {"x": raw[0].tolist(),
                                              "adj_idx": 2})
        assert code == 200
        np.testing.assert_allclose(np.asarray(body["y"]), want[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert _post(port, "/predict", {"x": raw[0].tolist()})[0] == 400
    finally:
        _stop(run)
