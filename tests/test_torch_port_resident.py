"""The port's device-resident training held to the JAX package on the CPU:
the device loaders' batches, superbatches and remainders against the JAX
loaders for one seed; the fused train steps (``train_steps_resident``,
``train_steps_windows``) against S eager ``train_step`` calls bit for bit
and against the JAX fused steps on the same indices; ``train_step_accum``
and the fused eval passes against JAX; a resumed run against the
uninterrupted one and against JAX; the configuration's validation; and
``dropout_scale`` against the formula it replaced.

On the CPU a fused call is the eager loop of the step (the CUDA graph is
held to eager steps on the card, ``tests/test_torch_port_cuda.py``).
Trajectories against JAX run with dropout 0 (the two frameworks draw other
random bits): losses to rtol/atol 5e-4, parameters and BatchNorm
statistics to rtol 1e-3 / atol 1e-4 (the bar of
``test_engine_trajectory_matches_jax``), eval metrics to 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.config import ModelConfig as JConfig
from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
from graph_wavenet_tpu.data import device_loader as jdl
from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
from graph_wavenet_tpu.models.gwnet import init_gwnet
from graph_wavenet_tpu_torch import convert
from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data import device_loader as tdl
from graph_wavenet_tpu_torch.data import metr as tmetr
from graph_wavenet_tpu_torch.data.loader import DataLoader, WindowDataLoader
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.ops.diffusion import dropout_scale
from graph_wavenet_tpu_torch.train import checkpoint as tckpt
from graph_wavenet_tpu_torch.train.engine import Engine

CPU = "cpu"
N = 12
LOSS_TOL = dict(rtol=5e-4, atol=5e-4)
PARAM_TOL = dict(rtol=1e-3, atol=1e-4)
EVAL_TOL = dict(rtol=1e-5, atol=1e-5)
CHECK_KEYS = ("nodevec1", "nodevec2", "gconv.1.mlp.mlp.weight",
              "end_conv_2.weight", "bn.1.running_mean", "bn.1.running_var")


def np_batches(it):
    return [tuple(np.asarray(a) for a in b) for b in it]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for bg, bw in zip(got, want):
        for a, b in zip(bg, bw):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the device loaders
# ---------------------------------------------------------------------------

def loader_pair(kind, rng, seed):
    """The port's device loader (on the CPU), the JAX one and the port's
    host batcher over the same data, each with its own Generator of one
    seed."""
    if kind == "arrays":
        xs = rng.normal(size=(37, 12, 5, 2)).astype(np.float32)
        ys = rng.normal(size=(37, 12, 5, 2)).astype(np.float32)
        return (tdl.DeviceArrayLoader(xs, ys, 8, device=CPU,
                                      rng=np.random.default_rng(seed)),
                jdl.DeviceArrayLoader(xs, ys, 8,
                                      rng=np.random.default_rng(seed)),
                DataLoader(xs, ys, 8, np.random.default_rng(seed)))
    series = rng.normal(size=(120, 6, 2)).astype(np.float32)
    y_series = rng.normal(size=(120, 6, 2)).astype(np.float32)
    anchors = np.arange(11, 99)[rng.permutation(88)[:45]]
    kw = dict(y_series=y_series, anchors=anchors)
    return (tdl.DeviceWindowLoader(series, 12, 12, 8, device=CPU,
                                   rng=np.random.default_rng(seed), **kw),
            jdl.DeviceWindowLoader(series, 12, 12, 8,
                                   rng=np.random.default_rng(seed), **kw),
            WindowDataLoader(series, 12, 12, 8,
                             rng=np.random.default_rng(seed), **kw))


@pytest.mark.parametrize("kind", ["arrays", "windows"])
def test_device_loaders_match_jax(rng, kind):
    """Batches (two shuffled epochs), superbatches and remainders bit for
    bit the JAX loader's, and the batches the port's host batcher's."""
    got, want, host = loader_pair(kind, rng, seed=5)
    assert (got.num_real, got.num_batch, got.size, len(got)) == (
        want.num_real, want.num_batch, want.size, len(want))
    for _ in range(2):
        for ld in (got, want, host):
            ld.shuffle()
        assert_batches_equal(np_batches(got.get_iterator()),
                             np_batches(want.get_iterator()))
        assert_batches_equal(np_batches(got.get_iterator()),
                             np_batches(host.get_iterator()))
        for s in (2, 4):
            sg, sw = list(got.superbatches(s)), list(want.superbatches(s))
            assert len(sg) == len(sw) == got.num_batch // s
            for a, b in zip(sg, sw):
                assert a.shape == (s, 8) and a.dtype == np.int32
                np.testing.assert_array_equal(a, b)
            assert_batches_equal(np_batches(got.remainder_batches(s)),
                                 np_batches(want.remainder_batches(s)))
    resident = (got.resident_arrays() if kind == "arrays"
                else got.resident_series())
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in resident)


def test_device_window_loader_refuses_bad_anchors(rng):
    series = rng.normal(size=(40, 3, 2)).astype(np.float32)
    for bad in ([10, 28], [11, 29]):     # x before row 0; y past row 39
        with pytest.raises(ValueError, match="anchors out of range"):
            tdl.DeviceWindowLoader(series, 12, 12, 4, anchors=np.array(bad),
                                   device=CPU)
    ok = tdl.DeviceWindowLoader(series, 12, 12, 4,
                                anchors=np.array([11, 27]), device=CPU)
    assert ok.num_batch == 1


def test_streaming_dataset_device_resident_matches_jax(rng):
    """``load_dataset_streaming(resident="device")``: the JAX device
    dataset's batches split by split, its scaler and test targets; the
    three splits share one upload of each series."""
    from graph_wavenet_tpu.data import metr as jmetr

    values = (rng.normal(size=(200, 6)) * 5 + 60).astype(np.float32)
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(200) * np.timedelta64(5, "m"))
    got = tmetr.load_dataset_streaming(values, index, batch_size=8, seed=4,
                                       resident="device", device=CPU)
    want = jmetr.load_dataset_streaming(values, index, batch_size=8, seed=4,
                                        resident="device")
    assert (got["scaler"].mean, got["scaler"].std) == (
        want["scaler"].mean, want["scaler"].std)
    np.testing.assert_array_equal(got["y_test"], want["y_test"])
    for split in ("train", "val", "test"):
        g, w = got[split + "_loader"], want[split + "_loader"]
        g.shuffle()
        w.shuffle()
        assert_batches_equal(np_batches(g.get_iterator()),
                             np_batches(w.get_iterator()))
    sx = {id(got[s + "_loader"].resident_series()[0])
          for s in ("train", "val", "test")}
    assert len(sx) == 1


# ---------------------------------------------------------------------------
# fused steps, accumulation, eval and resume against JAX
# ---------------------------------------------------------------------------

def row_normalized(rng, n):
    a = rng.random((n, n)).astype(np.float32)
    a *= rng.random((n, n)) < 0.4
    a += np.eye(n, dtype=np.float32)
    return a / a.sum(-1, keepdims=True)


def dense_kw(dropout=0.0):
    return dict(num_nodes=N, in_dim=2, out_dim=12, residual_channels=8,
                dilation_channels=8, skip_channels=16, end_channels=16,
                blocks=2, layers=2, dropout=dropout, gcn_bool=True,
                addaptadj=True, n_supports=2)


TC = dict(learning_rate=1e-3, weight_decay=1e-4, grad_clip=5.0)


def jax_engine(rng, kw, mats, seed=3, tc=None, steps_per_epoch=0):
    from graph_wavenet_tpu.train.engine import Engine as JEngine

    jeng = JEngine(JConfig(**kw), JTrainConfig(**(tc or TC)),
                   JScaler(31.0, 9.5), seed=seed,
                   steps_per_epoch=steps_per_epoch)
    params, mstate = init_gwnet(jax.random.key(seed), JConfig(**kw),
                                aptinit=mats[0])
    state = dataclasses.replace(jeng.state, params=params,
                                opt_state=jeng.optimizer.init(params),
                                model_state=mstate)
    return jeng, state


def torch_engine(kw, state, mats=None, tc=None, steps_per_epoch=0):
    eng = Engine(ModelConfig(**kw), TrainConfig(**(tc or TC)),
                 StandardScaler(31.0, 9.5), device=CPU, seed=0,
                 steps_per_epoch=steps_per_epoch,
                 aptinit=None if mats is None else mats[0])
    eng.model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.model_state), eng.model_cfg))
    return eng


def assert_params_match_jax(teng, state, keys=CHECK_KEYS):
    sd = teng.model.state_dict()
    want = convert.params_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.model_state), teng.model_cfg)
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   err_msg=k, **PARAM_TOL)


def samples(rng, n_samples, n=N):
    xs = rng.normal(size=(n_samples, 12, n, 2)).astype(np.float32)
    ys = (rng.normal(size=(n_samples, 12, n, 2)) * 9.5 + 31.0).astype(
        np.float32)
    ys[:, :, :3, 0] = 0.0
    return xs, ys


def assert_same_state(a: Engine, b: Engine):
    for (k, v), (k2, w) in zip(a.model.state_dict().items(),
                               b.model.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k
    sa, sb = (e.optimizer.state_dict()["state"] for e in (a, b))
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step


def test_fused_resident_steps_equal_eager_and_match_jax(rng):
    """Two fused calls of 3 steps over resident arrays: with dropout, bit
    for bit the six eager steps on the gathered batches (metrics, weights,
    BN buffers, Adam, generator); without, the JAX fused steps on the same
    indices to the trajectory bar."""
    mats = [row_normalized(rng, N) for _ in range(2)]
    xs, ys = samples(rng, 10)
    idx = rng.integers(0, 10, size=(2, 3, 4)).astype(np.int32)
    t_sup = [torch.as_tensor(m) for m in mats]
    txs, tys = torch.as_tensor(xs), torch.as_tensor(ys)

    kw = dense_kw(dropout=0.3)
    _, state = jax_engine(rng, kw, mats)
    fused, eager = torch_engine(kw, state, mats), torch_engine(kw, state,
                                                               mats)
    for call in range(2):
        got = fused.train_steps_resident(txs, tys, idx[call], t_sup)
        want = [eager.train_step(xs[r], ys[r], t_sup) for r in idx[call]]
        for k in ("loss", "mape", "rmse"):
            assert got[k].shape == (3,)
            assert torch.equal(got[k], torch.stack([m[k] for m in want]))
    assert_same_state(fused, eager)

    kw = dense_kw()
    jeng, state = jax_engine(rng, kw, mats)
    teng = torch_engine(kw, state, mats)
    j_sup = [jnp.asarray(m) for m in mats]
    for call in range(2):
        state, jm = jeng.train_steps_resident(
            state, jnp.asarray(xs), jnp.asarray(ys),
            jnp.asarray(idx[call]), j_sup)
        tm = teng.train_steps_resident(txs, tys, idx[call], t_sup)
        for k in ("loss", "mape", "rmse"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       err_msg=k, **LOSS_TOL)
    assert_params_match_jax(teng, state)


def city_setup(rng):
    """The 256-node city layout of ``test_torch_port_training``: RCM
    ordered flat supports and the union adaptive mask, both frameworks."""
    from graph_wavenet_tpu.graphs import spatial as jspatial
    from graph_wavenet_tpu.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu.ops import adaptive_block as jab
    from graph_wavenet_tpu_torch.graphs import spatial as tspatial
    from graph_wavenet_tpu_torch.ops import adaptive_block as tab

    n, bs = 256, 32
    src, dst, w = jspatial.knn_graph_edges(rng.random((n, 2)), 4)
    perm = rcm_order_edges(src, dst, n)
    j_sups = jspatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form="flat", block_size=bs)
    t_sups = tspatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form="flat", block_size=bs, device=CPU)
    return (n, list(j_sups) + [jab.mask_from_supports(j_sups)],
            list(t_sups) + [tab.mask_from_supports(t_sups)])


def test_fused_window_steps_equal_eager_and_match_jax(rng):
    """The city model (256 nodes, flat supports, the adaptive mask) over a
    resident series: 3 fused window steps bit for bit 3 eager steps on the
    gathered windows, and the JAX ``train_steps_windows`` on the same
    anchors to the trajectory bar."""
    n, j_sup, t_sup = city_setup(rng)
    kw = dict(dense_kw(), num_nodes=n)
    series = rng.normal(size=(60, n, 2)).astype(np.float32)
    y_series = (np.abs(rng.normal(size=(60, n, 2))) * 9.5 + 31.0).astype(
        np.float32)
    anchors = rng.integers(11, 60 - 12, size=(3, 2)).astype(np.int32)
    ts, tys = torch.as_tensor(series), torch.as_tensor(y_series)

    jeng, state = jax_engine(rng, kw, [None])
    teng, eager = torch_engine(kw, state), torch_engine(kw, state)
    tm = teng.train_steps_windows(ts, anchors, 12, 12, 1, t_sup,
                                  y_series=tys)
    for a in torch.as_tensor(anchors):
        m = eager.train_step(tdl.gather_window_rows(ts, a - 11, 12),
                             tdl.gather_window_rows(tys, a + 1, 12), t_sup)
    assert torch.equal(tm["loss"][-1], m["loss"])
    assert_same_state(teng, eager)

    state, jm = jeng.train_steps_windows(
        state, jnp.asarray(series), jnp.asarray(anchors), 12, 12, 1, j_sup,
        y_series=jnp.asarray(y_series))
    for k in ("loss", "mape", "rmse"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **LOSS_TOL)
    assert_params_match_jax(teng, state, keys=(
        "nodevec1", "nodevec2", "end_conv_2.weight", "bn.1.running_mean",
        "bn.1.running_var"))


def test_train_step_accum_matches_jax(rng):
    """Two accumulated steps of 2 micro-batches: losses and parameters
    against JAX ``train_step_accum`` to the trajectory bar, the running
    statistics updated once per step."""
    mats = [row_normalized(rng, N) for _ in range(2)]
    xs, ys = samples(rng, 8)
    kw = dense_kw()
    jeng, state = jax_engine(rng, kw, mats)
    teng = torch_engine(kw, state, mats)
    j_sup = [jnp.asarray(m) for m in mats]
    t_sup = [torch.as_tensor(m) for m in mats]
    for s in range(2):
        sl = slice(4 * s, 4 * s + 4)
        state, jm = jeng.train_step_accum(state, jnp.asarray(xs[sl]),
                                          jnp.asarray(ys[sl]), j_sup, 2)
        tm = teng.train_step_accum(xs[sl], ys[sl], t_sup, 2)
        for k in ("loss", "mape", "rmse"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       err_msg=k, **LOSS_TOL)
    assert_params_match_jax(teng, state)
    assert int(teng.model.state_dict()["bn.1.num_batches_tracked"]) == 2
    assert teng.step == 2
    with pytest.raises(ValueError, match="n_micro=3"):
        teng.train_step_accum(xs[:4], ys[:4], t_sup, 3)


@pytest.mark.parametrize("feed", ["resident", "windows"])
def test_eval_steps_match_jax(rng, feed):
    """A fused eval pass over 3 chunks against JAX's to 1e-5, and against
    the port's eager eval steps bit for bit."""
    mats = [row_normalized(rng, N) for _ in range(2)]
    kw = dense_kw()
    jeng, state = jax_engine(rng, kw, mats)
    teng = torch_engine(kw, state, mats)
    j_sup = [jnp.asarray(m) for m in mats]
    t_sup = [torch.as_tensor(m) for m in mats]
    if feed == "resident":
        xs, ys = samples(rng, 9)
        idx = rng.integers(0, 9, size=(3, 4)).astype(np.int32)
        jm = jeng.eval_steps_resident(state, jnp.asarray(xs),
                                      jnp.asarray(ys), jnp.asarray(idx),
                                      j_sup)
        tx, ty = torch.as_tensor(xs), torch.as_tensor(ys)
        tm = teng.eval_steps_resident(tx, ty, idx, t_sup)
        eager = [teng.eval_step(xs[r], ys[r], t_sup) for r in idx]
    else:
        series = rng.normal(size=(50, N, 2)).astype(np.float32)
        ysr = (series * 9.5 + 31.0).astype(np.float32)
        idx = rng.integers(11, 50 - 12, size=(3, 4)).astype(np.int32)
        jm = jeng.eval_steps_windows(state, jnp.asarray(series),
                                     jnp.asarray(idx), 12, 12, 1, j_sup,
                                     y_series=jnp.asarray(ysr))
        ts, ty = torch.as_tensor(series), torch.as_tensor(ysr)
        tm = teng.eval_steps_windows(ts, idx, 12, 12, 1, t_sup,
                                     y_series=ty)
        eager = [teng.eval_step(tdl.gather_window_rows(ts, a - 11, 12),
                                tdl.gather_window_rows(ty, a + 1, 12),
                                t_sup) for a in torch.as_tensor(idx)]
    for k in ("loss", "mape", "rmse"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **EVAL_TOL)
        assert torch.equal(tm[k], torch.stack([m[k] for m in eager]))


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["no_dropout",
                                                      "dropout"])
def test_resume_matches_uninterrupted_run_and_jax(rng, tmp_path, dropout):
    """2 steps, a checkpoint, a fresh engine restored from it, 2 more
    steps: bit for bit the uninterrupted 4 steps (the dropout stream too),
    and without dropout JAX's 4-step trajectory to the bar."""
    mats = [row_normalized(rng, N) for _ in range(2)]
    xs, ys = samples(rng, 4 * 4)
    xs, ys = xs.reshape(4, 4, *xs.shape[1:]), ys.reshape(4, 4, *ys.shape[1:])
    t_sup = [torch.as_tensor(m) for m in mats]
    kw = dense_kw(dropout)
    # the learning rate halves every step: the resumed step count drives it
    tc = dict(TC, lr_decay=0.5, lr_decay_every=1)
    jeng, state = jax_engine(rng, kw, mats, tc=tc, steps_per_epoch=1)
    whole = torch_engine(kw, state, mats, tc, steps_per_epoch=1)
    first = torch_engine(kw, state, mats, tc, steps_per_epoch=1)
    for s in range(4):
        whole.train_step(xs[s], ys[s], t_sup)
    for s in range(2):
        first.train_step(xs[s], ys[s], t_sup)
    path = str(tmp_path / "mid.pt")
    tckpt.save_checkpoint(path, first.model.state_dict(),
                          model_cfg=first.model_cfg, train_cfg=first.train_cfg,
                          train_state=first.train_state())
    resumed = Engine(ModelConfig(**kw), TrainConfig(**tc),
                     StandardScaler(31.0, 9.5), device=CPU, seed=7,
                     steps_per_epoch=1)
    tckpt.load_checkpoint(path, resumed)
    assert resumed.step == 2
    for s in range(2, 4):
        resumed.train_step(xs[s], ys[s], t_sup)
    assert_same_state(resumed, whole)
    if dropout == 0.0:
        j_sup = [jnp.asarray(m) for m in mats]
        for s in range(4):
            state, _ = jeng.train_step(state, jnp.asarray(xs[s]),
                                       jnp.asarray(ys[s]), j_sup)
        assert_params_match_jax(resumed, state)
    with pytest.raises(ValueError, match="no train state"):
        bare = str(tmp_path / "bare.pt")
        tckpt.save_checkpoint(bare, first.model.state_dict())
        tckpt.load_checkpoint(bare, resumed)


def test_train_config_validation():
    """The JAX package's refusals (``tests/test_engine.py``)."""
    with pytest.raises(ValueError, match="grad_accum"):
        TrainConfig(grad_accum=0)
    with pytest.raises(ValueError, match="divide by grad_accum 5"):
        TrainConfig(batch_size=32, grad_accum=5)
    with pytest.raises(ValueError, match="scan_steps"):
        TrainConfig(scan_steps=0)
    TrainConfig(batch_size=32, grad_accum=4, scan_steps=8)


# ---------------------------------------------------------------------------
# dropout_scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dropout_scale_equals_the_host_scalar_formula(dtype):
    """The mask divided by a device-filled 1 - p is bit for bit the one
    divided by a host-made tensor of 1 - p (the formula it replaced), at
    rates whose 1 - p rounds in ``dtype``."""
    for p in (0.3, 0.1, 0.5, 0.7, 1 / 3):
        got = dropout_scale(torch.Generator().manual_seed(11), p, (64, 257),
                            dtype, torch.device(CPU))
        keep = torch.rand((64, 257),
                          generator=torch.Generator().manual_seed(11)) < 1 - p
        want = keep.to(dtype) / torch.tensor(1.0 - p, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want), p
