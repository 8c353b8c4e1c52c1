"""The port's dense model held to the JAX package on the CPU: the dense
diffusion ops, the adaptive adjacency, the dense ``GWNet`` in every variant
and ``gcn_mode`` against ``apply_gwnet``, remat against the plain step, and
a five-step dense ``Engine`` trajectory against the JAX ``Engine``.

Supports are row-normalized random matrices, asymmetric on purpose (as in
``bench.py``): a transposed support passes every test on a symmetric one.
fp32 throughout; ops to 1e-5, the model to 2e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.config import ModelConfig as JConfig
from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
from graph_wavenet_tpu.models.gwnet import apply_gwnet, init_gwnet
from graph_wavenet_tpu.ops import adaptive as jadaptive
from graph_wavenet_tpu.ops import diffusion as jdiff
from graph_wavenet_tpu.ops import sparse as jsparse
from graph_wavenet_tpu_torch import convert
from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models.gwnet import GWNet
from graph_wavenet_tpu_torch.ops import adaptive as tadaptive
from graph_wavenet_tpu_torch.ops import diffusion as tdiff
from graph_wavenet_tpu_torch.ops import sparse as tsparse
from graph_wavenet_tpu_torch.train.engine import Engine

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
CPU = "cpu"
N = 24


def row_normalized(rng, n, batch=None):
    shape = (n, n) if batch is None else (batch, n, n)
    a = rng.random(shape).astype(np.float32)
    a *= rng.random(shape) < 0.3
    a += np.eye(n, dtype=np.float32)
    return (a / a.sum(-1, keepdims=True)).astype(np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# dense ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_nconv_matches_jax(rng, batched):
    x = rng.normal(size=(3, 5, N, 4)).astype(np.float32)
    a = row_normalized(rng, N, 3 if batched else None)
    assert not np.allclose(a, np.swapaxes(a, -1, -2))
    j_fn, t_fn = ((jdiff.nconv_batched, tdiff.nconv_batched) if batched
                  else (jdiff.nconv, tdiff.nconv))
    want = j_fn(jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_allclose(t_fn(t(x), t(a)).numpy(), np.asarray(want),
                               **TOL)


def test_diffusion_hops_mixed_ell_and_dense_match_jax(rng):
    x = rng.normal(size=(2, 3, N, 4)).astype(np.float32)
    dense = row_normalized(rng, N)
    ell_src = row_normalized(rng, N)
    supports = {"jax": [jsparse.from_dense(ell_src), jnp.asarray(dense)],
                "torch": [tsparse.from_dense(ell_src, device=CPU), t(dense)]}
    want = jdiff.diffusion_hops(jnp.asarray(x), supports["jax"], 2)
    got = tdiff.diffusion_hops(t(x), supports["torch"], 2)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_support_powers_match_jax(rng, batched):
    a = row_normalized(rng, N, 2 if batched else None)
    want = jdiff.support_powers(jnp.asarray(a), 3)
    got = tdiff.support_powers(t(a), 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["fused", "stacked", "concat"])
@pytest.mark.parametrize("sups", ["dense", "mixed", "none"])
def test_gcn_apply_dense_modes_match_jax(rng, mode, sups):
    """Every mode over two dense supports, a mixed ELL/dense list
    (``stacked`` runs ``fused`` there, as in JAX) and no support at all
    (the hop list is x alone)."""
    c_in, c_out = 4, 6
    x = rng.normal(size=(2, 3, N, c_in)).astype(np.float32)
    mats = [row_normalized(rng, N) for _ in range(2)]
    if sups == "dense":
        j_s, t_s = [jnp.asarray(m) for m in mats], [t(m) for m in mats]
    elif sups == "mixed":
        j_s = [jsparse.from_dense(mats[0]), jnp.asarray(mats[1])]
        t_s = [tsparse.from_dense(mats[0], device=CPU), t(mats[1])]
    else:
        j_s, t_s = [], []
    n_hops = 2 * len(t_s) + 1
    w = rng.normal(size=(n_hops * c_in, c_out)).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    want = jdiff.gcn_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x), j_s, order=2, mode=mode)
    got = tdiff.gcn_apply(t(w.T[:, :, None, None]), t(b), t(x), t_s, 2,
                          mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if mode == "stacked" and sups == "dense":
        stacks = [tdiff.support_powers(s, 2) for s in t_s]
        again = tdiff.gcn_apply(t(w.T[:, :, None, None]), t(b), t(x), t_s, 2,
                                mode=mode, stacks=stacks)
        torch.testing.assert_close(again, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mode must be one of"):
        tdiff.gcn_apply(t(w.T[:, :, None, None]), t(b), t(x), t_s, 2,
                        mode="auto")


def test_adaptive_adjacency_matches_jax(rng):
    nv1 = rng.normal(size=(N, 5)).astype(np.float32)
    nv2 = rng.normal(size=(5, N)).astype(np.float32)
    want = jadaptive.adaptive_adjacency(jnp.asarray(nv1), jnp.asarray(nv2))
    got = tadaptive.adaptive_adjacency(t(nv1), t(nv2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-5)
    b1 = rng.normal(size=(3, N, 5)).astype(np.float32)
    b2 = rng.normal(size=(3, 5, N)).astype(np.float32)
    want = jadaptive.adaptive_adjacency_batched(jnp.asarray(b1),
                                                jnp.asarray(b2))
    got = tadaptive.adaptive_adjacency_batched(t(b1), t(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_svd_nodevecs_match_jax(rng):
    a = row_normalized(rng, N)
    for got, want in zip(tadaptive.svd_nodevecs(a, 6),
                         jadaptive.svd_nodevecs(a, 6)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the dense model
# ---------------------------------------------------------------------------

def model_cfg(**kw):
    base = dict(num_nodes=N, in_dim=2, out_dim=5, residual_channels=6,
                dilation_channels=6, skip_channels=8, end_channels=8,
                blocks=2, layers=2, dropout=0.0, gcn_bool=True,
                addaptadj=False, n_supports=2)
    base.update(kw)
    return base


VARIANTS = {
    "fixed": dict(addaptadj=False),
    "adaptive_svd": dict(addaptadj=True),
    "aptonly": dict(addaptadj=True, n_supports=0),
    "temporal": dict(addaptadj=False),
}


def jax_model(rng, cfg_kw, aptinit=None, seed=0):
    """JAX params and random BN statistics, and the port's model loaded
    with the same weights through ``params_from_jax``."""
    jcfg = JConfig(**cfg_kw)
    params, state = init_gwnet(jax.random.key(seed), jcfg, aptinit=aptinit)
    c = jcfg.residual_channels
    state = {"bn": [{"mean": jnp.asarray(rng.normal(size=c), jnp.float32),
                     "var": jnp.asarray(rng.random(c) + 0.5, jnp.float32)}
                    for _ in state["bn"]]}
    model = GWNet(ModelConfig(**cfg_kw), device=CPU)
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
        model.cfg))
    return jcfg, params, state, model


@pytest.mark.parametrize("mode", ["fused", "stacked", "concat"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dense_gwnet_matches_jax(rng, variant, mode):
    """Eval-mode forecasts of fixed dense supports, fixed supports plus the
    SVD-initialized adaptive adjacency, the adaptive adjacency alone
    (aptonly, ``[]``) and the temporal-only model (None), in each
    ``gcn_mode``, within 2e-4 of ``apply_gwnet``."""
    kw = model_cfg(gcn_mode=mode, **VARIANTS[variant])
    mats = [row_normalized(rng, N) for _ in range(2)]
    aptinit = mats[0] if variant == "adaptive_svd" else None
    jcfg, params, state, model = jax_model(rng, kw, aptinit=aptinit)
    if variant == "adaptive_svd":
        e1, _ = jadaptive.svd_nodevecs(aptinit, jcfg.adapt_rank)
        np.testing.assert_allclose(model.nodevec1.detach().numpy(), e1,
                                   **TOL)
    j_sup = {"fixed": [jnp.asarray(m) for m in mats], "aptonly": [],
             "temporal": None}.get(variant, [jnp.asarray(m) for m in mats])
    t_sup = None if j_sup is None else [t(np.asarray(m)) for m in j_sup]
    x = rng.normal(size=(3, 12, N, 2)).astype(np.float32)
    want, _ = apply_gwnet(jcfg, params, state, jnp.asarray(x), j_sup)
    with torch.no_grad():
        got = model(t(x), t_sup)
    assert got.shape == want.shape == (3, 6, N, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


def test_dense_gwnet_from_svd_init_equals_loaded_weights(rng):
    """``aptinit=`` builds the SVD embeddings itself: the same numbers the
    JAX model's init makes."""
    a = row_normalized(rng, N)
    model = GWNet(ModelConfig(**model_cfg(addaptadj=True)), device=CPU,
                  aptinit=a)
    params, _ = init_gwnet(jax.random.key(0), JConfig(**model_cfg(
        addaptadj=True)), aptinit=a)
    np.testing.assert_array_equal(model.nodevec1.detach().numpy(),
                                  np.asarray(params["nodevec1"]))
    np.testing.assert_array_equal(model.nodevec2.detach().numpy(),
                                  np.asarray(params["nodevec2"]))


def test_remat_equals_plain_step_with_dropout(rng):
    """The same seed with and without ``remat``, dropout 0.3, train mode:
    equal loss, gradients and BatchNorm statistics (each batch counted
    once)."""
    mats = [t(row_normalized(rng, N)) for _ in range(2)]
    x = t(rng.normal(size=(4, 12, N, 2)).astype(np.float32))
    results = {}
    for remat in (False, True):
        cfg = ModelConfig(**model_cfg(addaptadj=True, dropout=0.3,
                                      remat=remat))
        model = GWNet(cfg, device=CPU, seed=3)
        model.train()
        gen = torch.Generator().manual_seed(11)
        loss = model(x, mats, generator=gen).square().mean()
        loss.backward()
        results[remat] = (loss.detach(), {
            k: p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}, {
            k: v.clone() for k, v in model.state_dict().items()
            if k.startswith("bn.")})
    (l0, g0, s0), (l1, g1, s1) = results[False], results[True]
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    assert g0.keys() == g1.keys() and "nodevec1" in g0
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0, msg=k)
    assert int(s1["bn.3.num_batches_tracked"]) == 1


def test_model_refuses_dense_adaptive_at_city_scale():
    """The dense adaptive adjacency (no mask) stops at 16,384 nodes, as
    the reference's does."""
    cfg = ModelConfig(num_nodes=16384, residual_channels=2,
                      dilation_channels=2, skip_channels=2, end_channels=2,
                      blocks=1, layers=1, out_dim=1, adapt_rank=1)
    model = GWNet(cfg, device=CPU)
    with pytest.raises(ValueError, match="num_nodes=16384"):
        model(torch.zeros(1, 2, 16384, 2), [])


# ---------------------------------------------------------------------------
# the slice as a whole: a dense METR training trajectory
# ---------------------------------------------------------------------------

def test_dense_engine_trajectory_matches_jax(rng):
    """Five train steps of the dense METR model (two fixed supports, the
    SVD-initialized adaptive adjacency, fused gcn mode) from the same
    weights on the same batches: losses to 5e-4, parameters and BN
    statistics to rtol 1e-3 / atol 1e-4 (``test_engine_trajectory_matches_
    jax``'s bar)."""
    from graph_wavenet_tpu.train.engine import Engine as JEngine

    n = 32
    mats = [row_normalized(rng, n) for _ in range(2)]
    kw = dict(model_cfg(num_nodes=n, addaptadj=True), out_dim=12)
    tc = dict(learning_rate=1e-3, weight_decay=1e-4, grad_clip=5.0)
    jeng = JEngine(JConfig(**kw), JTrainConfig(**tc), JScaler(31.0, 9.5),
                   seed=3)
    params, mstate = init_gwnet(jax.random.key(3), JConfig(**kw),
                                aptinit=mats[0])
    state = dataclasses.replace(jeng.state, params=params,
                                opt_state=jeng.optimizer.init(params),
                                model_state=mstate)
    teng = Engine(ModelConfig(**kw), TrainConfig(**tc),
                  StandardScaler(31.0, 9.5), device=CPU, seed=0,
                  aptinit=mats[0])
    teng.model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, mstate),
        teng.model_cfg))
    init_nv1 = np.array(params["nodevec1"])
    j_sup, t_sup = [jnp.asarray(m) for m in mats], [t(m) for m in mats]
    steps, batch = 5, 4
    xs = rng.normal(size=(steps, batch, 12, n, 2)).astype(np.float32)
    ys = (rng.normal(size=(steps, batch, 12, n, 2)) * 9.5
          + 31.0).astype(np.float32)
    ys[:, :, :, :3, 0] = 0.0
    losses_j, losses_t = [], []
    for s in range(steps):
        state, m = jeng.train_step(state, jnp.asarray(xs[s]),
                                   jnp.asarray(ys[s]), j_sup)
        losses_j.append(float(m["loss"]))
        losses_t.append(float(teng.train_step(xs[s], ys[s], t_sup)["loss"]))
    np.testing.assert_allclose(losses_t, losses_j, rtol=5e-4, atol=5e-4)
    sd = teng.model.state_dict()
    assert not np.allclose(sd["nodevec1"].numpy(), init_nv1)
    want = convert.params_from_jax(jax.tree.map(np.asarray, state.params),
                                   jax.tree.map(np.asarray,
                                                state.model_state),
                                   teng.model_cfg)
    for k in ("nodevec1", "nodevec2", "gconv.1.mlp.mlp.weight",
              "end_conv_2.weight", "bn.1.running_mean", "bn.1.running_var"):
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
