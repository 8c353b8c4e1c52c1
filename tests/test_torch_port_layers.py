"""The port's layers and support builders, held to the JAX package on the
CPU: the same numpy inputs go through both, fp32, rtol/atol 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.graphs import spatial as jspatial
from graph_wavenet_tpu.ops import block_sparse as jbs
from graph_wavenet_tpu.ops.diffusion import gcn_apply as j_gcn_apply
from graph_wavenet_tpu.ops.linear import linear_apply
from graph_wavenet_tpu.ops.normalization import batch_norm_apply
from graph_wavenet_tpu.ops.temporal import gated_tcn_apply as j_gated
from graph_wavenet_tpu.ops.temporal import left_pad_time as j_left_pad
from graph_wavenet_tpu_torch.graphs import spatial as tspatial
from graph_wavenet_tpu_torch.ops import block_sparse as tbs
from graph_wavenet_tpu_torch.ops.diffusion import gcn_apply as t_gcn_apply
from graph_wavenet_tpu_torch.ops.linear import Linear
from graph_wavenet_tpu_torch.ops.normalization import BatchNorm
from graph_wavenet_tpu_torch.ops.temporal import CausalConv
from graph_wavenet_tpu_torch.ops.temporal import gated_tcn_apply as t_gated
from graph_wavenet_tpu_torch.ops.temporal import left_pad_time as t_left_pad

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def dense_params(rng, c_in, c_out):
    return {"w": rng.normal(size=(c_in, c_out)).astype(np.float32),
            "b": rng.normal(size=(c_out,)).astype(np.float32)}


def load_dense(mod, p):
    with torch.no_grad():
        mod.weight.copy_(torch.as_tensor(p["w"].T[:, :, None, None]))
        mod.bias.copy_(torch.as_tensor(p["b"]))


def test_linear_matches_jax(rng):
    p = dense_params(rng, 6, 5)
    x = rng.normal(size=(2, 3, 7, 6)).astype(np.float32)
    lin = Linear(6, 5, device=CPU)
    load_dense(lin, p)
    want = linear_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x))
    np.testing.assert_allclose(lin(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_gated_tcn_matches_jax(rng, dilation):
    k, c_in, c_out = 2, 4, 6
    pf = {"w": rng.normal(size=(k, c_in, c_out)).astype(np.float32),
          "b": rng.normal(size=(c_out,)).astype(np.float32)}
    pg = {"w": rng.normal(size=(k, c_in, c_out)).astype(np.float32),
          "b": rng.normal(size=(c_out,)).astype(np.float32)}
    x = rng.normal(size=(2, 9, 5, c_in)).astype(np.float32)
    convs = []
    for p in (pf, pg):
        c = CausalConv(c_in, c_out, k, device=CPU)
        with torch.no_grad():
            c.weight.copy_(torch.as_tensor(
                p["w"].transpose(2, 1, 0)[:, :, None, :]))
            c.bias.copy_(torch.as_tensor(p["b"]))
        convs.append(c)
    jx = lambda p: {kk: jnp.asarray(v) for kk, v in p.items()}
    want = j_gated(jx(pf), jx(pg), jnp.asarray(x), dilation)
    got = t_gated(convs[0], convs[1], torch.as_tensor(x), dilation)
    assert got.shape == (2, 9 - dilation, 5, c_out)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_left_pad_time_matches_jax(rng):
    x = rng.normal(size=(2, 3, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        t_left_pad(torch.as_tensor(x), 7).numpy(),
        np.asarray(j_left_pad(jnp.asarray(x), 7)))


def test_eval_batch_norm_matches_jax(rng):
    c = 5
    params = {"scale": rng.normal(size=c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.random(c).astype(np.float32) + 0.5}
    x = rng.normal(size=(2, 3, 4, c)).astype(np.float32)
    bn = BatchNorm(c, device=CPU).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(params["scale"]))
        bn.bias.copy_(torch.as_tensor(params["bias"]))
        bn.running_mean.copy_(torch.as_tensor(state["mean"]))
        bn.running_var.copy_(torch.as_tensor(state["var"]))
    want, _ = batch_norm_apply(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x),
        train=False)
    np.testing.assert_allclose(bn(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(want), **TOL)
    # eval mode reads the running statistics and never updates them
    np.testing.assert_array_equal(bn.running_mean.numpy(), state["mean"])
    assert int(bn.num_batches_tracked) == 0


def knn_graph(rng, n, k=4):
    return jspatial.knn_graph_edges(rng.random((n, 2)), k)


def assert_same_support(t_sp, j_sp):
    assert type(t_sp).__name__ == type(j_sp).__name__
    for name in ("row_tbl", "src_tbl", "slot_tbl", "row_t", "src_t",
                 "slot_t", "inv_slot"):
        np.testing.assert_array_equal(getattr(t_sp, name).numpy(),
                                      np.asarray(getattr(j_sp, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t_sp.blocks_flat.numpy(),
                                  np.asarray(j_sp.blocks_flat))
    assert t_sp.nb == int(np.asarray(j_sp.row_tbl)[-1]) + 1
    if isinstance(t_sp, tbs.Fused2FlatSupport):
        assert (t_sp.delay, t_sp.ring_w, t_sp.delay_t, t_sp.ring_w_t) == (
            j_sp.delay, j_sp.ring_w, j_sp.delay_t, j_sp.ring_w_t)


@pytest.mark.parametrize("bs", [(16, 16), (16, 32)], ids=["sq", "rect"])
def test_from_edges_flat_and_as_fused2_match_jax(rng, bs):
    from graph_wavenet_tpu.graphs.ordering import rcm_order_edges

    n = 96
    src, dst, w = knn_graph(rng, n)
    perm = rcm_order_edges(src, dst, n)
    j_sp = jbs.from_edges_flat(src, dst, w, n, bs[0], bs[1], perm=perm)
    t_sp = tbs.from_edges_flat(src, dst, w, n, bs[0], bs[1], perm=perm,
                               device=CPU)
    assert_same_support(t_sp, j_sp)
    j_f, t_f = jbs.as_fused2(j_sp), tbs.as_fused2(t_sp)
    assert_same_support(t_f, j_f)
    assert isinstance(t_f, tbs.Fused2FlatSupport) == (bs[0] == bs[1])
    assert_same_support(tbs.as_unfused(t_f), jbs.as_unfused(j_f))


@pytest.mark.parametrize("form", ["flat", "flat-rect"])
def test_doubletransition_supports_match_jax(rng, form):
    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges

    n = 128
    src, dst, w = knn_graph(rng, n)
    perm = rcm_order_edges(src, dst, n)
    j_sup = jspatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form=form, block_size=16)
    t_sup = tspatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form=form, block_size=16, device=CPU)
    assert len(t_sup) == len(j_sup) == 2
    for t_sp, j_sp in zip(t_sup, j_sup):
        assert_same_support(t_sp, j_sp)
    with pytest.raises(NotImplementedError, match="padded"):
        tspatial.doubletransition_block_supports(
            src, dst, w, n, perm=perm, form="block", device=CPU)


@pytest.mark.parametrize("form", ["flat", "unfused", "flat-rect"])
def test_sparse_gcn_matches_jax(rng, form):
    n, c_in, c_out, b, t = 64, 3, 4, 2, 3
    src, dst, w = knn_graph(rng, n)
    build = "flat-rect" if form == "flat-rect" else "flat"
    j_sup = jspatial.doubletransition_block_supports(
        src, dst, w, n, form=build, block_size=16)
    t_sup = tspatial.doubletransition_block_supports(
        src, dst, w, n, form=build, block_size=16, device=CPU)
    if form == "unfused":
        j_sup = [jbs.as_unfused(s) for s in j_sup]
        t_sup = [tbs.as_unfused(s) for s in t_sup]
    fused = [hasattr(s, "mix2_2d") for s in t_sup]
    assert fused == [hasattr(s, "mix2_2d") for s in j_sup]
    assert any(fused) == (form == "flat")
    p = dense_params(rng, 5 * c_in, c_out)
    x = rng.normal(size=(b, t, n, c_in)).astype(np.float32)
    want = j_gcn_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), j_sup, order=2)
    got = t_gcn_apply(torch.as_tensor(p["w"].T[:, :, None, None]),
                      torch.as_tensor(p["b"]), torch.as_tensor(x), t_sup,
                      order=2)
    assert got.shape == (b, t, n, c_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_hops_are_forward_only(rng, monkeypatch):
    """A fixed support's blocks are forward-only: the backward of its hops
    gives x a gradient, the blocks none, and never runs kernel 2 (the
    weight cotangent), as XLA drops it for the reference's constants."""
    from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as tbd

    calls = []
    plain = tbd.outer_flat_plain
    monkeypatch.setattr(tbd, "outer_flat_plain",
                        lambda *a: calls.append(1) or plain(*a))
    n = 32
    src, dst, w = knn_graph(rng, n)
    sp = tbs.from_edges_flat(src, dst, w, n, 16, 16, device=CPU)
    fused = tbs.as_fused2(sp)
    assert isinstance(fused, tbs.Fused2FlatSupport)
    x = torch.ones(n, 4, requires_grad=True)
    (sp.mix_2d(x).sum() + sum(o.sum() for o in fused.mix2_2d(x))).backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    assert sp.blocks_flat.grad is None and not calls
    blocks = sp.blocks_flat.clone().requires_grad_(True)
    dataclasses.replace(sp, blocks_flat=blocks).mix_2d(x).sum().backward()
    assert len(calls) == 1 and blocks.grad is not None


@pytest.mark.parametrize("ordering", ["rcm", "hilbert"])
def test_city_layout_matches_jax(rng, ordering):
    """The layout record and the node-layout maps equal the reference's,
    so a sidecar written by either package rebuilds the same supports."""
    from graph_wavenet_tpu.graphs import city as jcity
    from graph_wavenet_tpu_torch.graphs import city as tcity

    n = 70
    pos = rng.random((n, 2))
    src, dst, w = jspatial.knn_graph_edges(pos, 3)
    _, _, j_layout = jcity.build_city_supports(
        src, dst, w, n, pos=pos, ordering=ordering, form="flat",
        block_size=16)
    t_sup, mask, t_layout = tcity.build_city_supports(
        src, dst, w, n, pos=pos, ordering=ordering, form="flat",
        block_size=16, device=CPU)
    assert mask is None and len(t_sup) == 2
    assert t_layout == j_layout
    x = rng.normal(size=(2, 3, n, 2)).astype(np.float32)
    xm = tcity.apply_node_layout(x, t_layout, axis=2)
    np.testing.assert_array_equal(
        xm, jcity.apply_node_layout(x, j_layout, axis=2))
    np.testing.assert_array_equal(
        tcity.invert_node_layout(xm, t_layout, axis=2), x)
