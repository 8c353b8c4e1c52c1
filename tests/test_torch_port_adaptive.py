"""The port's hop gradients and block-masked adaptive adjacency, held to
the JAX package on the CPU: the same numpy inputs and cotangents go
through ``torch.autograd`` and ``jax.vjp`` (the Pallas kernels in
interpret mode); fp32, 1e-5 unless stated."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.graphs import spatial as jspatial
from graph_wavenet_tpu.ops import adaptive as jadaptive
from graph_wavenet_tpu.ops import adaptive_block as jab
from graph_wavenet_tpu.ops import block_sparse as jbs
from graph_wavenet_tpu_torch.graphs import spatial as tspatial
from graph_wavenet_tpu_torch.ops import adaptive_block as tab
from graph_wavenet_tpu_torch.ops import block_sparse as tbs
from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as tbd

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"
N, BS, RANK = 64, 16, 5


def banded_graph(rng, n=N):
    """k-NN edges under RCM: a banded block pattern, so supports fuse."""
    from graph_wavenet_tpu.graphs.ordering import rcm_order_edges

    src, dst, w = jspatial.knn_graph_edges(rng.random((n, 2)), 3)
    perm = rcm_order_edges(src, dst, n)
    return perm[src], perm[dst], w


def both_supports(src, dst, w, bs=(BS, BS), fuse=True):
    j_sp = jbs.from_edges_flat(src, dst, w, N, *bs)
    t_sp = tbs.from_edges_flat(src, dst, w, N, *bs, device=CPU)
    if fuse:
        j_sp, t_sp = jbs.as_fused2(j_sp), tbs.as_fused2(t_sp)
    return j_sp, t_sp


def vjp_both(j_fn, t_fn, x, blocks, cots):
    """(dx, dblocks) of j_fn / t_fn (x, blocks) -> output(s) under the same
    cotangents."""
    blocks = np.array(blocks)
    _, pull = jax.vjp(j_fn, jnp.asarray(x), jnp.asarray(blocks))
    j_cots = tuple(jnp.asarray(c) for c in cots)
    want = pull(j_cots if len(cots) > 1 else j_cots[0])
    xt = torch.as_tensor(x).requires_grad_(True)
    bt = torch.as_tensor(blocks).requires_grad_(True)
    outs = t_fn(xt, bt)
    outs = outs if isinstance(outs, tuple) else (outs,)
    got = torch.autograd.grad(outs, (xt, bt),
                              tuple(torch.as_tensor(c) for c in cots))
    return [g.numpy() for g in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("kind", ["square", "rect", "fused"])
def test_mix_2d_gradients_match_jax(rng, kind):
    src, dst, w = banded_graph(rng)
    bs = (BS, 2 * BS) if kind == "rect" else (BS, BS)
    j_sp, t_sp = both_supports(src, dst, w, bs, fuse=kind == "fused")
    r = 24
    x = rng.normal(size=(N, r)).astype(np.float32)
    g = rng.normal(size=(N, r)).astype(np.float32)
    got, want = vjp_both(
        lambda x2, b: dataclasses.replace(j_sp, blocks_flat=b).mix_2d(x2),
        lambda x2, b: dataclasses.replace(t_sp, blocks_flat=b).mix_2d(x2),
        x, np.asarray(j_sp.blocks_flat), [g])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert not got[1][-1].any(), "the trailing zero block gets no gradient"


@pytest.mark.parametrize("branch", ["fused", "chained"])
def test_mix2_2d_gradients_match_jax(rng, branch):
    """Both backward branches of the fused order-2 hop: one kernel-3 pass
    over the transpose tables with ``add`` (delay_t > 0), or two chained
    kernel-1 hops (delay_t = 0)."""
    src, dst, w = banded_graph(rng)
    j_sp, t_sp = both_supports(src, dst, w)
    assert isinstance(t_sp, tbs.Fused2FlatSupport) and t_sp.delay_t > 0
    if branch == "chained":
        j_sp = dataclasses.replace(j_sp, delay_t=0, ring_w_t=0)
        t_sp = dataclasses.replace(t_sp, delay_t=0, ring_w_t=0)
    r = 20
    x = rng.normal(size=(N, r)).astype(np.float32)
    cots = [rng.normal(size=(N, r)).astype(np.float32) for _ in range(2)]
    got, want = vjp_both(
        lambda x2, b: dataclasses.replace(j_sp, blocks_flat=b).mix2_2d(x2),
        lambda x2, b: dataclasses.replace(t_sp, blocks_flat=b).mix2_2d(x2),
        x, np.asarray(j_sp.blocks_flat), cots)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.fixture
def masks(rng):
    src, dst, w = banded_graph(rng)
    j_sups = jspatial.doubletransition_block_supports(
        src, dst, w, N, form="flat", block_size=BS)
    t_sups = tspatial.doubletransition_block_supports(
        src, dst, w, N, form="flat", block_size=BS, device=CPU)
    return j_sups, t_sups


def assert_same_mask(t_m, j_m):
    for name in ("row_tbl", "src_tbl", "slot_tbl", "row_t", "src_t",
                 "slot_t", "inv_slot", "live_dst", "live_src"):
        np.testing.assert_array_equal(getattr(t_m, name).numpy(),
                                      np.asarray(getattr(j_m, name)),
                                      err_msg=name)
    assert (t_m.bs_src, t_m.n_src_blocks, t_m.fuse2) == (
        j_m.bs_src, j_m.n_src_blocks, j_m.fuse2)
    assert t_m.lag == tbd.fused2_lag(t_m.row_tbl.numpy(),
                                     t_m.src_tbl.numpy())


@pytest.mark.parametrize("hops", [1, 2])
def test_mask_from_supports_matches_jax(masks, hops):
    j_sups, t_sups = masks
    j_m = jab.mask_from_supports(j_sups, hops=hops)
    t_m = tab.mask_from_supports(t_sups, hops=hops)
    assert_same_mask(t_m, j_m)
    assert t_m.fuse2 is not None and t_m.n_live < (N // BS) ** 2
    assert_same_mask(tab.full_mask(N, BS, device=CPU), jab.full_mask(N, BS))


def test_widen_block_pairs_matches_jax(rng):
    d = rng.integers(0, 12, size=20)
    s = rng.integers(0, 12, size=20)
    for hops in (1, 2, 3):
        for a, b in zip(tab.widen_block_pairs(d, s, 12, hops),
                        jab.widen_block_pairs(d, s, 12, hops)):
            np.testing.assert_array_equal(a, b)


def test_mask_refuses_rectangular_blocks(rng):
    src, dst, w = banded_graph(rng)
    rect = tbs.from_edges_flat(src, dst, w, N, BS, 2 * BS, device=CPU)
    with pytest.raises(ValueError, match="square blocks"):
        tab.mask_from_supports([rect])


def nodevecs(rng):
    return (rng.normal(size=(N, RANK)).astype(np.float32),
            rng.normal(size=(RANK, N)).astype(np.float32))


def test_adaptive_blocks_and_materialize_match_jax(masks, rng):
    j_m = jab.mask_from_supports(masks[0])
    t_m = tab.mask_from_supports(masks[1])
    nv1, nv2 = nodevecs(rng)
    tv = (torch.as_tensor(nv1), torch.as_tensor(nv2))
    want = np.asarray(jab.adaptive_blocks(j_m, jnp.asarray(nv1),
                                          jnp.asarray(nv2)))
    got = tab.adaptive_blocks(t_m, *tv)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    sp = t_m.materialize(*tv)
    assert isinstance(sp, tbs.Fused2FlatSupport)
    assert (sp.delay, sp.ring_w, sp.delay_t, sp.ring_w_t) == t_m.fuse2
    np.testing.assert_array_equal(sp.blocks_flat[:-1].numpy(), got.numpy())
    assert not sp.blocks_flat[-1].any()
    # out_dtype is the exit cast: exactly the fp32 blocks rounded once
    bf = t_m.materialize(*tv, out_dtype=torch.bfloat16)
    assert bf.blocks_flat.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf.blocks_flat.float().numpy(),
                                  sp.blocks_flat.bfloat16().float().numpy())
    j_bf = j_m.materialize(jnp.asarray(nv1), jnp.asarray(nv2),
                           out_dtype=jnp.bfloat16)
    np.testing.assert_allclose(bf.blocks_flat.float().numpy(),
                               np.asarray(j_bf.blocks_flat, np.float32),
                               rtol=2 ** -8, atol=1e-7)
    unfused = dataclasses.replace(t_m, fuse2=None)
    assert type(unfused.materialize(*tv)) is tbs.FlatBlockSparseSupport


@pytest.mark.parametrize("which", ["full", "partial"])
def test_nodevec_gradients_match_jax(masks, rng, which):
    """Gradients reach both nodevecs through the materialized support's
    blocks cotangent: a single hop over the full mask, both fused hops over
    the partial (union) mask."""
    if which == "full":
        j_m, t_m = jab.full_mask(N, BS), tab.full_mask(N, BS, device=CPU)
    else:
        j_m = jab.mask_from_supports(masks[0])
        t_m = tab.mask_from_supports(masks[1])
    nv1, nv2 = nodevecs(rng)
    x = rng.normal(size=(N, 6)).astype(np.float32)

    def j_loss(a, b):
        sp = j_m.materialize(a, b)
        outs = (sp.mix_2d(jnp.asarray(x)),) if which == "full" else \
            sp.mix2_2d(jnp.asarray(x))
        return sum((o ** 2).sum() for o in outs)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(nv1),
                                            jnp.asarray(nv2))
    tv = [torch.as_tensor(v).requires_grad_(True) for v in (nv1, nv2)]
    sp = t_m.materialize(*tv)
    outs = (sp.mix_2d(torch.as_tensor(x)),) if which == "full" else \
        sp.mix2_2d(torch.as_tensor(x))
    sum((o ** 2).sum() for o in outs).backward()
    for t, j in zip(tv, want):
        # 1e-5 of the gradient's scale: entries that cancel carry the fp32
        # summation-order error of their larger terms
        scale = np.abs(np.asarray(j)).max()
        assert scale > 0
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_full_mask_equals_dense_adaptive_adjacency(rng):
    nv1, nv2 = nodevecs(rng)
    m = tab.full_mask(N, BS, device=CPU)
    sp = m.materialize(torch.as_tensor(nv1), torch.as_tensor(nv2))
    dense = np.zeros((N, N), np.float32)
    for i in range(m.n_live):
        d, s = int(m.live_dst[i]), int(m.live_src[i])
        dense[s * BS:(s + 1) * BS, d * BS:(d + 1) * BS] = \
            sp.blocks_flat[i].numpy()
    want = np.asarray(jadaptive.adaptive_adjacency(jnp.asarray(nv1),
                                                   jnp.asarray(nv2)))
    np.testing.assert_allclose(dense, want, rtol=1e-6, atol=1e-6)
