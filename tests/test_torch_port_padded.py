"""The port's padded block-sparse form (kernels 4 and 5, ``BlockSparseSupport``
and ``PallasBlockSparseSupport``) and the ELL form, held to the JAX package
on the CPU: the same numpy inputs go through both, the Pallas kernels in
interpret mode; fp32, 1e-5 unless stated. Then the slice as a whole: JAX city
checkpoints whose layout records a padded form served by the port, and the
port's training CLI on padded supports."""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.graphs import spatial as jspatial
from graph_wavenet_tpu.ops import block_sparse as jbs
from graph_wavenet_tpu.ops import sparse as jsparse
from graph_wavenet_tpu.ops.pallas import block_diffusion as jbd
from graph_wavenet_tpu_torch.graphs import spatial as tspatial
from graph_wavenet_tpu_torch.ops import block_sparse as tbs
from graph_wavenet_tpu_torch.ops import sparse as tsparse
from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as tbd

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = "cpu"


def padded_tables(rng, nb, nbx, mb, n_blocks):
    """(NB, MB) slot/src tables with both kinds of sentinel: a forward one
    (a real slot, the zero block-row ``nbx`` of x) and a transpose one (the
    zero block ``n_blocks``, the row's own index as source). Every row has
    fewer live slots than MB, and row 1 has none."""
    slot = np.empty((nb, mb), np.int64)
    src = np.empty((nb, mb), np.int64)
    for i in range(nb):
        k = 0 if i == 1 else int(rng.integers(1, mb))
        slot[i, :k] = rng.choice(n_blocks, size=k, replace=False)
        src[i, :k] = rng.integers(0, nbx, size=k)
        for m in range(k, mb):
            if rng.random() < 0.5:
                slot[i, m], src[i, m] = rng.integers(0, n_blocks), nbx
            else:
                slot[i, m], src[i, m] = n_blocks, min(i, nbx - 1)
    return slot, src


def i32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def knn_graph(rng, n, k=4):
    return jspatial.knn_graph_edges(rng.random((n, 2)), k)


# ---------------------------------------------------------------------------
# kernels 4 and 5: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "dx"])
@pytest.mark.parametrize("r", [24, 130], ids=["r24", "r130"])
def test_mix_padded_plain_matches_pallas(rng, transpose_lhs, r):
    nb, nbx, mb, bs, n_blocks = 5, 4, 3, 16, 7
    slot, src = padded_tables(rng, nb, nbx, mb, n_blocks)
    blocks = rng.normal(size=(n_blocks + 1, bs, bs)).astype(np.float32)
    blocks[n_blocks] = 0.0
    x = rng.normal(size=(nbx + 1, bs, r)).astype(np.float32)
    x[nbx] = 0.0
    want = np.asarray(jbd.gathered_block_mix(
        jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(x),
        jnp.asarray(src), transpose_lhs=transpose_lhs, interpret=True))
    got = tbd.gathered_block_mix(torch.as_tensor(blocks), i32(slot),
                                 torch.as_tensor(x), i32(src),
                                 transpose_lhs=transpose_lhs)
    assert got.shape == (nb, bs, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[1].any(), "a row without live slots must come out zero"
    # without the zero block and zero row the sentinels fall outside the
    # operands and contribute nothing: the same result, bit for bit
    unpadded = tbd.gathered_block_mix(
        torch.as_tensor(blocks[:n_blocks]), i32(slot),
        torch.as_tensor(x[:nbx]), i32(src), transpose_lhs=transpose_lhs)
    np.testing.assert_array_equal(unpadded.numpy(), got.numpy())


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [40, 130], ids=["r40", "r130"])
def test_outer_padded_plain_matches_pallas(rng, out_dtype, r):
    nb, mb, bs = 5, 3, 16
    slot, src = padded_tables(rng, nb, nb, mb, nb * mb)
    src = np.where(slot == nb * mb, nb, src)     # the forward table's form
    x = rng.normal(size=(nb + 1, bs, r)).astype(np.float32)
    x[nb] = 0.0
    g = rng.normal(size=(nb, bs, r)).astype(np.float32)
    j_dtype = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jbd.gathered_block_outer(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(src), out_dtype=j_dtype,
        interpret=True).astype(jnp.float32))
    got = tbd.gathered_block_outer(torch.as_tensor(x), torch.as_tensor(g),
                                   i32(src), out_dtype=out_dtype)
    assert got.shape == (nb, mb, bs, bs) and got.dtype == out_dtype
    # bf16: both round the same fp32 sums once, to within one bf16 ulp
    tol = TOL if out_dtype == torch.float32 else dict(rtol=2 ** -8, atol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    sent = src == nb
    assert sent.any() and not got[torch.as_tensor(sent)].any()
    unpadded = tbd.gathered_block_outer(torch.as_tensor(x[:nb]),
                                        torch.as_tensor(g), i32(src),
                                        out_dtype=out_dtype)
    assert torch.equal(unpadded, got)


def test_padded_wrappers_refuse_bad_shapes():
    blocks = torch.zeros(3, 16, 16)
    tbl = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\(NB, MB\)"):
        tbd.gathered_block_mix(blocks, tbl.reshape(-1), torch.zeros(2, 16, 4),
                               tbl.reshape(-1), transpose_lhs=True)
    with pytest.raises(ValueError, match="square"):
        tbd.gathered_block_mix(torch.zeros(3, 16, 32), tbl,
                               torch.zeros(2, 16, 4), tbl, transpose_lhs=True)
    with pytest.raises(ValueError, match="must be"):
        tbd.gathered_block_outer(torch.zeros(2, 16, 4), torch.zeros(3, 16, 4),
                                 tbl, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def assert_same_padded(t_sp, j_sp):
    assert type(t_sp).__name__ == type(j_sp).__name__
    for name in ("block_idx", "idx_t", "perm_t"):
        np.testing.assert_array_equal(getattr(t_sp, name).numpy(),
                                      np.asarray(getattr(j_sp, name)),
                                      err_msg=name)
        assert getattr(t_sp, name).dtype == torch.int32
    np.testing.assert_allclose(t_sp.blocks.float().numpy(),
                               np.asarray(j_sp.blocks, np.float32),
                               rtol=1e-6, atol=1e-6)
    assert t_sp.n_nodes == j_sp.n_nodes
    assert t_sp.block_size == j_sp.block_size


def assert_same_flat(t_sp, j_sp):
    for name in ("row_tbl", "src_tbl", "slot_tbl", "row_t", "src_t",
                 "slot_t", "inv_slot"):
        np.testing.assert_array_equal(getattr(t_sp, name).numpy(),
                                      np.asarray(getattr(j_sp, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t_sp.blocks_flat.numpy(),
                               np.asarray(j_sp.blocks_flat),
                               rtol=1e-6, atol=1e-6)
    assert t_sp.nb == int(np.asarray(j_sp.row_tbl)[-1]) + 1


def test_padded_builders_match_jax(rng):
    from graph_wavenet_tpu.graphs.ordering import rcm_order_edges

    n, bs = 100, 16                      # N pads to 112: an empty block-row
    src, dst, w = knn_graph(rng, n)
    perm = rcm_order_edges(src, dst, n)
    built = {
        "edges": (jbs.from_edges_blocked(src, dst, w, n, bs, perm=perm),
                  tbs.from_edges_blocked(src, dst, w, n, bs, perm=perm,
                                         device=CPU)),
        "random": (jbs.random_block_support(6, 3, bs,
                                            np.random.default_rng(4)),
                   tbs.random_block_support(6, 3, bs,
                                            np.random.default_rng(4),
                                            device=CPU)),
    }
    j_e, t_e = built["edges"]
    dense = j_e.to_dense()
    np.testing.assert_array_equal(t_e.to_dense(), dense)
    built["dense"] = (jbs.from_dense(dense, bs),
                      tbs.from_dense(dense, bs, device=CPU))
    for key, (j_sp, t_sp) in built.items():
        assert_same_padded(t_sp, j_sp)
        assert_same_padded(tbs.as_pallas(t_sp), jbs.as_pallas(j_sp))
        assert_same_flat(tbs.as_flat_pallas(t_sp), jbs.as_flat_pallas(j_sp))
    bidx = t_e.block_idx.numpy()
    assert (bidx == bidx.shape[0]).any(), "the graph must leave sentinels"
    half = tbs.as_pallas(t_e).astype(torch.bfloat16)
    assert isinstance(half, tbs.PallasBlockSparseSupport)
    assert half.blocks.dtype == torch.bfloat16 and half.slot is not None
    assert half.block_idx is t_e.block_idx


# ---------------------------------------------------------------------------
# the padded hop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["BlockSparseSupport",
                                 "PallasBlockSparseSupport"])
def test_padded_hop_vjp_matches_jax(rng, cls):
    """Forward and the vjp in x and in the blocks against ``jax.vjp`` of the
    reference's kernel-backed hop (``_block_mix_pallas``); the sentinel
    slots' block gradient is exactly zero."""
    from graph_wavenet_tpu.graphs.ordering import rcm_order_edges

    n, bs, r = 128, 16, 24
    src, dst, w = knn_graph(rng, n)
    j_sp = jbs.from_edges_blocked(src, dst, w, n, bs,
                                  perm=rcm_order_edges(src, dst, n))
    t_sp = getattr(tbs, cls)(*(torch.as_tensor(np.array(a)) for a in (
        j_sp.blocks, j_sp.block_idx, j_sp.idx_t, j_sp.perm_t)))
    x = rng.normal(size=(n, r)).astype(np.float32)
    cot = rng.normal(size=(n, r)).astype(np.float32)

    def j_fn(x2, blocks):
        return jbs.PallasBlockSparseSupport(
            blocks, j_sp.block_idx, j_sp.idx_t, j_sp.perm_t).mix_2d(x2)

    want, pull = jax.vjp(j_fn, jnp.asarray(x), jnp.asarray(j_sp.blocks))
    j_dx, j_db = pull(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    bt = t_sp.blocks.clone().requires_grad_(True)
    got = dataclasses.replace(t_sp, blocks=bt).mix_2d(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    dx, db = torch.autograd.grad(got, (xt, bt), torch.as_tensor(cot))
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(j_db), **TOL)
    sent = t_sp.block_idx.numpy() == t_sp.blocks.shape[0]
    assert sent.any() and not db[torch.as_tensor(sent)].any()
    # a fixed support's blocks need no gradient: dx alone
    xt.grad = None
    t_sp.mix_2d(xt).backward(torch.as_tensor(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_dx), **TOL)
    assert t_sp.blocks.grad is None


def test_nconv_block_sparse_matches_jax(rng):
    sp_np = jbs.random_block_support(4, 2, 16, np.random.default_rng(1))
    t_sp = tbs.random_block_support(4, 2, 16, np.random.default_rng(1),
                                    device=CPU)
    x = rng.normal(size=(2, 3, 64, 5)).astype(np.float32)
    want = jbs.nconv_block_sparse(jnp.asarray(x), sp_np)
    got = tbs.nconv_block_sparse(torch.as_tensor(x), t_sp)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------

def test_ell_builders_match_jax(rng):
    n = 40
    src, dst, w = knn_graph(rng, n, k=3)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (src, dst), w)
    pairs = {
        "edges": (jsparse.from_edges(src, dst, w, n),
                  tsparse.from_edges(src, dst, w, n, device=CPU)),
        "edges_top2": (jsparse.from_edges(src, dst, w, n, max_degree=2),
                       tsparse.from_edges(src, dst, w, n, max_degree=2,
                                          device=CPU)),
        "dense": (jsparse.from_dense(dense), tsparse.from_dense(dense,
                                                                device=CPU)),
        "random": (jsparse.random_sparse_support(
            n, 3, np.random.default_rng(2)), tsparse.random_sparse_support(
            n, 3, np.random.default_rng(2), device=CPU)),
    }
    for key, (j_sp, t_sp) in pairs.items():
        for name in ("idx", "w", "idx_t", "perm_t", "live"):
            np.testing.assert_array_equal(getattr(t_sp, name).numpy(),
                                          np.asarray(getattr(j_sp, name)),
                                          err_msg=f"{key}.{name}")
        np.testing.assert_array_equal(t_sp.to_dense(), j_sp.to_dense())
        assert (t_sp.n_nodes, t_sp.max_degree) == (j_sp.n_nodes,
                                                   j_sp.max_degree)


def test_ell_hop_and_gradients_match_jax(rng):
    n, r = 40, 12
    src, dst, w = knn_graph(rng, n, k=3)
    j_sp = jsparse.from_edges(src, dst, w, n)
    t_sp = tsparse.from_edges(src, dst, w, n, device=CPU)
    assert not t_sp.live.all(), "the graph must leave padding slots"
    x = rng.normal(size=(n, r)).astype(np.float32)
    cot = rng.normal(size=(n, r)).astype(np.float32)

    def j_fn(x2, w_):
        return dataclasses.replace(j_sp, w=w_).mix_2d(x2)

    want, pull = jax.vjp(j_fn, jnp.asarray(x), j_sp.w)
    j_dx, j_dw = pull(jnp.asarray(cot))
    xt = torch.as_tensor(x).requires_grad_(True)
    wt = t_sp.w.clone().requires_grad_(True)
    got = dataclasses.replace(t_sp, w=wt).mix_2d(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.as_tensor(cot))
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_dx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), **TOL)
    assert not dw[~t_sp.live].any(), "padding slots must get no gradient"
    x4 = rng.normal(size=(2, 3, n, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tsparse.nconv_sparse(torch.as_tensor(x4), t_sp).numpy(),
        np.asarray(jsparse.nconv_sparse(jnp.asarray(x4), j_sp)), **TOL)


# ---------------------------------------------------------------------------
# supports, gcn and the adaptive mask over the padded forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["block", "pallas"])
def test_padded_supports_gcn_and_mask_match_jax(rng, form):
    from graph_wavenet_tpu.ops import adaptive_block as jab
    from graph_wavenet_tpu.ops.diffusion import gcn_apply as j_gcn_apply
    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.ops import adaptive_block as tab
    from graph_wavenet_tpu_torch.ops.diffusion import gcn_apply as t_gcn_apply

    n, c_in, c_out = 64, 3, 4
    src, dst, w = knn_graph(rng, n)
    perm = rcm_order_edges(src, dst, n)
    j_sup = jspatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form=form, block_size=16)
    t_sup = tspatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form=form, block_size=16, device=CPU)
    for t_sp, j_sp in zip(t_sup, j_sup):
        assert_same_padded(t_sp, j_sp)
    wgt = rng.normal(size=(5 * c_in, c_out)).astype(np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    x = rng.normal(size=(2, 3, n, c_in)).astype(np.float32)
    want = j_gcn_apply({"w": jnp.asarray(wgt), "b": jnp.asarray(bias)},
                       jnp.asarray(x), j_sup, order=2)
    got = t_gcn_apply(torch.as_tensor(wgt.T[:, :, None, None]),
                      torch.as_tensor(bias), torch.as_tensor(x), t_sup,
                      order=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    j_m = jab.mask_from_supports(j_sup, hops=2)
    t_m = tab.mask_from_supports(t_sup, hops=2)
    for name in ("row_tbl", "src_tbl", "slot_tbl", "row_t", "src_t",
                 "slot_t", "inv_slot", "live_dst", "live_src"):
        np.testing.assert_array_equal(getattr(t_m, name).numpy(),
                                      np.asarray(getattr(j_m, name)),
                                      err_msg=name)
    assert t_m.fuse2 == j_m.fuse2


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

N_RAW = 40


@pytest.fixture(scope="module", params=["auto", "pallas"],
                ids=["jax-auto-block", "pallas"])
def padded_ckpt(request, tmp_path_factory):
    """A JAX city checkpoint whose layout records a padded form (the JAX
    package resolves "auto" to "block" off the TPU), converted to the port's
    format."""
    from flax import serialization

    from graph_wavenet_tpu.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler
    from graph_wavenet_tpu.graphs import city
    from graph_wavenet_tpu.train import checkpoint as jckpt
    from graph_wavenet_tpu.train.engine import Engine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt

    tmp = tmp_path_factory.mktemp("padded")
    rng = np.random.default_rng(0)
    pos = rng.random((N_RAW, 2))
    src, dst, w = jspatial.knn_graph_edges(pos, 3)
    gpath = str(tmp / "g.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_RAW)
    _, _, layout = city.build_city_supports(
        src, dst, w, N_RAW, pos=pos, ordering="rcm", form=request.param,
        block_size=16)
    assert layout["form"] == {"auto": "block"}.get(request.param,
                                                   request.param)
    cfg = ModelConfig(num_nodes=layout["n_pad"], out_dim=6,
                      residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=32, blocks=2,
                      layers=2, dropout=0.0, n_supports=2, addaptadj=False)
    scaler = StandardScaler(3.0, 2.0)
    engine = Engine(cfg, TrainConfig(), scaler, seed=0)
    jpath = str(tmp / "city.msgpack")
    jckpt.save_checkpoint(jpath, engine.state, model_cfg=cfg,
                          train_cfg=TrainConfig(), scaler=scaler,
                          extra={"graph_layout": layout})
    with open(jpath, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    meta = tckpt.load_metadata(jpath)
    sd = convert.params_from_jax(tree["params"], tree["model_state"],
                                 meta["model_cfg"])
    tpath = str(tmp / "city.pt")
    tckpt.save_checkpoint(tpath, sd, model_cfg=meta["model_cfg"],
                          train_cfg=meta["train_cfg"], scaler=meta["scaler"],
                          extra=meta["extra"])
    return dict(jpath=jpath, tpath=tpath, gpath=gpath, form=layout["form"])


def test_padded_city_checkpoint_serves_like_jax(padded_ckpt):
    """The repaired fault: a JAX city checkpoint trained off the TPU (layout
    form "block") or with --sparse pallas serves through the port's
    Forecaster and serve CLI, in original node order, within 2e-4 of the
    JAX Forecaster."""
    from graph_wavenet_tpu.train import serving as jserving
    from graph_wavenet_tpu_torch.cli import serve
    from graph_wavenet_tpu_torch.train import serving as tserving

    jfc = jserving.Forecaster.from_city_checkpoint(padded_ckpt["jpath"],
                                                   padded_ckpt["gpath"])
    tfc = tserving.Forecaster.from_city_checkpoint(
        padded_ckpt["tpath"], padded_ckpt["gpath"], device=CPU)
    want_cls = {"block": "BlockSparseSupport",
                "pallas": "PallasBlockSparseSupport"}[padded_ckpt["form"]]
    assert [type(s).__name__ for s in tfc.supports] == [want_cls] * 2
    assert [type(s).__name__ for s in jfc.supports] == [want_cls] * 2
    x = np.random.default_rng(1).normal(
        size=(3, 12, N_RAW, 2)).astype(np.float32)
    want = np.asarray(jfc.predict(jnp.asarray(x)))
    got = tfc.predict(x)
    assert got.shape == (3, 6, N_RAW)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)

    run = serve.main(["--checkpoint", padded_ckpt["tpath"], "--graph_npz",
                      padded_ckpt["gpath"], "--device", CPU, "--port", "0",
                      "--window_ms", "1"], serve_forever=False)
    server, batcher, fc = run["server"], run["batcher"], run["forecaster"]
    try:
        raw = x[0].copy()
        raw[..., 0] = fc.scaler.inverse_transform(raw[..., 0])
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_port}/predict",
            data=json.dumps({"x": raw.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = np.asarray(json.loads(r.read())["y"])
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    np.testing.assert_allclose(answer, want[0], rtol=2e-4, atol=2e-4)


def test_train_cli_on_padded_supports(tmp_path):
    """``--sparse pallas --addaptadj`` on the CPU: a few steps with finite
    metrics; the checkpoint serves, and the same weights under the flat
    layout forecast the same (both forms mix the same live blocks)."""
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt
    from graph_wavenet_tpu_torch.train import serving as tserving

    rng = np.random.default_rng(0)
    pos = rng.random((N_RAW, 2))
    src, dst, w = jspatial.knn_graph_edges(pos, 3)
    gpath = str(tmp_path / "g.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=N_RAW)
    data = tmp_path / "data"
    data.mkdir()
    for split, s in (("train", 8), ("val", 4), ("test", 4)):
        x = rng.normal(5.0, 2.0, size=(s, 12, N_RAW, 2)).astype(np.float32)
        y = rng.normal(5.0, 2.0, size=(s, 12, N_RAW, 2)).astype(np.float32)
        np.savez(data / f"{split}.npz", x=x, y=y)
    out = train.main([
        "--graph_npz", gpath, "--data", str(data), "--device", CPU,
        "--gcn_bool", "--addaptadj", "--sparse", "pallas", "--block_size",
        "16", "--ordering", "rcm", "--seq_length", "12", "--nhid", "4",
        "--blocks", "2", "--layers", "2", "--batch_size", "4", "--epochs",
        "1", "--print_every", "1", "--save", str(tmp_path / "ckpt")])
    result, sups = out["result"], out["supports"]
    assert [type(s).__name__ for s in sups[:2]] == [
        "PallasBlockSparseSupport"] * 2
    assert getattr(sups[2], "adaptive_mask", False)
    hist = result.history[0]
    assert all(np.isfinite(v) for v in (*hist.train.values(),
                                        *hist.valid.values(),
                                        *result.test_metrics.values()))
    path = result.best_checkpoint
    meta = tckpt.load_metadata(path)
    layout = meta["extra"]["graph_layout"]
    assert layout["form"] == "pallas" and layout["fused2"] is False
    fc = tserving.Forecaster.from_city_checkpoint(path, gpath, device=CPU)
    x = rng.normal(size=(2, 12, N_RAW, 2)).astype(np.float32)
    got = fc.predict(x)
    assert got.shape == (2, 12, N_RAW) and bool(torch.isfinite(got).all())
    sups, mask, flat_layout = city.build_city_supports(
        src, dst, w, N_RAW, pos=pos, ordering="rcm", form="flat",
        block_size=16, addaptadj=True, device=CPU)
    flat = tserving.Forecaster.from_checkpoint(path, sups + [mask],
                                               device=CPU)
    flat.node_layout = flat_layout
    np.testing.assert_allclose(flat.predict(x).numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)
