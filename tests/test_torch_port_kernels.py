"""The port's flat block-sparse kernels (1, 2 and 3), held to the JAX
package's Pallas kernels (run in interpret mode) on the CPU.

On a CPU tensor each wrapper takes its plain PyTorch version, so these tests
pin the kernels' function; the CUDA kernels themselves are held against the
same plain versions on the card by ``chip_smoke.py``. fp32 throughout: JAX
accumulates bf16 in bf16 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_wavenet_tpu.ops.pallas import block_diffusion as jbd
from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as tbd

TOL = dict(rtol=1e-5, atol=1e-5)


def flat_tables(rng, nb, nbx, max_per_row, band=None):
    """Row-sorted (row, src, slot) tables with some empty rows, each empty
    row visited once by a dummy entry on the trailing zero block."""
    rows, srcs = [], []
    for r in range(nb):
        k = int(rng.integers(0, max_per_row + 1))
        if band is None:
            cand = np.arange(nbx)
        else:
            cand = np.arange(max(0, r - band), min(nbx, r + band + 1))
        for s in sorted(rng.choice(cand, size=min(k, len(cand)),
                                   replace=False)):
            rows.append(r)
            srcs.append(int(s))
    n_live = len(rows)
    row, src = np.array(rows, np.int64), np.array(srcs, np.int64)
    slot = rng.permutation(n_live)
    empty = np.setdiff1d(np.arange(nb), row)
    row = np.concatenate([row, empty])
    src = np.concatenate([src, np.zeros(len(empty), np.int64)])
    slot = np.concatenate([slot, np.full(len(empty), n_live)])
    order = np.argsort(row, kind="stable")
    return row[order], src[order], slot[order], n_live, len(empty)


def as_t(a, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("transpose_lhs", [True, False])
@pytest.mark.parametrize("shape", [(16, 16), (16, 32)],
                         ids=["square", "rect"])
@pytest.mark.parametrize("r", [24, 130], ids=["r24", "r130"])
def test_mix_flat_plain_matches_pallas(rng, transpose_lhs, shape, r):
    bs_a, bs_b = shape
    bs_c, bs_o = (bs_a, bs_b) if transpose_lhs else (bs_b, bs_a)
    nb, nbx = 5, 4
    row, src, slot, n_live, n_empty = flat_tables(rng, nb, nbx, 3)
    assert n_empty >= 1, "the seed must give an empty destination row"
    blocks = rng.normal(size=(n_live + 1, bs_a, bs_b)).astype(np.float32)
    blocks[n_live] = 0.0
    x = rng.normal(size=(nbx, bs_c, r)).astype(np.float32)

    want = jbd.gathered_block_mix_flat(
        jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(x),
        jnp.asarray(src), jnp.asarray(row), nb=nb,
        transpose_lhs=transpose_lhs, interpret=True)
    got = tbd.gathered_block_mix_flat(
        torch.as_tensor(blocks), as_t(slot), torch.as_tensor(x), as_t(src),
        as_t(row), nb=nb, transpose_lhs=transpose_lhs)
    assert got.shape == (nb, bs_o, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for e in np.setdiff1d(np.arange(nb), row[slot < n_live]):
        assert not got[e].any(), "an empty row must come out zero"


@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "add"])
def test_mix_flat2_plain_matches_pallas_fused(rng, with_add):
    nb, bs, r = 8, 16, 40
    row, src, slot, n_live, _ = flat_tables(rng, nb, nb, 3, band=2)
    sched = jbd.fused2_schedule(row, src, nb)
    assert sched is not None
    delay, ring_w = sched
    blocks = rng.normal(size=(n_live + 1, bs, bs)).astype(np.float32)
    blocks[n_live] = 0.0
    x = rng.normal(size=(nb, bs, r)).astype(np.float32)
    add = (rng.normal(size=(nb, bs, r)).astype(np.float32)
           if with_add else None)

    w1, w2 = jbd.gathered_block_mix_flat2(
        jnp.asarray(blocks), jnp.asarray(slot), jnp.asarray(x),
        jnp.asarray(src), jnp.asarray(row), nb=nb, delay=delay,
        ring_w=ring_w, transpose_lhs=True,
        add=None if add is None else jnp.asarray(add), interpret=True,
        dispatch="fused")
    g1, g2 = tbd.gathered_block_mix_flat2(
        torch.as_tensor(blocks), as_t(slot), torch.as_tensor(x), as_t(src),
        as_t(row), nb=nb, lag=tbd.fused2_lag(row, src), transpose_lhs=True,
        add=None if add is None else torch.as_tensor(add))
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), **TOL)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2), **TOL)


@pytest.mark.parametrize("shape", [(16, 16), (16, 32), (32, 16)],
                         ids=["square", "rect", "tall"])
@pytest.mark.parametrize("r", [40, 130], ids=["r40", "r130"])
def test_outer_flat_plain_matches_pallas(rng, shape, r):
    """Kernel 2's plain version against the Pallas kernel: one output per
    table entry, dummy entries included, R not a multiple of 128."""
    bs_x, bs_g = shape
    nb, nbx = 5, 4
    row, src, _, _, n_empty = flat_tables(rng, nb, nbx, 3)
    assert n_empty >= 1, "the seed must give a dummy entry"
    x = rng.normal(size=(nbx, bs_x, r)).astype(np.float32)
    g = rng.normal(size=(nb, bs_g, r)).astype(np.float32)
    want = jbd.gathered_block_outer_flat(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(src), jnp.asarray(row),
        out_dtype=jnp.float32, interpret=True)
    got = tbd.gathered_block_outer_flat(torch.as_tensor(x),
                                        torch.as_tensor(g), as_t(src),
                                        as_t(row))
    assert got.shape == (len(row), bs_x, bs_g)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def inv_slot_of(slot, n_live):
    """The flat support's ``inv_slot``: the table position of each storage
    slot, and for the zero slot the row past the table."""
    inv = np.zeros(n_live + 1, np.int64)
    inv[slot] = np.arange(len(slot))
    inv[n_live] = len(slot)
    return inv


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 16), (16, 32), (32, 16)],
                         ids=["square", "rect", "tall"])
def test_outer_flat_storage_order_matches_gather(rng, shape, out_dtype):
    """Kernel 2 in storage order equals the per-entry result gathered by
    ``inv_slot`` (a zero row appended for the zero slot) and cast, bit for
    bit: dummy entries land nowhere and the zero slot stays zero."""
    bs_x, bs_g = shape
    nb, nbx, r = 6, 5, 40
    row, src, slot, n_live, n_empty = flat_tables(rng, nb, nbx, 3)
    assert n_empty >= 1 and n_live >= 2
    x = torch.as_tensor(rng.normal(size=(nbx, bs_x, r)).astype(np.float32))
    g = torch.as_tensor(rng.normal(size=(nb, bs_g, r)).astype(np.float32))
    per_entry = tbd.gathered_block_outer_flat(x, g, as_t(src), as_t(row))
    pad = per_entry.new_zeros((1, bs_x, bs_g))
    want = torch.cat([per_entry, pad]).index_select(
        0, torch.as_tensor(inv_slot_of(slot, n_live))).to(out_dtype)
    got = tbd.gathered_block_outer_flat(x, g, as_t(src), as_t(row),
                                        slot=as_t(slot), n_slots=n_live + 1,
                                        out_dtype=out_dtype)
    assert got.shape == (n_live + 1, bs_x, bs_g) and got.dtype == out_dtype
    assert torch.equal(got, want)
    assert not got[n_live].any()
    assert torch.equal(got, tbd.outer_flat_plain(
        x, g, as_t(src), as_t(row), slot=as_t(slot), n_slots=n_live + 1,
        out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 16), (16, 32)],
                         ids=["square", "rect"])
def test_outer_flat_storage_order_matches_pallas(rng, shape, out_dtype):
    """Against the reference's backward: the Pallas kernel per entry, then
    ``jnp.take`` by ``inv_slot`` over a zero pad row and a cast to the
    blocks' dtype (``graph_wavenet_tpu/ops/block_sparse.py:604-611``).
    fp32 inputs; 1e-5 before the cast, so a bf16 result may differ by the
    one ulp that 1e-5 can move a rounding by."""
    bs_x, bs_g = shape
    nb, nbx, r = 5, 4, 130
    row, src, slot, n_live, n_empty = flat_tables(rng, nb, nbx, 3)
    assert n_empty >= 1
    x = rng.normal(size=(nbx, bs_x, r)).astype(np.float32)
    g = rng.normal(size=(nb, bs_g, r)).astype(np.float32)
    dflat = jbd.gathered_block_outer_flat(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(src), jnp.asarray(row),
        out_dtype=jnp.float32, interpret=True)
    dflat_pad = jnp.concatenate([dflat, jnp.zeros((1, bs_x, bs_g),
                                                  dflat.dtype)])
    want = jnp.take(dflat_pad, jnp.asarray(inv_slot_of(slot, n_live)),
                    axis=0).astype(out_dtype)
    t_dtype = torch.float32 if out_dtype == jnp.float32 else torch.bfloat16
    got = tbd.gathered_block_outer_flat(
        torch.as_tensor(x), torch.as_tensor(g), as_t(src), as_t(row),
        slot=as_t(slot), n_slots=n_live + 1, out_dtype=t_dtype)
    assert got.shape == (n_live + 1, bs_x, bs_g) and got.dtype == t_dtype
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if t_dtype == torch.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp + 1e-5 * np.abs(want) + 1e-5).all()
    assert not got[n_live].any()


def test_outer_flat_storage_arguments_refused():
    x, g = torch.zeros(2, 16, 4), torch.zeros(2, 16, 4)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="need slot"):
        tbd.gathered_block_outer_flat(x, g, one, one, n_slots=2)
    with pytest.raises(ValueError, match="need slot"):
        tbd.gathered_block_outer_flat(x, g, one, one,
                                      out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n_slots >= 1"):
        tbd.gathered_block_outer_flat(x, g, one, one, slot=one)
    with pytest.raises(ValueError, match="one entry per table entry"):
        tbd.gathered_block_outer_flat(x, g, one, one,
                                      slot=torch.zeros(2, dtype=torch.int32),
                                      n_slots=2)


@pytest.mark.parametrize("band", [1, 3, None], ids=["b1", "b3", "wide"])
def test_fused2_schedule_matches_reference(rng, band):
    nb = 40
    row, src, _, _, _ = flat_tables(rng, nb, nb, 4, band=band)
    for max_ring in (4, 24):
        assert (tbd.fused2_schedule(row, src, nb, max_ring=max_ring)
                == jbd.fused2_schedule(row, src, nb, max_ring=max_ring))


@pytest.mark.parametrize("band", [0, 2, 5])
def test_fused2_lag_orders_every_dependency(rng, band):
    """Hop 2 of row i runs after hop 1 of row i + lag: every source row an
    entry of row i reads must be at most i + lag, and the lag is tight."""
    row, src, _, _, _ = flat_tables(rng, 30, 30, 4, band=band)
    lag = tbd.fused2_lag(row, src)
    assert lag >= 0 and (src <= row + lag).all()
    if lag > 0:
        assert (src == row + lag).any()


def test_row_pointer_is_csr_of_sorted_rows():
    row = torch.tensor([0, 0, 2, 2, 2, 3], dtype=torch.int32)
    ptr = tbd.row_pointer(row, 5)
    assert ptr.dtype == torch.int32
    assert ptr.tolist() == [0, 2, 2, 5, 6, 6]


def test_cpu_tensor_takes_plain_version_and_no_launch(rng):
    """A CPU tensor never reaches the kernel: the launch count stays 0."""
    tbd.reset_launch_counts()
    row, src, slot, n_live, _ = flat_tables(rng, 4, 4, 2, band=1)
    blocks = torch.zeros(n_live + 1, 32, 128)
    x = torch.ones(4, 32, 8)
    out = tbd.gathered_block_mix_flat(blocks, as_t(slot), x, as_t(src),
                                      as_t(row), nb=4, transpose_lhs=True)
    o1, o2 = tbd.gathered_block_mix_flat2(
        torch.zeros(n_live + 1, 16, 16), as_t(slot), torch.ones(4, 16, 8),
        as_t(src), as_t(row), nb=4, lag=1, transpose_lhs=True)
    dw = tbd.gathered_block_outer_flat(torch.ones(4, 128, 8),
                                       torch.ones(4, 64, 8), as_t(src),
                                       as_t(row))
    tbl = torch.zeros(4, 2, dtype=torch.int32)
    padded = tbd.gathered_block_mix(torch.zeros(2, 16, 16), tbl,
                                    torch.ones(4, 16, 8), tbl,
                                    transpose_lhs=True)
    db = tbd.gathered_block_outer(torch.ones(4, 16, 8), torch.ones(4, 16, 8),
                                  tbl, out_dtype=torch.bfloat16)
    assert out.shape == (4, 128, 8) and o2.shape == (4, 16, 8)
    assert dw.shape == (len(row), 128, 64)
    assert padded.shape == (4, 16, 8) and db.shape == (4, 2, 16, 16)
    assert tbd.LAUNCHES == {"gathered_block_mix_flat": 0,
                            "gathered_block_mix_flat2": 0,
                            "gathered_block_outer_flat": 0,
                            "gathered_block_mix": 0,
                            "gathered_block_outer": 0}


def test_wrappers_refuse_bad_shapes():
    blocks = torch.zeros(2, 16, 16)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="contracted block axis"):
        tbd.gathered_block_mix_flat(blocks, one, torch.zeros(1, 8, 4), one,
                                    one, nb=1, transpose_lhs=True)
    with pytest.raises(ValueError, match="square"):
        tbd.gathered_block_mix_flat2(torch.zeros(2, 16, 32), one,
                                     torch.zeros(1, 16, 4), one, one, nb=1,
                                     lag=0, transpose_lhs=True)
    with pytest.raises(ValueError, match="nbg, BSg, R"):
        tbd.gathered_block_outer_flat(torch.zeros(1, 16, 4),
                                      torch.zeros(1, 16, 5), one, one)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tile_cols_rule(dtype):
    """Kernels 1, 3 and 4 take their R tile width from one host rule: 64
    in fp32; in bf16 64 up to R = 64, else 256 unless 128 pads R to fewer
    columns by more than 1/8."""
    bf16 = {1: 64, 24: 64, 63: 64, 64: 64, 65: 128, 96: 128, 127: 128,
            128: 128, 129: 256, 192: 256, 255: 256, 256: 256, 257: 128,
            384: 128, 416: 256, 640: 128, 1152: 256, 1536: 256, 1664: 256,
            2304: 256, 3072: 256}
    for r, ct in bf16.items():
        want = 64 if dtype == torch.float32 else ct
        assert tbd.tile_cols(r, dtype) == want, r


@pytest.mark.parametrize("r", [32, 64, 65, 128, 130, 256, 3072])
def test_flag_count_covers_every_tile(r):
    """Kernel 3's flags: one per (row, R tile) of the width kernel 1 takes
    for the same R and dtype, then the ticket counter."""
    nb = 7
    for dtype in (torch.float32, torch.bfloat16):
        ct = tbd.tile_cols(r, dtype)
        n = tbd.flag_count(nb, r, dtype)
        assert n == nb * -(-r // ct) + 1
        assert (n - 1) * ct >= nb * r and (n - 1 - nb) * ct < nb * r
