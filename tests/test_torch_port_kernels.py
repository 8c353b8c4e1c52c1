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
from graph_wavenet_tpu_torch.ops.cuda import bn_tail, build, chan_proj

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


@pytest.mark.parametrize("dtype,r,resident,lag,want", [
    # bf16 at the city's widest R: 12 tiles of 256, one block an SM on 132;
    # a block's producer holds a second ticket, so 264 tickets span 11 steps
    (torch.bfloat16, 3072, 132, 5, (16, 132)),
    # bf16 R = 1536 (6 tiles): 22 steps of slack
    (torch.bfloat16, 1536, 132, 5, (27, 132)),
    # fp32 R = 512 (8 tiles of 64), two blocks an SM, a ticket each: 264
    # tickets, 17 steps
    (torch.float32, 512, 264, 5, (22, 264)),
    # one tile a row: 528 tickets span 264 steps
    (torch.bfloat16, 32, 264, 5, (269, 264)),
    # fewer items than blocks: the grid shrinks to the items, and the span
    # stops at nb (every hop 1 before any hop 2)
    (torch.float32, 64, 10_000, 0, (320, 640)),
    (torch.bfloat16, 256, 1, 0, (1, 1)),
])
def test_fused2_launch(dtype, r, resident, lag, want):
    """Kernel 3's persistent grid (at most the resident blocks, at most the
    items) and span (lag plus the steps the held tickets cover, at most
    nb), at the 40,960-node city's 320 block rows."""
    assert tbd.fused2_launch(320, r, dtype, lag, resident) == want


def fused2_item(t, nb, nt, span):
    """Kernel 3's ticket-to-item map (``item_of`` in csrc/mix_flat2.cu):
    (hop, row, tile), or None past the last item."""
    a, b = span * nt, 2 * nt * (nb - span)
    if t < a:
        return 0, t // nt, t % nt
    t -= a
    if t < b:
        step, w = span + t // (2 * nt), t % (2 * nt)
        hop = w // nt
        return hop, step if hop == 0 else step - span, w % nt
    t -= b
    return (1, nb - span + t // nt, t % nt) if t < a else None


@pytest.mark.parametrize("band", [0, 2, 5, None])
@pytest.mark.parametrize("dtype,r,resident", [
    (torch.bfloat16, 768, 4), (torch.bfloat16, 100, 1),
    (torch.float32, 200, 7), (torch.float32, 64, 1000)])
def test_fused2_tickets_order_every_dependency(rng, band, dtype, r,
                                                resident):
    """On hand-built tables (banded, or unbanded: lag near nb), the tickets
    of :func:`fused2_launch`'s span hand out every (hop, row, tile) item
    once, and every hop-2 item comes after the hop-1 items of its row's
    source rows, at least ``slack`` steps after (or every hop 1 first);
    each item's flag lies inside :func:`flag_count`'s buffer, before the
    ticket counter."""
    nb = 30
    row, src, _, _, _ = flat_tables(rng, nb, nb, 4, band=band)
    lag = tbd.fused2_lag(row, src)
    span, grid = tbd.fused2_launch(nb, r, dtype, lag, resident)
    assert lag <= span <= nb and 1 <= grid <= resident
    nt = -(-r // tbd.tile_cols(r, dtype))
    n_flags = tbd.flag_count(nb, r, dtype) - 1
    ticket = {}
    for t in range(2 * nb * nt + grid):
        item = fused2_item(t, nb, nt, span)
        if item is None:
            assert t >= 2 * nb * nt
            continue
        assert item not in ticket
        ticket[item] = t
        assert item[1] * nt + item[2] < n_flags
    assert len(ticket) == 2 * nb * nt
    for rw, s in zip(row, src):
        for tile in range(nt):
            assert ticket[0, s, tile] < ticket[1, rw, tile]
    if span < nb:
        # hop 2 of row i shares its step with hop 1 of row i + span
        for rw in range(nb - span):
            assert (ticket[1, rw, 0] - ticket[0, rw + span, 0]) == nt


def test_row_pointer_is_csr_of_sorted_rows():
    row = torch.tensor([0, 0, 2, 2, 2, 3], dtype=torch.int32)
    ptr = tbd.row_pointer(row, 5)
    assert ptr.dtype == torch.int32
    assert ptr.tolist() == [0, 2, 2, 5, 6, 6]


def test_cpu_tensor_takes_plain_version_and_no_launch(rng):
    """A CPU tensor never reaches the kernel: the launch count stays 0."""
    build.reset_launch_counts()
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
    assert {k: build.LAUNCHES[k] for k in tbd.OPS} == {
        "mix_flat": 0, "mix_flat2": 0, "outer_flat": 0, "mix_padded": 0,
        "outer_padded": 0}


# every hand kernel's op: its schema, as artifacts written by earlier
# versions resolve it
SCHEMAS = {
    "mix_flat": "(Tensor blocks, Tensor slot, Tensor x, Tensor src, Tensor "
                "row, Tensor? row_ptr, int nb, bool transpose_lhs) -> Tensor",
    "mix_flat2": "(Tensor blocks, Tensor slot, Tensor x, Tensor src, Tensor "
                 "row, Tensor? row_ptr, Tensor? add, int nb, int lag, bool "
                 "transpose_lhs) -> (Tensor, Tensor)",
    "outer_flat": "(Tensor x, Tensor g, Tensor src, Tensor row, Tensor? slot, "
                  "int? n_slots, ScalarType? out_dtype) -> Tensor",
    "mix_padded": "(Tensor blocks_flat, Tensor slot_tbl, Tensor x_pad, Tensor "
                  "src_tbl, bool transpose_lhs) -> Tensor",
    "outer_padded": "(Tensor x_pad, Tensor g_blocks, Tensor src_tbl, "
                    "ScalarType out_dtype) -> Tensor",
    "chan_proj": "(Tensor[] xs, Tensor w, Tensor bias) -> Tensor",
    "chan_proj_dgrad": "(Tensor g, Tensor w, Tensor[] xs) -> Tensor[]",
    "chan_proj_wgrad": "(Tensor[] xs, Tensor g) -> (Tensor, Tensor)",
    "bn_tail_stats": "(Tensor h, Tensor? drop, Tensor? res) -> (Tensor, "
                     "Tensor)",
    "bn_tail_var": "(Tensor x, Tensor mean) -> Tensor",
    "bn_tail_apply": "(Tensor x, Tensor mean, Tensor inv, Tensor w, Tensor b) "
                     "-> Tensor",
    "bn_tail_eval": "(Tensor h, Tensor? drop, Tensor? res, Tensor mean, "
                    "Tensor inv, Tensor w, Tensor b) -> Tensor",
    "bn_tail_grad_reduce": "(Tensor g, Tensor x, Tensor mean, Tensor inv) -> "
                           "Tensor",
    "bn_tail_grad_apply": "(Tensor g, Tensor x, Tensor? drop, Tensor mean, "
                          "Tensor inv, Tensor w, Tensor sums, int count, int "
                          "t_res) -> (Tensor, Tensor)",
}


def op_case(name: str):
    """(op arguments, the plain version's result on them) on small CPU
    tensors."""
    gen = torch.Generator().manual_seed(5)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    row, src, slot, n_live, _ = flat_tables(np.random.default_rng(3), 4, 4, 2,
                                            band=1)
    row, src, slot = as_t(row), as_t(src), as_t(slot)
    tbl = as_t([[0, 1], [1, 2], [2, 0], [3, 9]])
    bf = torch.bfloat16
    xs = [rand(2, 3, 8, dtype=bf), rand(2, 3, 4, dtype=bf)]
    w, g = rand(6, 12, dtype=bf), rand(2, 3, 6, dtype=bf)
    h, drop, res = (rand(2, 3, 4, 8, dtype=bf) for _ in range(3))
    mean, w8, b8 = rand(8), rand(8), rand(8)
    inv, sums = rand(8).abs() + 0.5, rand(2, 8)
    if name == "mix_flat":
        blocks, x = rand(n_live + 1, 16, 32), rand(4, 16, 8)
        return ((blocks, slot, x, src, row, None, 4, True),
                tbd.mix_flat_plain(blocks, slot, x, src, row, nb=4,
                                   transpose_lhs=True))
    if name == "mix_flat2":
        blocks, x, add = rand(n_live + 1, 16, 16), rand(4, 16, 8), rand(4, 16,
                                                                          8)
        return ((blocks, slot, x, src, row, None, add, 4, 1, False),
                tbd.mix_flat2_plain(blocks, slot, x, src, row, nb=4,
                                    transpose_lhs=False, add=add))
    if name == "outer_flat":
        x, gb = rand(4, 16, 8), rand(4, 32, 8)
        return ((x, gb, src, row, slot, n_live + 1, bf),
                tbd.outer_flat_plain(x, gb, src, row, slot, n_live + 1, bf))
    if name == "mix_padded":
        blocks, x = rand(5, 16, 16), rand(4, 16, 8)
        return ((blocks, tbl, x, tbl, True),
                tbd.mix_padded_plain(blocks, tbl, x, tbl, transpose_lhs=True))
    if name == "outer_padded":
        x, gb = rand(4, 16, 8), rand(4, 16, 8)
        return ((x, gb, tbl, bf),
                tbd.outer_padded_plain(x, gb, tbl, out_dtype=bf))
    if name == "chan_proj":
        bias = rand(6)
        return (xs, w, bias), chan_proj.chan_proj_plain(xs, w, bias)
    if name == "chan_proj_dgrad":
        return (g, w, xs), chan_proj.chan_proj_dgrad_plain(g, w, xs)
    if name == "chan_proj_wgrad":
        return (xs, g), chan_proj.chan_proj_wgrad_plain(xs, g)
    x = bn_tail.stats_plain(h, drop, res)[0]
    args = {"bn_tail_stats": (h, drop, res),
            "bn_tail_var": (x, mean),
            "bn_tail_apply": (x, mean, inv, w8, b8),
            "bn_tail_eval": (h, drop, res, mean, inv, w8, b8),
            "bn_tail_grad_reduce": (h, x, mean, inv),
            "bn_tail_grad_apply": (h, x, drop, mean, inv, w8, sums, 72, 5)}
    plain = {"bn_tail_stats": bn_tail.stats_plain,
             "bn_tail_var": bn_tail.var_plain,
             "bn_tail_apply": bn_tail.apply_plain,
             "bn_tail_eval": bn_tail.eval_plain,
             "bn_tail_grad_reduce": bn_tail.grad_reduce_plain,
             "bn_tail_grad_apply": bn_tail.grad_apply_plain}
    return args[name], plain[name](*args[name])


def leaves(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_every_op_registered_once_and_plain_on_cpu(name):
    """Each hand kernel's op is defined once in ``gwt_torch`` through the
    seam, with its schema, a fake kernel (its shapes under FakeTensorMode
    match the CPU result's) and a FLOP formula (FlopCounterMode counts the
    op); a CPU call runs the plain version and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    from torch.utils.flop_counter import FlopCounterMode

    assert set(build.LAUNCHES) == set(SCHEMAS)
    assert set(tbd.OPS + chan_proj.OPS + bn_tail.OPS) == set(SCHEMAS)
    op = getattr(torch.ops.gwt_torch, name)
    assert str(op.default._schema) == f"gwt_torch::{name}{SCHEMAS[name]}"
    assert op.overloads() == ["default"]
    args, want = op_case(name)
    build.reset_launch_counts()
    counter = FlopCounterMode(display=False)
    with counter:
        got = op(*args)
    assert not any(build.LAUNCHES.values())
    assert len(leaves(got)) == len(leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert op in counter.get_flop_counts()["Global"]
    mode = FakeTensorMode()
    with mode:
        fake = op(*tree_map(lambda t: mode.from_tensor(t)
                            if isinstance(t, torch.Tensor) else t, args))
    for a, b in zip(leaves(fake), leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


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


# ---------------------------------------------------------------------------
# kernel 3's dispatch: one fused pass or kernel 1 + add + kernel 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "add"])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "dx"])
def test_mix_flat2_chain_equals_fused_bit_for_bit(rng, with_add,
                                                  transpose_lhs):
    """The chain (two kernel-1 plain versions, ``+ add`` after the cast)
    and the fused plain version agree bit for bit, and ``"auto"`` gives the
    same numbers; no branch launches a kernel on CPU tensors."""
    nb, bs, r = 6, 16, 40
    row, src, slot, n_live, _ = flat_tables(rng, nb, nb, 3, band=2)
    blocks = torch.as_tensor(rng.normal(size=(n_live + 1, bs, bs)).astype(
        np.float32))
    blocks[n_live] = 0
    x = torch.as_tensor(rng.normal(size=(nb, bs, r)).astype(np.float32))
    add = (torch.as_tensor(rng.normal(size=(nb, bs, r)).astype(np.float32))
           if with_add else None)
    build.reset_launch_counts()
    outs = {d: tbd.gathered_block_mix_flat2(
        blocks, as_t(slot), x, as_t(src), as_t(row), nb=nb, lag=2,
        transpose_lhs=transpose_lhs, add=add, dispatch=d)
        for d in tbd.DISPATCHES}
    for d in ("chain", "auto"):
        for got, want in zip(outs[d], outs["fused"]):
            assert torch.equal(got, want), d
    assert not any(build.LAUNCHES.values())


def test_mix_flat2_dispatch_is_validated():
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="dispatch must be one of"):
        tbd.gathered_block_mix_flat2(torch.zeros(2, 16, 16), one,
                                     torch.zeros(1, 16, 4), one, one, nb=1,
                                     lag=0, transpose_lhs=True,
                                     dispatch="fuse")


def test_fused2_dispatch_rule():
    """The card's rule (PERF.md's table): fp32 fuses at every R, and so
    does bf16 with ``add``; bf16 forward fuses up to R = 2,048 and leaves
    wider pairs to two kernel-1 launches, which measure ~1.5% faster
    there."""
    f32, bf16 = torch.float32, torch.bfloat16
    want = {(f32, False): {32: "fused", 448: "fused", 512: "fused",
                           3072: "fused"},
            (f32, True): {128: "fused", 384: "fused", 1536: "fused"},
            (bf16, False): {32: "fused", 128: "fused", 384: "fused",
                            1536: "fused", 2048: "fused", 2049: "chain",
                            2304: "chain", 3072: "chain"},
            (bf16, True): {128: "fused", 384: "fused", 1536: "fused",
                           3072: "fused"}}
    for (dtype, add), cases in want.items():
        for r, branch in cases.items():
            assert tbd.fused2_dispatch(r, dtype, add=add) == branch, (
                dtype, add, r)
    assert tbd.fused2_dispatch(512, torch.float16, add=False) == "chain"


@pytest.mark.parametrize("r", [24, 512])
def test_fused_support_follows_the_dispatch_rule(rng, monkeypatch, r):
    """A fused support's forward and transpose-table backward take the
    branch ``fused2_dispatch`` picks for their R (fp32: the chain at 24,
    kernel 3 at 512, with and without ``add``); either way its outputs and
    gradients equal the unfused support's bit for bit."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    n = 96
    src = rng.integers(0, n, size=400)
    dst = np.clip(src + rng.integers(-20, 20, size=400), 0, n - 1)
    w = rng.random(400).astype(np.float32)
    flat = tbs.from_edges_flat(src, dst, w, n, 16, 16, device="cpu")
    fused = tbs.as_fused2(flat)
    assert isinstance(fused, tbs.Fused2FlatSupport) and fused.delay_t > 0
    assert tbs.as_fused2(fused) is fused
    passes = []
    plain = tbd.mix_flat2_plain
    monkeypatch.setattr(tbd, "mix_flat2_plain",
                        lambda *a, **k: passes.append(k["add"] is not None)
                        or plain(*a, **k))
    x_np = rng.normal(size=(n, r)).astype(np.float32)
    got = {}
    for name, sp in (("fused", fused), ("unfused", tbs.as_unfused(fused))):
        x = torch.as_tensor(x_np).requires_grad_(True)
        if name == "fused":
            o1, o2 = sp.mix2_2d(x)
        else:
            o1 = sp.mix_2d(x)
            o2 = sp.mix_2d(o1)
        (o1.square().sum() + (o2 * o2.detach().sign()).sum()).backward()
        got[name] = (o1.detach(), o2.detach(), x.grad)
    want = [add for add in (False, True)
            if tbd.fused2_dispatch(r, torch.float32, add=add) == "fused"]
    assert passes == want
    for a, b in zip(got["fused"], got["unfused"]):
        assert torch.equal(a, b)
