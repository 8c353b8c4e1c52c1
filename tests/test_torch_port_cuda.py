"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the fixture, so every worker collects the same tests). On a machine
with a card and nvcc:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port.) It adds
what ``chip_smoke.py`` does not cover: ragged R just below, at and above
every tile width ``tile_cols`` can pick (including R not a multiple of 8,
where the bf16 kernels copy x by element loads instead of TMA), rows with
no entries, kernel 3 in the transpose orientation, repeated bit for bit and
with an ``add`` one element into its storage, and the wrappers' refusals;
kernel 2 (the weight cotangent)
at ragged R on square, rectangular and tall blocks, per entry and in
storage order (bitwise against the per-entry result gathered); the hops'
backward on the card against the CPU's plain versions; kernels 4 and 5
(the padded form) at ragged R with both kinds of sentinel, kernel 4
bitwise against kernel 1 and kernel 5 against kernel 2 on
``as_flat_pallas`` tables, and the padded hop's backward.
"""

import dataclasses

import numpy as np
import pytest
import torch

from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tables(seed, nb, nbx, band, per_row=4):
    """Row-sorted (row, src, slot) int32 tables with empty rows visited by
    a dummy entry on the trailing zero block; returns them and n_live."""
    rng = np.random.default_rng(seed)
    rows, srcs = [], []
    for r in range(nb):
        cand = np.arange(max(0, r - band), min(nbx, r + band + 1))
        k = int(rng.integers(0, per_row + 1))
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
    return row[order], src[order], slot[order], n_live


def i32(a, dev):
    return torch.as_tensor(np.asarray(a, np.int32), device=dev)


def assert_close(got, want, summand=None):
    """fp32: rtol 1e-5 (atol 1e-5 of the largest value). bf16: one bf16
    ulp, plus one more of the value before ``summand`` was added, plus
    2^-16 of the largest value for the tensor cores' fp32 accumulation."""
    g, w = got.float(), want.float()
    scale = w.abs().max().clamp_min(1e-30)
    if got.dtype == torch.float32:
        tol = 1e-5 * w.abs() + 1e-5 * scale
    else:
        def ulp(v):
            return torch.exp2(torch.floor(torch.log2(v.clamp_min(1e-30))) - 7)
        tol = ulp(torch.maximum(g.abs(), w.abs())) + scale * 2.0 ** -16
        if summand is not None:
            tol = tol + ulp((w - summand.float()).abs())
    diff = (g - w).abs()
    assert bool((diff <= tol).all()), f"max |diff| {float(diff.max())}"


DTYPES = [torch.float32, torch.bfloat16]
# just below, at and above each bf16 tile width (64, 128, 256), R that are
# not multiples of 8 (no TMA for x), and 384 (three 128-column tiles)
R_CASES = [24, 63, 64, 65, 127, 128, 129, 130, 255, 256, 257, 384]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", R_CASES)
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", [(128, 128), (128, 512)],
                         ids=["sq", "rect"])
def test_kernel1_matches_plain(card, dtype, r, transpose_lhs, shape):
    bs_a, bs_b = shape
    bs_c, bs_o = (bs_a, bs_b) if transpose_lhs else (bs_b, bs_a)
    nb, nbx = 6, 5
    row, src, slot, n_live = tables(r, nb, nbx, band=2)
    gen = torch.Generator(device=card).manual_seed(r)
    blocks = torch.rand(n_live + 1, bs_a, bs_b, device=card,
                        generator=gen).to(dtype)
    blocks[n_live] = 0
    x = torch.randn(nbx, bs_c, r, device=card, generator=gen).to(dtype)
    args = (blocks, i32(slot, card), x, i32(src, card), i32(row, card))
    before = bd.LAUNCHES["gathered_block_mix_flat"]
    got = bd.gathered_block_mix_flat(*args, nb=nb,
                                     transpose_lhs=transpose_lhs)
    assert bd.LAUNCHES["gathered_block_mix_flat"] == before + 1
    want = bd.mix_flat_plain(*args, nb=nb, transpose_lhs=transpose_lhs)
    torch.cuda.synchronize()
    assert got.shape == (nb, bs_o, r) and got.dtype == dtype
    assert_close(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", R_CASES)
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("with_add", [None, "aligned", "offset"],
                         ids=["plain", "add", "add_offset"])
def test_kernel3_bitwise_two_kernel1(card, dtype, r, transpose_lhs,
                                     with_add):
    """``add_offset``: an add that is a view one element into its storage
    (not 4-byte aligned in bf16)."""
    nb = 9
    row, src, slot, n_live = tables(100 + r, nb, nb, band=3)
    gen = torch.Generator(device=card).manual_seed(r)
    blocks = (torch.rand(n_live + 1, 128, 128, device=card, generator=gen)
              / 16).to(dtype)
    blocks[n_live] = 0
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    add = None
    if with_add is not None:
        off = int(with_add == "offset")
        add = torch.randn(nb * 128 * r + off, device=card,
                          generator=gen).to(dtype)[off:].view(nb, 128, r)
    args = (blocks, i32(slot, card), x, i32(src, card), i32(row, card))
    before = bd.LAUNCHES["gathered_block_mix_flat2"]
    o1, o2 = bd.gathered_block_mix_flat2(
        *args, nb=nb, lag=bd.fused2_lag(row, src),
        transpose_lhs=transpose_lhs, add=add)
    assert bd.LAUNCHES["gathered_block_mix_flat2"] == before + 1
    c1 = bd.gathered_block_mix_flat(*args, nb=nb,
                                    transpose_lhs=transpose_lhs)
    if add is not None:
        c1 = c1 + add
    c2 = bd.gathered_block_mix_flat(blocks, args[1], c1, args[3], args[4],
                                    nb=nb, transpose_lhs=transpose_lhs)
    torch.cuda.synchronize()
    assert torch.equal(o1, c1) and torch.equal(o2, c2)
    p1, _ = bd.mix_flat2_plain(*args, nb=nb, transpose_lhs=transpose_lhs,
                               add=add)
    assert_close(o1, p1, summand=add)
    assert_close(o2, bd.mix_flat_plain(blocks, args[1], o1, args[3],
                                       args[4], nb=nb,
                                       transpose_lhs=transpose_lhs))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [24, 130, 256])
@pytest.mark.parametrize("shape", [(128, 128), (128, 512), (256, 64)],
                         ids=["sq", "rect", "tall"])
def test_kernel2_matches_plain(card, dtype, r, shape):
    """fp32 to rtol 1e-5 of the sum of |terms| (bf16 inputs multiply
    exactly in fp32, so the same bound holds for them)."""
    bs_x, bs_g = shape
    row, src, _, _ = tables(200 + r, 6, 5, band=2)
    gen = torch.Generator(device=card).manual_seed(r)
    x = torch.randn(5, bs_x, r, device=card, generator=gen).to(dtype)
    g = torch.randn(6, bs_g, r, device=card, generator=gen).to(dtype)
    args = (x, g, i32(src, card), i32(row, card))
    before = bd.LAUNCHES["gathered_block_outer_flat"]
    got = bd.gathered_block_outer_flat(*args)
    assert bd.LAUNCHES["gathered_block_outer_flat"] == before + 1
    want = bd.outer_flat_plain(*args)
    terms = bd.outer_flat_plain(x.abs(), g.abs(), *args[2:])
    torch.cuda.synchronize()
    assert got.shape == (len(row), bs_x, bs_g) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 * terms + 1e-30).all())
    again = bd.gathered_block_outer_flat(*args)
    assert torch.equal(got, again), "kernel 2 must be deterministic"


@pytest.mark.parametrize("out_dtype", DTYPES, ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [24, 130, 256])
@pytest.mark.parametrize("shape", [(128, 128), (128, 512), (256, 64)],
                         ids=["sq", "rect", "tall"])
def test_kernel2_storage_order_bitwise_gather(card, dtype, out_dtype, r,
                                              shape):
    """Kernel 2 with the storage slots equals its per-entry launch gathered
    by ``inv_slot`` (a zero row for the zero slot) and cast, bit for bit:
    the dummy entries, whose per-entry products are not zero, land nowhere
    and the zero slot's block is exact zeros (the output is allocated
    uninitialised)."""
    bs_x, bs_g = shape
    row, src, slot, n_live = tables(501 + r, 6, 5, band=2)
    assert (slot == n_live).any(), "the tables must hold dummy entries"
    gen = torch.Generator(device=card).manual_seed(r)
    x = torch.randn(5, bs_x, r, device=card, generator=gen).to(dtype)
    g = torch.randn(6, bs_g, r, device=card, generator=gen).to(dtype)
    args = (x, g, i32(src, card), i32(row, card))
    inv = np.zeros(n_live + 1, np.int64)
    inv[slot] = np.arange(len(slot))
    inv[n_live] = len(slot)
    before = bd.LAUNCHES["gathered_block_outer_flat"]
    got = bd.gathered_block_outer_flat(*args, slot=i32(slot, card),
                                       n_slots=n_live + 1,
                                       out_dtype=out_dtype)
    assert bd.LAUNCHES["gathered_block_outer_flat"] == before + 1
    per_entry = bd.gathered_block_outer_flat(*args)
    want = torch.cat([per_entry, per_entry.new_zeros((1, bs_x, bs_g))])
    want = want.index_select(0, torch.as_tensor(inv, device=card))
    torch.cuda.synchronize()
    assert got.shape == (n_live + 1, bs_x, bs_g) and got.dtype == out_dtype
    assert torch.equal(got, want.to(out_dtype))
    assert not got[n_live].any()
    assert per_entry[torch.as_tensor(slot == n_live, device=card)].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [130, 1536])
def test_kernel5_bitwise_kernel2_on_flat_tables(card, dtype, r):
    """A padded support's blocks cotangent (kernel 5, fp32 output) equals
    kernel 2 on ``as_flat_pallas``'s tables bit for bit: the same live
    products on the same tiles in the same R order; sentinel slots zero."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    n = 1024
    rng = np.random.default_rng(6)
    src = rng.integers(0, n, size=6000)
    dst = np.clip(src + rng.integers(-300, 300, size=6000), 0, n - 1)
    w = rng.random(6000).astype(np.float32)
    sp = tbs.from_edges_blocked(src, dst, w, n, 128, device=card)
    nb, mb = sp.block_idx.shape
    live = sp.block_idx < nb
    assert not live.all(), "the layout must leave sentinels"
    flat = tbs.as_flat_pallas(sp)
    gen = torch.Generator(device=card).manual_seed(r)
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    g = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    got = bd.gathered_block_outer(x, g, sp.block_idx,
                                  out_dtype=torch.float32)
    want = bd.gathered_block_outer_flat(
        x, g, flat.src_tbl, flat.row_tbl, slot=flat.slot_tbl,
        n_slots=flat.n_live + 1)
    torch.cuda.synchronize()
    assert torch.equal(got[live], want[:flat.n_live])
    assert not got[~live].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("shape", [(128, 128), (128, 512)],
                         ids=["sq", "rect"])
def test_kernel1_rows_without_entries(card, dtype, transpose_lhs, shape):
    """Rows that no entry names (no dummy entry either) come out zero; the
    others match the plain version."""
    bs_a, bs_b = shape
    bs_c = bs_a if transpose_lhs else bs_b
    nb, nbx, r = 7, 5, 200
    row, src, slot, n_live = tables(7, nb, nbx, band=2)
    # drop the dummy entries, and every entry of row 2
    keep = (slot < n_live) & (row != 2)
    row, src, slot = row[keep], src[keep], slot[keep]
    gen = torch.Generator(device=card).manual_seed(7)
    blocks = torch.rand(n_live, bs_a, bs_b, device=card,
                        generator=gen).to(dtype)
    x = torch.randn(nbx, bs_c, r, device=card, generator=gen).to(dtype)
    args = (blocks, i32(slot, card), x, i32(src, card), i32(row, card))
    got = bd.gathered_block_mix_flat(*args, nb=nb,
                                     transpose_lhs=transpose_lhs)
    want = bd.mix_flat_plain(*args, nb=nb, transpose_lhs=transpose_lhs)
    torch.cuda.synchronize()
    empty = torch.as_tensor(np.setdiff1d(np.arange(nb), row), device=card)
    assert not got[empty].any()
    assert_close(got, want)


@pytest.mark.parametrize("r", [512, 200], ids=["tma", "elementwise"])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
def test_kernel3_repeats_bit_for_bit(card, r, transpose_lhs):
    """Kernel 3 with add, five times in a row on the same inputs: every run
    bitwise equal to the first and to kernel 1 + add + kernel 1. Hop 2 reads
    out1 that other thread blocks write during the launch; a missing fence
    or flag shows as a run that differs."""
    nb = 48
    row, src, slot, n_live = tables(11, nb, nb, band=4, per_row=6)
    gen = torch.Generator(device=card).manual_seed(11)
    blocks = (torch.rand(n_live + 1, 128, 128, device=card, generator=gen)
              / 16).to(torch.bfloat16)
    blocks[n_live] = 0
    x = torch.randn(nb, 128, r, device=card,
                    generator=gen).to(torch.bfloat16)
    add = torch.randn(nb, 128, r, device=card,
                      generator=gen).to(torch.bfloat16)
    args = (blocks, i32(slot, card), x, i32(src, card), i32(row, card))
    lag = bd.fused2_lag(row, src)
    assert lag > 0
    runs = [bd.gathered_block_mix_flat2(*args, nb=nb, lag=lag,
                                        transpose_lhs=transpose_lhs, add=add)
            for _ in range(5)]
    c1 = bd.gathered_block_mix_flat(*args, nb=nb,
                                    transpose_lhs=transpose_lhs) + add
    c2 = bd.gathered_block_mix_flat(blocks, args[1], c1, args[3], args[4],
                                    nb=nb, transpose_lhs=transpose_lhs)
    torch.cuda.synchronize()
    for o1, o2 in runs:
        assert torch.equal(o1, c1) and torch.equal(o2, c2)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chained"])
def test_hop_backward_matches_cpu(card, fused):
    """dx and dblocks of both hops of a 128-block support on the card
    (kernels 1, 2, 3) against the CPU's plain versions."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    n = 1024
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, size=6000)
    dst = np.clip(src + rng.integers(-200, 200, size=6000), 0, n - 1)
    w = rng.random(6000).astype(np.float32)
    x_np = rng.normal(size=(n, 96)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        sp = tbs.as_fused2(tbs.from_edges_flat(src, dst, w, n, 128, 128,
                                               device=dev))
        assert isinstance(sp, tbs.Fused2FlatSupport) and sp.delay_t > 0
        if not fused:
            sp = dataclasses.replace(sp, delay_t=0, ring_w_t=0)
        blocks = sp.blocks_flat.clone().requires_grad_(True)
        sp = dataclasses.replace(sp, blocks_flat=blocks)
        x = torch.as_tensor(x_np, device=dev).requires_grad_(True)
        o1, o2 = sp.mix2_2d(x)
        (o1.square().sum() + (o2 * o2.detach().sign()).sum()).backward()
        grads[dev] = (x.grad.cpu(), blocks.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        # fp32 sums in another order: 1e-5 of the gradient's scale
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_cuda_tensors_never_take_the_plain_version(card):
    """On the card a wrapper launches its kernel or raises."""
    row, src, slot, n_live = tables(0, 4, 4, band=1)
    t = (i32(slot, card), i32(src, card), i32(row, card))
    x16 = torch.zeros(4, 128, 8, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bd.gathered_block_mix_flat(
            torch.zeros(n_live + 1, 128, 128, device=card,
                        dtype=torch.float16), t[0], x16, t[1], t[2], nb=4,
            transpose_lhs=True)
    with pytest.raises(ValueError, match="% 128"):
        bd.gathered_block_mix_flat(
            torch.zeros(n_live + 1, 16, 16, device=card), t[0],
            torch.zeros(4, 16, 8, device=card), t[1], t[2], nb=4,
            transpose_lhs=True)
    with pytest.raises(ValueError, match="128-row blocks"):
        bd.gathered_block_mix_flat2(
            torch.zeros(n_live + 1, 16, 16, device=card), t[0],
            torch.zeros(4, 16, 8, device=card), t[1], t[2], nb=4, lag=1,
            transpose_lhs=True)
    with pytest.raises(TypeError, match="x's dtype"):
        bd.gathered_block_mix_flat(
            torch.zeros(n_live + 1, 128, 128, device=card), t[0],
            torch.zeros(4, 128, 8, device=card, dtype=torch.bfloat16),
            t[1], t[2], nb=4, transpose_lhs=True)
    with pytest.raises(ValueError, match="% 128"):
        bd.gathered_block_outer_flat(
            torch.zeros(4, 64, 8, device=card),
            torch.zeros(4, 64, 8, device=card), t[1], t[2])
    odd = torch.zeros((n_live + 1) * 128 * 128 + 1, device=card,
                      dtype=torch.bfloat16)[1:].view(n_live + 1, 128, 128)
    with pytest.raises(ValueError, match="16-byte"):
        bd.gathered_block_mix_flat(
            odd, t[0], torch.zeros(4, 128, 8, device=card,
                                   dtype=torch.bfloat16),
            t[1], t[2], nb=4, transpose_lhs=True)


def padded_tables(seed, nb, nbx, mb, n_blocks):
    """(NB, MB) int64 slot/src tables: live slots first in every row (row 1
    has none), then sentinels of both kinds, the zero block-row ``nbx`` of
    x with a real slot and the zero block ``n_blocks`` with a real source."""
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", R_CASES)
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "dx"])
def test_kernel4_matches_plain(card, dtype, r, transpose_lhs):
    """Unpadded operands (the sentinels fall outside and are skipped) and
    the reference's padded ones (a zero block and row) give one result."""
    nb, nbx, mb, n_blocks = 6, 5, 4, 9
    slot, src = padded_tables(300 + r, nb, nbx, mb, n_blocks)
    gen = torch.Generator(device=card).manual_seed(r)
    blocks = (torch.rand(n_blocks + 1, 128, 128, device=card, generator=gen)
              / 16).to(dtype)
    blocks[n_blocks] = 0
    x = torch.randn(nbx + 1, 128, r, device=card, generator=gen).to(dtype)
    x[nbx] = 0
    tbl = (i32(slot, card).reshape(nb, mb), i32(src, card).reshape(nb, mb))
    before = bd.LAUNCHES["gathered_block_mix"]
    got = bd.gathered_block_mix(blocks[:n_blocks], tbl[0], x[:nbx], tbl[1],
                                transpose_lhs=transpose_lhs)
    padded = bd.gathered_block_mix(blocks, tbl[0], x, tbl[1],
                                   transpose_lhs=transpose_lhs)
    assert bd.LAUNCHES["gathered_block_mix"] == before + 2
    want = bd.mix_padded_plain(blocks, tbl[0], x, tbl[1],
                               transpose_lhs=transpose_lhs)
    torch.cuda.synchronize()
    assert got.shape == (nb, 128, r) and got.dtype == dtype
    assert torch.equal(got, padded)
    assert not got[1].any()
    assert_close(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "dx"])
def test_kernel4_bitwise_kernel1_on_flat_tables(card, dtype, transpose_lhs):
    """A padded support's hop equals kernel 1 on ``as_flat_pallas``'s
    tables bit for bit: the same live entries in the same order."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    n, r = 1024, 200
    rng = np.random.default_rng(4)
    src = rng.integers(0, n, size=6000)
    dst = np.clip(src + rng.integers(-300, 300, size=6000), 0, n - 1)
    w = rng.random(6000).astype(np.float32)
    sp = tbs.from_edges_blocked(src, dst, w, n, 128, device=card)
    sp = sp.astype(dtype)
    nb, mb = sp.block_idx.shape
    assert (sp.block_idx == nb).any(), "the layout must leave sentinels"
    flat = tbs.as_flat_pallas(sp)
    x = torch.randn(nb, 128, r, device=card,
                    generator=torch.Generator(device=card).manual_seed(0)
                    ).to(dtype)
    bflat = sp.blocks.reshape(nb * mb, 128, 128)
    if transpose_lhs:
        got = bd.gathered_block_mix(bflat, sp.slot, x, sp.block_idx,
                                    transpose_lhs=True)
        want = bd.gathered_block_mix_flat(
            flat.blocks_flat, flat.slot_tbl, x, flat.src_tbl, flat.row_tbl,
            nb=flat.nb, transpose_lhs=True, row_ptr=flat.row_ptr)
    else:
        got = bd.gathered_block_mix(bflat, sp.perm_t, x, sp.idx_t,
                                    transpose_lhs=False)
        want = bd.gathered_block_mix_flat(
            flat.blocks_flat, flat.slot_t, x, flat.src_t, flat.row_t,
            nb=flat.nb_t, transpose_lhs=False, row_ptr=flat.row_ptr_t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("out_dtype", DTYPES, ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("r", [24, 130, 256])
def test_kernel5_matches_plain(card, dtype, out_dtype, r):
    """fp32 sums to rtol 1e-5 of the sum of |terms|, plus one ulp of the
    output where it is bf16; sentinel slots exactly zero (the output is
    allocated uninitialised); a repeat bit-identical."""
    nb, mb = 6, 4
    slot, src = padded_tables(400 + r, nb, nb, mb, nb * mb)
    src = np.where(slot == nb * mb, nb, src)
    gen = torch.Generator(device=card).manual_seed(r)
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    g = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    tbl = i32(src, card).reshape(nb, mb)
    before = bd.LAUNCHES["gathered_block_outer"]
    got = bd.gathered_block_outer(x, g, tbl, out_dtype=out_dtype)
    assert bd.LAUNCHES["gathered_block_outer"] == before + 1
    want = bd.outer_padded_plain(x, g, tbl, out_dtype=torch.float32)
    terms = bd.outer_padded_plain(x.abs(), g.abs(), tbl,
                                  out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.shape == (nb, mb, 128, 128) and got.dtype == out_dtype
    tol = 1e-5 * terms + 1e-30
    if out_dtype == torch.bfloat16:
        mag = torch.maximum(got.float().abs(), want.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got.float() - want).abs() <= tol).all())
    sent = torch.as_tensor(src == nb, device=card)
    assert sent.any() and not got[sent].any()
    assert torch.equal(got, bd.gathered_block_outer(x, g, tbl,
                                                    out_dtype=out_dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_padded_hop_backward_matches_cpu(card, dtype):
    """Forward, dx and dblocks of a padded hop on the card (kernels 4 and
    5) against the CPU's plain versions, in the blocks' storage dtype."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    n = 1024
    rng = np.random.default_rng(5)
    src = rng.integers(0, n, size=6000)
    dst = np.clip(src + rng.integers(-200, 200, size=6000), 0, n - 1)
    w = rng.random(6000).astype(np.float32)
    x_np = rng.normal(size=(n, 96)).astype(np.float32)
    g_np = rng.normal(size=(n, 96)).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        sp = tbs.as_pallas(tbs.from_edges_blocked(src, dst, w, n, 128,
                                                  device=dev)).astype(dtype)
        blocks = sp.blocks.clone().requires_grad_(True)
        x = torch.as_tensor(x_np, device=dev).to(dtype).requires_grad_(True)
        out = dataclasses.replace(sp, blocks=blocks).mix_2d(x)
        out.backward(torch.as_tensor(g_np, device=dev).to(dtype))
        res[dev] = [t.float().cpu() for t in (out.detach(), x.grad,
                                              blocks.grad)]
        assert blocks.grad.dtype == dtype
    for got, want in zip(res["cuda"], res["cpu"]):
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
        else:   # bf16 rounds at other places on the CPU
            torch.testing.assert_close(got, want, rtol=2e-2,
                                       atol=2e-2 * float(want.abs().max()))


def test_padded_wrappers_launch_or_raise(card):
    tbl = torch.zeros(4, 2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="% 128"):
        bd.gathered_block_mix(torch.zeros(2, 16, 16, device=card), tbl,
                              torch.zeros(4, 16, 8, device=card), tbl,
                              transpose_lhs=True)
    with pytest.raises(TypeError, match="x's dtype"):
        bd.gathered_block_mix(
            torch.zeros(2, 128, 128, device=card), tbl,
            torch.zeros(4, 128, 8, device=card, dtype=torch.bfloat16), tbl,
            transpose_lhs=True)
    with pytest.raises(ValueError, match="% 128"):
        bd.gathered_block_outer(torch.zeros(4, 64, 8, device=card),
                                torch.zeros(4, 64, 8, device=card), tbl,
                                out_dtype=torch.float32)
    with pytest.raises(TypeError, match="g .* must be in x's dtype"):
        bd.gathered_block_outer(
            torch.zeros(4, 128, 8, device=card),
            torch.zeros(4, 128, 8, device=card, dtype=torch.bfloat16), tbl,
            out_dtype=torch.float32)
    with pytest.raises(TypeError, match="out_dtype"):
        bd.gathered_block_outer(torch.zeros(4, 128, 8, device=card),
                                torch.zeros(4, 128, 8, device=card), tbl,
                                out_dtype=torch.float16)
