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
with an ``add`` one element into its storage, its ``dispatch`` branches
bit for bit (``"auto"`` launching what ``fused2_dispatch`` picks), and the
wrappers' refusals;
kernel 2 (the weight cotangent)
at ragged R on square, rectangular and tall blocks, per entry and in
storage order (bitwise against the per-entry result gathered); the hops'
backward on the card against the CPU's plain versions; kernels 4 and 5
(the padded form) at ragged R with both kinds of sentinel, kernel 4
bitwise against kernel 1 and kernel 5 against kernel 2 on
``as_flat_pallas`` tables, and the padded hop's backward. And the fused
train steps as CUDA graphs: S graphed steps of a small dense model and of a
2,048-node flat city model (kernels 1, 2 and 3 inside the graph) bit for
bit equal to S eager steps, with the dropout stream, Adam's state and the
BatchNorm buffers; a graphed eval pass equal to eager eval steps; and a
capture that fails raises instead of running the steps eagerly. And the
kernels as ``torch.library`` ops: ``opcheck`` of each on CUDA tensors, a
2,048-node exported city artifact (flat with the masked adaptive
adjacency, and padded) bit for bit against its Forecaster, and rolling and
autoregressive forecasts, replayed graphs, bit for bit against eager
predicts. And the span store's clock against the profiler's device clock.
And the channel projection kernel (``csrc/chan_proj.cu``): every width the
model runs against the fp32 chain at ragged rows (forward, each operand's
gradient, the weight's and the bias's), a replayed graph against eager,
2,048-node city and 207-node METR bf16 steps against the chain within the
benchmark's ``grad_gap`` limits and both against the fp32 model's step,
every projection launching the kernel, the fp32 call sites bit for bit
against their old chains, and ``opcheck`` of its three ops.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd
from graph_wavenet_tpu_torch.ops.cuda import build, chan_proj

pytestmark = pytest.mark.cuda


def block_launches() -> dict:
    """The five block kernels' launch counts."""
    return {k: build.LAUNCHES[k] for k in bd.OPS}


def proj_launches() -> dict:
    """The projection kernel's launch counts, by op."""
    return {k: build.LAUNCHES[k] for k in chan_proj.OPS}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with a fixed workspace, set before the process's first matmul
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    before = build.LAUNCHES["mix_flat"]
    got = bd.gathered_block_mix_flat(*args, nb=nb,
                                     transpose_lhs=transpose_lhs)
    assert build.LAUNCHES["mix_flat"] == before + 1
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
    before = build.LAUNCHES["mix_flat2"]
    o1, o2 = bd.gathered_block_mix_flat2(
        *args, nb=nb, lag=bd.fused2_lag(row, src),
        transpose_lhs=transpose_lhs, add=add, dispatch="fused")
    assert build.LAUNCHES["mix_flat2"] == before + 1
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
@pytest.mark.parametrize("r", [96, 384, 520])
@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "add"])
def test_kernel3_dispatch_branches_agree(card, dtype, r, with_add):
    """``dispatch="chain"`` and ``"fused"`` give the same bits; ``"auto"``
    launches what ``fused2_dispatch`` picks: kernel 3 once, or kernel 1
    twice."""
    nb = 9
    row, src, slot, n_live = tables(300 + r, nb, nb, band=3)
    gen = torch.Generator(device=card).manual_seed(r)
    blocks = (torch.rand(n_live + 1, 128, 128, device=card, generator=gen)
              / 16).to(dtype)
    blocks[n_live] = 0
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    add = (torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
           if with_add else None)
    args = (blocks, i32(slot, card), x, i32(src, card), i32(row, card))
    outs, launches = {}, {}
    for d in bd.DISPATCHES:
        before = block_launches()
        outs[d] = bd.gathered_block_mix_flat2(
            *args, nb=nb, lag=bd.fused2_lag(row, src), transpose_lhs=True,
            add=add, dispatch=d)
        launches[d] = {k: build.LAUNCHES[k] - before[k]
                       for k in ("mix_flat", "mix_flat2")}
    torch.cuda.synchronize()
    for d in ("chain", "auto"):
        assert all(torch.equal(a, b) for a, b in zip(outs[d], outs["fused"]))
    assert launches["fused"] == {"mix_flat": 0, "mix_flat2": 1}
    assert launches["chain"] == {"mix_flat": 2, "mix_flat2": 0}
    pick = bd.fused2_dispatch(r, dtype, add=with_add)
    assert launches["auto"] == launches[pick]


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
    before = build.LAUNCHES["outer_flat"]
    got = bd.gathered_block_outer_flat(*args)
    assert build.LAUNCHES["outer_flat"] == before + 1
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
    before = build.LAUNCHES["outer_flat"]
    got = bd.gathered_block_outer_flat(*args, slot=i32(slot, card),
                                       n_slots=n_live + 1,
                                       out_dtype=out_dtype)
    assert build.LAUNCHES["outer_flat"] == before + 1
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
                                        transpose_lhs=transpose_lhs, add=add,
                                        dispatch="fused")
            for _ in range(5)]
    c1 = bd.gathered_block_mix_flat(*args, nb=nb,
                                    transpose_lhs=transpose_lhs) + add
    c2 = bd.gathered_block_mix_flat(blocks, args[1], c1, args[3], args[4],
                                    nb=nb, transpose_lhs=transpose_lhs)
    torch.cuda.synchronize()
    for o1, o2 in runs:
        assert torch.equal(o1, c1) and torch.equal(o2, c2)


def kernel3_case(card, dtype, r, kind, seed):
    """Square-block tables of one of three orders, their blocks and x:
    ``lag0`` (every entry on the diagonal, lag 0), ``band`` (a band of
    five block rows each side, the 40,960-node city's RCM lag), and
    ``shuffled`` (the band's block rows renumbered by a random permutation,
    entries re-sorted by row: lag >= nb / 2)."""
    nb = 24
    rng = np.random.default_rng(seed)
    if kind == "lag0":
        row = src = np.arange(nb)
        slot, n_live = rng.permutation(nb), nb
    else:
        row, src, slot, n_live = tables(seed, nb, nb, band=5, per_row=6)
        if kind == "shuffled":
            perm = rng.permutation(nb)
            row, src = perm[row], perm[src]
            order = np.argsort(row, kind="stable")
            row, src, slot = row[order], src[order], slot[order]
    gen = torch.Generator(device=card).manual_seed(seed)
    blocks = (torch.rand(n_live + 1, 128, 128, device=card, generator=gen)
              / 16).to(dtype)
    blocks[n_live] = 0
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    return nb, (blocks, i32(slot, card), x, i32(src, card), i32(row, card))


def chain_of(args, nb, transpose_lhs, add=None):
    """Kernel 1, ``+ add``, kernel 1: what kernel 3 equals bit for bit."""
    c1 = bd.gathered_block_mix_flat(*args, nb=nb, transpose_lhs=transpose_lhs)
    if add is not None:
        c1 = c1 + add
    return c1, bd.gathered_block_mix_flat(args[0], args[1], c1, args[3],
                                          args[4], nb=nb,
                                          transpose_lhs=transpose_lhs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["lag0", "band", "shuffled"])
@pytest.mark.parametrize("r", [64, 200, 768])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "add"])
def test_kernel3_bitwise_at_every_lag(card, dtype, kind, r, transpose_lhs,
                                      with_add):
    """Kernel 3 bit for bit kernel 1 + add + kernel 1 whatever the tables'
    lag: 0, the city's 5, and a random block order whose lag is at least
    half the rows (then hop 2 waits on rows published far apart in ticket
    order). 768 columns of bf16 give three 256-column tiles a row, so the
    24 rows' 144 items outnumber the persistent grid's blocks."""
    nb, args = kernel3_case(card, dtype, r, kind, seed=400 + r)
    lag = bd.fused2_lag(args[4].cpu(), args[3].cpu())
    assert lag == {"lag0": 0, "band": 5}.get(kind, lag)
    if kind == "shuffled":
        assert lag >= nb // 2
    add = (torch.randn(nb, 128, r, device=card).to(dtype) if with_add
           else None)
    o1, o2 = bd.gathered_block_mix_flat2(*args, nb=nb, lag=lag,
                                         transpose_lhs=transpose_lhs,
                                         add=add, dispatch="fused")
    c1, c2 = chain_of(args, nb, transpose_lhs, add)
    torch.cuda.synchronize()
    assert torch.equal(o1, c1) and torch.equal(o2, c2)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
def test_kernel3_rows_without_entries(card, dtype, transpose_lhs):
    """Rows no entry names (no dummy entry either): hop 1 still publishes
    their (zero) out1 tiles, so the hop-2 rows that read them finish, and
    both outputs equal the chain's, the empty rows zero in out2."""
    nb, r = 12, 300
    row, src, slot, n_live = tables(17, nb, nb, band=3)
    keep = (slot < n_live) & (row != 4) & (row != 5)
    row, src, slot = row[keep], src[keep], slot[keep]
    gen = torch.Generator(device=card).manual_seed(17)
    blocks = (torch.rand(n_live, 128, 128, device=card, generator=gen)
              / 16).to(dtype)
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    args = (blocks, i32(slot, card), x, i32(src, card), i32(row, card))
    o1, o2 = bd.gathered_block_mix_flat2(*args, nb=nb,
                                         lag=bd.fused2_lag(row, src),
                                         transpose_lhs=transpose_lhs,
                                         dispatch="fused")
    c1, c2 = chain_of(args, nb, transpose_lhs)
    torch.cuda.synchronize()
    assert torch.equal(o1, c1) and torch.equal(o2, c2)
    empty = torch.as_tensor(np.setdiff1d(np.arange(nb), row), device=card)
    assert len(empty) >= 2 and not o2[empty].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("grid", [1, 3, None], ids=["g1", "g3", "full"])
@pytest.mark.parametrize("slack", [0, 2, None], ids=["s0", "s2", "serial"])
def test_kernel3_any_grid_and_span(card, dtype, grid, slack):
    """The schedule's claim, through the C entry point: any grid that
    fits the card (one block doing every item in ticket order, a few, as
    many as the card holds at once or one per item if fewer) and
    any span from the lag (no slack) to nb (every hop 1 before any hop 2)
    finishes and gives the chain's bits, with add."""
    r = 384
    nb, args = kernel3_case(card, dtype, r, "shuffled", seed=23)
    blocks, slot, x, src, row = args
    lag = bd.fused2_lag(row.cpu(), src.cpu())
    add = torch.randn(nb, 128, r, device=card).to(dtype)
    ct = bd.tile_cols(r, dtype)
    items = 2 * nb * -(-r // ct)
    span = nb if slack is None else min(lag + slack, nb)
    grid = grid or min(items, bd.resident(x, ct))
    o1, o2 = torch.empty_like(x), torch.empty_like(x)
    flags = torch.zeros(bd.flag_count(nb, r, dtype), dtype=torch.int32,
                        device=card)
    build.launch("mix_flat2.cu", "gwt_mix_flat2", bd.mix_flat2_desc(
        blocks, slot, x, src, bd.row_pointer(row, nb), add, o1, o2, flags,
        nb, span, True, ct, grid), x.device)
    c1, c2 = chain_of(args, nb, True, add)
    torch.cuda.synchronize()
    assert torch.equal(o1, c1) and torch.equal(o2, c2)
    # every block's first ticket is its index; the counter handed out the
    # rest and one past the last item to every block
    assert int(flags[-1]) == items
    assert bool((flags[:-1] == 1).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel3_ten_launches_and_a_replayed_graph(card, dtype):
    """Ten launches in a row on the city's band, then one launch captured
    in a CUDA graph and replayed five times: every output bit for bit the
    chain's (the flags and the ticket counter are zeroed inside the op, so
    a replay starts from zero too)."""
    r = 1536
    nb, args = kernel3_case(card, dtype, r, "band", seed=31)
    lag = bd.fused2_lag(args[4].cpu(), args[3].cpu())
    add = torch.randn(nb, 128, r, device=card).to(dtype)

    def k3():
        return bd.gathered_block_mix_flat2(*args, nb=nb, lag=lag,
                                           transpose_lhs=True, add=add,
                                           dispatch="fused")

    c1, c2 = chain_of(args, nb, True, add)
    runs = [k3() for _ in range(10)]
    torch.cuda.synchronize()
    for o1, o2 in runs:
        assert torch.equal(o1, c1) and torch.equal(o2, c2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        k3()                      # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = build.LAUNCHES["mix_flat2"]
    with torch.cuda.graph(graph):
        g1, g2 = k3()
    assert build.LAUNCHES["mix_flat2"] == before + 1
    for _ in range(5):
        g1.zero_()
        g2.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g1, c1) and torch.equal(g2, c2)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "chained"])
def test_hop_backward_matches_cpu(card, fused):
    """dx and dblocks of both hops of a 128-block support on the card
    (kernels 1, 2, 3: fp32 R = 512 is inside kernel 3's range of the
    dispatch rule, forward and over the transpose tables) against the
    CPU's plain versions."""
    from graph_wavenet_tpu_torch.ops import block_sparse as tbs

    n = 1024
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, size=6000)
    dst = np.clip(src + rng.integers(-200, 200, size=6000), 0, n - 1)
    w = rng.random(6000).astype(np.float32)
    r = 512
    assert all(bd.fused2_dispatch(r, torch.float32, add=a) == "fused"
               for a in (False, True))
    x_np = rng.normal(size=(n, r)).astype(np.float32)
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
            transpose_lhs=True, dispatch="fused")
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
    before = build.LAUNCHES["mix_padded"]
    got = bd.gathered_block_mix(blocks[:n_blocks], tbl[0], x[:nbx], tbl[1],
                                transpose_lhs=transpose_lhs)
    padded = bd.gathered_block_mix(blocks, tbl[0], x, tbl[1],
                                   transpose_lhs=transpose_lhs)
    assert build.LAUNCHES["mix_padded"] == before + 2
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
    before = build.LAUNCHES["outer_padded"]
    got = bd.gathered_block_outer(x, g, tbl, out_dtype=out_dtype)
    assert build.LAUNCHES["outer_padded"] == before + 1
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


# ---------------------------------------------------------------------------
# the fused train steps as CUDA graphs
# ---------------------------------------------------------------------------

def step_state(engine) -> dict:
    """Everything a train step changes: the module's state (BatchNorm
    buffers included), Adam's moments and step counts, the dropout
    generator."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in engine.model.state_dict().items()}
    for i, st in engine.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    out["generator"] = engine.generator.get_state()
    return out


def assert_same_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), (
            f"{k}: max |diff| "
            f"{(got[k].double() - want[k].double()).abs().max().item()}")


def dense_setup(card, dtype, seed=0, remat=False):
    """A small dense METR model with dropout, its resident data and two
    engines from one seed."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    n = 40
    rng = np.random.default_rng(seed)
    a = rng.random((2, n, n)).astype(np.float32)
    sups = [torch.as_tensor(m / m.sum(-1, keepdims=True), device=card)
            for m in a]
    series = torch.as_tensor(rng.normal(size=(96, n, 2)).astype(np.float32),
                             device=card)
    cfg = ModelConfig(num_nodes=n, residual_channels=16, dilation_channels=16,
                      skip_channels=32, end_channels=64, blocks=2, layers=2,
                      dropout=0.3, n_supports=2, dtype=dtype, remat=remat)
    tc = TrainConfig(lr_decay=0.5, lr_decay_every=1)
    engines = [Engine(cfg, tc, StandardScaler(0.0, 1.0), device=card,
                      seed=seed, steps_per_epoch=2, aptinit=a[0])
               for _ in range(2)]
    return engines, sups, series


@pytest.mark.parametrize("feed,dtype,remat", [
    ("resident", "float32", False), ("resident", "bfloat16", False),
    ("windows", "float32", False), ("windows", "bfloat16", False),
    ("resident", "bfloat16", True)])
def test_graphed_dense_steps_equal_eager(card, feed, dtype, remat):
    """Two fused calls of S = 3 steps (the first warms up, captures and
    replays twice; the second replays three times, across a learning-rate
    decay) against six eager steps on the same batches: metrics and state
    bit for bit, dropout included; with remat too (its recompute touches
    no RNG, so it captures)."""
    from graph_wavenet_tpu_torch.data.device_loader import gather_window_rows

    (eager, graphed), sups, series = dense_setup(card, dtype, remat=remat)
    rng = np.random.default_rng(1)
    s, b = 3, 4
    if feed == "resident":
        starts = torch.arange(series.shape[0] - 24, device=card)
        xs = gather_window_rows(series, starts, 12)
        ys = gather_window_rows(series, starts + 12, 12) * 5 + 50
        idx = rng.integers(0, xs.shape[0], size=(2, s, b)).astype(np.int32)

        def batch(sel):
            return xs.index_select(0, sel), ys.index_select(0, sel)

        def fused(sel):
            return graphed.train_steps_resident(xs, ys, sel, sups)
    else:
        y_series = series * 5 + 50
        idx = rng.integers(11, series.shape[0] - 12,
                           size=(2, s, b)).astype(np.int32)

        def batch(a):
            return (gather_window_rows(series, a - 11, 12),
                    gather_window_rows(y_series, a + 1, 12))

        def fused(a):
            return graphed.train_steps_windows(series, a, 12, 12, 1, sups,
                                               y_series=y_series)
    for call in range(2):
        got = fused(idx[call])
        want = [eager.train_step(*batch(torch.as_tensor(r, device=card)),
                                 sups) for r in idx[call]]
        for k in ("loss", "mape", "rmse"):
            assert got[k].shape == (s,)
            assert torch.equal(got[k], torch.stack([m[k] for m in want])), k
        assert_same_state(step_state(graphed), step_state(eager))
    (g,) = graphed.step_graphs()
    assert g.replays == 2 * s - 1 and graphed.step == eager.step == 2 * s
    assert not any(g.launches.values())       # no block kernel here


def test_graphed_eval_equals_eager(card):
    (engine, _), sups, series = dense_setup(card, "bfloat16")
    idx = np.random.default_rng(2).integers(11, series.shape[0] - 12,
                                            size=(5, 4)).astype(np.int32)
    y_series = series * 5 + 50
    got = engine.eval_steps_windows(series, idx, 12, 12, 1, sups,
                                    y_series=y_series)
    again = engine.eval_steps_windows(series, idx, 12, 12, 1, sups,
                                      y_series=y_series)
    from graph_wavenet_tpu_torch.data.device_loader import gather_window_rows

    for k in ("loss", "mape", "rmse"):
        want = torch.stack([engine.eval_step(
            gather_window_rows(series, a - 11, 12),
            gather_window_rows(y_series, a + 1, 12), sups)[k]
            for a in torch.as_tensor(idx, device=card)])
        assert torch.equal(got[k], want) and torch.equal(again[k], want), k


def test_graphed_city_steps_equal_eager(card):
    """S = 3 graphed steps of the 2,048-node fp32 city model (flat
    supports and the adaptive mask, dropout on) against three eager steps,
    bit for bit, without deterministic algorithms: the adaptive softmax's
    segment sums and its gathers' backward run in a fixed order
    (``ops.adaptive_block``), so nothing accumulates with atomics. Kernels
    1, 2 and 3 run inside the graph: its per-replay launches equal an
    eager step's. fp32 sends every order-2 pair of a fused support to
    kernel 3, so the second support is given unfused (the same function
    bit for bit), whose hops run kernel 1."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.graphs.spatial import knn_graph_edges
    from graph_wavenet_tpu_torch.ops.block_sparse import as_unfused
    from graph_wavenet_tpu_torch.train.engine import Engine

    n = 2048
    pos = np.random.default_rng(0).random((n, 2))
    src, dst, w = knn_graph_edges(pos, 8)
    sup, mask, _ = build_city_supports(src, dst, w, n, pos=pos,
                                       ordering="rcm", form="flat",
                                       addaptadj=True, device=card)
    sups = [sup[0], as_unfused(sup[1]), mask]
    cfg = ModelConfig(num_nodes=n, addaptadj=True, dropout=0.3)
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.normal(size=(6, 12, n, 2)).astype(np.float32),
                         device=card)
    ys = torch.as_tensor(rng.normal(50, 10, size=(6, 12, n, 2)).astype(
        np.float32), device=card)
    idx = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    eager, graphed = (Engine(cfg, TrainConfig(), StandardScaler(50, 10),
                             device=card, seed=0) for _ in range(2))
    launches = []
    want = []
    for r in torch.as_tensor(idx, device=card):
        build.reset_launch_counts()
        want.append(eager.train_step(xs.index_select(0, r),
                                     ys.index_select(0, r), sups))
        launches.append(block_launches())
    got = graphed.train_steps_resident(xs, ys, idx, sups)
    torch.cuda.synchronize()
    assert torch.equal(got["loss"], torch.stack([m["loss"] for m in want]))
    assert_same_state(step_state(graphed), step_state(eager))
    (g,) = graphed.step_graphs()
    assert g.launches == launches[0] and g.replays == 2
    for k in ("mix_flat", "mix_flat2", "outer_flat"):
        assert g.launches[k] > 0, k


@pytest.mark.parametrize("how", ["raise", "sync"])
def test_capture_failure_raises_and_runs_no_step_eagerly(card, how):
    """A step that fails under capture (an error, or a host sync, which a
    capture refuses) makes the fused call raise after the warm-up step:
    no eager step runs in the captured steps' place."""
    (engine, _), sups, series = dense_setup(card, "float32")
    xs = series[None].expand(4, -1, -1, -1)[:, :12].contiguous()
    core = engine._train_core

    def failing(x, y, s):
        m = core(x, y, s)
        if torch.cuda.is_current_stream_capturing():
            if how == "raise":
                raise RuntimeError("injected capture failure")
            m[0].item()
        return m

    engine._train_core = failing
    idx = np.array([[0, 1], [2, 3], [1, 2]], np.int32)
    with pytest.raises(RuntimeError):
        engine.train_steps_resident(xs, xs, idx, sups)
    assert engine.step == 1 and not engine.step_graphs()
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the kernels as ops; export and the replayed forecasts
# ---------------------------------------------------------------------------

def op_case(name, card):
    """Arguments of one kernel op at small card shapes (128x128 blocks,
    R = 24, bf16 blocks for the mixes)."""
    ops = torch.ops.gwt_torch
    row, src, slot, n_live = tables(4, 6, 6, band=1)
    row, src, slot = (i32(a, card) for a in (row, src, slot))
    rng = np.random.default_rng(5)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=card).to(dtype)

    blocks = rand(n_live + 1, 128, 128)
    blocks[n_live] = 0
    x = rand(6, 128, 24)
    ptr = bd.row_pointer(row, 6)
    if name == "mix_flat":
        return ops.mix_flat, (blocks, slot, x, src, row, ptr, 6, True)
    if name == "mix_flat2":
        lag = bd.fused2_lag(row.cpu(), src.cpu())
        return ops.mix_flat2, (blocks, slot, x, src, row, ptr,
                               rand(6, 128, 24), 6, lag, True)
    if name == "outer_flat":
        return ops.outer_flat, (x, rand(6, 128, 24), src, row, None, None,
                                None)
    if name == "outer_flat_slots":
        return ops.outer_flat, (x, rand(6, 128, 24), src, row, slot,
                                n_live + 1, torch.bfloat16)
    tbl = i32(np.array([[0, 1], [2, 3], [1, 4], [5, 6]]), card)
    pblocks = rand(8, 128, 128)
    if name == "mix_padded":
        return ops.mix_padded, (pblocks, tbl, rand(4, 128, 24), tbl % 4,
                                True)
    return ops.outer_padded, (rand(4, 128, 24), rand(4, 128, 24), tbl % 4,
                              torch.float32)


@pytest.mark.parametrize("name", ["mix_flat", "mix_flat2", "outer_flat",
                                  "outer_flat_slots", "mix_padded",
                                  "outer_padded"])
def test_kernel_ops_pass_opcheck_on_the_card(card, name):
    """Each kernel's op on CUDA tensors: schema, autograd registration,
    fake kernel (shapes, dtypes and strides against the launched kernel's
    output) and AOT dispatch with dynamic shapes."""
    op, args = op_case(name, card)
    torch.library.opcheck(op, args)


def city_forecaster(card, form, addaptadj, n=2048):
    """A 2,048-node bf16 city Forecaster of random weights (seed 0) in
    original node order, its supports built under ``form``."""
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.graphs.spatial import knn_graph_edges
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.train.serving import Forecaster

    pos = np.random.default_rng(0).random((n - 37, 2))
    src, dst, w = knn_graph_edges(pos, 8)
    sup, mask, layout = build_city_supports(
        src, dst, w, n - 37, pos=pos, ordering="rcm", form=form,
        addaptadj=addaptadj, device=card)
    sups = [s.astype(torch.bfloat16) for s in sup]
    cfg = ModelConfig(num_nodes=layout["n_pad"], addaptadj=addaptadj,
                      dtype="bfloat16")
    return Forecaster(cfg, GWNet(cfg, device=card, seed=0),
                      sups + ([mask] if addaptadj else []),
                      StandardScaler(50.0, 10.0), node_layout=layout)


@pytest.mark.parametrize("form,addaptadj", [("flat", True),
                                            ("pallas", False)])
def test_exported_city_artifact_equals_forecaster(card, tmp_path, form,
                                                  addaptadj):
    """A 2,048-node bf16 city artifact (flat supports with the masked
    adaptive adjacency; padded supports) at batch 2 predicts what the
    Forecaster predicts, bit for bit (deterministic algorithms: the
    adaptive softmax's index_add_), with the same hand-kernel launches; its
    bf16 constants load on the 16-byte boundaries the kernels need."""
    from graph_wavenet_tpu_torch.train import serving

    fc = city_forecaster(card, form, addaptadj)
    path = str(tmp_path / "city.pt2")
    serving.export_forecaster(fc, path, batch_size=2)
    art = serving.load_exported_forecaster(path)
    assert art.device.type == "cuda"
    ep = torch.export.load(path)
    assert not [k for k, t in ep.constants.items()
                if torch.is_tensor(t) and t.data_ptr() % 16]
    x = torch.randn(2, 12, fc.input_nodes, 2, device=card,
                    generator=torch.Generator(card).manual_seed(1))
    torch.use_deterministic_algorithms(True)
    try:
        build.reset_launch_counts()
        want = fc.predict(x)
        torch.cuda.synchronize()
        live = block_launches()
        build.reset_launch_counts()
        got = art.predict(x)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, want)
    assert block_launches() == live
    # the flat supports' pairs go where the dispatch rule sends the first
    # layer's (R = 2 x 12 x 32)
    kernel = "mix_padded" if form == "pallas" else (
        "mix_flat2" if bd.fused2_dispatch(768, torch.bfloat16, add=False)
        == "fused" else "mix_flat")
    assert live[kernel] > 0


def test_rolling_forecast_graphed_equals_eager(card):
    """A rolling forecast over 6 origins of the 2,048-node flat model: the
    replayed graph equals ``predict`` on each window bit for bit, in the
    first call (warm-up, capture, replays) and in a second one (replays
    only); a replay launches what one predict launches."""
    from graph_wavenet_tpu_torch.train import serving

    fc = city_forecaster(card, "flat", False)
    history = torch.randn(17, fc.input_nodes, 2, device=card,
                          generator=torch.Generator(card).manual_seed(2))
    build.reset_launch_counts()
    want = torch.stack([fc.predict(history[None, k:k + 12])[0]
                        for k in range(6)])
    one = {k: v // 6 for k, v in block_launches().items()}
    for call in (1, 2):
        got = serving.rolling_forecast(fc, history, 12)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
    (g,) = fc.step_graphs()
    assert g.launches == one and g.replays == 5 + 6
    assert one["mix_flat2"] > 0


def test_autoregressive_forecast_graphed_equals_eager(card):
    """Three replayed rounds with ``future_aux`` on the 2,048-node flat
    model with the masked adaptive adjacency (deterministic algorithms)
    against the same rounds run eagerly: bit for bit, round 1 equal to
    ``predict``; a second call on the same inputs replays all three."""
    from graph_wavenet_tpu_torch.train import serving

    fc = city_forecaster(card, "flat", True)
    gen = torch.Generator(card).manual_seed(3)
    n = fc.input_nodes
    x = torch.randn(1, 12, n, 2, device=card, generator=gen)
    aux = torch.rand(1, 36, n, 1, device=card, generator=gen)
    torch.use_deterministic_algorithms(True)
    try:
        state, want = x.clone(), []
        for k in range(3):
            pred = fc.predict(state)
            new = torch.cat([((pred - fc.scaler.mean) / fc.scaler.std)[
                ..., None], aux[:, 12 * k:12 * k + 12]], -1)
            state = torch.cat([state[:, 12:], new], 1)
            want.append(pred)
        want = torch.cat(want, 1)
        for _ in range(2):
            got = serving.autoregressive_forecast(fc, x, 3, future_aux=aux)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        assert torch.equal(got[:, :12], fc.predict(x))
    finally:
        torch.use_deterministic_algorithms(False)
    (g,) = fc.step_graphs()
    assert g.replays == 2 + 3


# ---------------------------------------------------------------------------
# the parallel layer on the card (ranks as subprocesses sharing it)
# ---------------------------------------------------------------------------

DIST_CHILD = r'''
import json, os, sys
import numpy as np
import torch
from graph_wavenet_tpu_torch.config import MeshConfig
from graph_wavenet_tpu_torch.ops.cuda import block_diffusion as bd, build
from graph_wavenet_tpu_torch.parallel import collectives, multihost, sparse_tp
from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

mode, rank, world, init, out = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.backends.cuda.matmul.allow_tf32 = False
multihost.initialize("gloo" if mode == "gloo2" else "nccl", rank, world,
                     init, device="cuda", timeout_s=300)
dev = multihost.rank_device("cuda")
res = {}
if mode == "gloo2":
    mesh = make_mesh(MeshConfig(model_axis=world), dev)
    g = mesh.model_group
    x = torch.arange(6.0, device=dev).reshape(3, 2) + 10 * rank
    res["gather"] = collectives.all_gather_rows(x, g).cpu().tolist()
    prev, nxt = collectives.neighbour_exchange(x, g, mesh.model_ranks)
    res["exchange"] = [prev.cpu().tolist(), nxt.cpu().tolist()]
    v = torch.full((3,), float(rank + 1), device=dev, requires_grad=True)
    (collectives.all_sum(v, g) * (rank + 1)).sum().backward()
    res["all_sum_grad"] = v.grad.cpu().tolist()
    z = (torch.arange(8.0, device=dev).reshape(4, 2) + 10 * rank
         ).requires_grad_(True)
    rs = collectives.reduce_scatter_rows(z, g)
    (rs * (rank + 1)).sum().backward()
    res["reduce_scatter"] = rs.detach().cpu().tolist()
    res["reduce_scatter_grad"] = z.grad.cpu().tolist()
    from graph_wavenet_tpu_torch.graphs import spatial
    rng = np.random.default_rng(0)
    n = 2048
    src, dst, w = spatial.knn_graph_edges(rng.random((n, 2)), 4)
    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    perm = rcm_order_edges(src, dst, n)
    flat = spatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form="flat", block_size=128,
        device=dev)[0]
    for dtype in (torch.float32, torch.bfloat16):
        for halo in (False, "auto"):
            sp = sparse_tp.shard_flat_support(flat.astype(dtype), mesh,
                                              halo=halo, trainable=True)
            gen = torch.Generator().manual_seed(1)
            xa = torch.randn((n, 96), generator=gen).to(dtype)
            wa = torch.randn((n, 96), generator=gen).to(dtype)
            lo, hi = mesh.node_range(n)
            xl = xa[lo:hi].to(dev).requires_grad_(True)
            sp.blocks.requires_grad_(True)
            build.reset_launch_counts()
            y = sp.mix_2d(xl)
            (y.float() * wa[lo:hi].to(dev).float()).sum().backward()
            torch.cuda.synchronize()
            gb = collectives.all_reduce_(sp.blocks.grad.float().clone(), g)
            key = f"{dtype}/{halo}"
            np.save(os.path.join(out, f"{key.replace('/', '_')}_{rank}.npy"),
                    np.concatenate([y.detach().float().cpu().numpy().ravel(),
                                    xl.grad.float().cpu().numpy().ravel()]))
            if rank == 0:
                np.save(os.path.join(out, f"{key.replace('/', '_')}_db.npy"),
                        gb.cpu().numpy())
            res[key] = {"launches": {k: build.LAUNCHES[k] for k in bd.OPS},
                        "halo": sp.halo}
    res.update(gloo_refusals(dev))
elif mode == "nccl1_graphed":
    res.update(nccl_graphed(dev))
elif mode == "nccl2_tp_graphed":
    res.update(nccl_tp_graphed(dev))
elif mode == "nccl2_time_graphed":
    res.update(nccl_time_graphed(dev))
elif mode == "nccl2_dense_tp_graphed":
    res.update(nccl_dense_tp_graphed(dev))
else:
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.train.engine import Engine
    rng = np.random.default_rng(0)
    a = rng.random((2, 32, 32)).astype(np.float32)
    sups = [torch.as_tensor(s / s.sum(-1, keepdims=True), device=dev)
            for s in a]
    x = rng.normal(size=(8, 12, 32, 2)).astype(np.float32)
    y = (rng.normal(size=(8, 12, 32, 2)) + 5).astype(np.float32)
    cfg = ModelConfig(num_nodes=32, residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=16, blocks=2, layers=2)
    mesh = make_mesh(MeshConfig(), dev)
    states = []
    for m in (None, mesh):
        eng = Engine(cfg, TrainConfig(), None, device=dev, seed=0, mesh=m)
        for _ in range(2):
            eng.train_step(x, y, sups)
        torch.cuda.synchronize()
        states.append({k: v.cpu() for k, v in eng.model.state_dict().items()})
    res["differ"] = [k for k in states[0]
                     if not torch.equal(states[0][k], states[1][k])]
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
'''

# what the DIST_CHILD modes of the fused steps run (defined before it)
DIST_FUSED = r'''
def small_dense(dev, mesh, dropout):
    """Two engines of a 32-node dense model on ``mesh``, from one seed, and
    8 resident samples."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine
    rng = np.random.default_rng(0)
    a = rng.random((2, 32, 32)).astype(np.float32)
    sups = [torch.as_tensor(s / s.sum(-1, keepdims=True), device=dev)
            for s in a]
    xs = torch.as_tensor(rng.normal(size=(8, 12, 32, 2)).astype(np.float32),
                         device=dev)
    ys = torch.as_tensor((rng.normal(size=(8, 12, 32, 2)) * 5
                          + 50).astype(np.float32), device=dev)
    cfg = ModelConfig(num_nodes=32, residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=16, blocks=2, layers=2,
                      dropout=dropout)
    engines = [Engine(cfg, TrainConfig(), StandardScaler(50.0, 5.0),
                      device=dev, seed=0, mesh=mesh) for _ in range(2)]
    return engines, sups, xs, ys


def gloo_refusals(dev):
    """A fused call of an engine on the 2-rank gloo group raises the named
    error, and so does a staged collective inside a capture."""
    from graph_wavenet_tpu_torch.parallel.collectives import GlooCaptureError
    out = {}
    (eng, _), sups, xs, ys = small_dense(dev, make_mesh(MeshConfig(), dev),
                                         0.0)
    try:
        eng.train_steps_resident(xs, ys, np.zeros((2, 4), np.int32), sups)
        out["fused"] = "not refused"
    except GlooCaptureError as e:
        out["fused"] = str(e)
    graph, t = torch.cuda.CUDAGraph(), torch.ones(3, device=dev)
    try:
        with torch.cuda.graph(graph):
            collectives.all_reduce_(t, None if world == 1 else
                                    torch.distributed.group.WORLD)
        out["capture"] = "not refused"
    except Exception as e:
        chain = [e, e.__context__]
        out["capture"] = " | ".join(f"{type(c).__name__}: {c}"
                                    for c in chain if c is not None)
    return out


def nccl_graphed(dev):
    """Two fused calls of S = 3 steps on a one-rank NCCL mesh (dropout 0.3,
    the collectives captured) against six eager steps on the same mesh:
    losses, parameters, buffers and Adam's state bit for bit."""
    mesh = make_mesh(MeshConfig(), dev)
    (eager, graphed), sups, xs, ys = small_dense(dev, mesh, 0.3)
    idx = np.random.default_rng(1).integers(0, 8, size=(2, 3, 4)).astype(
        np.int32)
    out = {"loss_differ": []}
    for call in range(2):
        got = graphed.train_steps_resident(xs, ys, idx[call], sups)
        want = [eager.train_step(xs.index_select(0, r),
                                 ys.index_select(0, r), sups)
                for r in torch.as_tensor(idx[call], device=dev)]
        if not torch.equal(got["loss"],
                           torch.stack([m["loss"] for m in want])):
            out["loss_differ"].append(call)
    a, b = (dict(e.model.state_dict()) for e in (eager, graphed))
    for e, d in ((eager, a), (graphed, b)):
        for i, st in e.optimizer.state_dict()["state"].items():
            d.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out["state_differ"] = [k for k in a if not torch.equal(a[k], b[k])]
    (g,) = graphed.step_graphs()
    out["replays"] = g.replays
    return out


def nccl_tp_graphed(dev):
    """Node-TP on a 2-rank NCCL group (one card each): a 2,048-node city
    graph's two flat supports and their mask, sharded in both exchange
    forms (all_gather, and the halo's neighbour exchange); per form two
    fused calls of S = 2 steps (dropout 0.3, the hop exchanges captured
    with the step's other collectives) against four eager steps on the
    same mesh, bit for bit, and the hand kernels' per-replay launches."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs import spatial
    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges
    from graph_wavenet_tpu_torch.ops import adaptive_block
    from graph_wavenet_tpu_torch.train.engine import Engine
    n = 2048
    rng = np.random.default_rng(0)
    src, dst, w = spatial.knn_graph_edges(rng.random((n, 2)), 4)
    flat = list(spatial.doubletransition_block_supports(
        src, dst, w, n, perm=rcm_order_edges(src, dst, n), form="flat",
        block_size=128, device=dev))
    mask = adaptive_block.mask_from_supports(flat)
    xs = torch.as_tensor(rng.normal(size=(8, 12, n, 2)).astype(np.float32),
                         device=dev)
    ys = torch.as_tensor((rng.normal(size=(8, 12, n, 2)) * 9.5
                          + 31.0).astype(np.float32), device=dev)
    idx = rng.integers(0, 8, size=(2, 2, 4)).astype(np.int32)
    mesh = make_mesh(MeshConfig(model_axis=2), dev)
    cfg = ModelConfig(num_nodes=n, residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=16, blocks=2, layers=2,
                      dropout=0.3, gcn_bool=True, addaptadj=True,
                      n_supports=2)
    out = {}
    for halo in (False, True):
        sups = [sparse_tp.shard_flat_support(sp, mesh, halo) for sp in flat]
        sups.append(sparse_tp.shard_adaptive_mask(mask, mesh, halo))
        eager, graphed = (Engine(cfg, TrainConfig(),
                                 StandardScaler(31.0, 9.5), device=dev,
                                 seed=0, mesh=mesh) for _ in range(2))
        rec = {"halo": [sp.halo for sp in sups[:2]], "loss_differ": []}
        for call in range(2):
            got = graphed.train_steps_resident(xs, ys, idx[call], sups)
            want = [eager.train_step(xs.index_select(0, r),
                                     ys.index_select(0, r), sups)
                    for r in torch.as_tensor(idx[call], device=dev)]
            if not torch.equal(got["loss"],
                               torch.stack([m["loss"] for m in want])):
                rec["loss_differ"].append(call)
        a, b = (dict(e.model.state_dict()) for e in (eager, graphed))
        for e, d in ((eager, a), (graphed, b)):
            for i, st in e.optimizer.state_dict()["state"].items():
                d.update({f"adam.{i}.{k}": v for k, v in st.items()})
        rec["state_differ"] = [k for k in a if not torch.equal(a[k], b[k])]
        (g,) = graphed.step_graphs()
        rec["replays"], rec["per_replay"] = g.replays, g.launches
        out["halo" if halo else "all_gather"] = rec
    return out


def nccl_time_graphed(dev):
    """Time-halo SP over a 2-rank NCCL group (one card each): the K = 48
    diff-G model (16 nodes, 4 x 2 layers from dilation 4, per-sample
    supports, dropout 0.3) on 2 time ranks; two fused calls of S = 2
    ``train_steps_syn_resident`` steps (the halo exchanges captured with
    the step's other collectives) against four eager ``train_step_syn``
    calls on the same mesh, bit for bit."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import (
        Engine,
        cluster_mean_projector,
    )
    rng = np.random.default_rng(0)
    n, k = 16, 48
    xs = torch.as_tensor(rng.normal(size=(8, k, n, 2)).astype(np.float32),
                         device=dev)
    ys = torch.as_tensor((rng.normal(size=(8, k, n, 2)) + 3.0).astype(
        np.float32), device=dev)
    a = rng.random((3, n, n)).astype(np.float32)
    sup = torch.as_tensor(a / a.sum(-1, keepdims=True), device=dev)
    proj = torch.as_tensor(np.stack([cluster_mean_projector(lab, 4)
                                     for lab in rng.integers(0, 4, (3, n))]),
                           device=dev)
    adj = torch.as_tensor(rng.integers(0, 3, size=8).astype(np.int32),
                          device=dev)
    idx = rng.integers(0, 8, size=(2, 2, 4)).astype(np.int32)
    mesh = make_mesh(MeshConfig(time_axis=2), dev)
    cfg = ModelConfig(num_nodes=n, out_dim=k, residual_channels=8,
                      dilation_channels=8, skip_channels=16, end_channels=16,
                      blocks=4, layers=2, start_dilation=4, dropout=0.3,
                      gcn_bool=True, addaptadj=True, n_supports=1)
    eager, graphed = (Engine(cfg, TrainConfig(), StandardScaler(3.0, 1.0),
                             device=dev, seed=0, diff_g=True, mesh=mesh)
                      for _ in range(2))
    out = {"loss_differ": [], "time_index": mesh.time_index}
    for call in range(2):
        got = graphed.train_steps_syn_resident(xs, ys, idx[call], adj,
                                               [sup], proj, 4)
        want = []
        for r in torch.as_tensor(idx[call], device=dev):
            gids = adj.index_select(0, r)
            want.append(eager.train_step_syn(
                xs.index_select(0, r), ys.index_select(0, r),
                [sup.index_select(0, gids)], proj.index_select(0, gids), 4))
        if not torch.equal(got["loss"],
                           torch.stack([m["loss"] for m in want])):
            out["loss_differ"].append(call)
    a, b = (dict(e.model.state_dict()) for e in (eager, graphed))
    for e, d in ((eager, a), (graphed, b)):
        for i, st in e.optimizer.state_dict()["state"].items():
            d.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out["state_differ"] = [k for k in a if not torch.equal(a[k], b[k])]
    (g,) = graphed.step_graphs()
    out["replays"] = g.replays
    return out


def nccl_dense_tp_graphed(dev):
    """Dense node-TP of the METR model over a 2-rank NCCL group (one card
    each): 33 nodes (17 and 16), two supports and the adaptive adjacency,
    dropout 0.3, in the fused and the stacked mode; per mode two fused
    calls of S = 2 steps (every hop's reduce-scatter and its backward's
    all_gather, and the stacked mode's gather of the supports, captured
    with the step's other collectives) against four eager steps on the
    same mesh, bit for bit."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine
    n = 33
    rng = np.random.default_rng(0)
    a = rng.random((2, n, n)).astype(np.float32)
    sups = [torch.as_tensor(s / s.sum(-1, keepdims=True), device=dev)
            for s in a]
    xs = torch.as_tensor(rng.normal(size=(8, 12, n, 2)).astype(np.float32),
                         device=dev)
    ys = torch.as_tensor((rng.normal(size=(8, 12, n, 2)) * 5
                          + 50).astype(np.float32), device=dev)
    idx = rng.integers(0, 8, size=(2, 2, 4)).astype(np.int32)
    mesh = make_mesh(MeshConfig(model_axis=2), dev)
    out = {"node_range": list(mesh.node_range(n))}
    for mode in ("fused", "stacked"):
        cfg = ModelConfig(num_nodes=n, residual_channels=8,
                          dilation_channels=8, skip_channels=16,
                          end_channels=16, blocks=2, layers=2, dropout=0.3,
                          gcn_mode=mode)
        eager, graphed = (Engine(cfg, TrainConfig(),
                                 StandardScaler(50.0, 5.0), device=dev,
                                 seed=0, mesh=mesh) for _ in range(2))
        rec = {"loss_differ": []}
        for call in range(2):
            got = graphed.train_steps_resident(xs, ys, idx[call], sups)
            want = [eager.train_step(xs.index_select(0, r),
                                     ys.index_select(0, r), sups)
                    for r in torch.as_tensor(idx[call], device=dev)]
            if not torch.equal(got["loss"],
                               torch.stack([m["loss"] for m in want])):
                rec["loss_differ"].append(call)
        a_, b_ = (dict(e.model.state_dict()) for e in (eager, graphed))
        for e, d in ((eager, a_), (graphed, b_)):
            for i, st in e.optimizer.state_dict()["state"].items():
                d.update({f"adam.{i}.{k}": v for k, v in st.items()})
        rec["state_differ"] = [k for k in a_
                               if not torch.equal(a_[k], b_[k])]
        (g,) = graphed.step_graphs()
        rec["replays"] = g.replays
        out[mode] = rec
    return out
'''
DIST_CHILD = DIST_CHILD.replace("res = {}\n", DIST_FUSED + "res = {}\n", 1)


def run_dist_child(tmp_path, mode: str, world: int) -> list:
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=repo, LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DIST_CHILD, mode, str(rank), str(world),
             f"file://{tmp_path}/rdzv", str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


def test_gloo_ranks_sharing_the_card_stage_collectives_and_shard_hops(
        card, tmp_path):
    """Two gloo ranks on one card: the collectives on CUDA tensors (staged
    through the host) deliver the right rows and gradients, and a sharded
    2,048-node trainable support's hop, dx and summed blocks' gradient (both
    exchange forms, fp32 and bf16) equal the unsharded support's on the
    card bit for bit, kernel 1 twice and kernel 2 once per rank."""
    from graph_wavenet_tpu_torch.graphs import spatial
    from graph_wavenet_tpu_torch.graphs.ordering import rcm_order_edges

    res = run_dist_child(tmp_path, "gloo2", 2)
    x0 = [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
    x1 = [[10.0, 11.0], [12.0, 13.0], [14.0, 15.0]]
    assert res[0]["gather"] == x0 + x1 == res[1]["gather"]
    assert res[0]["exchange"] == [x1, x1] and res[1]["exchange"] == [x0, x0]
    # d/dv_r of sum_q (q+1) * sum(all_sum(v)) = 1 + 2 on every rank
    assert res[0]["all_sum_grad"] == [3.0] * 3 == res[1]["all_sum_grad"]
    # rows 0-1 summed to rank 0, rows 2-3 to rank 1 (row i of the sum:
    # [2i, 2i+1] + [10+2i, 11+2i]); every summand's gradient is the
    # all_gather of the cotangents (1 on rank 0's rows, 2 on rank 1's)
    summed = [[10.0 + 4 * i, 12.0 + 4 * i] for i in range(4)]
    assert res[0]["reduce_scatter"] == summed[:2]
    assert res[1]["reduce_scatter"] == summed[2:]
    for r in res:
        assert r["reduce_scatter_grad"] == [[1.0, 1.0]] * 2 + [[2.0, 2.0]] * 2
    rng = np.random.default_rng(0)
    n = 2048
    src, dst, w = spatial.knn_graph_edges(rng.random((n, 2)), 4)
    flat = spatial.doubletransition_block_supports(
        src, dst, w, n, perm=rcm_order_edges(src, dst, n), form="flat",
        block_size=128, device=card)[0]
    for dtype in (torch.float32, torch.bfloat16):
        for halo in (False, "auto"):
            key = f"{dtype}/{halo}"
            gen = torch.Generator().manual_seed(1)
            xa = torch.randn((n, 96), generator=gen).to(dtype).to(card)
            wa = torch.randn((n, 96), generator=gen).to(dtype).to(card)
            blocks = flat.blocks_flat.to(dtype).clone().requires_grad_(True)
            sp = dataclasses.replace(flat, blocks_flat=blocks)
            xa.requires_grad_(True)
            y = sp.mix_2d(xa)
            (y.float() * wa.float()).sum().backward()
            got = [np.load(tmp_path / f"{key.replace('/', '_')}_{r}.npy")
                   for r in range(2)]
            half = n // 2 * 96
            y_got = np.concatenate([g[:half] for g in got])
            dx_got = np.concatenate([g[half:] for g in got])
            # every destination row sums the same live entries in the same
            # order as the unsharded tables (chip_smoke.py's tp_local
            # shows it at full width): bit for bit
            np.testing.assert_array_equal(
                y_got, y.detach().float().cpu().numpy().ravel())
            np.testing.assert_array_equal(
                dx_got, xa.grad.float().cpu().numpy().ravel())
            np.testing.assert_array_equal(
                np.load(tmp_path / f"{key.replace('/', '_')}_db.npy"),
                blocks.grad.float().cpu().numpy())
            for r in res:
                launches = r[key]["launches"]
                assert launches["mix_flat"] == 2
                assert launches["outer_flat"] == 1
                assert r[key]["halo"] == (halo == "auto")


def test_fused_call_on_gloo_ranks_with_cuda_tensors_raises(card, tmp_path):
    """On the 2-rank gloo group sharing the card, a fused call refuses with
    ``GlooCaptureError`` before any step (its collectives would stage
    through the host, which a CUDA graph cannot capture), and a staged
    collective inside a capture raises it too: nothing falls back."""
    res = run_dist_child(tmp_path, "gloo2", 2)
    for r in res:
        assert "NCCL group" in r["fused"], r["fused"]
        assert "GlooCaptureError" in r["capture"], r["capture"]


def test_nccl_one_rank_graphed_steps_equal_eager(card, tmp_path):
    """On a one-rank NCCL group the fused steps capture the step's
    collectives (BatchNorm's, the loss mask's, the metrics', the gradient
    all-reduce) in the graph: two fused calls of S = 3 steps with dropout
    0.3 equal six eager ``train_step`` calls on the same mesh bit for
    bit."""
    res = run_dist_child(tmp_path, "nccl1_graphed", 1)[0]
    assert res["loss_differ"] == [] and res["state_differ"] == [], res
    assert res["replays"] == 5


def test_nccl_two_ranks_node_tp_graphed_steps_equal_eager(card, tmp_path):
    """Node-TP over a 2-rank NCCL group, one card per rank: the fused steps
    capture the hop exchanges (the all_gather form's gathers and the halo
    form's neighbour exchange) with the step's other collectives, and two
    fused calls of S = 2 steps with dropout 0.3 equal four eager
    ``train_step`` calls on the same mesh bit for bit on both ranks, with
    kernels 1 and 2 launched in every replay."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    res = run_dist_child(tmp_path, "nccl2_tp_graphed", 2)
    for r in res:
        for form, halo in (("all_gather", False), ("halo", True)):
            rec = r[form]
            assert rec["halo"] == [halo, halo], rec
            assert rec["loss_differ"] == [] and rec["state_differ"] == [], rec
            assert rec["replays"] == 3, rec
            assert rec["per_replay"]["mix_flat"] > 0, rec
            assert rec["per_replay"]["outer_flat"] > 0, rec


def test_nccl_two_ranks_time_sp_graphed_steps_equal_eager(card, tmp_path):
    """Time-halo SP over a 2-rank NCCL group, one card per rank: the fused
    diff-G steps capture each layer's halo exchange (forward and, in the
    backward, the cotangent's way back) with the step's other collectives,
    and two fused calls of S = 2 steps with dropout 0.3 equal four eager
    ``train_step_syn`` calls on the same mesh bit for bit on both
    ranks."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    res = run_dist_child(tmp_path, "nccl2_time_graphed", 2)
    assert [r["time_index"] for r in res] == [0, 1]
    for r in res:
        assert r["loss_differ"] == [] and r["state_differ"] == [], r
        assert r["replays"] == 3, r


def test_nccl_two_ranks_dense_tp_graphed_steps_equal_eager(card, tmp_path):
    """Dense node-TP of the METR model over a 2-rank NCCL group, one card
    per rank, 33 nodes (17 and 16): the fused steps capture every hop's
    reduce-scatter (and its backward's all_gather, and the stacked mode's
    gather of the supports) with the step's other collectives, and two
    fused calls of S = 2 steps with dropout 0.3 equal four eager
    ``train_step`` calls on the same mesh bit for bit on both ranks, in
    the fused and the stacked mode."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    res = run_dist_child(tmp_path, "nccl2_dense_tp_graphed", 2)
    assert [r["node_range"] for r in res] == [[0, 17], [17, 33]]
    for r in res:
        for mode in ("fused", "stacked"):
            rec = r[mode]
            assert rec["loss_differ"] == [] and rec["state_differ"] == [], rec
            assert rec["replays"] == 3, rec


def test_nccl_one_rank_steps_equal_plain_steps(card, tmp_path):
    """An Engine on a one-rank NCCL mesh takes the same two train steps as
    one without a mesh, bit for bit (parameters and BatchNorm buffers)."""
    res = run_dist_child(tmp_path, "nccl1", 1)
    assert res[0]["differ"] == []


PIPE_CHILD = r'''
import json
import sys

import numpy as np
import torch

from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.parallel import multihost
from graph_wavenet_tpu_torch.parallel.pipeline import (
    make_pipeline_mesh,
    make_pipeline_train_step,
)
from graph_wavenet_tpu_torch.train.engine import Engine

rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
multihost.initialize("nccl", rank, world, init, device="cuda",
                     timeout_s=240)
dev = multihost.rank_device("cuda")
mesh = make_pipeline_mesh(world, dev)
cfg = ModelConfig(num_nodes=12, in_dim=2, out_dim=6, residual_channels=8,
                  dilation_channels=8, skip_channels=16, end_channels=32,
                  blocks=4, layers=2, dropout=0.0)
rng = np.random.default_rng(0)
x = rng.normal(size=(8, 12, 12, 2)).astype(np.float32)
y = (rng.normal(size=(8, 6, 12, 2)) + 5.0).astype(np.float32)
a = rng.random((2, 12, 12)).astype(np.float32)
sups = [torch.as_tensor(s / s.sum(-1, keepdims=True), device=dev)
        for s in a]
pipe, ref = (Engine(cfg, TrainConfig(batch_size=8), StandardScaler(5.0, 2.0),
                    device=dev, seed=0) for _ in range(2))
got = make_pipeline_train_step(pipe, mesh, 2)(x, y, sups)
want = ref.train_step_accum(x, y, sups, 2)
rec = {"loss": [float(got["loss"]), float(want["loss"])], "grad_err": 0.0}
for (k, p), q in zip(pipe.model.named_parameters(), ref.model.parameters()):
    if q.grad is not None:
        scale = float(q.grad.abs().max()) or 1.0
        rec["grad_err"] = max(rec["grad_err"],
                              float((p.grad - q.grad).abs().max()) / scale)
rec["params"] = [float(p.double().sum()) for p in pipe.model.parameters()]
with open(f"{out}/pipe{rank}.json", "w") as f:
    json.dump(rec, f)
torch.distributed.destroy_process_group()
'''


def test_nccl_two_ranks_pipeline_step_equals_train_step_accum(card,
                                                              tmp_path):
    """The pipeline over 2 NCCL stages, one card each (a 4 x 2 dense model,
    2 micro-batches, dropout 0): its step's loss within 1e-5 and its
    gradients within 1e-5 of each tensor's largest of one process's
    ``train_step_accum`` on the same card, the ranks' parameters alike."""
    import json
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", PIPE_CHILD, str(r), "2",
         f"file://{tmp_path}/rdzv", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=repo, LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    res = [json.loads((tmp_path / f"pipe{r}.json").read_text())
           for r in range(2)]
    for r in res:
        got, want = r["loss"]
        assert abs(got - want) <= 1e-5 * abs(want), r
        assert r["grad_err"] <= 1e-5, r
    assert res[0]["params"] == res[1]["params"]


def test_prefetch_onto_the_card_equals_plain_copies(card):
    """Batches prefetched onto the card on a side stream equal plain
    copies of the same arrays, bit for bit, on the consumer's stream."""
    from graph_wavenet_tpu_torch.data.loader import DataLoader
    from graph_wavenet_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(0)
    xs = rng.normal(size=(64, 12, 207, 2)).astype(np.float32)
    ys = rng.normal(size=(64, 12, 207, 2)).astype(np.float32)
    dl = DataLoader(xs, ys, 8, rng=rng)
    batches = list(dl.get_iterator())
    got = list(prefetch_to_device(iter(batches), size=2, device=card))
    assert len(got) == len(batches)
    for (x, y), (gx, gy) in zip(batches, got):
        assert gx.is_cuda and gy.is_cuda
        assert torch.equal(gx * 1.0, torch.as_tensor(x, device=card))
        assert torch.equal(gy, torch.as_tensor(y, device=card))


BENCH_ROWS = ["metr-la-temporal", "metr-la-gcn", "metr-la-full",
              "pems-bay-full", "city-40k-block-flat"]


def test_span_holds_the_kernel_it_waits_for(card):
    """The span store's clock is the one ``torch.profiler`` aligns its
    device timestamps to: a span around a sleeping kernel and a
    synchronize holds the kernel's device interval, widened by at most
    50 us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from graph_wavenet_tpu_torch.train import profiling

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("sleep") as sid:
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    (s,) = [x for x in profiling.spans() if x["id"] == sid]
    kernel = max((e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and not e.is_user_annotation()),
                 key=lambda e: e.duration_ns())
    start, end = kernel.start_ns(), kernel.start_ns() + kernel.duration_ns()
    print(f"span_clock kernel {kernel.name()} {kernel.duration_ns()} ns; "
          f"starts {start - s['start_ns']} ns after the span, ends "
          f"{s['end_ns'] - end} ns before its end")
    assert kernel.duration_ns() > 1_000_000
    assert s["start_ns"] - 50_000 <= start
    assert end <= s["end_ns"] + 50_000


@pytest.mark.slow
@pytest.mark.parametrize("name", BENCH_ROWS)
def test_bench_row_within_band(card, name):
    """Every row of the port's record (``fig/perf_table_torch.json``,
    ``python -m graph_wavenet_tpu_torch.benchmarks --save``) re-measured
    on a card of the kind that recorded it, inside ``check_band``: step
    time within x1.08, the counted FLOPs within 2%."""
    import json

    from graph_wavenet_tpu_torch import benchmarks as B

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), B.RECORD)
    if not os.path.exists(path):
        pytest.skip(f"{B.RECORD} not recorded yet")
    with open(path) as f:
        rec = json.load(f)
    kind = torch.cuda.get_device_name(card)
    if rec.get("device") != kind:
        pytest.skip(f"recorded on {rec.get('device')!r}, running on "
                    f"{kind!r}")
    if name not in rec["configs"]:
        pytest.skip(f"{name} not in the record")
    row = rec["configs"][name]
    meas = B.remeasure_row(name, row, rec["batch"], rec["steps"],
                           rec["dtype"])
    B.check_band(row, meas["step_ms"], meas["flops_per_step"], name)


# ---------------------------------------------------------------------------
# the channel projection kernel (csrc/chan_proj.cu)
# ---------------------------------------------------------------------------

# (C, F, K) of every projection the cells run: start, packed filter/gate
# taps, residual, skip, the sparse and the dense diffusion (7 operands or
# the concatenation's one), end_conv_1, end_conv_2
PROJ_WIDTHS = {"start": (2, 32, 1), "tcn": (32, 64, 2),
               "residual": (32, 32, 1), "skip": (32, 256, 1),
               "gcn7": (32, 32, 7), "concat": (224, 32, 1),
               "end1": (256, 512, 1), "end2": (512, 12, 1)}


def proj_case(card, name, layout, rows, seed=0):
    """Operands of one projection as the model passes them, the weight
    (F, K*C) fp32 and the bias. ``layout``: ``rows`` (B, T, N, C)
    contiguous; ``taps`` the K time slices of one (B, T + K - 1, N, C)
    tensor (the temporal conv's); ``last`` the last T steps of a longer
    one (the skip conv's); ``nodes`` node-leading (N, B*T, C) hops read as
    (B*T, N, C) (the sparse diffusion's)."""
    c, f, k = PROJ_WIDTHS[name]
    b, t, n = rows
    gen = torch.Generator(device=card).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device=card, generator=gen)

    if layout == "taps":
        base = rand(b, t + k - 1, n, c).bfloat16().requires_grad_()
        xs = [base[:, i:i + t] for i in range(k)]
    elif layout == "last":
        base = rand(b, t + 3, n, c).bfloat16().requires_grad_()
        xs = [base[:, -t:]] * k
    elif layout == "nodes":
        base = rand(k, n, b * t * c).bfloat16().requires_grad_()
        xs = [base[i].reshape(n, b * t, c).transpose(0, 1)
              for i in range(k)]
    else:
        base = rand(k, b, t, n, c).bfloat16().requires_grad_()
        xs = list(base.unbind(0))
    w = (rand(f, k * c) / (k * c) ** 0.5).requires_grad_()
    bias = rand(f).requires_grad_()
    return base, xs, w, bias


PROJ_CASES = [("start", "rows"), ("tcn", "taps"), ("residual", "rows"),
              ("skip", "last"), ("gcn7", "nodes"), ("gcn7", "rows"),
              ("concat", "rows"), ("end1", "rows"), ("end2", "rows")]


@pytest.mark.parametrize("rows", [(2, 5, 37), (3, 13, 407)],
                         ids=["ragged", "splits"])
@pytest.mark.parametrize("name,layout", PROJ_CASES,
                         ids=[f"{n}-{lay}" for n, lay in PROJ_CASES])
def test_chan_proj_matches_fp32_chain(card, name, layout, rows):
    """The kernel's forward, every operand's gradient, the bf16-rounded
    weight gradient and the fp32 bias gradient against the fp32 chain
    (``ops.linear._chain``: fp32 upcasts, FFMA GEMMs, fp32 adds, one cast),
    each within bf16 rounding, at ragged row counts and with the strided
    operands and the node-leading output the model uses."""
    from graph_wavenet_tpu_torch.ops import linear
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj

    base, xs, w, bias = proj_case(card, name, layout, rows)
    build.reset_launch_counts()
    y = linear.project(xs, w, bias)
    want = linear._chain(xs, w, bias)
    assert y.shape == want.shape and y.dtype == torch.bfloat16
    assert_close(y, want)
    g = torch.randn(y.shape, device=card,
                    generator=torch.Generator(device=card).manual_seed(1)
                    ).bfloat16()
    # each operand's own gradient: where taps overlap, their bf16 sum
    # rounds again
    got = torch.autograd.grad(y, (*xs, w, bias), g)
    ref = torch.autograd.grad(want, (*xs, w, bias), g)
    for a, b in zip(got[:-2], ref[:-2]):
        assert_close(a, b)
    assert_close(got[-2].bfloat16(), ref[-2].bfloat16())
    assert_close(got[-1], ref[-1])
    assert proj_launches() == dict.fromkeys(chan_proj.OPS, 1)


def test_chan_proj_graphed_equals_eager(card):
    """The forward and both backward passes captured in a CUDA graph and
    replayed on new inputs give the eager results bit for bit."""
    from graph_wavenet_tpu_torch.ops import linear

    base, xs, w, bias = proj_case(card, "gcn7", "nodes", (2, 5, 300))
    gen = torch.Generator(device=card).manual_seed(2)
    static_x = base.detach().clone().requires_grad_()
    static_g = torch.randn(10, 300, 32, device=card,
                           generator=gen).bfloat16()

    def step():
        n = static_x.shape[1]
        ops = [static_x[i].reshape(n, 10, 32).transpose(0, 1)
               for i in range(7)]
        y = linear.project(ops, w, bias)
        return (y,) + torch.autograd.grad(y, (static_x, w, bias), static_g)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for seed in (3, 4):
        with torch.no_grad():
            static_x.copy_(torch.randn(
                static_x.shape, device=card,
                generator=torch.Generator(device=card).manual_seed(seed)))
            static_g.normal_(generator=gen)
        graph.replay()
        want = step()
        for a, b in zip(captured, want):
            assert torch.equal(a, b)


def proj_model_step(card, cfg, sups, x, y, kernel: bool, monkeypatch):
    """One training forward and backward of a fresh GWNet (seed 0) with the
    dropout stream seeded: the loss and every parameter's gradient. With
    ``kernel`` False the dispatch is patched to the fp32 chain: the
    projections' and the layer tail's."""
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.ops import diffusion, linear, normalization

    with monkeypatch.context() as mp:
        if not kernel:
            for mod in (linear, diffusion):
                mp.setattr(mod, "takes_kernel", lambda t: False)
            mp.setattr(normalization, "takes_tail_kernel",
                       lambda h, t_valid: False)
        model = GWNet(cfg, device=card, seed=0)
        model.train()
        gen = torch.Generator(device=card).manual_seed(7)
        out = model(x, sups, generator=gen)
        loss = (out - y).abs().mean()
        loss.backward()
    return loss.item(), {k: p.grad for k, p in model.named_parameters()
                         if p.grad is not None}


def grad_gaps(got: dict, want: dict) -> dict:
    """The benchmark's ``grad_gap`` (``gwbench/compare.py``): the worst
    leaf's gap of gradient norms over the larger of its reference norm
    and the median kept leaf's, leaves under a thousandth of the median
    reference gradient left out; and, beside it, the worst leaf's norm of
    the difference on the same scale. Each with its leaf's name."""
    assert got.keys() == want.keys()
    ref = {k: float(v.double().norm()) for k, v in want.items()}
    med = float(np.median(list(ref.values())))
    keep = [k for k in ref if ref[k] >= 1e-3 * med]
    base = float(np.median([ref[k] for k in keep]))
    norm = {k: abs(float(got[k].double().norm()) - ref[k])
            / max(ref[k], base) for k in keep}
    diff = {k: float((got[k].double() - want[k].double()).norm())
            / max(ref[k], base) for k in keep}
    worst_norm, worst_diff = max(norm, key=norm.get), max(diff, key=diff.get)
    return {"grad_gap": norm[worst_norm], "grad_gap_leaf": worst_norm,
            "diff": diff[worst_diff], "diff_leaf": worst_diff}


# how much farther the kernel's bf16 step may lie from the fp32 model's
# than the chain's: both differ from it by bf16 roundings at the same
# places and from each other only in the order of fp32 sums, so the two
# distances are of one size
STEP_DIFF_FACTOR = 1.5


@pytest.mark.parametrize("kind", ["city", "metr"])
def test_chan_proj_model_step_matches_fp32_chain(card, kind, monkeypatch):
    """A bf16 training step of the 2,048-node flat city model (masked
    adaptive adjacency, the sparse diffusion) and of the 207-node dense
    METR model (concat mode) through the kernel against the same step
    through the fp32 chain: the loss within the benchmark's loss limit
    (6e-4) and the gradients within its ``grad_gap`` limit (2e-2 city,
    1.5e-2 METR). Both bf16 steps against the fp32 model's step on the same
    inputs, parameters and dropout draws: the kernel's worst leaf's norm of
    the difference within ``STEP_DIFF_FACTOR`` of the chain's. Every
    projection takes the kernel: its launches are the model's count."""
    from graph_wavenet_tpu_torch.config import ModelConfig

    rng = np.random.default_rng(11)
    if kind == "city":
        from graph_wavenet_tpu_torch.graphs.city import build_city_supports
        from graph_wavenet_tpu_torch.graphs.spatial import knn_graph_edges

        n = 2048
        pos = rng.random((n, 2))
        src, dst, w = knn_graph_edges(pos, 8)
        sup, mask, _ = build_city_supports(src, dst, w, n, pos=pos,
                                           ordering="rcm", form="flat",
                                           addaptadj=True, device=card)
        sups = [s.astype(torch.bfloat16) for s in sup] + [mask]
        sups32 = list(sup) + [mask]
        limit = 2e-2
    else:
        n = 207
        a = rng.random((2, n, n)).astype(np.float32)
        sups = sups32 = [torch.as_tensor(m / m.sum(-1, keepdims=True),
                                         device=card) for m in a]
        limit = 1.5e-2
    cfg = ModelConfig(num_nodes=n, addaptadj=True, dropout=0.3,
                      dtype="bfloat16")
    x = torch.as_tensor(rng.normal(size=(4, 13, n, 2)).astype(np.float32),
                        device=card)
    y = torch.as_tensor(rng.normal(size=(4, 1, n, 12)).astype(np.float32),
                        device=card)
    build.reset_launch_counts()
    loss, grads = proj_model_step(card, cfg, sups, x, y, True, monkeypatch)
    counts = proj_launches()
    ref_loss, ref = proj_model_step(card, cfg, sups, x, y, False,
                                    monkeypatch)
    assert proj_launches() == counts
    loss32, ref32 = proj_model_step(
        card, dataclasses.replace(cfg, dtype="float32"), sups32, x, y, True,
        monkeypatch)
    assert proj_launches() == counts
    # per layer: taps, skip and diffusion; then start and the two end
    # convs. The last layer's diffusion reaches no loss term (no backward),
    # and the start conv's input needs no gradient (no dgrad)
    layers = cfg.blocks * cfg.layers
    assert counts["chan_proj"] == 3 * layers + 3
    assert counts["chan_proj_wgrad"] == counts["chan_proj"] - 1
    assert counts["chan_proj_dgrad"] == counts["chan_proj"] - 2
    assert abs(loss - ref_loss) <= 6e-4 * abs(ref_loss)
    vs_chain = grad_gaps(grads, ref)
    kernel32, chain32 = grad_gaps(grads, ref32), grad_gaps(ref, ref32)
    print(f"chan_proj {kind} step: loss {loss} vs chain {ref_loss} vs "
          f"fp32 {loss32}; kernel vs chain {vs_chain}; kernel vs fp32 "
          f"{kernel32}; chain vs fp32 {chain32}")
    assert vs_chain["grad_gap"] < limit
    assert kernel32["diff"] <= STEP_DIFF_FACTOR * chain32["diff"]


@pytest.mark.parametrize("site", ["linear", "taps", "sparse",
                                  "sparse_fused", "fused", "concat",
                                  "stacked"])
def test_fp32_projections_keep_the_chain_bitwise_on_the_card(card, site):
    """Each call site on fp32 card tensors against a copy of the chain it
    ran before (``tests/test_torch_port_proj.py``'s): the output and every
    gradient bit for bit, and the projection kernel never launched."""
    import test_torch_port_proj as P

    rng = np.random.default_rng(P.SITES.index(site))
    leaves, new, old = P.site_call(site, rng, torch.float32, device=card)
    build.reset_launch_counts()
    y, want = new(), old()
    assert y.dtype == torch.float32 and torch.equal(y, want)
    g = torch.randn(y.shape, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    for a, b in zip(torch.autograd.grad(y, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        assert torch.equal(a, b)
    assert not any(proj_launches().values())


@pytest.mark.parametrize("name", ["chan_proj", "chan_proj_dgrad",
                                  "chan_proj_wgrad"])
def test_chan_proj_ops_pass_opcheck_on_the_card(card, name):
    from graph_wavenet_tpu_torch.ops.cuda import chan_proj  # noqa: F401

    _, xs, w, bias = proj_case(card, "tcn", "taps", (2, 5, 37))
    xs = [x.detach() for x in xs]
    wb = w.detach().bfloat16()
    g = torch.randn(2, 5 * 37, 64, device=card).bfloat16()
    rows = [x.reshape(2, 5 * 37, 32) for x in xs]
    args = {"chan_proj": (rows, wb, bias.detach()),
            "chan_proj_dgrad": (g, wb, rows),
            "chan_proj_wgrad": (rows, g)}[name]
    torch.library.opcheck(getattr(torch.ops.gwt_torch, name), args)
