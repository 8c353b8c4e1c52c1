"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the fixture, so every worker collects the same tests). On a machine
with a card and nvcc:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have; this file imports only torch and the port.) It adds
what ``chip_smoke.py`` does not cover: ragged R (including R not a multiple
of 8, which takes the kernels' scalar load path), kernel 3 in the transpose
orientation, and the wrappers' refusals.
"""

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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [24, 130, 256])
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
@pytest.mark.parametrize("r", [24, 130, 256])
@pytest.mark.parametrize("transpose_lhs", [True, False], ids=["fwd", "bwd"])
@pytest.mark.parametrize("with_add", [False, True], ids=["plain", "add"])
def test_kernel3_bitwise_two_kernel1(card, dtype, r, transpose_lhs,
                                     with_add):
    nb = 9
    row, src, slot, n_live = tables(100 + r, nb, nb, band=3)
    gen = torch.Generator(device=card).manual_seed(r)
    blocks = (torch.rand(n_live + 1, 128, 128, device=card, generator=gen)
              / 16).to(dtype)
    blocks[n_live] = 0
    x = torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
    add = (torch.randn(nb, 128, r, device=card, generator=gen).to(dtype)
           if with_add else None)
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
