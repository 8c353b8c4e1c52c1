"""The channel projection's dispatch and its op on the CPU.

bf16 activations on a CUDA device take the projection kernel
(``ops.cuda.chan_proj`` through ``ops.linear.project``); every other dtype
and device keeps the fp32 chain it ran before, bit for bit: each call site
here against a copy of that chain, with the kernel path patched to raise,
so the dispatch never reaches the op off CUDA. Beside that, the kernel
path driven straight through the op's CPU kernel (its plain version): the
operand views it builds (read in place, never copied where a view exists),
the operands ``project`` refuses, the ops' fake kernels (``opcheck``) and
their FLOP formulas. The kernel itself runs on the card only
(``tests/test_torch_port_cuda.py``).
"""

import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from graph_wavenet_tpu_torch.ops import diffusion, linear, temporal
from graph_wavenet_tpu_torch.ops.cuda import build, chan_proj

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


def rand(rng, *shape, dtype=torch.float32):
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


@pytest.fixture
def no_kernel(monkeypatch):
    """The kernel paths patched to raise: ``project``'s and the
    diffusion's."""
    def refuse(*args, **kwargs):
        raise AssertionError("the projection kernel was dispatched off CUDA")

    monkeypatch.setattr(linear, "_kernel", refuse)
    monkeypatch.setattr(diffusion, "_kernel_project", refuse)


# ---------------------------------------------------------------------------
# the chains as they were, copied
# ---------------------------------------------------------------------------

def old_channel_matmul(x, w):
    return torch.matmul(x.float(), w.to(x.dtype).float())


def old_linear(weight, bias, x):
    w = weight[:, :, 0, 0].t()
    return (old_channel_matmul(x, w) + bias.float()).to(x.dtype)


def old_causal_conv(weight, bias, x, dilation):
    k = weight.shape[-1]
    t_out = x.shape[1] - dilation * (k - 1)
    taps = weight[:, :, 0, :].permute(2, 1, 0)
    out = old_channel_matmul(x[:, :t_out], taps[0])
    for i in range(1, k):
        out = out + old_channel_matmul(
            x[:, i * dilation:i * dilation + t_out], taps[i])
    return (out + bias.float()).to(x.dtype)


def old_sparse_gcn(weight, bias, x, supports, order):
    w = weight[:, :, 0, 0].t()
    b, t, n, c_in = x.shape
    xn = x.permute(2, 0, 1, 3).reshape(n, b * t * c_in)

    def proj(xk, k):
        return old_channel_matmul(xk.reshape(n, b * t, c_in),
                                  w[k * c_in:(k + 1) * c_in])

    h = proj(xn, 0)
    k = 1
    for sp in supports:
        if order == 2 and hasattr(sp, "mix2_2d"):
            x1, x2h = sp.mix2_2d(xn)
            h = h + proj(x1, k) + proj(x2h, k + 1)
            k += 2
            continue
        xk = xn
        for _ in range(order):
            xk = sp.mix_2d(xk)
            h = h + proj(xk, k)
            k += 1
    h = (h + bias.float()).to(x.dtype)
    return h.reshape(n, b, t, -1).permute(1, 2, 0, 3).contiguous()


def old_dense_gcn(weight, bias, x, supports, order, mode):
    w = weight[:, :, 0, 0].t()
    c_in = x.shape[-1]
    if mode == "stacked":
        h = old_channel_matmul(x, w[:c_in])
        for s, a in enumerate(supports):
            pw = diffusion.support_powers(a, order).to(x.dtype).float()
            hops = torch.einsum("btvc,kvw->btkwc", x.float(), pw).to(x.dtype)
            lo = (1 + s * order) * c_in
            wk = w[lo:lo + order * c_in].reshape(order, c_in, -1)
            h = h + torch.einsum("btkwc,kcf->btwf", hops.float(),
                                 wk.to(x.dtype).float())
    else:
        hops = diffusion.diffusion_hops(x, supports, order)
        if mode == "concat":
            h = old_channel_matmul(torch.cat(hops, dim=-1), w)
        else:
            h = old_channel_matmul(hops[0], w[:c_in])
            for k in range(1, len(hops)):
                h = h + old_channel_matmul(hops[k],
                                           w[k * c_in:(k + 1) * c_in])
    return (h + bias.float()).to(x.dtype)


class DenseAsSparse:
    """A support with ``mix_2d`` over a dense (N, N) matrix: the sparse
    path's interface, ``out[w] = sum_v A[v, w] x[v]``."""

    def __init__(self, a):
        self.a = a

    def mix_2d(self, x2):
        return (self.a.to(x2.dtype).float().t() @ x2.float()).to(x2.dtype)


class DenseAsFused(DenseAsSparse):
    def mix2_2d(self, x2):
        x1 = self.mix_2d(x2)
        return x1, self.mix_2d(x1)


# ---------------------------------------------------------------------------
# fp32 and CPU projections keep the chain bit for bit
# ---------------------------------------------------------------------------

SITES = ["linear", "taps", "sparse", "sparse_fused", "fused", "concat",
         "stacked"]


def site_call(site, rng, dtype, device="cpu"):
    """(inputs needing gradients, new function, old function) of one call
    site on small shapes, on ``device``."""
    b, t, n, c, f = 2, 6, 5, 4, 3

    def draw(*shape, dtype=torch.float32):
        return rand(rng, *shape, dtype=dtype).to(device)

    x = draw(b, t, n, c, dtype=dtype).requires_grad_()
    if site == "linear":
        weight = draw(f, c, 1, 1).requires_grad_()
        bias = draw(f).requires_grad_()
        lin = linear.Linear(c, f, device=device)
        with torch.no_grad():
            lin.weight.copy_(weight)
            lin.bias.copy_(bias)
        return ((x, lin.weight, lin.bias), lambda: lin(x),
                lambda: old_linear(lin.weight, lin.bias, x))
    if site == "taps":
        weight = draw(2 * f, c, 1, 2).requires_grad_()
        bias = draw(2 * f).requires_grad_()
        return ((x, weight, bias),
                lambda: temporal.causal_conv_apply(weight, bias, x, 2),
                lambda: old_causal_conv(weight, bias, x, 2))
    a = [torch.as_tensor(rng.random((n, n)).astype(np.float32),
                         device=device) for _ in range(2)]
    weight = draw(f, 5 * c, 1, 1).requires_grad_()
    bias = draw(f).requires_grad_()
    if site.startswith("sparse"):
        cls = DenseAsFused if site == "sparse_fused" else DenseAsSparse
        sups = [cls(m) for m in a]
        return ((x, weight, bias),
                lambda: diffusion.gcn_apply(weight, bias, x, sups, 2),
                lambda: old_sparse_gcn(weight, bias, x, sups, 2))
    return ((x, weight, bias),
            lambda: diffusion.gcn_apply(weight, bias, x, a, 2, mode=site),
            lambda: old_dense_gcn(weight, bias, x, a, 2, site))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("site", SITES)
def test_cpu_projections_keep_the_chain_bitwise(no_kernel, site, dtype):
    """Each call site on CPU tensors, fp32 and bf16, against a copy of the
    chain it ran before: the output and every gradient bit for bit, and
    the projection kernel never dispatched."""
    rng = np.random.default_rng(SITES.index(site))
    leaves, new, old = site_call(site, rng, dtype)
    before = dict(build.LAUNCHES)
    y, want = new(), old()
    assert y.dtype == dtype and torch.equal(y, want)
    g = rand(rng, *y.shape, dtype=dtype)
    got = torch.autograd.grad(y, leaves, g)
    ref = torch.autograd.grad(want, leaves, g)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert build.LAUNCHES == before


def test_dispatch_rule():
    """bf16 on a CUDA device takes the kernel; fp32 anywhere and anything
    on the CPU do not."""
    def like(dtype, dev):
        return types.SimpleNamespace(dtype=dtype, device=torch.device(dev))

    assert linear.takes_kernel(like(torch.bfloat16, "cuda"))
    assert linear.takes_kernel(like(torch.bfloat16, "cuda:1"))
    assert not linear.takes_kernel(like(torch.float32, "cuda"))
    assert not linear.takes_kernel(like(torch.bfloat16, "cpu"))
    assert not linear.takes_kernel(torch.zeros(2, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# project() through the op's plain CPU kernel
# ---------------------------------------------------------------------------

def assert_bf16_close(got, want):
    """Within one bf16 ulp of the larger value, plus 2^-16 of the largest
    (fp32 sums in another order)."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    tol = ulp + w.abs().max() * 2.0 ** -16
    assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


def layout_case(layout, rng):
    """(leaf, operands, weight (F, K*C), bias) of one layout."""
    b, t, n, c, f = 2, 5, 7, 8, 6
    if layout == "taps":
        base = rand(rng, b, t + 2, n, c, dtype=torch.bfloat16)
        xs = lambda v: [v[:, i:i + t] for i in (0, 2)]   # noqa: E731
    elif layout == "last":
        base = rand(rng, b, t + 3, n, c, dtype=torch.bfloat16)
        xs = lambda v: [v[:, -t:]]                        # noqa: E731
    elif layout == "nodes":
        base = rand(rng, 3, n, b * t * c, dtype=torch.bfloat16)
        # the sparse diffusion's node-leading hops, read as (B*T, N, C)
        xs = lambda v: [v[k].reshape(n, b * t, c).transpose(0, 1)  # noqa
                        for k in range(3)]
    elif layout == "permuted":
        # a node-TP hop's layout: (w, b, t, c) storage seen as (b, t, w, c)
        base = rand(rng, 2, n, b, t, c, dtype=torch.bfloat16)
        xs = lambda v: [v[k].permute(1, 2, 0, 3) for k in range(2)]  # noqa
    elif layout == "ragged":
        base = rand(rng, b, t, n, 3, dtype=torch.bfloat16)
        xs = lambda v: [v]                                # noqa: E731
    else:
        base = rand(rng, 4, b, t, n, c, dtype=torch.bfloat16)
        xs = lambda v: list(v.unbind(0))                  # noqa: E731
    base.requires_grad_()
    ops = xs(base)
    w = rand(rng, f, sum(x.shape[-1] for x in ops)).requires_grad_()
    bias = rand(rng, f).requires_grad_()
    return base, ops, w, bias


LAYOUTS = ["rows", "taps", "last", "nodes", "permuted", "ragged"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_project_through_the_plain_op_matches_the_chain(layout):
    """The kernel path on CPU bf16 operands runs the op's plain version
    through the autograd function: the output and the gradients of the
    operands, the weight (bf16-rounded) and the bias against ``_chain``."""
    rng = np.random.default_rng(LAYOUTS.index(layout))
    base, xs, w, bias = layout_case(layout, rng)
    before = dict(build.LAUNCHES)
    y = linear._kernel(xs, w, bias)
    want = linear._chain(xs, w, bias)
    assert y.shape == want.shape
    assert_bf16_close(y, want)
    g = rand(rng, *y.shape, dtype=torch.bfloat16)
    got = torch.autograd.grad(y, (base, w, bias), g)
    ref = torch.autograd.grad(want, (base, w, bias), g)
    assert_bf16_close(got[0], ref[0])
    assert_bf16_close(got[1].bfloat16(), ref[1].bfloat16())
    assert torch.allclose(got[2], ref[2], rtol=1e-5, atol=1e-5)
    assert build.LAUNCHES == before


def storage(t):
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("layout,o", [("taps", 2), ("last", 2),
                                      ("nodes", 10), ("permuted", 10),
                                      ("rows", 1)])
def test_row_views_read_operands_in_place(layout, o):
    """The (O, I, C) operands are views of the tensors given: the taps and
    last steps split after the batch, node-leading hops (B*T, N, C) and a
    (w, b, t, c) layout after (b, t), contiguous ones not at all."""
    base, xs, *_ = layout_case(layout, np.random.default_rng(0))
    rows = linear._row_views(xs)
    for r, x in zip(rows, xs):
        assert r.ndim == 3 and r.stride(2) == 1 and r.shape[0] == o
        assert storage(r) == storage(base)
        assert r.data_ptr() == x.data_ptr()
        assert torch.equal(r, x.reshape(r.shape))


def test_row_views_copy_only_what_has_no_view():
    """An operand whose channels are not unit-stride is copied; the others
    stay views."""
    rng = np.random.default_rng(3)
    a = rand(rng, 2, 3, 5, 4, dtype=torch.bfloat16)
    odd = rand(rng, 2, 3, 4, 5, dtype=torch.bfloat16).transpose(2, 3)
    rows = linear._row_views([a, odd])
    assert storage(rows[0]) == storage(a)
    assert storage(rows[1]) != storage(odd)
    assert torch.equal(rows[1].reshape(odd.shape), odd)


@pytest.mark.parametrize("case", ["operands", "shapes", "dtypes", "none"])
def test_project_refuses_what_the_kernel_cannot_take(case):
    """More operands than the kernel takes, none, or operands of different
    leading shapes or dtypes raise ``ValueError`` on every path: nothing
    falls back to the chain or broadcasts."""
    rng = np.random.default_rng(4)
    if case == "operands":
        xs = [rand(rng, 2, 3, 4, dtype=torch.bfloat16)
              for _ in range(chan_proj.MAX_OPERANDS + 1)]
    elif case == "shapes":
        xs = [rand(rng, 2, 3, 4, dtype=torch.bfloat16),
              rand(rng, 1, 3, 4, dtype=torch.bfloat16)]
    elif case == "dtypes":
        xs = [rand(rng, 2, 3, 4, dtype=torch.bfloat16), rand(rng, 2, 3, 4)]
    else:
        xs = []
    w = rand(rng, 5, 4 * max(len(xs), 1))
    bias = rand(rng, 5)
    with pytest.raises(ValueError, match="operands of one dtype"):
        linear.project(xs, w, bias)


@pytest.mark.parametrize("name", ["chan_proj", "chan_proj_dgrad",
                                  "chan_proj_wgrad"])
def test_chan_proj_ops_pass_opcheck(name):
    """Schema, fake kernel and dispatch of each op, on its CPU kernel."""
    rng = np.random.default_rng(5)
    base = rand(rng, 2, 7, 3, 8, dtype=torch.bfloat16)
    rows = [base[:, i:i + 6].reshape(2, 18, 8) for i in (0, 1)]
    w = rand(rng, 6, 16, dtype=torch.bfloat16)
    g = rand(rng, 2, 18, 6, dtype=torch.bfloat16)
    args = {"chan_proj": (rows, w, rand(rng, 6)),
            "chan_proj_dgrad": (g, w, rows),
            "chan_proj_wgrad": (rows, g)}[name]
    torch.library.opcheck(getattr(torch.ops.gwt_torch, name), args)


def test_chan_proj_flops_are_the_chains():
    """FlopCounterMode counts a projection's forward and backward as the
    fp32 chain's matmuls: 2 * rows * (sum C) * F each for the output, the
    operands' gradient and the weight's."""
    rng = np.random.default_rng(6)
    base, xs, w, bias = layout_case("taps", rng)
    rows = 2 * 5 * 7
    with FlopCounterMode(display=False) as fc:
        y = linear._kernel(xs, w, bias)
        y.backward(torch.ones_like(y))
    assert fc.get_total_flops() == 3 * 2 * rows * 16 * 6
