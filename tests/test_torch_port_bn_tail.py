"""The layer tail (dropout multiply, residual add, BatchNorm): its dispatch,
its ops on the CPU, and its kernels on the card.

bf16 activations on a CUDA device with statistics over every step run the
tail on the layer-tail kernel (``ops.cuda.bn_tail`` through
``BatchNorm.tail``); every other dtype and device, and time-halo sequence
parallelism's ``t_valid``, keep the chain of PyTorch ops. On the CPU: the
ops' plain versions through the tail's autograd function against the
module chain they replace (x bit for bit, y and every gradient within
stated fp32 tolerances), a whole model step through them against the
chain's, the fake kernels (``opcheck``) and the dispatch.

Cases marked ``cuda`` skip where no CUDA device is present. On a machine
with a card and nvcc:

    python -m pytest tests/test_torch_port_bn_tail.py --noconftest -q

They hold the kernels against the plain versions at the city layers'
widths, forward and backward, eval too, repeat a captured graph bit for
bit, and count the launches of a graphed model step.
"""

import numpy as np
import pytest
import torch

from graph_wavenet_tpu_torch.ops import normalization
from graph_wavenet_tpu_torch.ops.cuda import bn_tail, build
from graph_wavenet_tpu_torch.ops.normalization import BatchNorm

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]
# the city layers' output steps (12 inputs padded to 13, kernel 2,
# dilations 1, 2, 1, 2, ...)
CITY_STEPS = [12, 10, 9, 7, 6, 4, 3, 1]
TRAIN_OPS = ("bn_tail_stats", "bn_tail_var", "bn_tail_apply",
             "bn_tail_grad_reduce", "bn_tail_grad_apply")


def tail_launches() -> dict:
    return {k: build.LAUNCHES[k] for k in bn_tail.OPS}


def rand(gen, *shape, dtype=torch.float32, device="cpu", scale=1.0):
    t = torch.randn(*shape, generator=gen, device=device) * scale
    return t.to(dtype)


def drop_mask(gen, shape, dtype, device="cpu", p=0.3):
    keep = torch.rand(shape, generator=gen, device=device) < 1.0 - p
    return keep.to(dtype) / torch.full((), 1.0 - p, dtype=dtype,
                                       device=device)


def bn_module(c, gen, train, device="cpu"):
    """A BatchNorm with weights, bias and running statistics off their
    initial values."""
    bn = BatchNorm(c, device=device)
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen).to(device))
        bn.bias.copy_(0.2 * torch.randn(c, generator=gen).to(device))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen).to(device))
        bn.running_var.copy_(torch.rand(c, generator=gen).to(device) + 0.5)
    bn.train(train)
    return bn


def tail_case(dtype, mask, residual, seed=0, shape=(3, 5, 7, 16), t_in=7,
              device="cpu"):
    """(h, drop, res, dy) leaves: h (B, T, N, C) requiring a gradient, the
    mask or None, the residual (B, t_in, N, C) or None, the output's
    cotangent; values off zero mean and unit variance, as a layer's are."""
    gen = torch.Generator().manual_seed(seed)
    b, t, n, c = shape
    h = (rand(gen, *shape) * 2.0 + 0.5).to(dtype).to(device)
    drop = drop_mask(gen, shape, dtype).to(device) if mask else None
    res = None
    if residual:
        res = rand(gen, b, t_in, n, c, dtype=dtype).to(device)
        res.requires_grad_()
    h.requires_grad_()
    dy = rand(gen, *shape, dtype=dtype).to(device)
    return h, drop, res, dy


def chain_tail(bn, h, drop, res):
    x = h if drop is None else h * drop
    if res is not None:
        x = x + res[:, -x.shape[1]:]
    y, stats = bn._chain(x, None, None, None)
    return x, y, stats


def grads(y, leaves, dy):
    return torch.autograd.grad(y, leaves, dy)


def assert_close(got, want, dtype, what):
    """fp32: within 2e-5 of the largest value, plus a relative 1e-5; bf16:
    within one bf16 ulp of the value plus 2^-8 of the largest (one
    rounding of a result whose fp32 sums ran in another order)."""
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max()) or 1.0
    if dtype == torch.float32:
        tol = 2e-5 * scale + 1e-5 * want.abs()
    else:
        tol = 2.0 ** -7 * want.abs() + 2.0 ** -8 * scale
    err = (got - want).abs()
    assert bool((err <= tol).all()), (
        f"{what}: worst {float(err.max())} against {float(tol.min())}")


# ---------------------------------------------------------------------------
# the ops' plain versions against the chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", [True, False], ids=["res", "nores"])
@pytest.mark.parametrize("mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plain_tail_matches_the_chain(dtype, train, mask, residual):
    """The tail through the ops (their CPU kernels) and the autograd
    function against the module chain: x bit for bit, y, the statistics
    and the gradients of h, the residual, the weight and the bias within
    :func:`assert_close`."""
    gen = torch.Generator().manual_seed(1)
    bn = bn_module(16, gen, train)
    h, drop, res, dy = tail_case(dtype, mask, residual)
    leaves = [h, bn.weight, bn.bias] + ([res] if residual else [])
    x_want, y_want, st_want = chain_tail(bn, h, drop, res)
    g_want = grads(y_want, leaves, dy)
    running = None if train else (bn.running_mean.float(),
                                  bn.running_var.float())
    y, st = bn_tail.tail(h, drop, res, bn.weight, bn.bias, bn.eps,
                         count=None, running=running)
    g = grads(y, leaves, dy)
    resv = None if res is None else res[:, -h.shape[1]:]
    x, _ = torch.ops.gwt_torch.bn_tail_stats(h.detach(), drop,
                                             None if resv is None
                                             else resv.detach())
    assert torch.equal(x, x_want.detach())
    assert y.dtype == dtype and y.shape == h.shape
    assert_close(y, y_want, dtype, "y")
    if train:
        for a, b, name in zip(st[:2], st_want[:2], ("mean", "var")):
            assert_close(a, b, torch.float32, name)
        assert st[2] == st_want[2]
    else:
        assert st is None and st_want is None
    for a, b, name in zip(g, g_want, ("h", "weight", "bias", "residual")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert_close(a, b, b.dtype, name)


def test_plain_tail_reads_a_strided_residual_and_mask():
    """A residual that is a slice of the batch (its rows an other stride)
    and a mask sliced out of a wider draw, as a data-parallel rank holds
    them: the same results as on contiguous copies."""
    gen = torch.Generator().manual_seed(2)
    bn = bn_module(8, gen, True)
    b, t, n, c = 2, 4, 5, 8
    big = rand(gen, 2 * b, 6, n, c, dtype=torch.bfloat16)
    res = big[b:].requires_grad_(False)
    wide = drop_mask(gen, (2 * b, t, n + 3, c), torch.bfloat16)
    drop = wide[:b, :, 2:2 + n]
    h = rand(gen, b, t, n, c, dtype=torch.bfloat16).requires_grad_()
    y, st = bn_tail.tail(h, drop, res, bn.weight, bn.bias, bn.eps)
    y2, st2 = bn_tail.tail(h, drop.contiguous(), res.contiguous(),
                           bn.weight, bn.bias, bn.eps)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(st[:2], st2[:2]))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_model_step_through_the_plain_tail_matches_the_chain(dtype,
                                                             monkeypatch):
    """A small GWNet train step with dropout, the tail sent through the
    ops (their CPU kernels) against the chain: the loss, every gradient
    and the tracked BatchNorm statistics within tolerance; then an eval
    forward likewise."""
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.models.gwnet import GWNet

    n = 12
    rng = np.random.default_rng(3)
    a = rng.random((2, n, n)).astype(np.float32)
    sups = [torch.as_tensor(m / m.sum(-1, keepdims=True)) for m in a]
    cfg = ModelConfig(num_nodes=n, residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=16, blocks=2, layers=2,
                      dropout=0.3,
                      dtype="bfloat16" if dtype == torch.bfloat16
                      else "float32")
    x = torch.as_tensor(rng.normal(size=(3, 13, n, 2)).astype(np.float32))
    y = torch.as_tensor(rng.normal(size=(3, 1, n, 12)).astype(np.float32))

    def run(kernel):
        with monkeypatch.context() as mp:
            if kernel:
                mp.setattr(normalization, "takes_tail_kernel",
                           lambda h, t_valid: t_valid is None)
            else:
                mp.setattr(bn_tail, "tail", refuse)
            model = GWNet(cfg, device="cpu", seed=0)
            model.train()
            gen = torch.Generator().manual_seed(7)
            out = model(x, sups, generator=gen)
            loss = (out - y).abs().mean()
            loss.backward()
            model.eval()
            with torch.no_grad():
                pred = model(x, sups)
        g = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
        bufs = {k: v.clone() for k, v in model.named_buffers()}
        return float(loss), g, bufs, pred

    loss, g, bufs, pred = run(True)
    loss0, g0, bufs0, pred0 = run(False)
    tol = 1e-5 if dtype == torch.float32 else 2e-3
    assert abs(loss - loss0) <= tol * abs(loss0)
    assert g.keys() == g0.keys()
    for k in g0:
        scale = float(g0[k].abs().max()) or 1.0
        err = float((g[k] - g0[k]).abs().max())
        assert err <= (1e-4 if dtype == torch.float32 else 5e-2) * scale, k
    for k in bufs0:
        assert torch.allclose(bufs[k].float(), bufs0[k].float(), rtol=1e-3,
                              atol=1e-5), k
    assert torch.allclose(pred, pred0, rtol=tol * 10, atol=tol * 10)


def group_case():
    """The whole batch of the process-group check: (h, drop, res, dy)
    leaves of batch 4 and the BatchNorm's state."""
    h, drop, res, dy = tail_case(torch.bfloat16, True, True, seed=8,
                                 shape=(4, 3, 5, 8), t_in=5)
    return h, drop, res, dy


def _group_worker(rank: int, world: int, port: int, out: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        h, drop, res, dy = group_case()
        rows = slice(rank * 4 // world, (rank + 1) * 4 // world)
        h = h.detach()[rows].requires_grad_()
        res = res.detach()[rows].requires_grad_()
        bn = bn_module(8, torch.Generator().manual_seed(8), True)
        y, st = bn_tail.tail(h, drop[rows], res, bn.weight, bn.bias, bn.eps,
                             dist.group.WORLD)
        g = grads(y, (h, res, bn.weight, bn.bias), dy[rows])
        torch.save({"y": y.detach(), "mean": st[0], "var": st[1],
                    "count": st[2], "grads": [t.detach() for t in g]},
                   f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_plain_tail_under_a_process_group_is_the_whole_batch(tmp_path):
    """Two gloo ranks, each with half the batch, through the ops (their CPU
    kernels): each rank's statistics, y and input gradients those of one
    process over the whole batch, and the ranks' weight and bias gradients
    summing to its (the data-parallel all-reduce sums them)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_group_worker, args=(2, port, str(tmp_path)), nprocs=2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    h, drop, res, dy = group_case()
    bn = bn_module(8, torch.Generator().manual_seed(8), True)
    y, st = bn_tail.tail(h, drop, res, bn.weight, bn.bias, bn.eps)
    want = grads(y, (h, res, bn.weight, bn.bias), dy)
    for r, got in enumerate(ranks):
        rows = slice(2 * r, 2 * r + 2)
        assert got["count"] == st[2]
        assert_close(got["mean"], st[0], torch.float32, "mean")
        assert_close(got["var"], st[1], torch.float32, "var")
        assert_close(got["y"], y[rows], torch.bfloat16, "y")
        assert_close(got["grads"][0], want[0][rows], torch.bfloat16, "h")
        assert_close(got["grads"][1], want[1][rows], torch.bfloat16, "res")
    for k, name in ((2, "weight"), (3, "bias")):
        assert_close(ranks[0]["grads"][k] + ranks[1]["grads"][k], want[k],
                     torch.float32, name)


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

def refuse(*args, **kwargs):
    raise AssertionError("the tail kernel's path was taken")


@pytest.mark.parametrize("case", ["f32", "bf16_cpu", "t_valid"])
def test_the_chain_keeps_what_the_kernel_does_not_take(case, monkeypatch):
    """fp32, CPU and ``t_valid`` tails keep the chain: the kernel path
    patched to raise is never reached, and the result is the chain's bit
    for bit."""
    monkeypatch.setattr(bn_tail, "tail", refuse)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    gen = torch.Generator().manual_seed(4)
    bn = bn_module(16, gen, True)
    h, drop, res, dy = tail_case(dtype, True, True)
    t_valid = 3 if case == "t_valid" else None
    y, st = bn.tail(h, res, drop, t_valid=t_valid)
    x = h * drop + res[:, -h.shape[1]:]
    y2, st2 = bn._chain(x, None, t_valid, None)
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(st[:2], st2[:2]))
    y3, _ = bn.normalize(x, t_valid=t_valid)
    assert torch.equal(y3, y2)


def test_dispatch_rule():
    """bf16 on a CUDA device with every step in the statistics takes the
    kernel; another dtype, the CPU or ``t_valid`` does not."""
    class Fake:
        def __init__(self, dtype, device):
            self.dtype, self.device = dtype, torch.device(device)

    rule = normalization.takes_tail_kernel
    assert rule(Fake(torch.bfloat16, "cuda"), None)
    assert not rule(Fake(torch.bfloat16, "cuda"), 3)
    assert not rule(Fake(torch.float32, "cuda"), None)
    assert not rule(Fake(torch.bfloat16, "cpu"), None)


def test_plan_fixes_the_grid():
    """The city's first layer (batch 4, 12 steps, 40,960 nodes, 32
    channels) on 132 SMs: 4 threads a row, 64 rows a block, 22 blocks a
    plane; one step's plane takes 264 blocks; 1,025 channels refused."""
    assert bn_tail.plan(4, 12, 40960, 32, 8, 132) == (4, 64, 22)
    assert bn_tail.plan(4, 1, 40960, 32, 8, 132) == (4, 64, 264)
    assert bn_tail.plan(1, 1, 10, 12, 1, 132) == (12, 21, 1)
    with pytest.raises(ValueError, match="channels"):
        bn_tail.plan(1, 1, 10, 1025, 1, 132)


# ---------------------------------------------------------------------------
# the fake kernels
# ---------------------------------------------------------------------------

def op_args(name, device="cpu"):
    gen = torch.Generator().manual_seed(5)
    b, t, n, c = 2, 3, 5, 8
    h = rand(gen, b, t, n, c, dtype=torch.bfloat16).to(device)
    drop = drop_mask(gen, (b, t, n, c), torch.bfloat16).to(device)
    res = rand(gen, b, t + 2, n, c, dtype=torch.bfloat16).to(device)
    vec = [rand(gen, c).to(device) for _ in range(4)]
    inv = vec[1].abs() + 0.5
    sums = rand(gen, 2, c).to(device)
    return {
        "bn_tail_stats": (h, drop, res[:, -t:]),
        "bn_tail_var": (h, vec[0]),
        "bn_tail_apply": (h, vec[0], inv, vec[2], vec[3]),
        "bn_tail_eval": (h, None, res[:, -t:], vec[0], inv, vec[2],
                         vec[3]),
        "bn_tail_grad_reduce": (h, drop, vec[0], inv),
        "bn_tail_grad_apply": (h, drop, None, vec[0], inv, vec[2], sums,
                               b * t * n, t + 2),
    }[name]


OPS = ["bn_tail_stats", "bn_tail_var", "bn_tail_apply", "bn_tail_eval",
       "bn_tail_grad_reduce", "bn_tail_grad_apply"]


@pytest.mark.parametrize("name", OPS)
def test_ops_pass_opcheck(name):
    """Schema, fake kernel and dispatch of each op, on its CPU kernel."""
    torch.library.opcheck(getattr(torch.ops.gwt_torch, name), op_args(name))


@pytest.mark.parametrize("name", OPS)
def test_fake_kernels_give_the_plain_shapes_and_dtypes(name):
    """Each fake kernel's outputs have the plain version's shapes and
    dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = op_args(name)
    want = getattr(torch.ops.gwt_torch, name)(*args)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = getattr(torch.ops.gwt_torch, name)(*fake)
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_case(card, t, n=2048, c=32, b=4, dilation=2, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (b, t, n, c)
    h = (torch.randn(shape, generator=gen, device=card) * 2 + 0.5).bfloat16()
    drop = drop_mask(gen, shape, torch.bfloat16, device=card)
    res = torch.randn((b, t + dilation, n, c), generator=gen,
                      device=card).bfloat16()
    dy = torch.randn(shape, generator=gen, device=card).bfloat16()
    vec = [torch.randn(c, generator=gen, device=card) for _ in range(3)]
    return h, drop, res, dy, vec


def assert_bf16_close(got, want, what):
    """Within one bf16 ulp of the value plus 2^-16 of the largest (the
    plain version's fp32 sums run in another order)."""
    got, want = got.double(), want.double()
    tol = 2.0 ** -7 * want.abs() + 2.0 ** -16 * float(want.abs().max())
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"{what}: worst {float(err.max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("t", CITY_STEPS)
def test_kernels_match_plain_at_the_city_widths(card, t):
    """Each op's CUDA kernel against its plain version on the same card
    tensors at a city layer's width (batch 4, 32 channels, a cut node
    count), the residual the input's last t steps: x bit for bit, the sums
    within 1e-5 of their scale, y, dh and dres within a bf16 ulp, the
    residual's leading steps zero."""
    ops = torch.ops.gwt_torch
    h, drop, res, dy, (w, b, m0) = card_case(card, t)
    resv = res[:, -t:]
    build.reset_launch_counts()
    x, s1 = ops.bn_tail_stats(h, drop, resv)
    xw, s1w = bn_tail.stats_plain(h, drop, resv)
    assert torch.equal(x, xw)
    count = h.numel() // h.shape[-1]
    torch.testing.assert_close(s1, s1w, rtol=1e-5,
                               atol=1e-5 * float(s1w.abs().max()))
    mean = s1w / count
    s2 = ops.bn_tail_var(x, mean)
    torch.testing.assert_close(s2, bn_tail.var_plain(x, mean), rtol=1e-5,
                               atol=0)
    inv = torch.rsqrt(s2 / count + 1e-5)
    assert_bf16_close(ops.bn_tail_apply(x, mean, inv, w, b),
                      bn_tail.apply_plain(x, mean, inv, w, b), "apply")
    rm, rinv = 0.1 * m0, inv * 0.7
    assert_bf16_close(ops.bn_tail_eval(h, None, resv, rm, rinv, w, b),
                      bn_tail.eval_plain(h, None, resv, rm, rinv, w, b),
                      "eval")
    sums = ops.bn_tail_grad_reduce(dy, x, mean, inv)
    sums_w = bn_tail.grad_reduce_plain(dy, x, mean, inv)
    torch.testing.assert_close(sums, sums_w, rtol=1e-5,
                               atol=1e-5 * float(sums_w.abs().max()))
    dh, dres = ops.bn_tail_grad_apply(dy, x, drop, mean, inv, w, sums_w,
                                      count, res.shape[1])
    dhw, dresw = bn_tail.grad_apply_plain(dy, x, drop, mean, inv, w, sums_w,
                                          count, res.shape[1])
    assert_bf16_close(dh, dhw, "dh")
    assert_bf16_close(dres, dresw, "dres")
    assert not dres[:, :res.shape[1] - t].any()
    assert tail_launches() == dict.fromkeys(bn_tail.OPS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [12, 8, 64])
def test_kernels_take_odd_widths_and_views(card, c):
    """Widths that are no multiple of 8 and views off 16-byte alignment
    (element loads) against the plain versions, through the tail's
    autograd function, forward and backward."""
    gen = torch.Generator(device=card).manual_seed(c)
    base = torch.randn(2, 4, 37, c + 1, generator=gen,
                       device=card).bfloat16()
    h = base[..., 1:].contiguous()[:, 1:].clone().requires_grad_()
    res = base[..., 1:].clone().requires_grad_()      # 4 steps, reads 3
    drop = drop_mask(gen, (2, 3, 37, c + 1), torch.bfloat16,
                     device=card)[..., 1:]
    bn = bn_module(c, torch.Generator().manual_seed(c), True, device=card)
    dy = torch.randn(h.shape, generator=gen, device=card).bfloat16()
    y, st = bn.tail(h, res, drop)
    got = grads(y, (h, res, bn.weight, bn.bias), dy)
    hc, rc = (h.detach().cpu().requires_grad_(),
              res.detach().cpu().requires_grad_())
    bnc = bn_module(c, torch.Generator().manual_seed(c), True)
    yc, stc = bn_tail.tail(hc, drop.cpu(), rc, bnc.weight, bnc.bias, bnc.eps)
    want = grads(yc, (hc, rc, bnc.weight, bnc.bias), dy.cpu())
    assert_bf16_close(y.cpu(), yc, "y")
    for a, b, name in zip(got, want, ("h", "res", "w", "b")):
        if b.dtype == torch.float32:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))
        else:
            assert_bf16_close(a.cpu(), b, name)


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_under_graph_replay(card):
    """The training tail forward and backward captured in a CUDA graph and
    replayed on new inputs: each replay equal to an eager run bit for bit,
    and a repeat equal to itself."""
    bn = bn_module(32, torch.Generator().manual_seed(9), True, device=card)
    h, drop, res, dy, _ = card_case(card, 9, n=4096)
    h.requires_grad_()
    res.requires_grad_()

    def step():
        y, st = bn.tail(h, res, drop)
        return (y, st[0], st[1]) + grads(y, (h, res, bn.weight, bn.bias),
                                         dy)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        step()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    gen = torch.Generator(device=card).manual_seed(10)
    for _ in range(2):
        with torch.no_grad():
            h.copy_(torch.randn(h.shape, generator=gen, device=card))
            dy.normal_(generator=gen)
        graph.replay()
        first = [t.clone() for t in captured]
        graph.replay()
        want = step()
        for a, b, c in zip(captured, first, want):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_graphed_model_step_launches_the_tail_per_layer(card):
    """One call of two fused bf16 train steps of a 2,048-node city model
    (the first eager, the second captured) launches each forward kind of
    the tail 8 times a step, one per layer, and each backward kind 7 times
    (the last layer's output reaches no loss term), and a no-grad eval
    forward launches ``eval`` 8 times and nothing else."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.graphs.spatial import knn_graph_edges
    from graph_wavenet_tpu_torch.train.engine import Engine

    n = 2048
    rng = np.random.default_rng(11)
    pos = rng.random((n, 2))
    src, dst, w = knn_graph_edges(pos, 8)
    sup, mask, _ = build_city_supports(src, dst, w, n, pos=pos,
                                       ordering="rcm", form="flat",
                                       addaptadj=True, device=card)
    sups = [s.astype(torch.bfloat16) for s in sup] + [mask]
    cfg = ModelConfig(num_nodes=n, dropout=0.3, dtype="bfloat16")
    eng = Engine(cfg, TrainConfig(), StandardScaler(50.0, 10.0),
                 device=card, seed=0)
    xs = torch.randn(8, 12, n, 2, device=card)
    ys = 50 + 10 * torch.randn(8, 12, n, 2, device=card)
    idx = np.arange(8, dtype=np.int64).reshape(2, 4)
    layers = cfg.blocks * cfg.layers
    build.reset_launch_counts()
    loss = eng.train_steps_resident(xs, ys, idx, sups)["loss"]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss).all())
    # the last layer's output reaches no loss term: no backward there
    assert tail_launches() == {
        "bn_tail_stats": 2 * layers, "bn_tail_var": 2 * layers,
        "bn_tail_apply": 2 * layers, "bn_tail_grad_reduce": 2 * (layers - 1),
        "bn_tail_grad_apply": 2 * (layers - 1), "bn_tail_eval": 0}
    build.reset_launch_counts()
    eng.model.eval()
    with torch.no_grad():
        eng.model(xs[:2], sups)
    assert tail_launches() == dict(dict.fromkeys(TRAIN_OPS, 0),
                                   bn_tail_eval=layers)
