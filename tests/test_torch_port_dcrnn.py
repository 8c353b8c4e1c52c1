"""DCRNN in the port (``models/dcrnn.py``, ``ops/diffusion.py``'s DCRNN
functions, ``train/engine.py:DCRNNEngine``) held on the CPU to the plain
float32 reference ``tests/dcrnn_reference.py``, on seeded random weights:
the forward pass, the loss, every gradient leaf, and three Adam steps
whose coins take both outcomes, over dense supports (N = 24) and over
fused flat block-sparse ones (N = 256 in 128-node blocks, through the
kernels' plain versions). Beside them: the carry across supports changes
the result, the folded hop form equals the features DCRNN concatenates,
and the state is carried in float32 under bfloat16 activations.

Tolerances: the port and the reference compute the same fp32 function in
other orders (the recurrence folded into the weight, the hops as node-
leading products, the padded input's zero columns), so they agree to
float32 round-off grown over 2 x (seq_len + horizon) dependent cells.
"""

import math

import numpy as np
import pytest
import torch

import dcrnn_reference as ref
from graph_wavenet_tpu_torch.config import DCRNNConfig, TrainConfig
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.models import dcrnn
from graph_wavenet_tpu_torch.ops import block_sparse, diffusion
from graph_wavenet_tpu_torch.train.engine import DCRNNEngine

SCALER = {"mean": 50.0, "std": 15.0}
OPT = {"learning_rate": 0.01, "epsilon": 1e-3, "grad_clip": 5.0}
# fp32 round-off over the cells' chain (measured: the loss 8e-8 dense,
# 1.6e-7 flat; the worst gradient leaf 8e-7, 1.4e-6 of its largest entry):
# the loss to 1e-6, each leaf and the weights after three steps to 2e-5
# of the leaf's largest entry
LOSS_RTOL = 1e-6
LEAF_RTOL = 2e-5
# where the curriculum's threshold is 0.5 (tau = 2000): both coins occur
HALF_STEP = round(2000 * math.log(2000))


def cfg_of(n: int, dtype: str = "float32") -> DCRNNConfig:
    return DCRNNConfig(num_nodes=n, input_dim=2, output_dim=1, rnn_units=8,
                       num_rnn_layers=2, max_diffusion_step=2, seq_len=4,
                       horizon=4, dtype=dtype)


def ref_cfg(cfg: DCRNNConfig) -> dict:
    return {k: getattr(cfg, k) for k in (
        "num_rnn_layers", "rnn_units", "max_diffusion_step", "output_dim",
        "horizon")}


def graph(n: int, k: int = 4, seed: int = 0):
    """A seeded directed k-NN-like edge list with positive weights."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 2))
    d = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    nbr = np.argsort(d, axis=1)[:, :k]
    src = np.repeat(np.arange(n), k)
    dst = nbr.reshape(-1)
    w = np.exp(-d[src, dst] / d[src, dst].std())
    return src, dst, w


def supports(kind: str, n: int):
    """(the port's supports, the reference's dense pair)."""
    src, dst, w = graph(n)
    dense = ref.supports_from_edges(src, dst, w, n)
    if kind == "dense":
        return [a.clone() for a in dense], dense
    port = []
    for s, d in ((src, dst), (dst, src)):
        vals = ref.transition(s, d, w, n)[s, d]
        port.append(block_sparse.as_fused2(block_sparse.from_edges_flat(
            s, d, vals, n, 128, 128, device="cpu")))
    assert all(isinstance(p, block_sparse.Fused2FlatSupport) for p in port)
    return port, dense


def batch(cfg: DCRNNConfig, b: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, cfg.seq_len, cfg.num_nodes, cfg.input_dim),
                    generator=g)
    y = 50.0 + 15.0 * torch.randn((b, cfg.horizon, cfg.num_nodes, 2),
                                  generator=g)
    y[..., 0] = torch.where(torch.rand(y[..., 0].shape, generator=g) < 0.1,
                            torch.zeros(()), y[..., 0])
    return x, y


def engine_of(cfg: DCRNNConfig, seed: int = 0) -> DCRNNEngine:
    return DCRNNEngine(cfg, TrainConfig(learning_rate=OPT["learning_rate"],
                                        weight_decay=0.0),
                       StandardScaler(**SCALER), device="cpu", seed=seed)


def weights(engine) -> dict:
    return {k: v.detach().clone() for k, v in
            engine.model.named_parameters()}


def assert_leaves(port: dict, want: dict, rtol: float = LEAF_RTOL):
    assert set(port) == set(want)
    for k, w in want.items():
        gap = float((port[k].double() - w.double()).abs().max())
        scale = max(float(w.abs().max()), 1e-12)
        assert gap <= rtol * scale, (k, gap / scale)


@pytest.mark.parametrize("kind,n", [("dense", 24), ("flat", 256)])
def test_forward_loss_and_gradients_match_the_reference(kind, n):
    cfg = cfg_of(n)
    sups, dense = supports(kind, n)
    engine = engine_of(cfg)
    x, y = batch(cfg, 3)
    teacher = torch.tensor([True, False, True])
    engine._teacher = lambda: teacher
    engine.model.train()
    loss, _ = engine._loss(x, y, sups)
    loss.backward()
    loss = float(loss.detach())
    p = weights(engine)
    rp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want = ref.loss_of(rp, x, y, dense, ref_cfg(cfg), SCALER,
                       teacher.tolist())
    want.backward()
    assert loss == pytest.approx(float(want.detach()), rel=LOSS_RTOL)
    assert_leaves({k: v.grad for k, v in engine.model.named_parameters()},
                  {k: v.grad for k, v in rp.items()})
    # the forward itself, in eval mode: the decoder feeds itself back
    engine.model.eval()
    with torch.no_grad():
        out = engine.model(x, sups)
        want_out = ref.forward(p, x, dense, ref_cfg(cfg))
    assert_leaves({"out": out}, {"out": want_out})


def coins(seed: int, steps: int, horizon: int, start: int) -> list:
    """The teacher-forcing decisions a CPU engine seeded ``seed`` draws in
    its first ``steps`` steps from global step ``start``."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in range(start, start + steps):
        u = torch.rand((horizon - 1,), generator=g)
        p = dcrnn.curriculum_threshold(torch.tensor(s), 2000)
        out.append((u < p).tolist())
    return out


@pytest.mark.parametrize("kind,n", [("dense", 24), ("flat", 256)])
def test_three_adam_steps_match_the_reference(kind, n):
    cfg = cfg_of(n)
    sups, dense = supports(kind, n)
    engine = engine_of(cfg, seed=5)
    engine.set_global_step(HALF_STEP)
    p0 = weights(engine)
    xs, ys = batch(cfg, 8, seed=2)
    idx = np.array([[0, 3], [5, 1], [7, 2]])
    out = engine.train_steps_resident(xs, ys, idx, sups)
    teachers = coins(5, 3, cfg.horizon, HALF_STEP)
    flat = sum(teachers, [])
    assert any(flat) and not all(flat), teachers
    assert dcrnn.read_counts(engine.model)["teacher_forced"] == sum(flat)
    assert int(engine._global) == HALF_STEP + 3
    res = ref.train_steps(p0, [(xs[r], ys[r]) for r in idx], dense,
                          ref_cfg(cfg), OPT, SCALER, teachers)
    np.testing.assert_allclose(out["loss"].tolist(), res["losses"],
                               rtol=LOSS_RTOL)
    assert_leaves(weights(engine), res["params"])


def test_the_carry_across_supports_changes_the_result():
    """Resetting x0 between supports (the paper's per-support chain) is
    another function: the comparison above would refuse it."""
    cfg = cfg_of(24)
    sups, dense = supports("dense", 24)
    engine = engine_of(cfg)
    x, y = batch(cfg, 3)
    p = weights(engine)
    teacher = [True, False, True]
    engine._teacher = lambda: torch.tensor(teacher)
    engine.model.train()
    with torch.no_grad():
        loss = float(engine._loss(x, y, sups)[0])
        carried = float(ref.loss_of(p, x, y, dense, ref_cfg(cfg), SCALER,
                                    teacher))
        reset = float(ref.loss_of(p, x, y, dense, ref_cfg(cfg), SCALER,
                                  teacher, carry=False))
    assert loss == pytest.approx(carried, rel=LOSS_RTOL)
    assert abs(reset - loss) > 100 * LOSS_RTOL * abs(carried)


@pytest.mark.parametrize("kind,n", [("dense", 24), ("flat", 256)])
def test_the_folded_form_equals_the_features(kind, n):
    """Kernel-3 pairs with the recurrence folded into the weight columns,
    against the features DCRNN concatenates, in one projection each."""
    cfg = cfg_of(n)
    sups, _ = supports(kind, n)
    x, _ = batch(cfg, 3)
    models = [dcrnn.DCRNN(cfg, device="cpu", seed=3) for _ in range(2)]
    models[1].form = "features"
    with torch.no_grad():
        folded, feats = (m(x, sups) for m in models)
        cell = models[0].encoder[1]
        z = torch.randn((n, 3, 16))
        g = [cell.gconv(z, cell.gate, sups, f)
             for f in ("folded", "features")]
    assert_leaves({"gconv": g[0]}, {"gconv": g[1]})
    assert_leaves({"out": folded}, {"out": feats})


def test_bf16_activations_carry_the_state_in_fp32(monkeypatch):
    """Under bf16 activations every state a cell hands on is the fp32
    ``u * h + (1 - u) * c`` of its fp32 inputs, bit for bit, and the next
    cell takes it as it is: a state rounded to bf16 anywhere on the way
    fails here (no tolerance can tell it: it moves the loss by 1e-6 where
    the bf16 hops and projections move it by 3.5e-5). The bf16 loss stays
    within 5e-4 of the fp32 reference's (the raw speeds' MAE: bf16
    round-off of the outputs, ~2^-8 of the standardized values)."""
    cfg = cfg_of(24, "bfloat16")
    sups, dense = supports("dense", 24)
    seen = []
    update = dcrnn.gru_update

    def record(u, h, c):
        out = update(u, h, c)
        seen.append((u, h, c, out))
        return out

    monkeypatch.setattr(dcrnn, "gru_update", record)
    engine = engine_of(cfg)
    x, y = batch(cfg, 3)
    teacher = [True, False, True]
    engine._teacher = lambda: torch.tensor(teacher)
    engine.model.train()
    with torch.no_grad():
        loss = float(engine._loss(x, y, sups)[0])
    layers = cfg.num_rnn_layers
    assert len(seen) == layers * (cfg.seq_len + cfg.horizon)
    for i, (u, h, c, out) in enumerate(seen):
        assert h.dtype == out.dtype == torch.float32
        assert torch.equal(out, u * h + (1.0 - u) * c)
        if i >= layers:
            assert torch.equal(h, seen[i - layers][3])
    p = weights(engine)
    want = float(ref.loss_of(p, x, y, dense, ref_cfg(cfg), SCALER, teacher))
    assert loss == pytest.approx(want, rel=5e-4)


def test_fold_coefficients():
    """Each raw hop's weight block is the features' combination: with
    per-hop weights k + 1 over two supports, raw 0 gets 1 - 3, S1 z gets
    2 - 5, S1 S1 z 2 x 3, S2 S1 z 4 and S2 S2 S1 z 2 x 5."""
    w = torch.arange(1.0, 6.0)[None, :, None]
    got = diffusion.dcrnn_fold(w, 2)[0, :, 0].tolist()
    assert got == [-2.0, -3.0, 6.0, 4.0, 10.0]


def write_data(tmp, rng, n: int):
    """A METR-format dataset of ``n`` sensors in raw node order."""
    data = tmp / "data"
    data.mkdir()
    for split, s in (("train", 8), ("val", 4), ("test", 5)):
        x = rng.normal(5.0, 2.0, size=(s, 12, n, 2)).astype(np.float32)
        y = rng.normal(5.0, 2.0, size=(s, 12, n, 2)).astype(np.float32)
        np.savez(data / f"{split}.npz", x=x, y=y)
    return str(data)


@pytest.mark.parametrize("graph_kind", ["city", "adjdata"])
def test_the_training_cli_trains_dcrnn(tmp_path, graph_kind):
    """``--model dcrnn`` through the runner's fused resident steps, on a
    city graph's fused flat supports or on an adjacency pickle's dense
    pair; the checkpoint records the model."""
    import pickle

    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.graphs import city, spatial
    from graph_wavenet_tpu_torch.train import checkpoint as tckpt

    rng = np.random.default_rng(0)
    n = 40
    data = write_data(tmp_path, rng, n)
    if graph_kind == "city":
        pos = rng.random((n, 2))
        src, dst, w = spatial.knn_graph_edges(pos, 3)
        gpath = str(tmp_path / "g.npz")
        city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=n)
        graph = ["--graph_npz", gpath, "--block_size", "16", "--ordering",
                 "rcm"]
    else:
        adj = (rng.random((n, n)) < 0.3) * rng.random((n, n))
        path = str(tmp_path / "adj.pkl")
        with open(path, "wb") as f:
            pickle.dump(([str(i) for i in range(n)],
                         {str(i): i for i in range(n)},
                         adj.astype(np.float32)), f)
        graph = ["--adjdata", path, "--num_nodes", str(n)]
    out = train.main(["--model", "dcrnn", "--data", data, *graph,
                      "--device", "cpu", "--seq_length", "12",
                      "--batch_size", "4",
                      "--epochs", "1", "--scan_steps", "2",
                      "--learning_rate", "0.01", "--weight_decay", "0",
                      "--save", str(tmp_path / "ckpt")])
    res, runner = out["result"], out["runner"]
    assert isinstance(runner.engine, DCRNNEngine)
    assert runner.engine.step == 2
    assert np.isfinite(res.history[0].train["loss"])
    assert np.isfinite(res.test_metrics["mae"])
    meta = tckpt.load_metadata(res.best_checkpoint)
    assert meta["extra"]["model"] == "dcrnn"
    assert meta["model_cfg"].rnn_units == 64
    if graph_kind == "city":
        assert all(isinstance(s, block_sparse.Fused2FlatSupport)
                   for s in out["supports"])
