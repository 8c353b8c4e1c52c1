"""The port's runner on the CPU: its three train feeds agree, and its
checkpoint pruning, asynchronous writer, early stop, watchdog, resume and
``history.jsonl`` behave as the JAX package's (``tests/test_runner.py``
is the model); the training CLI takes ``--resident``, ``--scan_steps``,
``--resume``, ``--early_stop``, ``--grad_accum`` and ``--epoch_timeout``
end to end on a METR dataset the port's ETL writes.

On the CPU the fused feeds run the eager loop of the same steps, so a run
through them equals the per-step run bit for bit; the card holds the CUDA
graph to the eager step (``tests/test_torch_port_cuda.py``)."""

import dataclasses
import glob
import json
import os
import pickle

import numpy as np
import pytest
import torch

from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
from graph_wavenet_tpu_torch.data import metr as tmetr
from graph_wavenet_tpu_torch.data.device_loader import DeviceArrayLoader
from graph_wavenet_tpu_torch.data.loader import DataLoader
from graph_wavenet_tpu_torch.data.scaler import StandardScaler
from graph_wavenet_tpu_torch.train import checkpoint as tckpt
from graph_wavenet_tpu_torch.train.engine import Engine
from graph_wavenet_tpu_torch.train.runner import DeviceWedgedError, Runner

CPU = "cpu"
N = 8


def arrays(seed=0):
    """A learnable toy task: targets a fixed map of an AR-like signal."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(56, 12, N, 2)).astype(np.float32)
    y = (np.roll(x, -1, axis=1) * 2.0 + 5.0).astype(np.float32)
    a = rng.random((2, N, N)).astype(np.float32)
    return x, y, [torch.as_tensor(s / s.sum(-1, keepdims=True)) for s in a]


def dataset(resident: str, seed: int = 0):
    """Train/val/test splits of :func:`arrays` in host or device-resident
    batchers sharing one seeded Generator, batch 4."""
    x, y, sups = arrays()
    rng = np.random.default_rng(seed)
    cls = ((lambda a, b: DataLoader(a, b, 4, rng)) if resident == "host"
           else (lambda a, b: DeviceArrayLoader(a, b, 4, rng=rng,
                                                device=CPU)))
    data = {"train_loader": cls(x[:30], y[:30]),
            "val_loader": cls(x[30:42], y[30:42]),
            "test_loader": cls(x[42:], y[42:]), "y_test": y[42:]}
    return data, sups


def make_runner(tmp_path, **tc):
    cfg = ModelConfig(num_nodes=N, out_dim=12, residual_channels=4,
                      dilation_channels=4, skip_channels=8, end_channels=8,
                      blocks=2, layers=2, dropout=0.3, n_supports=2)
    tcfg = TrainConfig(**{"epochs": 2, "learning_rate": 3e-3,
                          "save_dir": str(tmp_path), "print_every": 1000,
                          "batch_size": 4, **tc})
    engine = Engine(cfg, tcfg, StandardScaler(5.0, 2.0), device=CPU, seed=0)
    return Runner(engine, tcfg, log_fn=lambda *a: None)


def checkpoints(path) -> list:
    return sorted(glob.glob(os.path.join(str(path), "*.pt")))


def test_fused_feeds_fit_like_the_per_step_feed(tmp_path):
    """Two epochs through the host batcher, the device batcher per step
    and the device batcher fused (scan_steps 3: two superbatches and a
    remainder batch per epoch, one fused validation pass): the same
    history, bit for bit, and the same final weights."""
    runs = {}
    for name, resident, scan in (("host", "host", 1),
                                 ("device", "device", 1),
                                 ("fused", "device", 3)):
        data, sups = dataset(resident)
        runner = make_runner(tmp_path / name, scan_steps=scan)
        runs[name] = (runner, runner.fit(data, sups), data, sups)
    want, wres = runs["host"][:2]
    for name in ("device", "fused"):
        got, gres = runs[name][:2]
        assert [(h.train, h.valid) for h in gres.history] == [
            (h.train, h.valid) for h in wres.history], name
        for k, v in want.engine.model.state_dict().items():
            assert torch.equal(got.engine.model.state_dict()[k], v), (name, k)
        assert got.engine.step == want.engine.step == 2 * 8
    runner, res, data, sups = runs["fused"]
    res = runner.test(data, sups, res)
    assert len(res.per_horizon) == 12 and np.isfinite(res.test_metrics["mae"])


def test_runner_refusals(tmp_path):
    data, sups = dataset("device")
    runner = make_runner(tmp_path, scan_steps=2, grad_accum=2)
    with pytest.raises(ValueError, match="grad_accum > 1 does not combine"):
        runner.fit(data, sups)
    # prefetch runs without a mesh and is refused under one
    eng = make_runner(tmp_path, prefetch=2).engine
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    eng.mesh = eng.model.mesh = make_mesh(device=CPU)
    with pytest.raises(ValueError, match="prefetch > 0"):
        Runner(eng, dataclasses.replace(eng.train_cfg, prefetch=2))


def test_grad_accum_fit(tmp_path):
    """grad_accum 2 through the per-step feed: one optimizer step per
    batch, the running statistics updated once per step."""
    data, sups = dataset("device")
    runner = make_runner(tmp_path, grad_accum=2)
    result = runner.fit(data, sups)
    assert runner.engine.step == 2 * 8
    sd = runner.engine.model.state_dict()
    assert int(sd["bn.0.num_batches_tracked"]) == 2 * 8
    assert all(np.isfinite(h.train["loss"]) for h in result.history)


@pytest.mark.parametrize("keep", [1, 2])
def test_checkpoint_pruning_keeps_the_best(tmp_path, keep):
    """Asynchronous writes pruned to the best ``keep``; the best one is
    kept and reloaded."""
    data, sups = dataset("device")
    runner = make_runner(tmp_path, epochs=4, keep_checkpoints=keep)
    assert runner.cfg.async_checkpoint
    result = runner.fit(data, sups)
    kept = checkpoints(tmp_path)
    assert len(kept) == keep and result.best_checkpoint in kept
    assert all(os.path.exists(p + ".json") for p in kept)
    ranked = sorted(result.history, key=lambda h: h.valid["loss"])[:keep]
    assert sorted(round(h.valid["loss"], 2) for h in ranked) == sorted(
        float(os.path.basename(p)[:-3].split("_")[-1]) for p in kept)
    best = tckpt.load_state_dict(result.best_checkpoint)
    for k, v in runner.engine.model.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_async_checkpointer_snapshots_and_reraises(tmp_path):
    """A save snapshots the state when it is queued; a failed write raises
    on the next call, and the writer goes on."""
    writer = tckpt.AsyncCheckpointer()
    w = torch.ones(3)
    opt = {"state": {0: {"exp_avg": torch.full((3,), 2.0)}}}
    path = str(tmp_path / "a.pt")
    writer.save(path, {"w": w}, train_state={"optimizer": opt, "step": 4})
    w.add_(1.0)
    opt["state"][0]["exp_avg"].add_(1.0)
    writer.wait()
    payload = torch.load(path, weights_only=True)
    assert torch.equal(payload["model"]["w"], torch.ones(3))
    assert torch.equal(payload["optimizer"]["state"][0]["exp_avg"],
                       torch.full((3,), 2.0))
    assert payload["step"] == 4 and os.path.exists(path + ".json")
    blocker = tmp_path / "file"
    blocker.write_text("")
    writer.save(str(blocker / "b.pt"), {"w": w})
    with pytest.raises(OSError):
        writer.wait()
    writer.save(str(tmp_path / "c.pt"), {"w": w})
    writer.wait()
    assert os.path.exists(tmp_path / "c.pt")


def test_early_stopping(tmp_path):
    """A plateau from epoch 1 on stops the run after ``patience`` more
    epochs; the best epoch stays 1."""
    data, sups = dataset("device")
    runner = make_runner(tmp_path, epochs=6, early_stop_patience=2)
    runner._eval_split = lambda *a, **k: [
        {"loss": torch.tensor(1.0), "mape": torch.tensor(0.1),
         "rmse": torch.tensor(1.0)}]
    result = runner.fit(data, sups)
    assert [h.epoch for h in result.history] == [1, 2, 3]
    assert result.best_epoch == 1


def test_epoch_watchdog_detects_wedge(tmp_path):
    """An epoch past ``epoch_timeout_s`` writes ``emergency.json`` and
    raises ``DeviceWedgedError``."""
    data, sups = dataset("device")
    runner = make_runner(tmp_path, epoch_timeout_s=1e-3)
    with pytest.raises(DeviceWedgedError, match="exceeded"):
        runner.fit(data, sups)
    info = json.load(open(tmp_path / "emergency.json"))
    assert info["epoch"] == 1 and "exceeded" in info["reason"]
    assert info["epochs_completed"] == 0


def test_wedge_then_resume(tmp_path):
    """A run that wedges in epoch 2 leaves diagnostics and the epoch-1
    checkpoint; a new runner resumes from it at epoch 2 with the train
    state it holds, and ``history.jsonl`` marks both segments."""
    data, sups = dataset("device")
    runner = make_runner(tmp_path, epochs=3)
    real_eval = runner._eval_split
    calls = {"n": 0}

    def eval_then_wedge(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise DeviceWedgedError("injected wedge")
        return real_eval(*a, **k)

    runner._eval_split = eval_then_wedge
    with pytest.raises(DeviceWedgedError):
        runner.fit(data, sups)
    info = json.load(open(tmp_path / "emergency.json"))
    assert info["epochs_completed"] == 1 and info["epoch"] == 2
    (first,) = checkpoints(tmp_path)
    assert info["best_checkpoint"] == first

    runner2 = make_runner(tmp_path, epochs=3)
    want = torch.load(first, weights_only=True)
    result = runner2.fit(data, sups, resume_from=first)
    assert [h.epoch for h in result.history] == [2, 3]
    assert runner2.engine.step == want["step"] + 2 * 8
    lines = [json.loads(ln) for ln in open(tmp_path / "history.jsonl")]
    starts = [ln for ln in lines if "run_start" in ln]
    assert [s["start_epoch"] for s in starts] == [1, 2]
    assert starts[1]["resumed_from"] == first
    epochs = [ln for ln in lines if "epoch" in ln]
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert set(epochs[-1]) == {"epoch", "train", "valid", "train_time_s",
                               "valid_time_s", "ts"}
    assert set(epochs[-1]["valid"]) == {"loss", "mape", "rmse"}


# ---------------------------------------------------------------------------
# the training CLI's runner flags
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def metr_dir(tmp_path_factory):
    from graph_wavenet_tpu_torch.data.traffic_etl import (
        generate_train_val_test,
    )

    tmp = tmp_path_factory.mktemp("metr_runner")
    rng = np.random.default_rng(0)
    t = 240
    values = (rng.normal(size=(t, N)) * 5 + 60).astype(np.float32)
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(t) * np.timedelta64(5, "m"))
    generate_train_val_test(values, str(tmp / "DATA"), index=index)
    # the same data with every validation target missing (zero): the
    # masked validation loss is exactly 0 each epoch and cannot improve
    generate_train_val_test(values, str(tmp / "FLAT"), index=index)
    with np.load(tmp / "FLAT" / "val.npz") as f:
        val = {k: f[k] for k in f.files}
    val["y"][..., 0] = 0.0
    np.savez(tmp / "FLAT" / "val.npz", **val)
    adj = (rng.random((N, N)) < 0.4).astype(np.float32)
    np.fill_diagonal(adj, 1.0)
    with open(tmp / "adj.pkl", "wb") as f:
        pickle.dump(([str(i) for i in range(N)],
                     {str(i): i for i in range(N)}, adj), f)
    return str(tmp / "DATA"), str(tmp / "FLAT"), str(tmp / "adj.pkl")


def test_train_cli_runner_flags(metr_dir, tmp_path):
    """``--resident device --scan_steps 3`` trains; ``--resume`` of its
    epoch-1 checkpoint runs epoch 2 only; ``--early_stop 1`` stops a run
    whose validation cannot improve; ``--grad_accum 2`` and
    ``--epoch_timeout`` train."""
    from graph_wavenet_tpu_torch.cli import train

    data, flat, adj = metr_dir
    base = ["--data", data, "--adjdata", adj, "--num_nodes", str(N),
            "--gcn_bool", "--addaptadj", "--seq_length", "12", "--nhid", "4",
            "--blocks", "2", "--batch_size", "8", "--print_every", "1000",
            "--device", CPU]
    fused = train.main(base + ["--scan_steps", "3", "--epochs", "1",
                               "--save", str(tmp_path / "a")])
    loader = tmetr.load_dataset(data, 8, resident="device", device=CPU)[
        "train_loader"]
    assert isinstance(loader, DeviceArrayLoader)
    assert fused["runner"].engine.step == loader.num_batch
    assert fused["runner"].cfg.scan_steps == 3
    (ck,) = checkpoints(tmp_path / "a")

    resumed = train.main(base + ["--resume", ck, "--epochs", "2", "--save",
                                 str(tmp_path / "a")])
    assert [h.epoch for h in resumed["result"].history] == [2]
    assert resumed["runner"].engine.step == 2 * loader.num_batch

    stop = train.main(base + ["--early_stop", "1", "--epochs", "4",
                              "--save", str(tmp_path / "b"), "--data", flat])
    hist = stop["result"].history
    assert [h.epoch for h in hist] == [1, 2]
    assert hist[0].valid["loss"] == hist[1].valid["loss"] == 0.0

    accum = train.main(base + ["--grad_accum", "2", "--epoch_timeout",
                               "600", "--epochs", "1", "--save",
                               str(tmp_path / "c")])
    assert accum["runner"].cfg.grad_accum == 2
    assert accum["runner"].engine.step == loader.num_batch
    assert np.isfinite(accum["result"].test_metrics["mae"])
    with pytest.raises(ValueError, match="divide by grad_accum 3"):
        train.main(base + ["--grad_accum", "3", "--save",
                           str(tmp_path / "d")])
    assert dataclasses.asdict(accum["runner"].cfg)["async_checkpoint"]
