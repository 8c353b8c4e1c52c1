"""The end of a process whose fused steps captured NCCL collectives, on
the card: NCCL's destroy waits for every CUDA graph that holds the
communicator, so the training CLI frees the captured steps
(``train.step_graph.release_all``) before ``destroy_process_group``.

Skips without a card (two cards for the ranks); run on the card with
``python -m pytest tests/test_torch_port_nccl_teardown.py --noconftest``.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds the ranks get to train one epoch and leave: a teardown that waits
# on the graphs never ends
RANKS_S = 240


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_released_step_graphs_are_captured_again(card):
    """``release_all`` frees every live step graph; the owner's next call
    captures the step anew and computes what the first graph did."""
    from graph_wavenet_tpu_torch.train import step_graph

    x = torch.arange(8.0, device=card)
    idx = torch.arange(3, dtype=torch.int32, device=card)[:, None]
    stream = torch.cuda.Stream(card)
    graphs, key = {}, ("step",)

    def run():
        return step_graph.run_steps(graphs, key,
                                    lambda sel: x[sel.long()] * 2.0, idx,
                                    stream, keep=(x,))

    first = run()
    g = graphs[key]
    step_graph.release_all()
    assert g.released and g.out is None
    second = run()
    assert graphs[key] is not g and not graphs[key].released
    assert torch.equal(first, second)
    assert torch.equal(second[:, 0], x[:3] * 2.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_data_parallel_cli_with_captured_nccl_steps_exits(card, tmp_path):
    """``gwt-torch-train --mesh_dp --scan_steps 2`` on an NCCL group of one
    card per rank (up to four) trains its epoch, its steps' all-reduce
    captured in CUDA graphs, and every rank exits within ``RANKS_S``."""
    world = min(4, torch.cuda.device_count())
    if world < 2:
        pytest.skip("needs two CUDA devices: NCCL takes one card per rank")
    rng = np.random.default_rng(0)
    n = 20
    data = tmp_path / "data"
    data.mkdir()
    for split, s in (("train", 16), ("val", 8), ("test", 8)):
        x = rng.normal(5.0, 2.0, size=(s, 12, n, 2)).astype(np.float32)
        y = rng.normal(5.0, 2.0, size=(s, 12, n, 2)).astype(np.float32)
        np.savez(data / f"{split}.npz", x=x, y=y)
    adj = tmp_path / "adj.pkl"
    with open(adj, "wb") as f:
        pickle.dump(([str(i) for i in range(n)],
                     {str(i): i for i in range(n)},
                     (rng.random((n, n)) < 0.3).astype(np.float32)), f)
    argv = [sys.executable, "-m", "graph_wavenet_tpu_torch.cli.train",
            "--device", "cuda", "--data", str(data), "--adjdata", str(adj),
            "--num_nodes", str(n), "--seq_length", "12", "--nhid", "4",
            "--blocks", "1", "--layers", "2", "--epochs", "1",
            "--batch_size", str(2 * world), "--gcn_bool", "--mesh_dp",
            "--dist_backend", "nccl", "--scan_steps", "2"]
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            argv + ["--save", str(tmp_path / f"ckpt{rank}")], env=env,
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, hung = [], []
    deadline = time.monotonic() + RANKS_S
    try:
        for rank, p in enumerate(procs):
            try:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                hung.append(rank)
                p.kill()
                logs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    tail = "\n".join(logs)[-4000:]
    assert not hung, f"ranks {hung} did not exit: {tail}"
    assert all(p.returncode == 0 for p in procs), tail
    assert "Total time spent" in logs[0], tail
