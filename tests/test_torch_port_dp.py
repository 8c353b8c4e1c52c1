"""Every training path of the port under data parallelism, fused steps
included, on the CPU with gloo (``graph_wavenet_tpu_torch/parallel``,
``train/engine.py``, ``train/runner.py``, ``cli/train.py``):

- ``adaptive_blocks`` forward and VJP against JAX's on a partial mask,
  fp32 and fp64, with no atomic-accumulating op recorded forward or
  backward (the fixed-order segment sums);
- 2-rank DP ``Runner.fit`` with ``scan_steps=2`` over the resident arrays
  and over the windows-on-demand feed, against one process and against
  the JAX package's fused single-device fit on the same data and weights;
- 2-rank node-TP of the flat supports and the mask through
  ``train_steps_resident`` / ``eval_steps_resident`` against one process;
- 2-rank DP ``train_step_syn`` and ``train_steps_syn_resident`` (diff-G)
  against JAX's single-device steps;
- ``fit_syn``, ``fit_syn_shared`` and a ``fresh_nodevec`` ``fit_syn``
  under 2 ranks against one process;
- the training CLI's ``--data syn --mesh_dp --scan_steps 2`` and ``--data
  crash --mesh_dp`` under 2 ranks against the one-process CLI, the DP
  diff-G checkpoint served in one process;
- the refusals.

Bars (fp32, dropout 0 against JAX): losses rtol 1e-5, parameters atol
2e-5, the ranks bit for bit. On the CPU a fused call is the eager loop of
its step (the CUDA graphs under an NCCL group are held on the card,
``tests/test_torch_port_cuda.py``). The ranks, and the one process they
are held to, are subprocesses of this file's ``__main__`` branch, which
imports only the port; they start once per module, while the test process
computes JAX's results, and write ``.npz`` results, every wait bounded.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TIMEOUT = 240
WORLD = 2
N = 16
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5


def not_jax(cfg_kw: dict) -> tuple:
    """What a comparison with JAX leaves out: the parameters no loss term
    reaches (the residual convs while gcn_bool, the last layer's graph
    conv and BatchNorm affine), to which the port gives no gradient, so
    Adam skips them, and optax a zero one that its weight decay moves
    (ROADMAP.md, deliberate differences), with the last BatchNorm's
    running statistics of that conv's output; and JAX's BatchNorm state
    has no batch counter."""
    last = cfg_kw["blocks"] * cfg_kw["layers"] - 1
    return ("residual_convs.", f"gconv.{last}.", f"bn.{last}.",
            "num_batches_tracked")
SYN = dict(num_nodes=12, seq_length=24, n_train=2, n_valid=1, n_test=1,
           num_timestep=100)
SYN_ARGV = ["--data", "syn", "--num_nodes", "10", "--nhid", "4",
            "--n_train", "2", "--n_valid", "1", "--n_test", "1",
            "--num_timestep", "100", "--batch_size", "8", "--epochs", "1",
            "--seq_length", "24", "--blocks", "2", "--gcn_bool",
            "--addaptadj", "--scan_steps", "2", "--device", CPU]
CRASH_ARGV = ["--data", "crash", "--nhid", "4", "--blocks", "2",
              "--batch_size", "4", "--epochs", "1", "--gcn_bool",
              "--addaptadj", "--device", CPU]


# ---------------------------------------------------------------------------
# shared by the test process and the ranks (port only)
# ---------------------------------------------------------------------------

def feed_dataset():
    """JAX ``tests/test_parallel.py``'s ``_feed_dataset``: 32 samples of 16
    nodes and two row-normalized supports."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 12, N, 2)).astype(np.float32)
    y = (rng.normal(size=(32, 12, N, 2)) + 40).astype(np.float32)
    a = rng.random((2, N, N)).astype(np.float32)
    return x, y, a / a.sum(-1, keepdims=True)


def series_dataset():
    rng = np.random.default_rng(1)
    series = rng.normal(size=(160, N, 2)).astype(np.float32)
    a = rng.random((2, N, N)).astype(np.float32)
    return series, a / a.sum(-1, keepdims=True)


def fit_cfg_kw():
    return dict(num_nodes=N, out_dim=12, residual_channels=4,
                dilation_channels=4, skip_channels=8, end_channels=16,
                blocks=2, layers=2, dropout=0.0, n_supports=2)


def syn_step_case():
    """JAX ``test_dp_diff_g_batched_supports_matches_single_device``'s
    configuration and batch."""
    rng = np.random.default_rng(2)
    cfg = dict(num_nodes=N, in_dim=1, out_dim=6, residual_channels=8,
               dilation_channels=8, skip_channels=16, end_channels=32,
               blocks=2, layers=2, dropout=0.0, n_supports=2,
               start_dilation=1)
    b, k = 16, 6
    x = rng.normal(size=(b, k, N, 1)).astype(np.float32)
    y = (rng.normal(size=(b, k, N, 2)) + 3.0).astype(np.float32)
    a = rng.random((b, 2, N, N)).astype(np.float32)
    a = a / a.sum(-1, keepdims=True)
    proj = np.tile(np.eye(N, dtype=np.float32), (b, 1, 1))
    return cfg, x, y, [a[:, 0], a[:, 1]], proj, 3


def syn_resident_case():
    """JAX ``test_fused_syn_resident_scan_under_mesh_matches_single``'s."""
    rng = np.random.default_rng(3)
    k = 12
    cfg = dict(num_nodes=N, in_dim=1, out_dim=k, residual_channels=4,
               dilation_channels=4, skip_channels=8, end_channels=16,
               blocks=4, layers=2, start_dilation=1, dropout=0.0,
               gcn_bool=True, addaptadj=False, n_supports=1)
    xs = rng.normal(size=(8, k, N, 1)).astype(np.float32)
    ys = (rng.normal(size=(8, k, N, 2)) + 3.0).astype(np.float32)
    sup = rng.random((3, N, N)).astype(np.float32)
    sup = sup / sup.sum(-1, keepdims=True)
    labels = rng.integers(0, 4, size=(3, N))
    onehot = (labels[:, :, None] == np.arange(4)).astype(np.float32)
    proj = np.stack([(o / np.maximum(o.sum(0), 1.0)) @ o.T for o in onehot])
    adj = rng.integers(0, 3, size=8).astype(np.int32)
    idx = rng.integers(0, 8, size=(2, 4)).astype(np.int32)
    return cfg, xs, ys, sup, proj, adj, idx, 4


def state_of(engine, prefix="p:") -> dict:
    return {prefix + k: v.detach().numpy().copy()
            for k, v in engine.model.state_dict().items()}


def history(res) -> np.ndarray:
    return np.asarray([(h.train["loss"], h.valid["loss"])
                       for h in res.history])


def run_fit(feed: str, mesh, workdir: str, save: str) -> dict:
    """``Runner.fit`` with ``scan_steps=2`` from JAX's initial weights:
    ``feed`` "arrays" (JAX's ``_feed_dataset``, batch 8) or "windows" (a
    160-step series, windows of 12); 2 epochs."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data import device_loader as tdl
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    tcfg = TrainConfig(learning_rate=1e-3, epochs=2, print_every=100,
                       scan_steps=2, save_dir=save)
    if feed == "arrays":
        x, y, a = feed_dataset()
        scaler = StandardScaler(40.0, 4.0)
        data = {"scaler": scaler, "x_test": x[:8], "y_test": y[:8]}
        for split, (xs, ys) in (("train", (x, y)), ("val", (x[:8], y[:8]))):
            data[split + "_loader"] = tdl.DeviceArrayLoader(
                xs, ys, 8, rng=np.random.default_rng(5), device=CPU)
    else:
        series, a = series_dataset()
        scaler = StandardScaler(0.0, 1.0)
        data = {"scaler": scaler}
        for split, seed in (("train", 3), ("val", 4)):
            data[split + "_loader"] = tdl.DeviceWindowLoader(
                series, 12, 12, 8, rng=np.random.default_rng(seed),
                device=CPU)
    eng = Engine(ModelConfig(**fit_cfg_kw()), tcfg, scaler, device=CPU,
                 seed=0, mesh=mesh)
    eng.model.load_state_dict(torch.load(
        os.path.join(workdir, f"jax_fit_{feed}.pt"), weights_only=True))
    runner = Runner(eng, tcfg, log_fn=lambda *a: None, mesh=mesh)
    res = runner.fit(data, [torch.as_tensor(s) for s in a])
    return {"history": history(res), **state_of(eng)}


def city_case():
    """A 256-node 4-NN city graph in RCM order (8 block-rows of 32): its
    flat supports, their mask, and 8 resident samples with a null share
    that differs across the node shards."""
    from graph_wavenet_tpu_torch.graphs import ordering, spatial
    from graph_wavenet_tpu_torch.ops import adaptive_block

    n = 256
    rng = np.random.default_rng(11)
    src, dst, w = spatial.knn_graph_edges(rng.random((n, 2)), 4)
    perm = ordering.rcm_order_edges(src, dst, n)
    sups = list(spatial.doubletransition_block_supports(
        src, dst, w, n, perm=perm, form="flat", block_size=32, device=CPU))
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(8, 12, n, 2)).astype(np.float32)
    ys = (rng.normal(size=(8, 12, n, 2)) * 9.5 + 31.0).astype(np.float32)
    ys[:, :, :40, 0] = 0.0
    ys[1, :5, 200:, 0] = 0.0
    return sups, adaptive_block.mask_from_supports(sups), xs, ys


def run_tp(mesh) -> dict:
    """Node-TP (or one process): two fused train steps and one fused eval
    pass of the city cell with the mask, dropout 0.3."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.parallel import sparse_tp
    from graph_wavenet_tpu_torch.train.engine import Engine

    sups, mask, xs, ys = city_case()
    if mesh is not None:
        sups = [sparse_tp.shard_flat_support(s, mesh) for s in sups]
        mask = sparse_tp.shard_adaptive_mask(mask, mesh)
        lo, hi = mesh.node_range(xs.shape[2])
        xs, ys = xs[:, :, lo:hi], ys[:, :, lo:hi]
    cfg = ModelConfig(num_nodes=256, in_dim=2, out_dim=12,
                      residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=16, blocks=2, layers=2,
                      dropout=0.3, gcn_bool=True, addaptadj=True,
                      n_supports=2)
    eng = Engine(cfg, TrainConfig(), StandardScaler(31.0, 9.5), device=CPU,
                 seed=0, mesh=mesh)
    xs_t, ys_t = torch.as_tensor(xs), torch.as_tensor(ys)
    idx = np.asarray([[0, 3, 5, 6], [7, 1, 2, 4]], np.int32)
    m = eng.train_steps_resident(xs_t, ys_t, idx, sups + [mask])
    ev = eng.eval_steps_resident(xs_t, ys_t, idx, sups + [mask])
    return {"losses": m["loss"].numpy(), "eval": np.stack(
        [ev[k].numpy() for k in ("loss", "mape", "rmse")]), **state_of(eng)}


def run_syn_steps(mesh, workdir: str) -> dict:
    """The DP diff-G steps of JAX's two mesh tests, from JAX's weights."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    out = {}
    cfg, x, y, sups, proj, F_t = syn_step_case()
    eng = Engine(ModelConfig(**cfg), TrainConfig(learning_rate=1e-3),
                 StandardScaler(0.0, 1.0), device=CPU, diff_g=True,
                 mesh=mesh)
    eng.model.load_state_dict(torch.load(
        os.path.join(workdir, "jax_syn_step.pt"), weights_only=True))
    m = eng.train_step_syn(x, y, [torch.as_tensor(s) for s in sups], proj,
                           F_t)
    out["step/loss"] = np.asarray(float(m["loss"]))
    out.update(state_of(eng, "step/p:"))
    cfg, xs, ys, sup, proj, adj, idx, F_t = syn_resident_case()
    eng = Engine(ModelConfig(**cfg), TrainConfig(learning_rate=1e-3),
                 StandardScaler(0.0, 1.0), device=CPU, diff_g=True,
                 mesh=mesh)
    eng.model.load_state_dict(torch.load(
        os.path.join(workdir, "jax_syn_resident.pt"), weights_only=True))
    m = eng.train_steps_syn_resident(
        torch.as_tensor(xs), torch.as_tensor(ys), idx, torch.as_tensor(adj),
        [torch.as_tensor(sup)], torch.as_tensor(proj), F_t)
    out["resident/losses"] = m["loss"].numpy()
    out.update(state_of(eng, "resident/p:"))
    return out


def run_fit_syn(kind: str, mesh, save: str) -> dict:
    """Two epochs of ``fit_syn`` (diff-G, the fused feed: ``scan_steps``
    2 over resident arrays, dropout 0.3), of ``fresh_nodevec`` diff-G, or
    of ``fit_syn_shared`` (``--same_g``), and the test."""
    from graph_wavenet_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        TrainConfig,
    )
    from graph_wavenet_tpu_torch.data import synthetic as tsyn
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    shared = kind == "shared"
    data, adjs, F_t, G = tsyn.load_dataset_syn(
        DataConfig(**dict(SYN, same_g=shared,
                          seq_length=12 if shared else 24)),
        8, seed=0, resident="device", device=CPU)
    cfg = ModelConfig(num_nodes=12, out_dim=12 if shared else 24,
                      residual_channels=4, dilation_channels=4,
                      skip_channels=8, end_channels=16,
                      blocks=4 if shared else 2, layers=2,
                      start_dilation=1 if shared else 4, dropout=0.3,
                      n_supports=2, fresh_nodevec=kind == "fresh")
    tcfg = TrainConfig(epochs=2, batch_size=8, save_dir=save,
                       scan_steps=1 if shared else 2)
    eng = Engine(cfg, tcfg, data["scaler"], device=CPU, seed=0,
                 diff_g=not shared, mesh=mesh)
    runner = Runner(eng, tcfg, log_fn=lambda *a: None, mesh=mesh)
    if shared:
        res = runner.fit_syn_shared(data, adjs, G, F_t, 5)
        runner.test_syn_shared(data, adjs, G, F_t, 5, res)
        extra = {}
    else:
        sups = tsyn.stack_support_splits(adjs, 2, 1)
        res = runner.fit_syn(data, sups, G, F_t, 5)
        runner.test_syn(data, sups, G, F_t, 5, res)
        extra = {"pred_E": res.test_metrics["pred_E"]}
    return {"history": history(res), "test": np.asarray(
        [res.test_metrics[k] for k in ("loss", "mape", "rmse")]),
        **extra, **state_of(eng)}


def cli_runs(workdir: str) -> dict:
    return {"syn": SYN_ARGV + ["--save", os.path.join(workdir, "cli_syn")],
            "crash": CRASH_ARGV + ["--save",
                                   os.path.join(workdir, "cli_crash")]}


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _worker(spec_path: str, rank: int) -> None:
    """One rank of the 2-rank gloo group, or (``rank`` -1) the one process
    every case is held to: its results to an ``.npz``."""
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    wd = spec["workdir"]
    one = rank < 0
    save = os.path.join(spec["out"], "one" if one else "dp")
    dp = tp = None
    if not one:
        multihost.initialize("gloo", rank, WORLD, spec["init"], device=CPU,
                             timeout_s=TIMEOUT)
        dp = make_mesh(MeshConfig(), CPU)
        tp = make_mesh(MeshConfig(model_axis=WORLD), CPU)
    out = {}

    def put(name, rec):
        out.update({f"{name}/{k}": v for k, v in rec.items()})

    for feed in ("arrays", "windows"):
        put(f"fit_{feed}", run_fit(feed, dp, wd,
                                   os.path.join(save, f"fit_{feed}")))
    put("tp", run_tp(tp))
    if not one:
        put("syn", run_syn_steps(dp, wd))
    for kind in ("diffg", "fresh", "shared"):
        put(f"fit_syn_{kind}", run_fit_syn(
            kind, dp, os.path.join(save, f"fit_syn_{kind}")))
    for name, argv in cli_runs(save).items():
        res = train.main(argv + ([] if one else ["--mesh_dp"]))["result"]
        out[f"cli_{name}/mae"] = np.asarray(res.test_metrics["loss"])
        out[f"cli_{name}/ckpt"] = np.asarray(res.best_checkpoint)
    np.savez(os.path.join(spec["out"], "one.npz" if one
                          else f"rank{rank}.npz"), **out)
    if not one:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _to_port(jeng, params, model_state, cfg_kw) -> dict:
    import jax

    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.config import ModelConfig

    return {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, model_state),
        ModelConfig(**cfg_kw)).items()}


def jax_engines(workdir):
    """The JAX engines of every JAX comparison, their initial weights
    written for the port (``convert.params_from_jax``)."""
    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.engine import Engine as JEngine

    engines = {}
    for name, cfg_kw, diff_g, scaler in (
            ("fit_arrays", fit_cfg_kw(), False, (40.0, 4.0)),
            ("fit_windows", fit_cfg_kw(), False, (0.0, 1.0)),
            ("syn_step", syn_step_case()[0], True, (0.0, 1.0)),
            ("syn_resident", syn_resident_case()[0], True, (0.0, 1.0))):
        tcfg = JTrainConfig(learning_rate=1e-3, epochs=2, print_every=100,
                            scan_steps=2,
                            save_dir=str(workdir / f"jax_{name}"))
        jeng = JEngine(JConfig(**cfg_kw), tcfg, JScaler(*scaler), seed=0,
                       diff_g=diff_g)
        sd = _to_port(jeng, jeng.state.params, jeng.state.model_state,
                      cfg_kw)
        torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
                   workdir / f"jax_{name}.pt")
        engines[name] = (jeng, tcfg, cfg_kw)
    return engines


def jax_results(engines) -> dict:
    """JAX's fused single-device fits and its diff-G steps."""
    import jax.numpy as jnp

    from graph_wavenet_tpu.data.device_loader import (
        DeviceArrayLoader,
        DeviceWindowLoader,
    )
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.runner import Runner as JRunner

    out = {}
    for feed in ("arrays", "windows"):
        jeng, tcfg, cfg_kw = engines[f"fit_{feed}"]
        if feed == "arrays":
            x, y, a = feed_dataset()
            data = {"scaler": JScaler(40.0, 4.0)}
            for split, (xs, ys) in (("train", (x, y)),
                                    ("val", (x[:8], y[:8]))):
                data[split + "_loader"] = DeviceArrayLoader(
                    xs, ys, 8, rng=np.random.default_rng(5))
        else:
            series, a = series_dataset()
            data = {"scaler": JScaler(0.0, 1.0)}
            for split, seed in (("train", 3), ("val", 4)):
                data[split + "_loader"] = DeviceWindowLoader(
                    series, 12, 12, 8, rng=np.random.default_rng(seed))
        res = JRunner(jeng, tcfg, log_fn=lambda *a: None).fit(
            data, [jnp.asarray(s) for s in a])
        out[f"fit_{feed}"] = {
            "history": history(res),
            **{"p:" + k: v for k, v in _to_port(
                jeng, jeng.state.params, jeng.state.model_state,
                cfg_kw).items()}}
    jeng, _, cfg_kw = engines["syn_step"]
    _, x, y, sups, proj, F_t = syn_step_case()
    st, m = jeng.train_step_syn(jeng.state, jnp.asarray(x), jnp.asarray(y),
                                [jnp.asarray(s) for s in sups],
                                jnp.asarray(proj), F_t)
    out["syn_step"] = {"loss": float(m["loss"]), **{
        "p:" + k: v for k, v in _to_port(jeng, st.params, st.model_state,
                                         cfg_kw).items()}}
    jeng, _, cfg_kw = engines["syn_resident"]
    _, xs, ys, sup, proj, adj, idx, F_t = syn_resident_case()
    st, m = jeng.train_steps_syn_resident(
        jeng.state, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(idx),
        jnp.asarray(adj), [jnp.asarray(sup)], jnp.asarray(proj), F_t)
    out["syn_resident"] = {"losses": np.asarray(m["loss"]), **{
        "p:" + k: v for k, v in _to_port(jeng, st.params, st.model_state,
                                         cfg_kw).items()}}
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("dp")


@pytest.fixture(scope="module")
def runs(workdir):
    """The 2-rank group and the one-process run (subprocesses started once
    the JAX weights are written), and, while they run, JAX's results:
    (one process's and JAX's records by case, the ranks' records)."""
    engines = jax_engines(workdir)
    out = workdir / "w2"
    out.mkdir()
    spec = dict(workdir=str(workdir), out=str(out),
                init=f"file://{out}/rendezvous")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in (-1, *range(WORLD)):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, __file__, str(spec_path), str(rank)], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    try:
        jax_recs = jax_results(engines)
        failed = []
        for rank, _, p in procs:
            try:
                rc = p.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append(f"rank {rank}: {rc}\n"
                              + (out / f"rank{rank}.log").read_text()[-3000:])
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    assert not failed, "\n".join(failed)
    one = dict(np.load(out / "one.npz"))
    single = {name: part(one, name) for name in {
        k.split("/")[0] for k in one}}
    single["jax"] = jax_recs
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return single, ranks


def part(rec: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in rec.items() if k.startswith(pre)}


def assert_ranks_equal(ranks, name: str) -> dict:
    """The ranks' records of ``name`` equal bit for bit; rank 0's."""
    r0 = part(ranks[0], name)
    for r in ranks[1:]:
        got = part(r, name)
        assert set(got) == set(r0)
        for k in r0:
            np.testing.assert_array_equal(got[k], r0[k], err_msg=k)
    return r0


def assert_state_close(got: dict, want: dict, skip: tuple = ()) -> None:
    keys = [k for k in want if k.startswith("p:")
            and not any(s in k for s in skip)]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the block-masked adaptive adjacency
# ---------------------------------------------------------------------------

def partial_mask_case(dtype):
    """A 1,024-node partial mask (a band of 32-node blocks, every third
    far block) and embeddings."""
    rng = np.random.default_rng(7)
    nb, bs, r = 32, 32, 10
    d, s = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    keep = (np.abs(d - s) <= 1) | ((d + 2 * s) % 7 == 0)
    e1 = rng.normal(size=(nb * bs, r)).astype(dtype)
    e2 = rng.normal(size=(r, nb * bs)).astype(dtype)
    g_seed = rng.normal(size=(int(keep.sum()), bs, bs))
    return d[keep], s[keep], bs, nb, e1, e2, g_seed


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_adaptive_blocks_forward_and_vjp_match_jax(dtype):
    """Forward and VJP of the masked softmax, in fp32 and in fp64, within
    1e-6 of each tensor's largest magnitude of JAX's ``adaptive_blocks``
    computed in fp64 (``jax.enable_x64``). JAX's own fp32 result sits
    2.9e-6 from its fp64 one on the embeddings' gradient, the port's fp32
    4.2e-7, so JAX's fp32 is not the reference."""
    import jax
    import jax.numpy as jnp

    from graph_wavenet_tpu.ops import adaptive_block as jab
    from graph_wavenet_tpu_torch.ops import adaptive_block as tab

    d, s, bs, nb, e1, e2, g = partial_mask_case(dtype)
    tmask = tab.mask_from_pairs(d, s, bs, nb, device=CPU)
    jmask = jab.mask_from_pairs(d, s, bs, nb)
    np.testing.assert_array_equal(tmask.live_src.numpy(),
                                  np.asarray(jmask.live_src))
    t1 = torch.as_tensor(e1).requires_grad_(True)
    t2 = torch.as_tensor(e2).requires_grad_(True)
    got = tab.adaptive_blocks(tmask, t1, t2)
    gt = torch.as_tensor(g.astype(dtype))
    (got * gt).sum().backward()
    with jax.enable_x64(True):
        want, vjp = jax.vjp(lambda a, b: jab.adaptive_blocks(jmask, a, b),
                            jnp.asarray(e1, jnp.float64),
                            jnp.asarray(e2, jnp.float64))
        w1, w2 = vjp(jnp.asarray(g, jnp.float64))
    for a, b in ((got.detach(), want), (t1.grad, w1), (t2.grad, w2)):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


def test_adaptive_blocks_record_no_accumulating_op():
    """Forward and backward under ``torch.profiler``: no ``index_add``,
    ``scatter_add_`` or accumulating ``index_put_`` (each adds in the order
    atomics land on the card); and a second run is bit for bit the
    first."""
    from torch.profiler import ProfilerActivity, profile

    from graph_wavenet_tpu_torch.ops import adaptive_block as tab

    d, s, bs, nb, e1, e2, g = partial_mask_case(np.float32)
    mask = tab.mask_from_pairs(d, s, bs, nb, device=CPU)
    runs = []
    for _ in range(2):
        t1 = torch.as_tensor(e1).requires_grad_(True)
        t2 = torch.as_tensor(e2).requires_grad_(True)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            out = tab.adaptive_blocks(mask, t1, t2)
            (out * torch.as_tensor(g, dtype=torch.float32)).sum().backward()
        runs.append((out.detach(), t1.grad, t2.grad))
    names = {e.name for e in prof.events()}
    bad = {"aten::index_add", "aten::index_add_", "aten::scatter_add_",
           "aten::scatter_add", "aten::_index_put_impl_", "aten::index_put_"}
    assert not names & bad, names & bad
    assert "aten::index_select" in names
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the fused feeds and node-TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feed", ["arrays", "windows"])
def test_fused_dp_fit_matches_one_process_and_jax(runs, feed):
    """``Runner.fit`` with ``scan_steps=2`` under 2 DP ranks (the resident
    arrays or the windows-on-demand feed) equals the one-process fused fit
    and JAX's fused single-device fit (JAX ``test_fused_scan_under_dp_
    mesh_matches_single_device`` / ``test_fused_window_scan_...``):
    history losses rtol 1e-5, parameters atol 2e-5, ranks bit for bit."""
    single, ranks = runs
    got = assert_ranks_equal(ranks, f"fit_{feed}")
    for want, skip in ((single[f"fit_{feed}"], ()),
                       (single["jax"][f"fit_{feed}"],
                        not_jax(fit_cfg_kw()))):
        np.testing.assert_allclose(got["history"], want["history"],
                                   rtol=LOSS_RTOL)
        assert_state_close(got, want, skip)


def test_fused_node_tp_with_mask_matches_one_process(runs):
    """2-rank node-TP of the flat supports and the mask: two fused train
    steps (dropout 0.3, drawn at the global shape) and a fused eval pass
    equal one process's."""
    single, ranks = runs
    got = assert_ranks_equal(ranks, "tp")
    want = single["tp"]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=LOSS_RTOL)
    assert_state_close(got, want)


# ---------------------------------------------------------------------------
# the two-modality tasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", ["step", "resident"])
def test_dp_syn_steps_match_jax(runs, step):
    """2-rank DP ``train_step_syn`` (per-sample supports and projectors
    taken by the rank's rows) and ``train_steps_syn_resident`` (the graph
    ids gathered inside the fused call) against JAX's single-device
    steps."""
    single, ranks = runs
    got = assert_ranks_equal(ranks, f"syn/{step}")
    want = single["jax"][f"syn_{step}"]
    if step == "step":
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=LOSS_RTOL)
    else:
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
    case = syn_step_case if step == "step" else syn_resident_case
    assert_state_close(got, want, not_jax(case()[0]))


@pytest.mark.parametrize("kind", ["diffg", "fresh", "shared"])
def test_fit_syn_under_dp_matches_one_process(runs, kind):
    """``fit_syn`` (the fused feed), a ``fresh_nodevec`` ``fit_syn`` and
    ``fit_syn_shared`` under 2 ranks, dropout 0.3: history, test metrics
    and parameters against one process, ranks bit for bit; the test's
    pooled predictions are the whole split's."""
    single, ranks = runs
    got = assert_ranks_equal(ranks, f"fit_syn_{kind}")
    want = single[f"fit_syn_{kind}"]
    np.testing.assert_allclose(got["history"], want["history"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["test"], want["test"], rtol=LOSS_RTOL)
    if "pred_E" in want:
        assert got["pred_E"].shape == want["pred_E"].shape
        np.testing.assert_allclose(got["pred_E"], want["pred_E"], rtol=0,
                                   atol=1e-5 * np.abs(want["pred_E"]).max())
    assert_state_close(got, want)


@pytest.mark.parametrize("name", ["syn", "crash"])
def test_train_cli_dp_matches_one_process(runs, name):
    """``--data syn --mesh_dp --scan_steps 2`` and ``--data crash
    --mesh_dp`` on 2 ranks test like the one-process CLI (test MAE rtol
    1e-5); the DP diff-G checkpoint serves in one process
    (``DiffGForecaster``) like the one-process run's."""
    from graph_wavenet_tpu_torch.train.serving import DiffGForecaster

    single, ranks = runs
    one = single[f"cli_{name}"]
    want = float(one["mae"])
    for r in ranks:
        np.testing.assert_allclose(float(r[f"cli_{name}/mae"]), want,
                                   rtol=LOSS_RTOL)
    if name != "syn":
        return
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 24, 10, 2)).astype(np.float32)
    a = rng.random((3, 10, 10)).astype(np.float32)
    sups = [torch.as_tensor(a / a.sum(-1, keepdims=True)),
            torch.as_tensor(a / a.sum(1, keepdims=True))]
    pred = [np.asarray(DiffGForecaster.from_checkpoint(
        p, device=CPU).predict(x, sups)) for p in (
            str(ranks[0]["cli_syn/ckpt"]), str(one["ckpt"]))]
    np.testing.assert_allclose(pred[0], pred[1], rtol=0,
                               atol=1e-5 * np.abs(pred[1]).max())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals(tmp_path):
    """A resident loader on another device than the mesh's fails the fused
    feed with a named ``ValueError``; so does a diff-G step given
    per-sample stacks whose length is not the batch's (the engine takes a
    rank's rows of them itself); ``--mesh_model 2`` with the
    per-sample-graph tasks, and ``--mesh_time`` with it (model x time),
    both ported, are in one process worlds their axes do not divide."""
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.config import (
        MeshConfig,
        ModelConfig,
        TrainConfig,
    )
    from graph_wavenet_tpu_torch.data import device_loader as tdl
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    mesh = make_mesh(MeshConfig(), CPU)
    tcfg = TrainConfig(scan_steps=2, save_dir=str(tmp_path))
    eng = Engine(ModelConfig(**fit_cfg_kw()), tcfg, None, device=CPU,
                 mesh=mesh)
    x, y, a = feed_dataset()
    data = {split + "_loader": tdl.DeviceArrayLoader(x, y, 8,
                                                      device="meta")
            for split in ("train", "val")}
    with pytest.raises(ValueError, match="resident arrays are on meta.*"
                       "mesh's device is cpu"):
        Runner(eng, tcfg, mesh=mesh).fit(data, [torch.as_tensor(s)
                                                for s in a])
    cfg, x, y, sups, proj, F_t = syn_step_case()
    eng = Engine(ModelConfig(**cfg), TrainConfig(), StandardScaler(0.0, 1.0),
                 device=CPU, diff_g=True)
    half = len(x) // 2
    with pytest.raises(ValueError, match="per-sample stack of .* rows for "
                       "a batch of"):
        eng.train_step_syn(x, y, [torch.as_tensor(s[:half]) for s in sups],
                           proj, F_t)
    with pytest.raises(ValueError, match="per-sample stack"):
        eng.eval_step_syn(x, y, [torch.as_tensor(s) for s in sups],
                          proj[:half], F_t)
    for data_flag in ("syn", "crash"):
        with pytest.raises(ValueError, match="ranks do not divide by the "
                           "model axis 2"):
            train.main(["--data", data_flag, "--mesh_model", "2",
                        "--device", CPU])
    with pytest.raises(ValueError, match="ranks do not divide by the model "
                       "x time axes 2 x 2"):
        train.main(["--data", "syn", "--mesh_time", "2", "--mesh_model",
                    "2", "--device", CPU])



if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
