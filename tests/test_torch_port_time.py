"""Time-halo sequence parallelism of the port on the CPU with gloo
(``graph_wavenet_tpu_torch/parallel/halo.py``, ``parallel/mesh.py``,
``parallel/collectives.py:shift``, ``ops/normalization.py``'s ``t_valid``,
``models/gwnet.py``, ``train/``, ``cli/train.py --mesh_time``):

- ``halo_exchange_right`` and ``sharded_causal_conv`` on 2 time ranks
  against JAX's ``parallel/halo.py`` on its host mesh (the layout checks of
  JAX's own test, dilations 1, 2 and 4 at atol 1e-5), and the "time-halo"
  refusal;
- the right-aligned exchange and conv the model uses, on 2 and 4 time
  ranks, forward and VJP against the unsharded ``causal_conv_apply`` at
  1e-6;
- ``BatchNorm(t_valid)`` against JAX ``batch_norm_apply(t_valid=)``
  (output, running statistics, VJP at 1e-5), the plain branch unchanged;
- the diff-G step of JAX's K = 48 test (``tests/test_parallel.py``'s
  ``test_syn_accum_under_time_sp_mesh_matches_single_device``
  configuration), plain and accumulated, on 2 data x 2 time ranks against
  JAX's unsharded steps (loss rtol 1e-5, parameters atol 2e-5);
- the CRASH-scale step (K = 2,912, 13 x 3 layers from dilation 32, 16
  nodes, batch 4, remat on both sides) on 4 time ranks against the port's
  single process at the same bar: a JAX compile of that stack would take
  most of this file's budget, and the other files hold the single process
  to JAX;
- the dense METR model with dropout 0.3 (drawn at the single process's
  shape) through ``Runner.fit`` with the fused feed and ``Runner.test``,
  and the city cell's fused steps (flat supports, the mask), 2 data x 2
  time, against one process;
- the training CLI: ``--data syn --mesh_time 2`` under torchrun on 2
  ranks, ``--data syn --same_g`` and ``--data crash --mesh_dp`` with
  ``--mesh_time 2`` on 4, against the one-process runs (test MAE rtol
  1e-5); the refusals (a world the model x time axes do not divide, a
  halo wider than a block, a world the time axis does not divide).

The ranks (a 4-rank gloo group), the one process they are held to and the
torchrun run are subprocesses started once per module; the ranks and the
one process import only the port and write ``.npz`` results, every wait
bounded, while the test process computes JAX's.
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
WORLD = 4
N = 16
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
SYN_ARGV = ["--data", "syn", "--num_nodes", "10", "--nhid", "4",
            "--n_train", "2", "--n_valid", "1", "--n_test", "1",
            "--num_timestep", "100", "--batch_size", "8", "--epochs", "1",
            "--seq_length", "24", "--blocks", "2", "--gcn_bool",
            "--addaptadj", "--device", CPU]
SAME_G_ARGV = ["--data", "syn", "--same_g", "--num_nodes", "10", "--nhid",
               "4", "--n_train", "2", "--n_valid", "1", "--n_test", "1",
               "--num_timestep", "100", "--batch_size", "8", "--epochs", "1",
               "--seq_length", "12", "--blocks", "4", "--gcn_bool",
               "--addaptadj", "--device", CPU]
CRASH_ARGV = ["--data", "crash", "--nhid", "4", "--blocks", "2",
              "--batch_size", "4", "--epochs", "1", "--gcn_bool",
              "--addaptadj", "--device", CPU]


# ---------------------------------------------------------------------------
# shared by the test process and the ranks (port only)
# ---------------------------------------------------------------------------

def conv_case():
    """A (3, 16, 4, 5) input and a (k = 2, 5 -> 7) conv in JAX's layout
    ``w (k, in, out)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 16, 4, 5)).astype(np.float32)
    w = rng.normal(size=(2, 5, 7)).astype(np.float32) * 0.3
    b = rng.normal(size=(7,)).astype(np.float32)
    return x, w, b


def port_conv(w, b):
    """JAX's (k, in, out) taps as ``CausalConv``'s weight and bias."""
    return (torch.as_tensor(w.transpose(2, 1, 0)[:, :, None, :].copy()),
            torch.as_tensor(b))


def syn_case(k: int, blocks: int, layers: int, start: int):
    """JAX's K = 48 and K = 2,912 time-SP tests' configuration and batch
    (4 samples, 16 nodes, one per-sample support, 4 communities)."""
    from graph_wavenet_tpu_torch.train.engine import cluster_mean_projector

    rng = np.random.default_rng(k)
    cfg = dict(num_nodes=N, in_dim=1, out_dim=k, residual_channels=4,
               dilation_channels=4, skip_channels=8, end_channels=16,
               blocks=blocks, layers=layers, start_dilation=start,
               dropout=0.0, gcn_bool=True, addaptadj=False, n_supports=1)
    x = rng.normal(size=(4, k, N, 1)).astype(np.float32)
    y = (rng.normal(size=(4, k, N, 2)) + 3.0).astype(np.float32)
    ba = rng.random((4, N, N)).astype(np.float32)
    ba = ba / ba.sum(-1, keepdims=True)
    proj = np.stack([cluster_mean_projector(lab, 4)
                     for lab in rng.integers(0, 4, size=(4, N))])
    return cfg, x, y, ba, proj, 4


def k48_case():
    return syn_case(48, 4, 2, 4)


def crash_case():
    return syn_case(2912, 13, 3, 32)


def state_of(engine, prefix="p:") -> dict:
    return {prefix + k: v.detach().numpy().copy()
            for k, v in engine.model.state_dict().items()}


def history(res) -> np.ndarray:
    return np.asarray([(h.train["loss"], h.valid["loss"])
                       for h in res.history])


def run_syn(case, mesh, accum: int, workdir: str | None = None,
            remat: bool = False) -> dict:
    """One diff-G ``train_step_syn`` (or ``_accum`` of ``accum``
    micro-batches), from JAX's initial weights where ``workdir`` holds
    them, else from the seed."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    cfg, x, y, ba, proj, F_t = case
    eng = Engine(ModelConfig(**cfg, remat=remat),
                 TrainConfig(learning_rate=1e-3), StandardScaler(0.0, 1.0),
                 device=CPU, seed=0, diff_g=True, mesh=mesh)
    if workdir is not None:
        eng.model.load_state_dict(torch.load(
            os.path.join(workdir, "jax_k48.pt"), weights_only=True))
    sups = [torch.as_tensor(ba)]
    if accum > 1:
        m = eng.train_step_syn_accum(x, y, sups, proj, F_t, accum)
    else:
        m = eng.train_step_syn(x, y, sups, proj, F_t)
    return {"loss": np.asarray(float(m["loss"])), **state_of(eng)}


def metr_case():
    """32 samples of 16 nodes (JAX ``_feed_dataset``'s shapes), two
    row-normalized supports."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 12, N, 2)).astype(np.float32)
    y = (rng.normal(size=(32, 12, N, 2)) + 40).astype(np.float32)
    a = rng.random((2, N, N)).astype(np.float32)
    return x, y, a / a.sum(-1, keepdims=True)


def run_metr(mesh, save: str) -> dict:
    """``Runner.fit`` of the dense model (dropout 0.3, ``scan_steps=2``
    over resident arrays, 2 epochs of batch 8) and ``Runner.test``."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data import device_loader as tdl
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    x, y, a = metr_case()
    scaler = StandardScaler(40.0, 4.0)
    data = {"scaler": scaler, "x_test": x[:8], "y_test": y[:8]}
    for split, (xs, ys) in (("train", (x, y)), ("val", (x[:8], y[:8])),
                            ("test", (x[:8], y[:8]))):
        data[split + "_loader"] = tdl.DeviceArrayLoader(
            xs, ys, 8, rng=np.random.default_rng(5), device=CPU)
    cfg = ModelConfig(num_nodes=N, out_dim=12, residual_channels=4,
                      dilation_channels=4, skip_channels=8, end_channels=16,
                      blocks=2, layers=2, dropout=0.3, n_supports=2)
    tcfg = TrainConfig(epochs=2, print_every=100, scan_steps=2,
                       save_dir=save)
    eng = Engine(cfg, tcfg, scaler, device=CPU, seed=0, mesh=mesh)
    runner = Runner(eng, tcfg, log_fn=lambda *a: None, mesh=mesh)
    sups = [torch.as_tensor(s) for s in a]
    res = runner.fit(data, sups)
    runner.test(data, sups, res)
    return {"history": history(res), "test": np.asarray(
        [res.test_metrics[k] for k in ("mae", "mape", "rmse")]),
        **state_of(eng)}


def run_city(mesh) -> dict:
    """The city cell under DP (x time): a 256-node 4-NN graph in RCM order
    (8 block-rows of 32), its flat supports and their mask, dropout 0.3;
    two fused train steps and a fused eval pass over 8 resident
    samples."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.graphs import ordering, spatial
    from graph_wavenet_tpu_torch.ops import adaptive_block
    from graph_wavenet_tpu_torch.train.engine import Engine

    n = 256
    rng = np.random.default_rng(11)
    src, dst, w = spatial.knn_graph_edges(rng.random((n, 2)), 4)
    sups = list(spatial.doubletransition_block_supports(
        src, dst, w, n, perm=ordering.rcm_order_edges(src, dst, n),
        form="flat", block_size=32, device=CPU))
    mask = adaptive_block.mask_from_supports(sups)
    xs = torch.as_tensor(rng.normal(size=(8, 12, n, 2)).astype(np.float32))
    ys = torch.as_tensor((rng.normal(size=(8, 12, n, 2)) * 9.5
                          + 31.0).astype(np.float32))
    cfg = ModelConfig(num_nodes=n, in_dim=2, out_dim=12,
                      residual_channels=8, dilation_channels=8,
                      skip_channels=16, end_channels=16, blocks=2, layers=2,
                      dropout=0.3, gcn_bool=True, addaptadj=True,
                      n_supports=2)
    eng = Engine(cfg, TrainConfig(), StandardScaler(31.0, 9.5), device=CPU,
                 seed=0, mesh=mesh)
    idx = np.asarray([[0, 3, 5, 6], [7, 1, 2, 4]], np.int32)
    m = eng.train_steps_resident(xs, ys, idx, sups + [mask])
    ev = eng.eval_steps_resident(xs, ys, idx, sups + [mask])
    return {"losses": m["loss"].numpy(), "eval": np.stack(
        [ev[k].numpy() for k in ("loss", "mape", "rmse")]), **state_of(eng)}


def run_convs(mesh) -> dict:
    """The halo protocol on ``mesh`` (rank's block of the time axis):
    JAX's contract (time 2 only) and the right-aligned conv with its VJP
    (a fixed cotangent on the valid steps, zero on the garbage)."""
    from graph_wavenet_tpu_torch.ops.temporal import causal_conv_apply
    from graph_wavenet_tpu_torch.parallel import halo

    x, w, b = conv_case()
    width = x.shape[1] // mesh.time
    lo = mesh.time_index * width
    blk = torch.as_tensor(x[:, lo:lo + width])
    out = {}
    if mesh.time == 2:
        small = np.arange(48.0, dtype=np.float32).reshape(1, 8, 2, 3)
        out["exchange"] = halo.halo_exchange_right(
            torch.as_tensor(small[:, 4 * mesh.time_index:
                                  4 * mesh.time_index + 4]), 2, mesh).numpy()
        for d in (1, 2, 4):
            out[f"sharded/{d}"] = halo.sharded_causal_conv(
                blk, *port_conv(w, b), d, mesh).numpy()
    g = np.random.default_rng(1).normal(size=(3, 16, 4, 7)).astype(
        np.float32)
    for d in (1, 2, 4):
        wt, bt = (t.clone().requires_grad_(True) for t in port_conv(w, b))
        xb = blk.clone().requires_grad_(True)
        y = causal_conv_apply(wt, bt, torch.cat(
            [halo.halo_from_left(xb, d, mesh), xb], dim=1), d)
        gb = torch.as_tensor(g[:, lo:lo + width]).clone()
        gb[:, :max(0, d - lo)] = 0.0      # the global axis' first d steps
        (y * gb).sum().backward()
        out.update({f"right/{d}/out": y.detach().numpy(),
                    f"right/{d}/dx": xb.grad.numpy(),
                    f"right/{d}/dw": wt.grad.numpy(),
                    f"right/{d}/db": bt.grad.numpy()})
    return out


def cli_crash(save: str) -> list:
    return CRASH_ARGV + ["--save", save]


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _worker(spec_path: str, rank: int) -> None:
    """One rank of the 4-rank gloo group, or (``rank`` -1) the one process
    the ranks are held to: its results to an ``.npz``."""
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    one = rank < 0
    save = os.path.join(spec["out"], "one" if one else f"r{rank}")
    out = {}

    def put(name, rec):
        out.update({f"{name}/{k}": v for k, v in rec.items()})

    if one:
        put("crash_scale", run_syn(crash_case(), None, 1, remat=True))
        put("metr", run_metr(None, os.path.join(save, "metr")))
        res = train.main(cli_crash(os.path.join(save, "crash")))["result"]
        out["cli_crash/mae"] = np.asarray(res.test_metrics["loss"])
        out["cli_crash/pred_E"] = res.test_metrics["pred_E"]
        res = train.main(SYN_ARGV + ["--save", os.path.join(save, "syn")])
        out["cli_syn/mae"] = np.asarray(res["result"].test_metrics["loss"])
        res = train.main(SAME_G_ARGV + ["--save",
                                        os.path.join(save, "same_g")])
        out["cli_same_g/mae"] = np.asarray(
            res["result"].test_metrics["loss"])
        put("city", run_city(None))
        np.savez(os.path.join(spec["out"], "one.npz"), **out)
        return
    multihost.initialize("gloo", rank, WORLD, spec["init"], device=CPU,
                         timeout_s=TIMEOUT)
    t2 = make_mesh(MeshConfig(time_axis=2), CPU)
    t4 = make_mesh(MeshConfig(time_axis=4), CPU)
    for m in (t2, t4):
        out[f"layout/t{m.time}"] = np.asarray(
            [m.data_index, m.model_index, m.time_index, m.data, m.time,
             m.holds_output, *m.time_ranks])
    put("convs/t2", run_convs(t2))
    put("convs/t4", run_convs(t4))
    put("k48/step", run_syn(k48_case(), t2, 1, spec["workdir"]))
    put("k48/accum", run_syn(k48_case(), t2, 2, spec["workdir"]))
    put("crash_scale", run_syn(crash_case(), t4, 1, remat=True))
    put("metr", run_metr(t2, os.path.join(save, "metr")))
    put("city", run_city(t2))
    res = train.main(SAME_G_ARGV + ["--mesh_time", "2", "--save",
                                    os.path.join(save, "same_g")])
    out["cli_same_g/mae"] = np.asarray(res["result"].test_metrics["loss"])
    res = train.main(cli_crash(os.path.join(save, "crash"))
                     + ["--mesh_dp", "--mesh_time", "2"])["result"]
    out["cli_crash/mae"] = np.asarray(res.test_metrics["loss"])
    out["cli_crash/pred_E"] = res.test_metrics["pred_E"]
    try:
        train.main(SYN_ARGV + ["--mesh_time", "4", "--save",
                               os.path.join(save, "refused")])
        out["refused:halo"] = np.asarray("")
    except ValueError as e:
        out["refused:halo"] = np.asarray(str(e))
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def jax_k48(workdir):
    """JAX's unsharded K = 48 steps, plain and accumulated; its initial
    weights written for the port (``convert.params_from_jax``)."""
    import jax
    import jax.numpy as jnp

    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.engine import Engine as JEngine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.config import ModelConfig

    cfg, x, y, ba, proj, F_t = k48_case()

    def to_port(params, model_state):
        return {k: v.numpy() for k, v in convert.params_from_jax(
            jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, model_state),
            ModelConfig(**cfg)).items()}

    def engine():
        return JEngine(JConfig(**cfg), JTrainConfig(learning_rate=1e-3),
                       JScaler(0.0, 1.0), seed=0, diff_g=True)

    jeng = engine()
    torch.save({k: torch.as_tensor(v) for k, v in to_port(
        jeng.state.params, jeng.state.model_state).items()},
        workdir / "jax_k48.pt")

    def results():
        # a step donates its state: one engine a step
        args = (jnp.asarray(x), jnp.asarray(y), [jnp.asarray(ba)],
                jnp.asarray(proj), F_t)
        second = engine()
        out = {}
        for name, (st, m) in (
                ("step", jeng.train_step_syn(jeng.state, *args)),
                ("accum", second.train_step_syn_accum(second.state, *args,
                                                      2))):
            out[name] = {"loss": float(m["loss"]), **{
                "p:" + k: v for k, v in to_port(st.params,
                                                st.model_state).items()}}
        return out

    return results


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("time")


@pytest.fixture(scope="module")
def runs(workdir):
    """The 4-rank group, the one process and the 2-rank torchrun CLI run
    (subprocesses started once JAX's weights are written) and, while they
    run, JAX's K = 48 steps: (one process's records, JAX's, the ranks',
    the torchrun run's output)."""
    jax_results = jax_k48(workdir)
    out = workdir / "w4"
    out.mkdir()
    spec = dict(workdir=str(workdir), out=str(out),
                init=f"file://{out}/rendezvous")
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in (-1, *range(WORLD)):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((f"rank {rank}", log, subprocess.Popen(
            [sys.executable, __file__, str(spec_path), str(rank)], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    log = open(out / "torchrun.log", "w+")
    procs.append(("torchrun", log, subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "graph_wavenet_tpu_torch.cli.train",
         *SYN_ARGV, "--mesh_time", "2", "--save", str(out / "syn_t2")],
        cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)))
    try:
        jax_recs = jax_results()
        failed = []
        for name, log, p in procs:
            try:
                rc = p.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                log.flush()
                with open(log.name) as f:
                    failed.append(f"{name}: {rc}\n{f.read()[-3000:]}")
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    assert not failed, "\n".join(failed)
    one = dict(np.load(out / "one.npz"))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return one, jax_recs, ranks, (out / "torchrun.log").read_text()


def part(rec: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in rec.items() if k.startswith(pre)}


def assert_ranks_equal(ranks, name: str) -> dict:
    """The ranks' records of ``name`` equal bit for bit; rank 0's."""
    r0 = part(ranks[0], name)
    assert r0
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


def time_blocks(ranks, name: str, time: int, data: int = 0) -> list:
    """``name``'s record of the time ranks of data row ``data``, in time
    order."""
    return [ranks[data * time + t][name] for t in range(time)]


# ---------------------------------------------------------------------------
# the halo protocol
# ---------------------------------------------------------------------------

def test_mesh_layout_puts_time_innermost(runs):
    """Rank (d, m, t) is ``(d*M + m)*S_t + t``: with 4 ranks, time 2 gives
    2 data rows of 2 time ranks, time 4 one row; the last time rank holds
    the output."""
    _, _, ranks, _ = runs
    for r, rec in enumerate(ranks):
        np.testing.assert_array_equal(
            rec["layout/t2"], [r // 2, 0, r % 2, 2, 2, r % 2 == 1,
                               2 * (r // 2), 2 * (r // 2) + 1])
        np.testing.assert_array_equal(
            rec["layout/t4"], [0, 0, r, 1, 4, r == 3, 0, 1, 2, 3])


def test_halo_exchange_right_matches_jax(runs):
    """JAX ``test_halo_exchange_right``'s layout checks: the first shard
    appends the second's first 2 steps, the last wraps around to the
    first shard's head."""
    _, _, ranks, _ = runs
    x = np.arange(48.0, dtype=np.float32).reshape(1, 8, 2, 3)
    got = np.concatenate(time_blocks(ranks, "convs/t2/exchange", 2), axis=1)
    assert got.shape == (1, 12, 2, 3)
    np.testing.assert_array_equal(got[:, :4], x[:, :4])
    np.testing.assert_array_equal(got[:, 4:6], x[:, 4:6])
    np.testing.assert_array_equal(got[:, 6:10], x[:, 4:8])
    np.testing.assert_array_equal(got[:, 10:12], x[:, :2])


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_sharded_causal_conv_matches_jax(runs, dilation):
    """The port's ``sharded_causal_conv`` on 2 time ranks equals JAX's on
    its host mesh (time axis 2) on the same input and taps, all steps
    (the valid ones and the wrap-around garbage), atol 1e-5."""
    import jax.numpy as jnp

    from graph_wavenet_tpu.config import MeshConfig as JMesh
    from graph_wavenet_tpu.parallel import halo as jhalo
    from graph_wavenet_tpu.parallel import mesh as jmesh

    _, _, ranks, _ = runs
    x, w, b = conv_case()
    want = np.asarray(jhalo.sharded_causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation,
        jmesh.make_mesh(JMesh(time_axis=2))))
    for row in (0, 1):
        got = np.concatenate(time_blocks(
            ranks, f"convs/t2/sharded/{dilation}", 2, row), axis=1)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_halo_wider_than_a_block_is_refused():
    """A halo wider than a rank's block: ``sharded_causal_conv`` and the
    model (``Engine`` on a mesh of 8 time ranks, K = 48: blocks of 7
    steps, a dilation of 8) raise JAX's "time-halo" ``ValueError`` before
    any exchange."""
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.parallel import halo
    from graph_wavenet_tpu_torch.parallel.mesh import Mesh
    from graph_wavenet_tpu_torch.train.engine import Engine

    x, w, b = conv_case()
    mesh = Mesh(1, 1, 0, torch.device(CPU), time=2)
    with pytest.raises(ValueError, match="time-halo"):
        halo.sharded_causal_conv(torch.as_tensor(x[:, :8]), *port_conv(w, b),
                                 12, mesh)
    cfg, x, y, ba, proj, F_t = k48_case()
    eng = Engine(ModelConfig(**cfg), TrainConfig(), None, device=CPU,
                 diff_g=True, mesh=Mesh(1, 1, 0, torch.device(CPU), time=8))
    with pytest.raises(ValueError, match="time-halo"):
        eng.train_step_syn(x, y, [torch.as_tensor(ba)], proj, F_t)


@pytest.mark.parametrize("time", [2, 4])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_right_aligned_conv_and_vjp_match_unsharded(runs, time, dilation):
    """The model's exchange (the previous rank's last steps, zeros on the
    first rank) and conv on 2 and 4 time ranks: the ranks' blocks, in
    order, are the unsharded valid conv right-aligned behind ``dilation``
    garbage steps, and with a cotangent on the valid steps the input's
    gradient equals the unsharded VJP's (atol 1e-6), the taps' and the
    bias's, summed over the ranks, within 1e-6 of their largest
    magnitude."""
    from graph_wavenet_tpu_torch.ops.temporal import causal_conv_apply

    _, _, ranks, _ = runs
    x, w, b = conv_case()
    wt, bt = (t.clone().requires_grad_(True) for t in port_conv(w, b))
    xt = torch.as_tensor(x).clone().requires_grad_(True)
    want = causal_conv_apply(wt, bt, xt, dilation)
    g = np.random.default_rng(1).normal(size=(3, 16, 4, 7)).astype(
        np.float32)
    (want * torch.as_tensor(g[:, dilation:])).sum().backward()
    pre = f"convs/t{time}/right/{dilation}/"
    got = np.concatenate(time_blocks(ranks, pre + "out", time), axis=1)
    np.testing.assert_allclose(got[:, dilation:], want.detach().numpy(),
                               rtol=0, atol=1e-6)
    assert np.isfinite(got).all()
    dx = np.concatenate(time_blocks(ranks, pre + "dx", time), axis=1)
    np.testing.assert_allclose(dx, xt.grad.numpy(), rtol=0, atol=1e-6)
    for key, ref in (("dw", wt.grad), ("db", bt.grad)):
        # sums over every step, in blocks: 1e-6 of the largest magnitude
        total = sum(time_blocks(ranks, pre + key, time))
        np.testing.assert_allclose(total, ref.numpy(), rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# BatchNorm's t_valid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_valid", [9, 7, 3])
def test_batchnorm_t_valid_matches_jax(t_valid):
    """``BatchNorm.normalize(t_valid=)`` in train mode against JAX
    ``batch_norm_apply(t_valid=)``: the output on the valid steps, the
    running statistics after ``track`` and the VJP with respect to x,
    scale and bias, atol 1e-5; inf in the left-out steps reaches none of
    them (a select, not a product)."""
    import jax
    import jax.numpy as jnp

    from graph_wavenet_tpu.ops.normalization import batch_norm_apply
    from graph_wavenet_tpu_torch.ops.normalization import BatchNorm

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 5, 4)).astype(np.float32) * 2.0 + 1.0
    scale = rng.normal(size=4).astype(np.float32)
    bias = rng.normal(size=4).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    valid = slice(x.shape[1] - t_valid, None)
    g[:, :x.shape[1] - t_valid] = 0.0
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    js = {"mean": jnp.zeros(4), "var": jnp.ones(4)}
    y, st = batch_norm_apply(jp, js, jnp.asarray(x), True, t_valid=t_valid)
    _, vjp = jax.vjp(lambda a, p: batch_norm_apply(
        p, js, a, True, t_valid=t_valid)[0], jnp.asarray(x), jp)
    jdx, jdp = vjp(jnp.asarray(g))

    bn = BatchNorm(4).train()
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
    xt = torch.as_tensor(x).clone()
    xt[:, :x.shape[1] - t_valid] = float("inf")
    xt.requires_grad_(True)
    out, stats = bn.normalize(xt, t_valid=t_valid)
    bn.track(*stats)
    (out[:, valid] * torch.as_tensor(g[:, valid])).sum().backward()
    for a, b in ((out.detach().numpy()[:, valid], np.asarray(y)[:, valid]),
                 (bn.running_mean.numpy(), st["mean"]),
                 (bn.running_var.numpy(), st["var"]),
                 (xt.grad.numpy()[:, valid], np.asarray(jdx)[:, valid]),
                 (bn.weight.grad.numpy(), jdp["scale"]),
                 (bn.bias.grad.numpy(), jdp["bias"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_batchnorm_block_of_garbage_adds_nothing():
    """A rank whose block holds no valid step (``t_valid`` 0, inf in every
    step) adds zeros to the statistics' sums, which divide by the global
    ``count`` it is given, and takes a finite, zero gradient."""
    from graph_wavenet_tpu_torch.ops.normalization import BatchNorm

    bn = BatchNorm(4).train()
    xt = torch.full((2, 5, 3, 4), float("inf"), requires_grad=True)
    out, (mean, var, n) = bn.normalize(xt, t_valid=0, count=60)
    assert n == 60.0
    assert torch.equal(mean, torch.zeros(4)) and torch.equal(
        var, torch.zeros(4))
    (out[:, :0].sum() + mean.sum() + var.sum()).backward()
    assert torch.equal(xt.grad, torch.zeros_like(xt))


def test_batchnorm_plain_branch_unchanged():
    """Without ``t_valid`` the statistics are the plain sums over the
    global count, bit for bit the formula before ``t_valid`` existed, and
    ``t_valid`` equal to the whole axis gives the same output to
    rounding."""
    from graph_wavenet_tpu_torch.ops.normalization import BatchNorm

    x = torch.as_tensor(np.random.default_rng(5).normal(
        size=(3, 7, 6, 4)).astype(np.float32))
    bn = BatchNorm(4).train()
    y, (mean, var, n) = bn.normalize(x)
    n0 = float(x.numel() // x.shape[-1])
    m0 = x.sum(dim=(0, 1, 2)) / n0
    v0 = ((x - m0) ** 2).sum(dim=(0, 1, 2)) / n0
    y0 = (x - m0) * torch.rsqrt(v0 + bn.eps) * bn.weight + bn.bias
    assert n == n0
    assert torch.equal(mean, m0) and torch.equal(var, v0)
    assert torch.equal(y, y0)
    y_all, _ = bn.normalize(x, t_valid=7)
    np.testing.assert_allclose(y_all.detach().numpy(), y.detach().numpy(),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the steps under data x time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", ["step", "accum"])
def test_k48_diffg_step_under_data_x_time_matches_jax(runs, step):
    """JAX's K = 48 diff-G configuration (16 nodes, 4/4/8/16 channels, 4 x
    2 layers from dilation 4, batch 4) on 2 data x 2 time ranks:
    ``train_step_syn`` and ``train_step_syn_accum(n_micro=2)`` against
    JAX's unsharded steps (loss rtol 1e-5, parameters atol 2e-5; the
    parameters no loss term reaches are left out, as in the DP tests), the
    ranks bit for bit."""
    _, jax_recs, ranks, _ = runs
    got = assert_ranks_equal(ranks, f"k48/{step}")
    want = jax_recs[step]
    np.testing.assert_allclose(float(got["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    last = 4 * 2 - 1
    assert_state_close(got, want, ("residual_convs.", f"gconv.{last}.",
                                   f"bn.{last}.", "num_batches_tracked"))


def test_crash_scale_step_on_four_time_ranks_matches_one_process(runs):
    """JAX's CRASH-scale configuration (K = 2,912, 13 x 3 layers from
    dilation 32, receptive field 2,913) on 4 time ranks (blocks of 729
    steps, halos up to 128), remat on both sides: the loss and every
    parameter and buffer against the single process, the ranks bit for
    bit."""
    one, _, ranks, _ = runs
    got = assert_ranks_equal(ranks, "crash_scale")
    want = part(one, "crash_scale")
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=LOSS_RTOL)
    assert_state_close(got, want)


def test_city_fused_steps_under_data_x_time_match_one_process(runs):
    """The city cell (flat block-sparse supports and the mask, dropout
    0.3) on 2 data x 2 time ranks: two fused train steps and a fused eval
    pass against one process, the ranks bit for bit."""
    one, _, ranks, _ = runs
    got = assert_ranks_equal(ranks, "city")
    want = part(one, "city")
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=LOSS_RTOL)
    assert_state_close(got, want)


def test_metr_fit_under_data_x_time_matches_one_process(runs):
    """The dense METR model with dropout 0.3 (the mask drawn at the single
    process's shape, laid on the global time axis) through ``Runner.fit``
    with the fused feed (2 epochs, ``scan_steps=2``) and ``Runner.test``
    (the predictions of each time group's last rank), 2 data x 2 time:
    history, test metrics and parameters against one process, the ranks
    bit for bit."""
    one, _, ranks, _ = runs
    got = assert_ranks_equal(ranks, "metr")
    want = part(one, "metr")
    np.testing.assert_allclose(got["history"], want["history"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["test"], want["test"], rtol=LOSS_RTOL)
    assert_state_close(got, want)


# ---------------------------------------------------------------------------
# the CLI and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["syn", "same_g", "crash"])
def test_train_cli_under_time_matches_one_process(runs, name):
    """``torchrun --nproc_per_node 2 ... --data syn --mesh_time 2`` (one
    data row of 2 time ranks), and on the 4-rank group (2 x 2) ``--data
    syn --same_g --mesh_time 2`` and ``--data crash --mesh_dp --mesh_time
    2``, test like the one-process CLI runs (test MAE rtol 1e-5; the CRASH
    test's pooled predictions, gathered from each time group's last rank,
    atol 1e-5 of their scale); the mesh line names the time axis."""
    one, _, ranks, torchrun = runs
    want = float(one[f"cli_{name}/mae"])
    if name == "syn":
        assert "mesh: {'data': 1, 'model': 1, 'time': 2}" in torchrun
        assert torchrun.count("Total time spent") == 1
        line = [ln for ln in torchrun.splitlines()
                if ln.startswith("On average over seq_length horizons")][-1]
        got = [float(line.split("Test MAE: ")[1].split(",")[0])]
        # the printed value has 4 decimals
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
        return
    for r in ranks:
        np.testing.assert_allclose(float(r[f"cli_{name}/mae"]), want,
                                   rtol=LOSS_RTOL)
    if name == "same_g":
        return
    pred = one["cli_crash/pred_E"]
    for r in ranks:
        assert r["cli_crash/pred_E"].shape == pred.shape
        np.testing.assert_allclose(r["cli_crash/pred_E"], pred, rtol=0,
                                   atol=1e-5 * np.abs(pred).max())


def test_refusals(runs):
    """``--mesh_time`` with ``--mesh_model 2`` (model x time, ported) in
    one process is a world the model x time axes do not divide, and
    ``MeshConfig`` takes both axes; ``--mesh_time 2`` in one process is a
    world the time axis does not divide; on the 4 ranks ``--mesh_time 4``
    with blocks of 7 steps and a dilation of 8 is a halo wider than a
    block."""
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.config import MeshConfig

    with pytest.raises(ValueError, match="do not divide by the model x time "
                       "axes 2 x 2"):
        train.main(SYN_ARGV + ["--mesh_time", "2", "--mesh_model", "2"])
    assert MeshConfig(model_axis=2, time_axis=2).time_axis == 2
    with pytest.raises(ValueError, match="do not divide by the time axis 2"):
        train.main(SYN_ARGV + ["--mesh_time", "2"])
    _, _, ranks, _ = runs
    for r in ranks:
        assert "time-halo" in str(r["refused:halo"])


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
