"""Dense node tensor parallelism of the port on the CPU with gloo
(``graph_wavenet_tpu_torch/parallel/dense_tp.py``, ``parallel/mesh.py``'s
uneven node ranges, ``parallel/collectives.py``'s row reduce-scatter and
all_gather, ``ops/diffusion.py``, ``models/``, ``train/``, ``cli/train.py
--mesh_model`` on the METR and diff-G paths, and model x time):

- the node ranges: JAX's layout of ceil(N/S) nodes a rank, the last ones
  fewer (207 over 2 and 4), a layout that leaves a rank no node refused;
- the sharded contraction: ``nconv`` over 32 nodes on 2 model ranks (JAX
  ``tests/test_parallel.py``'s node-TP shapes) against JAX ``nconv`` at
  atol 1e-5; then over 33 nodes on 2 ranks and 15 on 4, forward and VJP,
  the shared and the batched hop, a power stack's hops, the adaptive
  adjacency's rows (also against JAX ``ops/adaptive.py`` at 1e-5) and
  ``pool_E``, against the unsharded plain versions at 1e-6 (the summed
  gradients 1e-6 of their largest magnitude);
- the dense METR step (15 nodes, two supports and the adaptive adjacency)
  on 4 model ranks and on 2 data x 2 model, in each ``gcn_mode``, against
  JAX's single-device ``train_step`` from the same weights (dropout 0;
  loss rtol 1e-5, parameters atol 2e-5), and with dropout 0.3 against the
  port's one process;
- JAX's non-toy TP x SP step (``tests/test_parallel.py``'s N = 1,024, K =
  512, the adaptive adjacency) on 1 data x 2 model x 2 time against JAX's
  single-device step at the same bar;
- the diff-G step of JAX's DP test configuration (15 nodes, per-sample
  supports and projectors) on 2 data x 2 model against JAX's single
  device; under 2 model x 2 time with ``fresh_nodevec`` (drawn at the
  global shape) against the port's one process; the model's forward with
  injected per-sample ``aptinit_nodevecs`` on 4 model ranks against the
  unsharded forward;
- the city's fused steps (flat supports and the mask, dropout 0.3) under 2
  model x 2 time against one process;
- the training CLI: ``--mesh_model 2`` on the METR path (15 nodes: 8 and
  7) under torchrun with 2 ranks, and on the 4 ranks ``--mesh_model 2
  --mesh_time 2`` on the METR path and with ``--data crash``, against the
  one-process runs (test MAE rtol 1e-5; CRASH's pooled predictions, whose
  node ranges the test gathers).

The ranks (a 4-rank gloo group), the one process they are held to and the
torchrun run are subprocesses started once per module; they import only
the port and write ``.npz`` results, every wait bounded, while the test
process computes JAX's.
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
N = 15
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
MODES = ("fused", "stacked", "concat")
# name -> (model axis, time axis) on the 4 ranks
LAYOUTS = {"m4": (4, 1), "d2m2": (2, 1), "m2t2": (2, 2)}
CRASH_ARGV = ["--data", "crash", "--nhid", "4", "--blocks", "2",
              "--batch_size", "4", "--epochs", "1", "--gcn_bool",
              "--addaptadj", "--device", CPU]


# ---------------------------------------------------------------------------
# shared by the test process and the ranks (port only)
# ---------------------------------------------------------------------------

def metr_cfg(mode: str = "fused", dropout: float = 0.0) -> dict:
    return dict(num_nodes=N, out_dim=12, residual_channels=4,
                dilation_channels=4, skip_channels=8, end_channels=16,
                blocks=2, layers=2, dropout=dropout, n_supports=2,
                gcn_mode=mode)


def metr_batch():
    """A batch of 8 windows over N nodes and two row-normalized
    supports."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 12, N, 2)).astype(np.float32)
    y = (rng.normal(size=(8, 12, N, 2)) + 40).astype(np.float32)
    a = rng.random((2, N, N)).astype(np.float32)
    return x, y, a / a.sum(-1, keepdims=True)


def big_case():
    """JAX ``test_tp_sp_nontoy_shape_matches_single_device``: 1,024 nodes,
    K = 512, 2 blocks x 1 layer from dilation 256 (receptive field 513),
    batch 2, the adaptive adjacency."""
    rng = np.random.default_rng(7)
    n, k, b = 1024, 512, 2
    cfg = dict(num_nodes=n, out_dim=12, residual_channels=4,
               dilation_channels=4, skip_channels=8, end_channels=16,
               blocks=2, layers=1, start_dilation=256, dropout=0.0,
               gcn_bool=True, addaptadj=True, n_supports=2)
    x = rng.normal(size=(b, k, n, 2)).astype(np.float32)
    y = (rng.normal(size=(b, 12, n, 2)) + 3.0).astype(np.float32)
    a = rng.random((2, n, n)).astype(np.float32)
    return cfg, x, y, a / a.sum(-1, keepdims=True)


def syn_case():
    """JAX ``test_dp_diff_g_batched_supports_matches_single_device``'s
    widths (8/8/16/32, 2 x 2 layers from dilation 1, K = 6, batch 16) over
    N nodes, with the cluster-mean projectors of 3 communities a sample."""
    from graph_wavenet_tpu_torch.train.engine import cluster_mean_projector

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
    proj = np.stack([cluster_mean_projector(lab, 3)
                     for lab in rng.integers(0, 3, size=(b, N))])
    return cfg, x, y, [a[:, 0], a[:, 1]], proj, 3


def fresh_case():
    """A diff-G step at K = 48 (4 x 2 layers from dilation 4) with
    ``fresh_nodevec``, batch 4, for the model x time layout."""
    from graph_wavenet_tpu_torch.train.engine import cluster_mean_projector

    rng = np.random.default_rng(9)
    k = 48
    cfg = dict(num_nodes=N, in_dim=1, out_dim=k, residual_channels=4,
               dilation_channels=4, skip_channels=8, end_channels=16,
               blocks=4, layers=2, start_dilation=4, dropout=0.0,
               gcn_bool=True, addaptadj=True, fresh_nodevec=True,
               n_supports=1)
    x = rng.normal(size=(4, k, N, 1)).astype(np.float32)
    y = (rng.normal(size=(4, k, N, 2)) + 3.0).astype(np.float32)
    a = rng.random((4, N, N)).astype(np.float32)
    proj = np.stack([cluster_mean_projector(lab, 4)
                     for lab in rng.integers(0, 4, size=(4, N))])
    return cfg, x, y, [a / a.sum(-1, keepdims=True)], proj, 4


def state_of(engine, prefix="p:") -> dict:
    return {prefix + k: v.detach().numpy().copy()
            for k, v in engine.model.state_dict().items()}


def engine(cfg: dict, mesh, scaler=(40.0, 4.0), weights=None, **kw):
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    eng = Engine(ModelConfig(**cfg), TrainConfig(learning_rate=1e-3),
                 StandardScaler(*scaler), device=CPU, seed=0, mesh=mesh,
                 **kw)
    if weights is not None:
        eng.model.load_state_dict(torch.load(weights, weights_only=True))
    return eng


def run_metr(mesh, mode: str, dropout: float, weights=None,
             steps: int = 1) -> dict:
    x, y, a = metr_batch()
    eng = engine(metr_cfg(mode, dropout), mesh, weights=weights)
    sups = [torch.as_tensor(s) for s in a]
    losses = [float(eng.train_step(x, y, sups)["loss"])
              for _ in range(steps)]
    return {"loss": np.asarray(losses), **state_of(eng)}


def run_big(mesh, weights) -> dict:
    cfg, x, y, a = big_case()
    eng = engine(cfg, mesh, scaler=(0.0, 1.0), weights=weights)
    m = eng.train_step(x, y, [torch.as_tensor(s) for s in a])
    return {"loss": np.asarray(float(m["loss"])), **state_of(eng)}


def run_syn(case, mesh, weights=None) -> dict:
    cfg, x, y, sups, proj, f_t = case
    eng = engine(cfg, mesh, scaler=(0.0, 1.0), weights=weights, diff_g=True)
    tsup = [torch.as_tensor(s) for s in sups]
    m = eng.train_step_syn(x, y, tsup, proj, f_t)
    ev = eng.eval_step_syn(x, y, tsup, proj, f_t)
    return {"loss": np.asarray([float(m["loss"]), float(ev["loss"])]),
            **state_of(eng)}


def run_city(mesh) -> dict:
    """The city cell: a 256-node 4-NN graph in RCM order (8 block-rows of
    32), its flat supports (sharded where the mesh splits nodes) and their
    mask, dropout 0.3; two fused train steps and a fused eval pass over 8
    resident samples."""
    from graph_wavenet_tpu_torch.graphs import ordering, spatial
    from graph_wavenet_tpu_torch.ops import adaptive_block
    from graph_wavenet_tpu_torch.parallel import sparse_tp

    n = 256
    rng = np.random.default_rng(11)
    src, dst, w = spatial.knn_graph_edges(rng.random((n, 2)), 4)
    sups = list(spatial.doubletransition_block_supports(
        src, dst, w, n, perm=ordering.rcm_order_edges(src, dst, n),
        form="flat", block_size=32, device=CPU))
    mask = adaptive_block.mask_from_supports(sups)
    if mesh is not None:
        sups = [sparse_tp.shard_flat_support(s, mesh) for s in sups]
        mask = sparse_tp.shard_adaptive_mask(mask, mesh)
    xs = torch.as_tensor(rng.normal(size=(8, 12, n, 2)).astype(np.float32))
    ys = torch.as_tensor((rng.normal(size=(8, 12, n, 2)) * 9.5
                          + 31.0).astype(np.float32))
    cfg = dict(num_nodes=n, in_dim=2, out_dim=12, residual_channels=8,
               dilation_channels=8, skip_channels=16, end_channels=16,
               blocks=2, layers=2, dropout=0.3, gcn_bool=True,
               addaptadj=True, n_supports=2)
    eng = engine(cfg, mesh, scaler=(31.0, 9.5))
    idx = np.asarray([[0, 3, 5, 6], [7, 1, 2, 4]], np.int32)
    m = eng.train_steps_resident(xs, ys, idx, sups + [mask])
    ev = eng.eval_steps_resident(xs, ys, idx, sups + [mask])
    return {"losses": m["loss"].numpy(), "eval": np.stack(
        [ev[k].numpy() for k in ("loss", "mape", "rmse")]), **state_of(eng)}


def op_inputs(n: int):
    """Inputs of the contraction checks over ``n`` nodes: x (3, 5, n, 4),
    a support, a per-sample stack, embeddings shared and per sample, a
    projector stack and the cotangents."""
    rng = np.random.default_rng(n)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    a = rng.random((n, n)).astype(np.float32)
    ab = rng.random((3, n, n)).astype(np.float32)
    from graph_wavenet_tpu_torch.train.engine import cluster_mean_projector

    proj = np.stack([cluster_mean_projector(lab, 3)
                     for lab in rng.integers(0, 3, size=(3, n))])
    return dict(x=f32(3, 5, n, 4), a=a / a.sum(-1, keepdims=True),
                ab=ab / ab.sum(-1, keepdims=True), e1=f32(n, 3),
                e2=f32(3, n), e1b=f32(3, n, 3), e2b=f32(3, 3, n),
                pred=f32(3, 1, n, 5), proj=proj, g=f32(3, 5, n, 4),
                g2=f32(3, 5, 2, n, 4), gp=f32(3, 1, n, 5), ga=f32(n, n),
                gab=f32(3, n, n))


def run_ops(mesh, n: int) -> dict:
    """Every sharded contraction on ``mesh`` (``None``: the unsharded plain
    versions) over ``n`` nodes: outputs in the rank's node range, and the
    gradients of the global leaves (x, the supports, the embeddings, the
    projectors; a rank's share, which the model group sums)."""
    from graph_wavenet_tpu_torch.ops import diffusion
    from graph_wavenet_tpu_torch.ops.adaptive import (
        adaptive_adjacency,
        adaptive_adjacency_batched,
    )
    from graph_wavenet_tpu_torch.parallel import dense_tp
    from graph_wavenet_tpu_torch.train.engine import pool_E

    inp = op_inputs(n)
    lo, hi = (0, n) if mesh is None else mesh.node_range(n)

    def leaf(k):
        return torch.as_tensor(inp[k]).clone().requires_grad_(True)

    def rows(a):
        return a if mesh is None else dense_tp.shard_dense_support(a, mesh)

    def adj(e1, e2):
        if mesh is not None:
            return dense_tp.adaptive_rows(e1, e2, mesh).rows
        return (adaptive_adjacency_batched if e1.ndim == 3
                else adaptive_adjacency)(e1, e2)

    cases = {
        "nconv": (("x", "a"), lambda x, a: diffusion.diffusion_hops(
            x[:, :, lo:hi], [rows(a)], 1)[1], "g"),
        "nconv2": (("x", "a"), lambda x, a: diffusion.diffusion_hops(
            x[:, :, lo:hi], [rows(a)], 2)[2], "g"),
        "batched": (("x", "ab"), lambda x, a: diffusion.diffusion_hops(
            x[:, :, lo:hi], [rows(a)], 1)[1], "g"),
        "stacked": (("x", "a"), lambda x, a: diffusion._stacked_hops_project(
            x[:, :, lo:hi], diffusion.support_powers(rows(a), 2),
            torch.eye(8), 2).reshape(3, 5, -1, 2, 4).permute(0, 1, 3, 2, 4),
            "g2"),
        "stacked_batched": (("x", "ab"), lambda x, a: (
            diffusion._stacked_hops_project(
                x[:, :, lo:hi], diffusion.support_powers(rows(a), 2),
                torch.eye(8), 2).reshape(3, 5, -1, 2, 4).permute(
                    0, 1, 3, 2, 4)), "g2"),
        "adaptive": (("e1", "e2"), adj, "ga"),
        "adaptive_batched": (("e1b", "e2b"), adj, "gab"),
        "pool_E": (("pred", "proj"), lambda p, q: pool_E(
            p[:, :, lo:hi], q, mesh), "gp"),
    }
    out = {}
    for name, (keys, fn, gk) in cases.items():
        leaves = [leaf(k) for k in keys]
        y = fn(*leaves)
        g = torch.as_tensor(inp[gk])
        g = g[..., lo:hi, :] if name.startswith("adaptive") else (
            g[..., lo:hi, :] if name.startswith("stacked") else
            g[:, :, lo:hi])
        (y * g).sum().backward()
        out[f"{name}/out"] = y.detach().numpy()
        for k, t in zip(keys, leaves):
            out[f"{name}/d{k}"] = t.grad.numpy()
    return out


def run_aptinit_forward(mesh) -> dict:
    """The diff-G model's eval forward with injected per-sample
    ``aptinit_nodevecs`` (the SVD of the first support) on ``mesh``."""
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.models.gwnet_diff_g import (
        GWNetDiffG,
        svd_nodevecs_batched,
    )

    cfg, x, _, sups, _, _ = syn_case()
    model = GWNetDiffG(ModelConfig(**cfg), device=CPU, seed=3)
    model.mesh = mesh
    nv = svd_nodevecs_batched(sups[0], 10)
    xt = torch.as_tensor(x)
    if mesh is not None:
        lo, hi = mesh.node_range(N)
        xt = xt[:, :, lo:hi]
    with torch.no_grad():
        return {"out": model(xt, [torch.as_tensor(s) for s in sups],
                             aptinit_nodevecs=nv).numpy()}


def metr_cli_argv(data: dict) -> list:
    return ["--data", data["dir"], "--adjdata", data["adj"], "--num_nodes",
            str(N), "--gcn_bool", "--addaptadj", "--seq_length", "12",
            "--nhid", "4", "--blocks", "2", "--layers", "2", "--batch_size",
            "8", "--epochs", "1", "--dropout", "0.0", "--device", CPU]


def write_metr(root: str) -> dict:
    """A METR-format dataset of N sensors written by the port's ETL and a
    DCRNN-format adjacency pickle."""
    import pickle

    from graph_wavenet_tpu_torch.data import traffic_etl

    rng = np.random.default_rng(0)
    t = 160
    values = (rng.normal(size=(t, N)) * 5 + 60).astype(np.float32)
    values[rng.random(values.shape) < 0.05] = 0.0
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(t) * np.timedelta64(5, "m"))
    data_dir = os.path.join(root, "METR")
    traffic_etl.generate_train_val_test(values, data_dir, index=index)
    adj = (rng.random((N, N)) < 0.4).astype(np.float32) * rng.random((N, N))
    np.fill_diagonal(adj, 1.0)
    path = os.path.join(root, "adj_mx.pkl")
    with open(path, "wb") as f:
        pickle.dump(([str(i) for i in range(N)],
                     {str(i): i for i in range(N)}, adj.astype(np.float32)),
                    f)
    return {"dir": data_dir, "adj": path}


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

    torch.manual_seed(0)
    with open(spec_path) as f:
        spec = json.load(f)
    w = spec["workdir"]
    one = rank < 0
    save = os.path.join(spec["out"], "one" if one else f"r{rank}")
    out = {}

    def put(name, rec):
        out.update({f"{name}/{k}": v for k, v in rec.items()})

    def cli(name, argv, mesh_flags=()):
        res = train.main(argv + list(mesh_flags) + [
            "--save", os.path.join(save, name)])["result"]
        out[f"cli_{name}/mae"] = np.asarray(
            res.test_metrics["mae" if "mae" in res.test_metrics else "loss"])
        if "pred_E" in res.test_metrics:
            out[f"cli_{name}/pred_E"] = res.test_metrics["pred_E"]

    if one:
        for mode in MODES:
            put(f"metr_drop/{mode}", run_metr(None, mode, 0.3, steps=2))
        put("fresh", run_syn(fresh_case(), None))
        put("city", run_city(None))
        cli("metr", metr_cli_argv(spec["metr"]))
        cli("crash", CRASH_ARGV)
        np.savez(os.path.join(spec["out"], "one.npz"), **out)
        return
    multihost.initialize("gloo", rank, WORLD, spec["init"], device=CPU,
                         timeout_s=TIMEOUT)
    meshes = {name: make_mesh(MeshConfig(model_axis=s, time_axis=st), CPU)
              for name, (s, st) in LAYOUTS.items()}
    put("ops/d2m2/32", run_ops(meshes["d2m2"], 32))
    put("ops/d2m2/33", run_ops(meshes["d2m2"], 33))
    put("ops/m4/15", run_ops(meshes["m4"], 15))
    put("aptinit/m4", run_aptinit_forward(meshes["m4"]))
    for lay in ("m4", "d2m2"):
        for mode in MODES:
            put(f"metr/{lay}/{mode}", run_metr(
                meshes[lay], mode, 0.0, os.path.join(w, f"metr_{mode}.pt")))
            put(f"metr_drop/{lay}/{mode}", run_metr(meshes[lay], mode, 0.3,
                                                    steps=2))
    put("syn/d2m2", run_syn(syn_case(), meshes["d2m2"],
                            os.path.join(w, "syn.pt")))
    put("fresh/m2t2", run_syn(fresh_case(), meshes["m2t2"]))
    put("city/m2t2", run_city(meshes["m2t2"]))
    put("big/m2t2", run_big(meshes["m2t2"], os.path.join(w, "big.pt")))
    flags = ("--mesh_model", "2", "--mesh_time", "2")
    cli("metr", metr_cli_argv(spec["metr"]), flags)
    cli("crash", CRASH_ARGV, flags)
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def jax_steps(workdir):
    """JAX's single-device steps (METR per mode, the 1,024-node TP x SP
    case, the diff-G DP case), their initial weights written for the port
    first (``convert.params_from_jax``); returns the function that runs the
    steps."""
    import jax
    import jax.numpy as jnp

    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.engine import Engine as JEngine
    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.config import ModelConfig

    def to_port(state, cfg):
        return {k: v.numpy() for k, v in convert.params_from_jax(
            jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, state.model_state),
            ModelConfig(**cfg)).items()}

    cases = {}
    x, y, a = metr_batch()
    for mode in MODES:
        cases[f"metr_{mode}"] = (metr_cfg(mode), (40.0, 4.0), False,
                                 (x, y, list(a)))
    cfg, bx, by, ba = big_case()
    cases["big"] = (cfg, (0.0, 1.0), False, (bx, by, list(ba)))
    cfg, sx, sy, sups, proj, f_t = syn_case()
    cases["syn"] = (cfg, (0.0, 1.0), True, (sx, sy, sups, proj, f_t))
    engines = {}
    for name, (cfg, scaler, diff_g, _) in cases.items():
        eng = JEngine(JConfig(**cfg), JTrainConfig(learning_rate=1e-3),
                      JScaler(*scaler), seed=0, diff_g=diff_g)
        torch.save({k: torch.as_tensor(v)
                    for k, v in to_port(eng.state, cfg).items()},
                   workdir / f"{name}.pt")
        engines[name] = eng

    def results():
        out = {}
        for name, (cfg, _, diff_g, args) in cases.items():
            eng = engines[name]
            if diff_g:
                bx_, by_, sups_, proj_, f = args
                st, m = eng.train_step_syn(
                    eng.state, jnp.asarray(bx_), jnp.asarray(by_),
                    [jnp.asarray(s) for s in sups_], jnp.asarray(proj_), f)
            else:
                bx_, by_, sups_ = args
                st, m = eng.train_step(eng.state, jnp.asarray(bx_),
                                       jnp.asarray(by_),
                                       [jnp.asarray(s) for s in sups_])
            out[name] = {"loss": float(m["loss"]),
                         **{"p:" + k: v for k, v in to_port(st, cfg).items()}}
        return out

    return results


def not_jax(cfg: dict) -> tuple:
    """What a comparison with JAX leaves out (as ``test_torch_port_dp``):
    the parameters no loss term reaches (the residual convs, the last
    layer's graph conv and BatchNorm), to which the port gives no gradient
    and optax's weight decay a step, and the batch counter JAX lacks."""
    last = cfg["blocks"] * cfg["layers"] - 1
    return ("residual_convs.", f"gconv.{last}.", f"bn.{last}.",
            "num_batches_tracked")


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("dense_tp")


@pytest.fixture(scope="module")
def runs(workdir):
    """The 4-rank group, the one process and the 2-rank torchrun METR run
    (subprocesses started once JAX's weights are written) and, while they
    run, JAX's steps: (one process's records, JAX's, the ranks', the
    torchrun run's output)."""
    jax_results = jax_steps(workdir)
    out = workdir / "w4"
    out.mkdir()
    metr = write_metr(str(workdir))
    spec = dict(workdir=str(workdir), out=str(out), metr=metr,
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
         *metr_cli_argv(metr), "--save", str(out / "metr_m2"),
         "--mesh_model", "2"],
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


def model_ranks(ranks, layout: str) -> list:
    """The records of data row 0's model ranks of ``layout`` (its first
    time rank), in model order."""
    s, st = LAYOUTS[layout]
    return [ranks[m * st] for m in range(s)]


# ---------------------------------------------------------------------------
# the node ranges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,s,want", [
    (207, 2, [104, 103]), (207, 4, [52, 52, 52, 51]), (15, 4, [4, 4, 4, 3]),
    (32, 2, [16, 16]), (4096, 4, [1024] * 4)])
def test_node_ranges_follow_jax_layout(n, s, want):
    """ceil(N/S) nodes a rank, the last ones fewer (JAX's sharding of an
    axis S does not divide); the ranges tile the nodes in model order, and
    a layout that leaves a rank no node is refused."""
    from graph_wavenet_tpu_torch.parallel.mesh import Mesh

    meshes = [Mesh(1, s, m, torch.device(CPU)) for m in range(s)]
    assert meshes[0].node_counts(n) == want
    assert meshes[0].node_block(n) == want[0]
    bounds = [m.node_range(n) for m in meshes]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert [hi - lo for lo, hi in bounds] == want
    with pytest.raises(ValueError, match="leave a rank no node"):
        Mesh(1, 4, 0, torch.device(CPU)).node_counts(5)


# ---------------------------------------------------------------------------
# the sharded contractions
# ---------------------------------------------------------------------------

def test_sharded_nconv_matches_jax(runs):
    """JAX ``test_node_tp_sharded_diffusion_exact``'s shapes (x (4, 6, 32,
    8) is here (3, 5, 32, 4); A (32, 32) row-sharded) on 2 model ranks:
    the ranks' node ranges, in order, equal JAX ``nconv`` at atol 1e-5, and
    the adaptive rows JAX ``adaptive_adjacency`` (shared and per sample)."""
    import jax.numpy as jnp

    from graph_wavenet_tpu.ops.adaptive import (
        adaptive_adjacency,
        adaptive_adjacency_batched,
    )
    from graph_wavenet_tpu.ops.diffusion import nconv

    _, _, ranks, _ = runs
    inp = op_inputs(32)
    recs = [part(r, "ops/d2m2/32") for r in model_ranks(ranks, "d2m2")]
    got = np.concatenate([r["nconv/out"] for r in recs], axis=2)
    want = np.asarray(nconv(jnp.asarray(inp["x"]), jnp.asarray(inp["a"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for name, fn, e1, e2 in (
            ("adaptive", adaptive_adjacency, "e1", "e2"),
            ("adaptive_batched", adaptive_adjacency_batched, "e1b", "e2b")):
        got = np.concatenate([r[f"{name}/out"] for r in recs], axis=-2)
        want = np.asarray(fn(jnp.asarray(inp[e1]), jnp.asarray(inp[e2])))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


CONTRACTIONS = ("nconv", "nconv2", "batched", "stacked", "stacked_batched",
                "adaptive", "adaptive_batched", "pool_E")


@pytest.mark.parametrize("layout,n", [("d2m2", 32), ("d2m2", 33),
                                      ("m4", 15)])
@pytest.mark.parametrize("name", CONTRACTIONS)
def test_sharded_contractions_match_unsharded(runs, layout, n, name):
    """Each sharded contraction on 2 model ranks (32 and 33 nodes) and on 4
    (15 nodes: 4, 4, 4, 3): the ranks' outputs in node order equal the
    unsharded plain version's at atol 1e-6, and the gradients of the
    global inputs, summed over the model ranks (sums in another order,
    as the time tests' blocks), its VJP within 1e-6 of their largest
    magnitude; the data rows' ranks bit for bit."""
    _, _, ranks, _ = runs
    key = f"ops/{layout}/{n}"
    for d in range(WORLD // LAYOUTS[layout][0]):
        for m in range(LAYOUTS[layout][0]):
            np.testing.assert_array_equal(
                ranks[d * LAYOUTS[layout][0] + m][f"{key}/{name}/out"],
                ranks[m][f"{key}/{name}/out"])
    want = run_ops(None, n)
    recs = [part(r, key) for r in model_ranks(ranks, layout)]
    axis = -2 if name.startswith(("adaptive", "stacked")) else 2
    got = np.concatenate([r[f"{name}/out"] for r in recs], axis=axis)
    np.testing.assert_allclose(got, want[f"{name}/out"], rtol=0, atol=1e-6)
    grads = [k for k in want if k.startswith(name + "/d")]
    assert grads
    for k in grads:
        np.testing.assert_allclose(sum(r[k] for r in recs), want[k], rtol=0,
                                   atol=1e-6 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_aptinit_forward_on_four_model_ranks_matches_unsharded(runs):
    """The diff-G model's forward with injected per-sample
    ``aptinit_nodevecs`` on 4 model ranks (15 nodes): the ranks' node
    ranges equal the unsharded forward at 1e-6."""
    _, _, ranks, _ = runs
    got = np.concatenate([r["aptinit/m4/out"]
                          for r in model_ranks(ranks, "m4")], axis=2)
    want = run_aptinit_forward(None)["out"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["m4", "d2m2"])
@pytest.mark.parametrize("mode", MODES)
def test_metr_step_under_node_tp_matches_jax(runs, layout, mode):
    """The dense METR step (15 nodes, two supports and the adaptive
    adjacency, dropout 0) on 4 model ranks and on 2 data x 2 model in
    ``mode``, from JAX's initial weights: JAX's single-device step's loss
    (rtol 1e-5) and parameters (atol 2e-5), the ranks bit for bit."""
    _, jax_recs, ranks, _ = runs
    got = assert_ranks_equal(ranks, f"metr/{layout}/{mode}")
    want = jax_recs[f"metr_{mode}"]
    np.testing.assert_allclose(float(got["loss"][0]), want["loss"],
                               rtol=LOSS_RTOL)
    assert_state_close(got, want, not_jax(metr_cfg()))


@pytest.mark.parametrize("layout", ["m4", "d2m2"])
@pytest.mark.parametrize("mode", MODES)
def test_metr_steps_with_dropout_match_one_process(runs, layout, mode):
    """Two METR steps with dropout 0.3 (each layer's mask drawn at the
    global shape, every rank keeping its node range) on 4 model ranks and
    on 2 data x 2 model: the losses and every parameter and buffer against
    the port's one process, the ranks bit for bit."""
    one, _, ranks, _ = runs
    got = assert_ranks_equal(ranks, f"metr_drop/{layout}/{mode}")
    want = part(one, f"metr_drop/{mode}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert_state_close(got, want)


def test_tp_sp_nontoy_step_matches_jax(runs):
    """JAX's non-toy TP x SP case (1,024 nodes, K = 512, the adaptive
    adjacency, halos of 256 steps) on 1 data x 2 model x 2 time, from
    JAX's initial weights: JAX's single-device step at loss rtol 1e-5 and
    parameters atol 2e-5 (JAX's own test holds its 2 x 2 x 2 step to
    it), the ranks bit for bit."""
    _, jax_recs, ranks, _ = runs
    got = assert_ranks_equal(ranks, "big/m2t2")
    want = jax_recs["big"]
    np.testing.assert_allclose(float(got["loss"]), want["loss"],
                               rtol=LOSS_RTOL)
    assert_state_close(got, want, not_jax(big_case()[0]))


def test_diffg_step_under_data_x_model_matches_jax(runs):
    """JAX's diff-G DP test configuration over 15 nodes (per-sample
    supports and projectors, the shared adaptive embeddings) on 2 data x
    2 model: ``train_step_syn`` against JAX's single-device step (loss rtol
    1e-5, parameters atol 2e-5), the ranks bit for bit."""
    _, jax_recs, ranks, _ = runs
    got = assert_ranks_equal(ranks, "syn/d2m2")
    want = jax_recs["syn"]
    np.testing.assert_allclose(float(got["loss"][0]), want["loss"],
                               rtol=LOSS_RTOL)
    assert_state_close(got, want, not_jax(syn_case()[0]))


def test_fresh_nodevec_step_under_model_x_time_matches_one_process(runs):
    """A diff-G step with ``fresh_nodevec`` (K = 48) on 2 model x 2 time:
    the embeddings drawn at the global shape, the rank's node rows of E1
    and all of E2 kept; the train and eval losses and the state against
    the port's one process, the ranks bit for bit."""
    one, _, ranks, _ = runs
    got = assert_ranks_equal(ranks, "fresh/m2t2")
    want = part(one, "fresh")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert_state_close(got, want)


def test_city_fused_steps_under_model_x_time_match_one_process(runs):
    """The city cell (flat supports and the mask sharded over 2 model
    ranks, dropout 0.3) on 2 model x 2 time: two fused train steps and a
    fused eval pass against one process, the ranks bit for bit."""
    one, _, ranks, _ = runs
    got = assert_ranks_equal(ranks, "city/m2t2")
    want = part(one, "city")
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval"], want["eval"], rtol=LOSS_RTOL)
    assert_state_close(got, want)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_metr_cli_under_node_tp_matches_one_process(runs):
    """``torchrun --nproc_per_node 2 ... --mesh_model 2`` on the METR path
    (15 nodes: 8 and 7) prints its mesh and exchange and tests like the
    one-process CLI run (the printed test MAE, 4 decimals)."""
    one, _, _, torchrun = runs
    assert "mesh: {'data': 1, 'model': 2, 'time': 1}" in torchrun
    assert "exchange: reduce-scatter" in torchrun and "[8, 7]" in torchrun
    assert torchrun.count("Total time spent") == 1
    line = [ln for ln in torchrun.splitlines()
            if ln.startswith("On average over seq_length horizons")][-1]
    got = float(line.split("Test MAE: ")[1].split(",")[0])
    np.testing.assert_allclose(got, float(one["cli_metr/mae"]), rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("name", ["metr", "crash"])
def test_cli_under_model_x_time_matches_one_process(runs, name):
    """``--mesh_model 2 --mesh_time 2`` on the 4 ranks, on the METR path
    and with ``--data crash``: test MAE against the one-process run (rtol
    1e-5); CRASH's pooled predictions, gathered from the model ranks' node
    ranges of each time group's last rank, atol 1e-5 of their scale."""
    one, _, ranks, _ = runs
    want = float(one[f"cli_{name}/mae"])
    for r in ranks:
        np.testing.assert_allclose(float(r[f"cli_{name}/mae"]), want,
                                   rtol=LOSS_RTOL)
    if name == "crash":
        pred = one["cli_crash/pred_E"]
        for r in ranks:
            assert r["cli_crash/pred_E"].shape == pred.shape
            np.testing.assert_allclose(r["cli_crash/pred_E"], pred, rtol=0,
                                       atol=1e-5 * np.abs(pred).max())


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
