"""The port's parallel layer (``graph_wavenet_tpu_torch/parallel``) on the
CPU with gloo: data parallelism (DP) and block-sparse node-TP.

- the partition tables equal the JAX package's ``shard_flat_support`` on
  the conftest's virtual mesh, bit for bit;
- S-rank ``mix_2d`` and its VJP against the single-process flat support;
- 3 train steps of 2- and 4-rank node-TP (all_gather and halo, with the
  mask), 2-rank DP, 2 x 2, and DP with ``grad_accum`` 2 and with ``remat``,
  dropout 0.3, against the single-process port at JAX's DP bar (loss rtol
  1e-5, parameters atol 1e-5), the parameters equal across ranks bit for
  bit; one node-TP step against JAX's mesh step;
- the training CLI under torchrun, its checkpoint served in one process;
- the refusals.

The ranks are subprocesses of this file's ``__main__`` branch, which
imports only the port; each group starts once per module (a module-scoped
fixture writes their inputs and reads their ``.npz`` results), rendezvous
through ``file://`` in a temporary directory, every wait bounded.
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
N_CITY, BLOCK, BATCH, STEPS = 256, 32, 4, 3
TIMEOUT = 240

# the groups of rank processes and what each runs
TRAIN_CASES = {
    2: [dict(name="tp2_gather", model=2, halo=False),
        dict(name="tp2_halo", model=2, halo=True),
        dict(name="dp2", model=1),
        dict(name="dp2_accum", model=1, accum=2),
        dict(name="dp2_remat", model=1, remat=True)],
    4: [dict(name="tp4_gather", model=4, halo=False),
        dict(name="tp4_halo", model=4, halo=True),
        dict(name="dp2_tp2", model=2, halo="auto"),
        dict(name="tp4_jax", model=4, halo="auto", dropout=0.0, steps=1,
             weights="jax_init.pt")],
}


# ---------------------------------------------------------------------------
# shared by the test process and the ranks (port only)
# ---------------------------------------------------------------------------

def city_cfg(**kw):
    from graph_wavenet_tpu_torch.config import ModelConfig

    base = dict(num_nodes=N_CITY, in_dim=2, out_dim=12, residual_channels=8,
                dilation_channels=8, skip_channels=16, end_channels=16,
                blocks=2, layers=2, dropout=0.3, gcn_bool=True,
                addaptadj=True, n_supports=2)
    base.update(kw)
    return ModelConfig(**base)


def city_graph():
    """A 256-node 4-NN graph in RCM order (8 block-rows of 32)."""
    from graph_wavenet_tpu_torch.graphs import ordering, spatial

    rng = np.random.default_rng(11)
    src, dst, w = spatial.knn_graph_edges(rng.random((N_CITY, 2)), 4)
    return src, dst, w, ordering.rcm_order_edges(src, dst, N_CITY)


def city_supports():
    """The two flat doubletransition supports and their union mask."""
    from graph_wavenet_tpu_torch.graphs import spatial
    from graph_wavenet_tpu_torch.ops import adaptive_block

    src, dst, w, perm = city_graph()
    sups = spatial.doubletransition_block_supports(
        src, dst, w, N_CITY, perm=perm, form="flat", block_size=BLOCK,
        device=CPU)
    return list(sups), adaptive_block.mask_from_supports(sups)


def city_batches(steps=STEPS):
    """Batches with a null share that differs across the node shards (the
    mask's mean must be the global one)."""
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(steps, BATCH, 12, N_CITY, 2)).astype(np.float32)
    ys = (rng.normal(size=(steps, BATCH, 12, N_CITY, 2)) * 9.5
          + 31.0).astype(np.float32)
    ys[:, :, :, :40, 0] = 0.0
    ys[:, 1, :5, 200:, 0] = 0.0
    return xs, ys


def skewed_flat():
    """8 block-rows of 64, skewed: 5 sources for one column block, an
    empty one, cross-shard sources (a shard with fewer live blocks)."""
    from graph_wavenet_tpu_torch.ops import block_sparse

    rng = np.random.default_rng(0)
    n = 8 * 64
    a = np.zeros((n, n), np.float32)
    a[:64, :64] = rng.random((64, 64))
    a[:320, 64:128] = rng.random((320, 64))
    a[:64, 192:256] = rng.random((64, 64))
    a[384:448, 256:448] = rng.random((64, 192))
    return a, block_sparse.as_flat_pallas(
        block_sparse.from_dense(a, block_size=64, device=CPU))


def run_train(case: dict, mesh=None, workdir: str = "") -> dict:
    """``case``'s steps on the port's Engine (a mesh, or one process):
    the losses, the gradients the first update took (summed over the
    ranks, clipped) and every parameter and buffer after the last step."""
    from graph_wavenet_tpu_torch.config import TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.parallel import sparse_tp
    from graph_wavenet_tpu_torch.train.engine import Engine

    fixed, mask = city_supports()
    if mesh is not None and mesh.model > 1:
        fixed = [sparse_tp.shard_flat_support(s, mesh, halo=case["halo"])
                 for s in fixed]
        mask = sparse_tp.shard_adaptive_mask(mask, mesh, halo=case["halo"])
    cfg = city_cfg(dropout=case.get("dropout", 0.3),
                   remat=case.get("remat", False))
    eng = Engine(cfg, TrainConfig(learning_rate=1e-3, weight_decay=1e-4),
                 StandardScaler(31.0, 9.5), device=CPU, seed=0, mesh=mesh)
    if case.get("weights"):
        eng.model.load_state_dict(torch.load(
            os.path.join(workdir, case["weights"]), weights_only=True))
    steps = case.get("steps", STEPS)
    xs, ys = city_batches(steps)
    losses = []
    for s in range(steps):
        if case.get("accum", 1) > 1:
            m = eng.train_step_accum(xs[s], ys[s], fixed + [mask],
                                     case["accum"])
        else:
            m = eng.train_step(xs[s], ys[s], fixed + [mask])
        losses.append(float(m["loss"]))
        if s == 0:
            grads = {"g:" + k: p.grad.numpy().copy()
                     for k, p in eng.model.named_parameters()
                     if p.grad is not None}
    out = {"losses": np.asarray(losses), **grads}
    for k, v in eng.model.state_dict().items():
        out["p:" + k] = v.numpy().copy()
    if mesh is not None:
        out["halo"] = np.asarray([getattr(mask, "halo", False)])
    return out


def run_mix(mesh, halo, trainable: bool) -> dict:
    """One hop of the skewed support and its VJP (x, and the blocks when
    ``trainable``) for ``loss = sum(sin(hop(x)) * w)``: on a mesh the
    rank's node rows and, for the blocks, the gradient summed over the
    model group; without one the single-process flat support."""
    from graph_wavenet_tpu_torch.parallel import collectives, sparse_tp

    _, flat = skewed_flat()
    rng = np.random.default_rng(3)
    n, r = flat.n_nodes, 24
    x = torch.as_tensor(rng.normal(size=(n, r)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(n, r)).astype(np.float32))
    if mesh is None:
        x.requires_grad_(True)
        blocks = flat.blocks_flat.clone().requires_grad_(trainable)
        import dataclasses

        sp = dataclasses.replace(flat, blocks_flat=blocks)
        out = sp.mix_2d(x)
        (torch.sin(out) * w).sum().backward()
        return {"out": out.detach().numpy(), "dx": x.grad.numpy(),
                "dblocks": (blocks.grad.numpy() if trainable
                            else np.zeros(1))}
    sp = sparse_tp.shard_flat_support(flat, mesh, halo=halo,
                                      trainable=trainable)
    lo, hi = mesh.node_range(n)
    xl = x[lo:hi].clone().requires_grad_(True)
    if trainable:
        sp.blocks.requires_grad_(True)
    out = sp.mix_2d(xl)
    (torch.sin(out) * w[lo:hi]).sum().backward()
    dblocks = np.zeros(1)
    if trainable:
        dblocks = collectives.all_reduce_(sp.blocks.grad.clone(),
                                          mesh.model_group).numpy()
    return {"out": out.detach().numpy(), "dx": xl.grad.numpy(),
            "dblocks": dblocks, "halo": np.asarray([sp.halo])}


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _cli_refusals(spec: dict) -> dict:
    """The CLI's refusals that need two ranks (each raises on both ranks
    before any collective)."""
    from graph_wavenet_tpu_torch.cli import train

    base = ["--data", spec["city_data"], "--device", CPU, "--gcn_bool",
            "--block_size", "16", "--ordering", "rcm", "--seq_length", "12",
            "--nhid", "4", "--blocks", "1", "--layers", "2", "--epochs", "1",
            "--save", os.path.join(spec["out"], "refused")]
    runs = {
        "padded": ["--graph_npz", spec["city_graph"], "--sparse", "pallas",
                   "--mesh_model", "2", "--batch_size", "4"],
        "block_rows": ["--graph_npz", spec["odd_graph"], "--mesh_model", "2",
                       "--batch_size", "4"],
        "batch": ["--graph_npz", spec["city_graph"], "--mesh_dp",
                  "--batch_size", "3"],
    }
    out = {}
    for name, argv in runs.items():
        try:
            train.main(base + argv)
            out["refused:" + name] = np.asarray("")
        except (SystemExit, ValueError) as e:
            out["refused:" + name] = np.asarray(str(e))
    return out


# the CLI runs each rank makes in the 2-rank group, and the same runs in
# one process in the tests (fp32, dropout 0, one epoch)
def cli_runs(spec: dict) -> dict:
    small = ["--device", CPU, "--seq_length", "12", "--nhid", "4",
             "--blocks", "1", "--layers", "2", "--epochs", "1", "--dropout",
             "0.0", "--batch_size", "4"]
    return {
        "city_aptonly": small + [
            "--graph_npz", spec["city_graph"], "--data", spec["city_data"],
            "--gcn_bool", "--addaptadj", "--aptonly", "--sparse", "flat",
            "--block_size", "16", "--ordering", "rcm", "--mesh_model", "2"],
        "metr_dp": small + [
            "--data", spec["metr_data"], "--adjdata", spec["metr_adj"],
            "--num_nodes", "20", "--gcn_bool", "--addaptadj", "--mesh_dp"],
    }


def _cli_train(spec: dict) -> dict:
    """The CLI's city aptonly node-TP run and its METR DP run on this
    group (the process group exists, so the CLI joins it): test MAE."""
    from graph_wavenet_tpu_torch.cli import train

    out = {}
    for name, argv in cli_runs(spec).items():
        res = train.main(argv + ["--save", os.path.join(spec["out"], name)])
        out["cli:" + name] = np.asarray(res["result"].test_metrics["mae"])
    return out


def _worker(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    layout = multihost.initialize("gloo", rank, spec["world"], spec["init"],
                                  device=CPU, timeout_s=TIMEOUT)
    out = {"layout": np.asarray([layout[k] for k in (
        "process_index", "process_count", "local_devices",
        "global_devices")])}
    for case in spec["train"]:
        mesh = make_mesh(MeshConfig(model_axis=case["model"]), CPU)
        for k, v in run_train(case, mesh, spec["workdir"]).items():
            out[f"{case['name']}/{k}"] = v
    mesh = make_mesh(MeshConfig(model_axis=spec["world"]), CPU)
    # a rank's rows (DP) and node range (node-TP) of a global batch, and
    # a state replicated from rank 0
    dp = make_mesh(MeshConfig(), CPU)
    batch = torch.arange(8.0 * spec["world"]).reshape(2 * spec["world"], 1,
                                                      4, 1)
    out["dp_batch"] = dp.shard_batch(batch, n_nodes=4).numpy()
    out["tp_batch"] = mesh.shard_batch(batch[:, :, :spec["world"]],
                                       n_nodes=spec["world"]).numpy()
    state = {"w": torch.full((3,), float(rank)), "n": [torch.tensor(rank)]}
    multihost.replicate_pytree(state, dp)
    out["replicated"] = np.concatenate([state["w"].numpy(),
                                        state["n"][0].numpy()[None]])
    for halo in (False, "auto"):
        for trainable in (False, True):
            name = f"mix/{halo}/{trainable}"
            for k, v in run_mix(mesh, halo, trainable).items():
                out[f"{name}/{k}"] = v
    if spec.get("city_data"):
        out.update(_cli_refusals(spec))
        out.update(_cli_train(spec))
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def write_city_cli(tmp, n_raw: int, name: str, with_data: bool):
    """A 4-NN graph of ``n_raw`` nodes and (``with_data``) a METR-format
    dataset in raw node order."""
    from graph_wavenet_tpu_torch.graphs import city, spatial

    rng = np.random.default_rng(n_raw)
    pos = rng.random((n_raw, 2))
    src, dst, w = spatial.knn_graph_edges(pos, 3)
    gpath = str(tmp / f"{name}.npz")
    city.save_graph_npz(gpath, src, dst, w, pos=pos, n_nodes=n_raw)
    if not with_data:
        return gpath, None
    data = tmp / f"{name}_data"
    data.mkdir()
    for split, s in (("train", 8), ("val", 4), ("test", 6)):
        x = rng.normal(5.0, 2.0, size=(s, 12, n_raw, 2)).astype(np.float32)
        y = rng.normal(5.0, 2.0, size=(s, 12, n_raw, 2)).astype(np.float32)
        y[:, :, :3, 0] = 0.0
        np.savez(data / f"{split}.npz", x=x, y=y)
    return gpath, str(data)


def write_metr(tmp):
    """A 20-sensor METR-format dataset (the port's ETL over 300 readings)
    and an adjacency pickle."""
    import pickle

    from graph_wavenet_tpu_torch.data.traffic_etl import (
        generate_train_val_test,
    )

    rng = np.random.default_rng(4)
    n, t = 20, 300
    values = (rng.normal(size=(t, n)) * 10 + 55).astype(np.float32)
    values[rng.random(values.shape) < 0.05] = 0.0
    index = (np.datetime64("2012-03-01T00:00")
             + np.arange(t) * np.timedelta64(5, "m"))
    data = str(tmp / "metr")
    generate_train_val_test(values, data, index=index)
    adj = (rng.random((n, n)) < 0.4).astype(np.float32) * rng.random((n, n))
    np.fill_diagonal(adj, 1.0)
    path = str(tmp / "adj.pkl")
    with open(path, "wb") as f:
        pickle.dump(([str(i) for i in range(n)],
                     {str(i): i for i in range(n)}, adj.astype(np.float32)),
                    f)
    return data, path


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel")


@pytest.fixture(scope="module")
def jax_init(workdir):
    """The JAX engine whose initial weights the ``tp4_jax`` ranks load
    (converted with ``convert.params_from_jax``)."""
    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.engine import Engine as JEngine
    from graph_wavenet_tpu_torch import convert

    cfg = city_cfg(dropout=0.0)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "num_nodes", "in_dim", "out_dim", "residual_channels",
        "dilation_channels", "skip_channels", "end_channels", "blocks",
        "layers", "dropout", "gcn_bool", "addaptadj", "n_supports")})
    jeng = JEngine(jcfg, JTrainConfig(learning_rate=1e-3, weight_decay=1e-4),
                   JScaler(31.0, 9.5), seed=3)
    import jax

    sd = convert.params_from_jax(jax.tree.map(np.asarray, jeng.state.params),
                                 jax.tree.map(np.asarray,
                                              jeng.state.model_state), cfg)
    torch.save(sd, workdir / "jax_init.pt")
    return jeng


@pytest.fixture(scope="module")
def ranks(workdir, jax_init):
    """Both groups of rank processes (2 and 4 ranks), run once, started
    together; their per-rank results."""
    cli_graph, cli_data = write_city_cli(workdir, 60, "city", True)
    odd_graph, _ = write_city_cli(workdir, 40, "odd", False)
    metr_data, metr_adj = write_metr(workdir)
    procs = []
    for world, cases in TRAIN_CASES.items():
        out = workdir / f"w{world}"
        out.mkdir()
        spec = dict(world=world, train=cases, out=str(out),
                    workdir=str(workdir), init=f"file://{out}/rendezvous")
        if world == 2:
            spec.update(city_graph=cli_graph, city_data=cli_data,
                        odd_graph=odd_graph, metr_data=metr_data,
                        metr_adj=metr_adj)
        spec_path = out / "spec.json"
        spec_path.write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        for rank in range(world):
            log = open(out / f"rank{rank}.log", "w")
            procs.append((out, rank, log, subprocess.Popen(
                [sys.executable, __file__, str(spec_path), str(rank)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    try:
        for out, rank, log, p in procs:
            try:
                rc = p.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append(f"{out.name} rank {rank}: {rc}\n"
                              + (out / f"rank{rank}.log").read_text()[-3000:])
    finally:
        for _, _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    assert not failed, "\n".join(failed)
    return {w: [dict(np.load(workdir / f"w{w}" / f"rank{r}.npz"))
                for r in range(w)] for w in TRAIN_CASES}


@pytest.fixture(scope="module")
def single(workdir):
    """Every train case's single-process port run, by configuration."""
    runs, by_name = {}, {}
    for cases in TRAIN_CASES.values():
        for case in cases:
            if case.get("weights"):
                continue
            key = (case.get("dropout", 0.3), case.get("accum", 1),
                   case.get("remat", False), case.get("steps", STEPS))
            if key not in runs:
                runs[key] = run_train(case, None, str(workdir))
            by_name[case["name"]] = runs[key]
    return by_name


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def inv_slots(slot, max_live: int) -> np.ndarray:
    """The JAX module's ``inv`` of stacked slot tables: each shard's table
    position of every local live slot (the rest -> the table length), the
    gather of its per-entry weight cotangent."""
    inv = np.full((slot.shape[0], max_live + 1), slot.shape[1], np.int32)
    for s, sl in enumerate(slot):
        pos = np.nonzero(sl < max_live)[0]
        inv[s, sl[pos]] = pos
    return inv


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("halo", [False, "auto"], ids=["gather", "auto"])
@pytest.mark.parametrize("trainable", [False, True],
                         ids=["fixed", "trainable"])
def test_partition_tables_equal_jax(n_shards, halo, trainable):
    """Both partitions, the halo remap and choice, and glob/inv: the port's
    tables are the JAX package's ``shard_flat_support`` fields."""
    import jax.numpy as jnp

    from graph_wavenet_tpu.config import MeshConfig as JMesh
    from graph_wavenet_tpu.ops import block_sparse as JB
    from graph_wavenet_tpu.parallel.mesh import make_mesh as jmake_mesh
    from graph_wavenet_tpu.parallel.sparse_tp import (
        shard_flat_support as jshard,
    )
    from graph_wavenet_tpu_torch.parallel.sparse_tp import partition_tables

    a, flat = skewed_flat()
    jflat = JB.as_flat_pallas(JB.from_dense(jnp.asarray(a), block_size=64))
    want = jshard(jflat, jmake_mesh(JMesh(model_axis=n_shards)), halo=halo,
                  trainable=trainable)
    got = partition_tables(flat, n_shards, halo)
    assert got["halo"] == want.halo
    names = ["row_f", "src_f", "slot_f", "row_b", "src_b", "slot_b"]
    names += (["glob_f", "inv_f", "glob_b"] if trainable
              else ["blocks_f", "blocks_b"])
    if trainable:
        got["inv_f"] = inv_slots(got["slot_f"], got["blocks_f"].shape[1] - 1)
    for k in names:
        w = np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if trainable:
        np.testing.assert_array_equal(got["blocks"],
                                      np.asarray(want.blocks)[:-1])
    # the skew: one shard holds fewer live blocks than the longest
    assert got["n_live"].min() < got["n_live"].max()


def test_halo_auto_picks_halo_on_a_band_and_forced_halo_refuses():
    from graph_wavenet_tpu_torch.parallel.sparse_tp import partition_tables

    sups, _ = city_supports()
    assert all(partition_tables(s, 4, "auto")["halo"] for s in sups)
    _, flat = skewed_flat()
    assert not partition_tables(flat, 4, "auto")["halo"]
    with pytest.raises(ValueError, match="halo=True"):
        partition_tables(flat, 4, True)
    with pytest.raises(ValueError, match="divide"):
        partition_tables(flat, 3)


# ---------------------------------------------------------------------------
# hops and train steps across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("halo", [False, "auto"], ids=["gather", "auto"])
@pytest.mark.parametrize("trainable", [False, True],
                         ids=["fixed", "trainable"])
def test_sharded_mix_and_vjp_match_flat(ranks, world, halo, trainable):
    """The ranks' hop outputs and dx, put back together, and the blocks'
    gradient summed over the ranks, equal the single-process flat support's
    (fp32, 1e-6 of the scale)."""
    want = run_mix(None, None, trainable)
    name = f"mix/{halo}/{trainable}"
    got = {k: np.concatenate([r[f"{name}/{k}"] for r in ranks[world]])
           for k in ("out", "dx")}
    got["dblocks"] = ranks[world][0][f"{name}/dblocks"]
    keys = ("out", "dx") + (("dblocks",) if trainable else ())
    for k in keys:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-6 * scale, err_msg=k)
    halo_used = bool(ranks[world][0][f"{name}/halo"][0])
    assert halo_used == (halo == "auto" and world == 2)


ALL_CASES = [c["name"] for cases in TRAIN_CASES.values() for c in cases
             if not c.get("weights")]


@pytest.mark.parametrize("case", ALL_CASES)
def test_train_steps_match_single_process(ranks, single, case):
    """3 steps with dropout 0.3 across ranks equal the single-process port:
    loss rtol 1e-5, every parameter and buffer atol 1e-5; parameters and
    buffers equal across the ranks bit for bit."""
    world = next(w for w, cs in TRAIN_CASES.items()
                 if any(c["name"] == case for c in cs))
    results = ranks[world]
    want = single[case]
    np.testing.assert_allclose(results[0][f"{case}/losses"], want["losses"],
                               rtol=1e-5)
    keys = [k for k in want if k.startswith("p:")]
    for k in keys:
        np.testing.assert_allclose(results[0][f"{case}/{k}"], want[k],
                                   rtol=0, atol=1e-5, err_msg=k)
        for r in results[1:]:
            np.testing.assert_array_equal(r[f"{case}/{k}"],
                                          results[0][f"{case}/{k}"],
                                          err_msg=k)
    if case in ("tp2_halo", "tp4_halo"):
        assert all(bool(r[f"{case}/halo"][0]) for r in results)


@pytest.mark.parametrize("case", ALL_CASES)
def test_first_step_gradients_match_single_process(ranks, single, case):
    """The gradients of the first update, summed over the ranks, equal the
    single process's: atol 1e-5 x each tensor's largest magnitude. Adam's
    update is close to the gradient's sign and invariant to a tensor's
    scale, so the parameters alone would not show a rank's share of a
    gradient lost or counted twice."""
    world = next(w for w, cs in TRAIN_CASES.items()
                 if any(c["name"] == case for c in cs))
    results = ranks[world]
    want = single[case]
    keys = [k for k in want if k.startswith("g:")]
    assert keys and {k for k in results[0]
                     if k.startswith(f"{case}/g:")} == {
        f"{case}/{k}" for k in keys}
    for k in keys:
        np.testing.assert_allclose(results[0][f"{case}/{k}"], want[k],
                                   rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_node_tp_step_matches_jax_mesh_step(ranks, jax_init):
    """One 4-rank node-TP step (flat supports and the mask, dropout 0) from
    JAX's initial weights against JAX's step on its (data 2 x model 4)
    virtual mesh with ``shard_flat_support``/``shard_adaptive_mask``
    (``test_sparse_tp.py``'s model step with the mask): loss to 5e-4,
    parameters to rtol 1e-3 / atol 1e-4, the port's parity bars."""
    import jax
    import jax.numpy as jnp

    from graph_wavenet_tpu.config import MeshConfig as JMesh
    from graph_wavenet_tpu.graphs import spatial as jspatial
    from graph_wavenet_tpu.ops import adaptive_block as jab
    from graph_wavenet_tpu.parallel.mesh import make_mesh as jmake_mesh
    from graph_wavenet_tpu.parallel.sparse_tp import (
        shard_adaptive_mask,
        shard_flat_support,
    )
    from graph_wavenet_tpu_torch import convert

    src, dst, w, perm = city_graph()
    sups = jspatial.doubletransition_block_supports(
        src, dst, w, N_CITY, perm=perm, form="flat", block_size=BLOCK)
    mesh = jmake_mesh(JMesh(model_axis=4))
    j_sup = ([shard_flat_support(s, mesh) for s in sups]
             + [shard_adaptive_mask(jab.mask_from_supports(sups), mesh)])
    xs, ys = city_batches(1)
    state, m = jax_init.train_step(jax_init.state, jnp.asarray(xs[0]),
                                   jnp.asarray(ys[0]), j_sup)
    got = ranks[4][0]
    np.testing.assert_allclose(got["tp4_jax/losses"], [float(m["loss"])],
                               rtol=5e-4, atol=5e-4)
    want = convert.params_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.model_state), city_cfg())
    for k in ("nodevec1", "nodevec2", "end_conv_2.weight",
              "gconv.0.mlp.mlp.weight", "bn.1.running_mean",
              "bn.1.running_var"):
        np.testing.assert_allclose(got[f"tp4_jax/p:{k}"],
                                   want[k].numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the CLI under torchrun, and the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr", [None, 0.0], ids=["lr1e-3", "lr0"])
def test_train_cli_under_torchrun_serves_in_one_process(workdir, ranks, lr):
    """``torchrun --nproc_per_node 2`` trains the city model with node-TP
    (flat supports and the mask, dropout 0); rank 0's checkpoint serves in
    one process through ``Forecaster.from_city_checkpoint`` and its
    forecast equals the single-process CLI run's checkpoint's: 1e-5 of the
    scale at the default learning rate (the two runs differ in summation
    order only, which Adam's first update turns into moves of up to 2 lr
    on elements whose gradient is a cancellation result), 1e-6 at
    learning rate 0, where only BatchNorm's running statistics, summed in
    another order, differ (ROADMAP.md §3)."""
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.train import serving

    gpath, data = str(workdir / "city.npz"), str(workdir / "city_data")
    argv = ["--graph_npz", gpath, "--data", data, "--device", CPU,
            "--gcn_bool", "--addaptadj", "--sparse", "flat",
            "--block_size", "16", "--ordering", "rcm", "--seq_length", "12",
            "--nhid", "4", "--blocks", "1", "--layers", "2", "--batch_size",
            "4", "--epochs", "1", "--dropout", "0.0"]
    if lr is not None:
        argv += ["--learning_rate", str(lr)]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    name = "default" if lr is None else f"lr{lr}"
    save = workdir / f"ck_tp_{name}"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "graph_wavenet_tpu_torch.cli.train",
         *argv, "--mesh_model", "2", "--save", str(save)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("Total time spent") == 1     # rank 0 prints
    assert "mesh: {'data': 1, 'model': 2" in out.stdout
    res = train.main(argv + ["--save", str(workdir / f"ck_one_{name}")])
    (path_tp,) = [str(p) for p in save.glob("*.pt")]
    one = res["result"].best_checkpoint
    x = np.random.default_rng(2).normal(size=(2, 12, 60, 2)).astype(
        np.float32)
    pred = {}
    for k, p in (("tp", path_tp), ("one", one)):
        fc = serving.Forecaster.from_city_checkpoint(p, gpath, device=CPU)
        pred[k] = np.asarray(fc.predict(x))
    scale = np.abs(pred["one"]).max()
    np.testing.assert_allclose(pred["tp"], pred["one"], rtol=0,
                               atol=(1e-5 if lr is None else 1e-6) * scale)
    hist = (save / "history.jsonl").read_text().splitlines()
    assert sum('"epoch"' in h for h in hist) == 1


@pytest.mark.parametrize("name", ["city_aptonly", "metr_dp"])
def test_train_cli_across_ranks_matches_one_process(workdir, ranks, name):
    """The CLI on two ranks, the city model with the adaptive adjacency
    alone under node-TP and the METR model under DP, tests like the same
    run in one process (test MAE rtol 1e-5: fp32, dropout 0, one epoch)."""
    from graph_wavenet_tpu_torch.cli import train

    spec = dict(city_graph=str(workdir / "city.npz"),
                city_data=str(workdir / "city_data"),
                metr_data=str(workdir / "metr"),
                metr_adj=str(workdir / "adj.pkl"))
    argv = cli_runs(spec)[name]
    for flag in ("--mesh_dp", "--mesh_model"):
        if flag in argv:
            i = argv.index(flag)
            del argv[i:i + (2 if flag == "--mesh_model" else 1)]
    one = train.main(argv + ["--save", str(workdir / f"one_{name}")])
    want = one["result"].test_metrics["mae"]
    for r in ranks[2]:
        got = float(r["cli:" + name])
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_global_batch_and_shard_state(ranks, world):
    """``initialize`` reports the rank's place; ``Mesh.shard_batch`` gives
    DP rank d the rows [2d, 2d + 2) of a batch of 2 x world rows, every
    node, and node-TP rank m every row and node m;
    ``multihost.replicate_pytree`` gives every rank rank 0's tensors,
    nested ones too."""
    batch = np.arange(8.0 * world).reshape(2 * world, 1, 4, 1)
    for d, r in enumerate(ranks[world]):
        np.testing.assert_array_equal(r["layout"], [d, world, 1, world])
        np.testing.assert_array_equal(r["dp_batch"], batch[2 * d:2 * d + 2])
        np.testing.assert_array_equal(r["tp_batch"], batch[:, :, d:d + 1])
        np.testing.assert_array_equal(r["replicated"], np.zeros(4))


def test_refusals_across_ranks(ranks):
    """Under two ranks the CLI refuses the padded form with --mesh_model,
    block-rows the model axis does not divide, and a batch the data axis
    does not divide."""
    r0 = ranks[2][0]
    assert "--sparse flat" in str(r0["refused:padded"])
    assert "block-rows" in str(r0["refused:block_rows"])
    assert "divide by the data axis 2" in str(r0["refused:batch"])


def test_refusals_in_one_process(tmp_path):
    """What is still refused, in one process: a world that the model axis,
    or model x time, does not divide (``--mesh_time`` with
    ``--mesh_model``, and ``--mesh_model`` on the METR path and with the
    per-sample-graph tasks, all ported now); city block-rows that the
    model axis does not divide; NCCL with more ranks than cards.
    ``MeshConfig`` takes both axes."""
    from graph_wavenet_tpu_torch.cli import train
    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost, sparse_tp
    from graph_wavenet_tpu_torch.parallel.mesh import Mesh, make_mesh

    with pytest.raises(ValueError, match="ranks do not divide by the model "
                       "x time axes 2 x 2"):
        train.main(["--mesh_time", "2", "--mesh_model", "2", "--device",
                    CPU])
    both = MeshConfig(model_axis=2, time_axis=2)
    assert (both.model_axis, both.time_axis) == (2, 2)
    for data in ("syn", "crash"):
        with pytest.raises(ValueError, match="ranks do not divide by the "
                           "model axis 2"):
            train.main(["--data", data, "--mesh_model", "2", "--device",
                        CPU])
    with pytest.raises(ValueError, match="ranks do not divide by the model "
                       "axis 2"):
        train.main(["--mesh_model", "2", "--device", CPU])
    sups, _ = city_supports()
    with pytest.raises(ValueError, match="8 block-rows must divide by the "
                       "model axis size 3"):
        sparse_tp.shard_flat_support(sups[0], Mesh(1, 3, 0,
                                                   torch.device(CPU)))
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        multihost.initialize("nccl", 0, 2, f"file://{tmp_path}/rdzv",
                             device=CPU)
    with pytest.raises(ValueError, match="ranks do not divide"):
        make_mesh(MeshConfig(model_axis=2), CPU)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
