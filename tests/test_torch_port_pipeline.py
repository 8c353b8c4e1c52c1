"""GPipe pipeline parallelism of the port on the CPU with gloo
(``graph_wavenet_tpu_torch/parallel/pipeline.py``, ``parallel/mesh.py``'s
pipe axis):

- ``stack_stages``/``unstack_stages`` against JAX's;
- the eval forward of JAX ``tests/test_pipeline.py``'s model (12 nodes,
  4 x 2 layers, two dense supports and the adaptive adjacency) on 4
  stages against JAX ``pipeline_apply`` on its 8-device host mesh (2e-4),
  and on (4 stages, 2 micro-batches), (2, 4) and (2, 1) against the
  port's one-process forward; the temporal-only model; flat block-sparse
  supports and the block-masked adaptive adjacency (the kernels' plain
  versions);
- pipeline train steps against the port's ``Engine.train_step_accum``
  with the same ``n_micro`` (losses and metrics rtol 1e-6, each gradient
  within 1e-6 of its tensor's largest, 1e-5 where 2 data ranks split its
  sums, parameters and BatchNorm buffers
  atol 2e-5 after Adam), fp32, dropout 0 and 0.3, on 4 stages and on 2
  data x 2 stages; two steps in a row; remat bit for bit the plain step; every rank
  bit for bit; one step against JAX ``make_pipeline_train_step`` with
  dropout 0 (loss rtol 1e-5, parameters atol 2e-5, leaving out those no
  loss term reaches);
- a one-stage pipeline against ``train_step_accum`` in this process, and
  the refusals: blocks the stages do not divide, a batch ``n_micro`` does
  not divide, ``fresh_nodevec``, the diff-G engine, block-sparse supports
  in a training step, a mesh with model or time axes.

The 4 ranks (a gloo group) and the one process they are held to are
subprocesses of this file's ``__main__`` branch, which imports only the
port; they start once per module, while the test process computes JAX's
results, and write ``.npz`` results, every wait bounded.
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
N = 12
N_CITY = 64
RTOL = 1e-6
# a gradient's sums split over data ranks add in another order
DATA_GRAD_RTOL = 1e-5
# Adam's first update divides a gradient by its magnitude: where the
# gradient is near zero its last bits move the parameter (the DP files' bar)
PARAM_ATOL = 2e-5
JAX_LOSS_RTOL, JAX_PARAM_ATOL = 1e-5, 2e-5

# eval forwards: name -> (stages, micro-batches, model config changes)
FORWARD = {"s4_m2": (4, 2, {}), "s2_m4": (2, 4, {}), "s2_m1": (2, 1, {}),
           "temporal": (4, 2, dict(gcn_bool=False, addaptadj=False)),
           "flat": (2, 2, dict(num_nodes=N_CITY)),
           "jax": (4, 2, dict(dropout=0.0))}
# train steps: name -> (stages, dropout, remat, steps)
TRAIN = {"s4": (4, 0.0, False, 1), "s4_drop": (4, 0.3, False, 1),
         "d2_s2_drop": (2, 0.3, False, 1), "s4_remat": (4, 0.3, True, 1),
         "s4_two": (4, 0.3, False, 2), "jax": (4, 0.0, False, 1)}
N_MICRO = 2


def cfg_kw(**kw) -> dict:
    """JAX ``tests/test_pipeline.py``'s ``_cfg``."""
    base = dict(num_nodes=N, in_dim=2, out_dim=6, residual_channels=8,
                dilation_channels=8, skip_channels=16, end_channels=32,
                blocks=4, layers=2, gcn_bool=True, addaptadj=True,
                n_supports=2, dropout=0.3)
    base.update(kw)
    return base


def batch(n: int = N):
    """JAX ``tests/test_pipeline.py``'s ``_data`` (batch 8, 12 steps,
    horizon 6) from a seeded numpy Generator."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 12, n, 2)).astype(np.float32)
    y = (rng.normal(size=(8, 6, n, 2)) + 5.0).astype(np.float32)
    a = rng.random((2, n, n)).astype(np.float32)
    return x, y, [s / s.sum(-1, keepdims=True) for s in a]


def city_supports():
    """A 64-node 4-NN graph in RCM order: its flat supports (blocks of 16)
    and their adaptive mask."""
    from graph_wavenet_tpu_torch.graphs import ordering, spatial
    from graph_wavenet_tpu_torch.ops import adaptive_block

    rng = np.random.default_rng(11)
    src, dst, w = spatial.knn_graph_edges(rng.random((N_CITY, 2)), 4)
    perm = ordering.rcm_order_edges(src, dst, N_CITY)
    sups = list(spatial.doubletransition_block_supports(
        src, dst, w, N_CITY, perm=perm, form="flat", block_size=16,
        device=CPU))
    return sups + [adaptive_block.mask_from_supports(sups)]


def state_of(model, prefix: str = "p:") -> dict:
    out = {prefix + k: v.detach().numpy().copy()
           for k, v in model.state_dict().items()}
    out.update({"g:" + k: p.grad.numpy().copy()
                for k, p in model.named_parameters() if p.grad is not None})
    return out


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _forward_case(name: str, meshes: dict, workdir: str) -> dict:
    from graph_wavenet_tpu_torch.config import ModelConfig
    from graph_wavenet_tpu_torch.models.gwnet import GWNet
    from graph_wavenet_tpu_torch.parallel.pipeline import pipeline_apply

    stages, n_micro, kw = FORWARD[name]
    cfg = ModelConfig(**cfg_kw(**kw))
    model = GWNet(cfg, device=CPU, seed=0)
    if name == "jax":
        model.load_state_dict(torch.load(
            os.path.join(workdir, "jax_weights.pt"), weights_only=True))
    x, _, a = batch(cfg.num_nodes)
    sups = (city_supports() if name == "flat" else None if not cfg.gcn_bool
            else [torch.as_tensor(s) for s in a])
    x = torch.as_tensor(x)
    with torch.no_grad():
        if meshes is None:
            model.eval()
            return {"out": model(x, sups).numpy()}
        mesh = meshes[stages]
        out = pipeline_apply(model, x, sups, mesh=mesh, n_micro=n_micro)
    return {"out": out.numpy(), "rows": mesh.batch_rows(8, n_micro),
            "holds": np.asarray(mesh.pipe_index == stages - 1)}


def _train_case(name: str, meshes: dict, workdir: str) -> dict:
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )
    from graph_wavenet_tpu_torch.train.engine import Engine

    stages, dropout, remat, steps = TRAIN[name]
    cfg = ModelConfig(**cfg_kw(dropout=dropout, remat=remat))
    eng = Engine(cfg, TrainConfig(batch_size=8), StandardScaler(5.0, 2.0),
                 device=CPU, seed=0)
    if name == "jax":
        eng.model.load_state_dict(torch.load(
            os.path.join(workdir, "jax_weights.pt"), weights_only=True))
    x, y, a = batch()
    sups = [torch.as_tensor(s) for s in a]
    if meshes is None:
        def step(xx, yy, ss):
            return eng.train_step_accum(xx, yy, ss, N_MICRO)
    else:
        step = make_pipeline_train_step(eng, meshes[stages], N_MICRO)
    metrics = [step(x, y, sups) for _ in range(steps)]
    return {"metrics": np.asarray([[float(m[k]) for k in
                                    ("loss", "mape", "rmse")]
                                   for m in metrics]),
            "gen": eng.generator.get_state().numpy(),
            **state_of(eng.model)}


def _worker(spec_path: str, rank: int) -> None:
    """One rank of the 4-rank gloo group, or (``rank`` -1) the one process
    every case is held to: its results to an ``.npz``."""
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.pipeline import make_pipeline_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    meshes = None
    if rank >= 0:
        multihost.initialize("gloo", rank, WORLD, spec["init"], device=CPU,
                             timeout_s=TIMEOUT)
        meshes = {s: make_pipeline_mesh(s, CPU) for s in (2, 4)}
    out = {}
    for kind, cases, fn in (("fwd", FORWARD, _forward_case),
                            ("train", TRAIN, _train_case)):
        for name in cases:
            rec = fn(name, meshes, spec["workdir"])
            out.update({f"{kind}_{name}/{k}": v for k, v in rec.items()})
    np.savez(os.path.join(spec["out"], "one.npz" if rank < 0
                          else f"rank{rank}.npz"), **out)
    if rank >= 0:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def jax_case(workdir):
    """JAX's engine for the JAX comparisons, its weights written for the
    port (``convert.params_from_jax``)."""
    import jax

    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.train.engine import Engine as JEngine

    kw = cfg_kw(dropout=0.0)
    jeng = JEngine(JConfig(**kw), JTrainConfig(batch_size=8),
                   JScaler(5.0, 2.0), seed=0)
    sd = to_port(jeng.state.params, jeng.state.model_state, kw)
    torch.save({k: torch.as_tensor(v) for k, v in sd.items()},
               workdir / "jax_weights.pt")
    del jax
    return jeng, kw


def to_port(params, model_state, kw) -> dict:
    import jax

    from graph_wavenet_tpu_torch import convert
    from graph_wavenet_tpu_torch.config import ModelConfig

    return {k: v.numpy() for k, v in convert.params_from_jax(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, model_state), ModelConfig(**kw)).items()}


def jax_results(jeng, kw) -> dict:
    """JAX's 4-stage eval forward and one pipeline train step (dropout 0,
    2 micro-batches, 2 data x 4 stages on the 8 host devices)."""
    import jax.numpy as jnp

    from graph_wavenet_tpu.parallel.pipeline import (
        make_pipeline_mesh,
        make_pipeline_train_step,
        pipeline_apply,
    )

    x, y, a = batch()
    sups = [jnp.asarray(s) for s in a]
    mesh = make_pipeline_mesh(4)
    out, _ = pipeline_apply(jeng.model_cfg, jeng.state.params,
                            jeng.state.model_state, jnp.asarray(x), sups,
                            mesh=mesh, n_micro=N_MICRO)
    step = make_pipeline_train_step(jeng, mesh, N_MICRO)
    st, m = step(jeng.state, jnp.asarray(x), jnp.asarray(y), sups)
    return {"out": np.asarray(out), "loss": float(m["loss"]),
            **{"p:" + k: v for k, v in to_port(st.params, st.model_state,
                                                kw).items()}}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank group and the one process (subprocesses started once the
    JAX weights are written), and, while they run, JAX's results: (one
    process's records, JAX's, every rank's)."""
    workdir = tmp_path_factory.mktemp("pipe")
    jeng, kw = jax_case(workdir)
    out = workdir / "w4"
    out.mkdir()
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(dict(
        workdir=str(workdir), out=str(out),
        init=f"file://{out}/rendezvous")))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in (-1, *range(WORLD)):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, __file__, str(spec_path), str(rank)], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    try:
        jax_rec = jax_results(jeng, kw)
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
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return one, jax_rec, ranks


def part(rec: dict, name: str) -> dict:
    pre = name + "/"
    return {k[len(pre):]: v for k, v in rec.items() if k.startswith(pre)}


def last_stages(ranks: list, name: str) -> list:
    """The records of ``name`` of the ranks that hold the output."""
    recs = [part(r, name) for r in ranks]
    return [r for r in recs if bool(r["holds"])]


def assert_rel(got, want, rtol: float, what: str) -> None:
    """Each tensor within ``rtol`` of its largest magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# stacking
# ---------------------------------------------------------------------------

def test_stack_stages_matches_jax_and_round_trips():
    import jax

    from graph_wavenet_tpu.config import ModelConfig as JConfig
    from graph_wavenet_tpu.config import TrainConfig as JTrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler as JScaler
    from graph_wavenet_tpu.parallel import pipeline as jpipe
    from graph_wavenet_tpu.train.engine import Engine as JEngine
    from graph_wavenet_tpu_torch.parallel.pipeline import (
        stack_stages,
        unstack_stages,
    )

    jeng = JEngine(JConfig(**cfg_kw()), JTrainConfig(),
                   JScaler(0.0, 1.0), seed=0)
    layers = jax.tree.map(np.array, jeng.state.params["layers"])
    want = jpipe.stack_stages(layers, 4)
    got = stack_stages(layers, 4)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat_w:
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = unstack_stages(got, len(layers))
    for a, b in zip(jax.tree_util.tree_leaves(layers),
                    jax.tree_util.tree_leaves(
                        jax.tree.map(lambda t: t.numpy(), back))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="do not divide"):
        stack_stages(layers, 3)


# ---------------------------------------------------------------------------
# the eval forward
# ---------------------------------------------------------------------------

def test_eval_forward_matches_jax_pipeline_apply(runs):
    """4 stages, 2 micro-batches, JAX's weights: the last stage's output
    against JAX ``pipeline_apply`` at 2e-4."""
    _, jax_rec, ranks = runs
    (rec,) = last_stages(ranks, "fwd_jax")
    np.testing.assert_allclose(rec["out"], jax_rec["out"][rec["rows"]],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["s4_m2", "s2_m4", "s2_m1", "temporal",
                                  "flat"])
def test_eval_forward_matches_one_process(runs, name):
    """The last stages' rows against the one-process forward (rtol 1e-6,
    the micro-batches cut the GEMMs' batch); 2-stage layouts run 2 data
    ranks, so both halves of the batch are checked."""
    one, _, ranks = runs
    want = part(one, f"fwd_{name}")["out"]
    recs = last_stages(ranks, f"fwd_{name}")
    assert len(recs) == WORLD // FORWARD[name][0]
    seen = set()
    for rec in recs:
        np.testing.assert_allclose(rec["out"], want[rec["rows"]],
                                   rtol=RTOL, atol=RTOL)
        seen.update(rec["rows"].tolist())
    assert seen == set(range(8))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def assert_ranks_equal(ranks: list, name: str) -> dict:
    """Every rank's parameters, buffers, metrics and generator bit for
    bit; rank 0's record (gradients are the same after the all-reduce)."""
    r0 = part(ranks[0], name)
    for r in ranks[1:]:
        got = part(r, name)
        for k in r0:
            if k.startswith(("p:", "g:")) or k in ("metrics", "gen"):
                np.testing.assert_array_equal(got[k], r0[k], err_msg=k)
    return r0


@pytest.mark.parametrize("name", ["s4", "s4_drop", "d2_s2_drop", "s4_two"])
def test_train_step_matches_train_step_accum(runs, name):
    """Pipeline steps against ``train_step_accum`` with the same
    ``n_micro`` in one process, the dropout masks the same draws."""
    one, _, ranks = runs
    got = assert_ranks_equal(ranks, f"train_{name}")
    want = part(one, f"train_{name}")
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=RTOL)
    np.testing.assert_array_equal(got["gen"], want["gen"])
    assert {k for k in got if k.startswith(("p:", "g:"))} == \
        {k for k in want if k.startswith(("p:", "g:"))}
    grad_rtol = DATA_GRAD_RTOL if name.startswith("d2") else RTOL
    for k in want:
        if k.startswith("g:"):
            assert_rel(got[k], want[k], grad_rtol, k)
        elif k.startswith("p:"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)


def test_remat_step_equals_plain_step(runs):
    _, _, ranks = runs
    plain = assert_ranks_equal(ranks, "train_s4_drop")
    remat = assert_ranks_equal(ranks, "train_s4_remat")
    for k in plain:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_train_step_matches_jax_pipeline_step(runs):
    """One step from JAX's weights against JAX ``make_pipeline_train_step``
    (dropout 0), leaving out the parameters no loss term reaches (the port
    gives them no gradient, optax a zero one its weight decay moves;
    ROADMAP.md's deliberate differences) and the batch counters."""
    _, jax_rec, ranks = runs
    got = assert_ranks_equal(ranks, "train_jax")
    np.testing.assert_allclose(got["metrics"][0, 0], jax_rec["loss"],
                               rtol=JAX_LOSS_RTOL)
    last = cfg_kw()["blocks"] * cfg_kw()["layers"] - 1
    skip = ("residual_convs.", f"gconv.{last}.", f"bn.{last}.",
            "num_batches_tracked")
    keys = [k for k in jax_rec if k.startswith("p:")
            and not any(s in k for s in skip)]
    assert len(keys) > 40
    for k in keys:
        np.testing.assert_allclose(got[k], jax_rec[k], rtol=0,
                                   atol=JAX_PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# in this process: one stage, and the refusals
# ---------------------------------------------------------------------------

def _engine(**kw):
    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.scaler import StandardScaler
    from graph_wavenet_tpu_torch.train.engine import Engine

    diff_g = kw.pop("diff_g", False)
    return Engine(ModelConfig(**cfg_kw(**kw)), TrainConfig(batch_size=8),
                  StandardScaler(5.0, 2.0), device=CPU, seed=0,
                  diff_g=diff_g)


def _mesh(stages: int, **kw):
    from graph_wavenet_tpu_torch.parallel.mesh import Mesh

    return Mesh(1, kw.pop("model", 1), 0, torch.device(CPU), pipe=stages,
                **kw)


def test_one_stage_pipeline_step_equals_train_step_accum():
    """A pipeline of one stage (no process group) against the accumulation
    step: dropout 0.3, 2 micro-batches, two steps (the adaptive adjacency
    is built once for both micro-batches, so its gradient sums in another
    order)."""
    from graph_wavenet_tpu_torch.parallel.pipeline import (
        make_pipeline_mesh,
        make_pipeline_train_step,
    )

    x, y, a = batch()
    sups = [torch.as_tensor(s) for s in a]
    ref, eng = _engine(), _engine()
    step = make_pipeline_train_step(eng, make_pipeline_mesh(1, CPU),
                                    N_MICRO)
    for _ in range(2):
        want = ref.train_step_accum(x, y, sups, N_MICRO)
        got = step(x, y, sups)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=RTOL, err_msg=k)
    for (k, p), q in zip(eng.model.named_parameters(),
                         ref.model.parameters()):
        assert (p.grad is None) == (q.grad is None), k
        if p.grad is not None:
            assert_rel(p.grad.numpy(), q.grad.numpy(), RTOL, k)
    for (k, p), q in zip(eng.model.state_dict().items(),
                         ref.model.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_refuses_stages_that_are_not_whole_blocks():
    from graph_wavenet_tpu_torch.parallel.pipeline import pipeline_apply

    eng = _engine(blocks=3)
    x, _, a = batch()
    with pytest.raises(ValueError, match="blocks=3 must divide"):
        pipeline_apply(eng.model, torch.as_tensor(x),
                       [torch.as_tensor(s) for s in a], mesh=_mesh(2),
                       n_micro=2)


def test_refuses_a_batch_the_micro_batches_do_not_divide():
    from graph_wavenet_tpu_torch.parallel.pipeline import pipeline_apply

    eng = _engine()
    x, _, a = batch()
    with pytest.raises(ValueError, match="n_micro=3"):
        pipeline_apply(eng.model, torch.as_tensor(x),
                       [torch.as_tensor(s) for s in a], mesh=_mesh(2),
                       n_micro=3)


def test_refuses_fresh_nodevec():
    from graph_wavenet_tpu_torch.parallel.pipeline import pipeline_apply

    eng = _engine(fresh_nodevec=True)
    x, _, a = batch()
    with pytest.raises(ValueError, match="fresh_nodevec"):
        pipeline_apply(eng.model, torch.as_tensor(x),
                       [torch.as_tensor(s) for s in a], mesh=_mesh(2),
                       n_micro=2)


def test_refuses_the_diff_g_engine():
    from graph_wavenet_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )

    eng = _engine(start_dilation=1, diff_g=True)
    with pytest.raises(ValueError, match="shared-graph"):
        make_pipeline_train_step(eng, _mesh(2), 2)


def test_train_step_refuses_block_sparse_supports():
    from graph_wavenet_tpu_torch.parallel.pipeline import (
        make_pipeline_train_step,
    )

    eng = _engine(num_nodes=N_CITY, addaptadj=False)
    x, y, _ = batch(N_CITY)
    step = make_pipeline_train_step(eng, _mesh(2), 2)
    with pytest.raises(ValueError, match="dense .* supports only"):
        step(x, y, city_supports()[:2])


def test_refuses_model_and_time_axes():
    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh
    from graph_wavenet_tpu_torch.parallel.pipeline import pipeline_apply

    with pytest.raises(ValueError, match="model axis of 2 and a time "
                                         "axis of 1"):
        make_mesh(MeshConfig(model_axis=2), CPU, pipe=2)
    with pytest.raises(ValueError, match="model axis of 1 and a time "
                                         "axis of 2"):
        make_mesh(MeshConfig(time_axis=2), CPU, pipe=2)
    eng = _engine()
    x, _, a = batch()
    with pytest.raises(ValueError, match="model axis of 2"):
        pipeline_apply(eng.model, torch.as_tensor(x),
                       [torch.as_tensor(s) for s in a],
                       mesh=_mesh(1, model=2), n_micro=2)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
