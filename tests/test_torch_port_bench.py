"""The port's benchmark module and the graphTools orderings, against the JAX
package on the CPU (``graph_wavenet_tpu_torch/benchmarks.py``,
``graphs/ordering.py``, the ops' FLOP formulas in
``ops/cuda/block_diffusion.py``, ``parallel/mesh.py``'s rank subsets):

- the six graphTools orderings bit for bit against JAX's on a seeded
  40-node graph (labels, orders, permuted matrices);
- ``_random_inputs`` bit for bit, and the differential timing on one
  scripted fake clock through every branch (degenerate, negative,
  repeats) equal to JAX's;
- the band check tripping as JAX's does, refusing a record of another
  device by name, and giving a verdict a recorded row (the re-measurement
  stubbed: a real one is the card test's), each row re-run by its own
  benchmark;
- each op's FLOP formula equal to the JAX kernel's ``CostEstimate`` flops
  over the same tables' shapes (R unpadded);
- a 512-node ``block-flat`` step's count equal to the dense products'
  count (the same step with the hops stubbed) plus the hops' formulas: the
  plain versions inside the ops are not counted again;
- the dense steps' counts within [0.90, 1.00] of JAX's XLA cost-model
  counts (FlopCounterMode counts products only);
- the rows' keys on the CPU equal JAX's, with ``mfu`` and the peak None,
  and ``cuda`` refused on a machine without a card;
- ``bench_sharded_train_step`` (model axis 2) and ``weak_scaling`` on two
  gloo processes, started once for the module (this file's ``__main__``
  branch, which imports only the port) while the test process runs JAX.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TIMEOUT = 240
WORLD = 2


def _worker(out: str, rank: int) -> None:
    """One gloo rank: the sharded step on a model axis of 2, weak scaling
    over 1 and 2 ranks, and the mesh of the first rank alone."""
    from graph_wavenet_tpu_torch import benchmarks as B
    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.initialize("gloo", rank, WORLD, f"file://{out}/rendezvous",
                         device=CPU, timeout_s=TIMEOUT)
    sharded = B.bench_sharded_train_step(
        B.SMALL_SMOKE, MeshConfig(model_axis=2), batch=4, seq=6, steps=2,
        warmup=1, device=CPU)
    weak = B.weak_scaling(B.SMALL_SMOKE, per_device_batch=2, seq=6,
                          steps=2, device=CPU)
    first = make_mesh(None, CPU, ranks=1)
    rec = {"sharded": sharded, "weak": {str(k): v for k, v in weak.items()},
           "first_mesh": None if first is None else first.world_size}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """The two ranks, started before the module's first test; the rank
    tests wait for them."""
    out = tmp_path_factory.mktemp("bench_w2")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(WORLD):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((rank, log, subprocess.Popen(
            [sys.executable, __file__, str(out), str(rank)], cwd=REPO,
            env=env, stdout=log, stderr=subprocess.STDOUT)))
    state = {}

    def results():
        if "recs" not in state:
            failed = []
            for rank, _, p in procs:
                try:
                    rc = p.wait(timeout=TIMEOUT)
                except subprocess.TimeoutExpired:
                    rc = "timeout"
                if rc != 0:
                    failed.append(f"rank {rank}: {rc}\n" + (
                        out / f"rank{rank}.log").read_text()[-3000:])
            assert not failed, "\n".join(failed)
            state["recs"] = [json.loads((out / f"rank{r}.json").read_text())
                             for r in range(WORLD)]
        return state["recs"]

    yield results
    for _, log, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one thread: its steps are small, and
    beside other test processes a bf16 step on every core waits on the
    busiest (the sparse rows took minutes so, seconds alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_mods():
    from graph_wavenet_tpu import benchmarks as jb
    from graph_wavenet_tpu.graphs import ordering as jo

    return jb, jo


# ---------------------------------------------------------------------------
# the graphTools orderings
# ---------------------------------------------------------------------------

def ordering_graph():
    """A seeded 40-node weighted graph: four dense communities, sparse
    links between them, row-normalized."""
    rng = np.random.default_rng(40)
    n, c = 40, 4
    comm = np.arange(n) % c
    p = np.where(comm[:, None] == comm[None, :], 0.6, 0.05)
    a = (rng.random((n, n)) < p) * rng.random((n, n))
    a = np.triu(a, 1)
    a = a + a.T
    return a / np.maximum(a.sum(1, keepdims=True), 1e-12)


ORDERINGS = {
    "spectral_clustering": lambda m, a: m.spectral_clustering(
        a, 4, np.random.default_rng(3)),
    "compute_source_nodes": lambda m, a: m.compute_source_nodes(
        a, 4, np.random.default_rng(5)),
    "perm_identity": lambda m, a: m.perm_identity(a),
    "perm_degree": lambda m, a: m.perm_degree(a),
    "perm_spectral_proxies": lambda m, a: m.perm_spectral_proxies(a, k=6),
    "perm_eds": lambda m, a: m.perm_eds(a),
}


@pytest.mark.parametrize("name", list(ORDERINGS))
def test_ordering_matches_jax_bit_for_bit(name, jax_mods):
    from graph_wavenet_tpu_torch.graphs import ordering as po

    a = ordering_graph()
    got = ORDERINGS[name](po, a)
    want = ORDERINGS[name](jax_mods[1], a)
    if isinstance(want, tuple):        # (S permuted, order)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert sorted(got[1]) == list(range(40))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if name == "compute_source_nodes":
        assert len(set(got)) == 4


# ---------------------------------------------------------------------------
# inputs, timing and bands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["metr-la-temporal", "metr-la-full"])
def test_random_inputs_match_jax(name, jax_mods):
    from graph_wavenet_tpu_torch import benchmarks as B

    jb = jax_mods[0]
    got = B._random_inputs(B.CONFIGS[name], 3, 12, seed=4)
    want = jb._random_inputs(jb.CONFIGS[name], 3, 12, seed=4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[2] is None) == (want[2] is None)
    for g, w in zip(got[2] or [], want[2] or []):
        np.testing.assert_array_equal(g, w)


def scripted_clock(seconds_per_step: list):
    """run_steps(n) returning a scripted per-step time times n, one entry
    per call, and the calls' n."""
    calls, script = [], iter(seconds_per_step)

    def run_steps(n):
        calls.append(n)
        return next(script) * n

    return run_steps, calls


@pytest.mark.parametrize("case", [
    ("degenerate", 1, 1, 1, [0.5]),
    ("positive", 2, 6, 1, [0.5, 0.25]),
    ("negative", 2, 6, 1, [0.5, 0.01]),
    ("repeats", 2, 6, 3, [0.4, 0.2, 0.5, 0.3, 0.6, 0.1, 0.3, 0.2]),
    ("repeats_degenerate", 3, 3, 3, [0.5, 0.4, 0.3, 0.2]),
], ids=lambda c: c[0])
def test_differential_timing_matches_jax(case, jax_mods):
    from graph_wavenet_tpu_torch import benchmarks as B

    _, n1, n2, repeats, script = case
    jb = jax_mods[0]
    got_fn, got_calls = scripted_clock(script)
    want_fn, want_calls = scripted_clock(script)
    got = B._repeat_differential(got_fn, n1, n2, repeats)
    want = jb._repeat_differential(want_fn, n1, n2, repeats)
    assert got == want
    assert got_calls == want_calls
    if repeats == 1:
        assert B._differential_time(scripted_clock(script)[0], n1, n2) == \
            jb._differential_time(scripted_clock(script)[0], n1, n2)


def test_band_trips_on_deliberate_regression():
    from graph_wavenet_tpu_torch.benchmarks import check_band

    row = {"step_ms": 10.0, "flops_per_step": 1e9}
    check_band(row, 10.5, 1e9)            # inside the band
    with pytest.raises(AssertionError, match="regressed"):
        check_band(row, 11.0, 1e9)        # the deliberate 10% slowdown
    with pytest.raises(AssertionError, match="FLOP count drifted"):
        check_band(row, 10.0, 1.05e9)     # compute-graph drift


def test_band_check_refuses_another_device():
    from graph_wavenet_tpu_torch import benchmarks as B

    with pytest.raises(SystemExit, match="'TPU v5 lite'.*'cpu'"):
        B.band_check(os.path.join(REPO, "fig", "perf_table.json"),
                     device=CPU)


def test_band_check_reads_the_port_record(tmp_path, capsys, monkeypatch):
    """A record taken on this device: every row (or those named in
    ``only``) re-measured and held to its band, a verdict a row, and
    ``SystemExit`` naming the rows that regressed."""
    from graph_wavenet_tpu_torch import benchmarks as B

    seen = []

    def remeasure(name, row, batch, steps, dtype, device):
        seen.append((name, batch, steps, dtype, str(device)))
        return {"step_ms": 5.0, "flops_per_step": 1e9}

    monkeypatch.setattr(B, "remeasure_row", remeasure)
    rec = {"device": "cpu", "batch": 2, "steps": 6, "dtype": "float32",
           "configs": {"metr-la-gcn": {"step_ms": 5.0,
                                       "flops_per_step": 1e9},
                       "metr-la-full": {"step_ms": 4.0,
                                        "flops_per_step": 1e9}}}
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(rec))
    with pytest.raises(SystemExit, match="regressed rows: metr-la-full$"):
        B.band_check(str(path), device=CPU)
    out = capsys.readouterr().out
    assert "band check OK: metr-la-gcn" in out
    assert "band check FAIL: metr-la-full" in out
    assert seen == [("metr-la-gcn", 2, 6, "float32", "cpu"),
                    ("metr-la-full", 2, 6, "float32", "cpu")]
    B.band_check(str(path), only=["metr-la-gcn"], device=CPU)
    assert len(seen) == 3


def test_remeasure_row_reruns_the_rows_benchmark(monkeypatch):
    """A dense row re-runs ``bench_train_step`` on its config in the
    record's dtype; the city row ``bench_sparse_train_step`` on its own
    geometry; both min of 3."""
    from graph_wavenet_tpu_torch import benchmarks as B

    calls = []
    monkeypatch.setattr(B, "bench_train_step",
                        lambda cfg, **kw: calls.append(("dense", cfg, kw)))
    monkeypatch.setattr(B, "bench_sparse_train_step",
                        lambda **kw: calls.append(("sparse", kw)))
    B.remeasure_row("pems-bay-full", {"step_ms": 1.0}, 64, 30, "bfloat16",
                    device=CPU)
    B.remeasure_row("city-40k-block-flat",
                    {"form": "block-flat", "graph": "spatial",
                     "ordering": "best"}, 64, 30, "bfloat16", device=CPU)
    assert calls[0] == ("dense", replace(B.CONFIGS["pems-bay-full"],
                                         dtype="bfloat16"),
                        dict(batch=64, steps=30, repeats=3, device=CPU))
    assert calls[1] == ("sparse", dict(steps=10, form="block-flat",
                                       graph="spatial", ordering="best",
                                       repeats=3, device=CPU))


# ---------------------------------------------------------------------------
# FLOP formulas
# ---------------------------------------------------------------------------

def small_supports():
    """The doubletransition pair of a 256-node k-NN graph under RCM in
    16x16 blocks, padded and flat, from both packages (the port's on the
    CPU): (port padded, port flat, JAX padded, JAX flat), first support."""
    from graph_wavenet_tpu.graphs import spatial as jspatial
    from graph_wavenet_tpu_torch.graphs import ordering, spatial

    n = 256
    pos = np.random.default_rng(0).random((n, 2))
    src, dst, w = spatial.knn_graph_edges(pos, 6)
    perm = ordering.rcm_order_edges(src, dst, n)
    out = []
    for build, kw in ((spatial.doubletransition_block_supports,
                       dict(device=CPU)),
                      (jspatial.doubletransition_block_supports, {})):
        for form in ("block", "flat"):
            out.append(build(src, dst, w, n, perm=perm, form=form,
                             block_size=16, **kw)[0])
    return out


def counted(fn) -> dict:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as m:
        fn()
    return {str(k): v for k, v in m.get_flop_counts()["Global"].items()}


@pytest.mark.parametrize("op", ["mix_flat", "mix_flat2", "outer_flat",
                                "mix_padded", "outer_padded"])
def test_flop_formula_matches_cost_estimate(op):
    """Each op's count equals the JAX kernel's CostEstimate flops
    (``ops/pallas/block_diffusion.py``: ``2 n_live bs_a bs_b rp`` :227,
    ``4 n_live bs bs rp`` :620, ``2 n_live bs_x bs_g rp`` :296, ``2 nb mb
    bs bs rp`` :119 and :359) over JAX's own tables' shapes, with rp the
    unpadded R."""
    ops = torch.ops.gwt_torch
    padded, flat, jpadded, jflat = small_supports()
    r = 24
    gen = torch.Generator().manual_seed(0)
    nb, mb = (int(d) for d in jpadded.block_idx.shape)
    bs = int(jflat.blocks_flat.shape[1])
    n_live = int(jflat.slot_tbl.shape[0])
    assert tuple(padded.block_idx.shape) == (nb, mb)
    assert flat.slot_tbl.numel() == n_live
    assert flat.src_tbl.numel() == int(jflat.src_tbl.shape[0])
    x = torch.randn((flat.nb, bs, r), generator=gen)
    calls = {
        "mix_flat": (lambda: ops.mix_flat(
            flat.blocks_flat, flat.slot_tbl, x, flat.src_tbl, flat.row_tbl,
            None, flat.nb, True), 2 * n_live * bs * bs * r),
        "mix_flat2": (lambda: ops.mix_flat2(
            flat.blocks_flat, flat.slot_tbl, x, flat.src_tbl, flat.row_tbl,
            None, None, flat.nb, 0, True), 4 * n_live * bs * bs * r),
        "outer_flat": (lambda: ops.outer_flat(
            x, x, flat.src_tbl, flat.row_tbl, None, None, None),
            2 * int(jflat.src_tbl.shape[0]) * bs * bs * r),
        "mix_padded": (lambda: ops.mix_padded(
            padded.blocks.reshape(nb * mb, bs, bs), padded.slot, x,
            padded.block_idx, True), 2 * nb * mb * bs * bs * r),
        "outer_padded": (lambda: ops.outer_padded(
            x, x, padded.block_idx, torch.float32),
            2 * nb * mb * bs * bs * r),
    }
    fn, want = calls[op]
    assert counted(fn) == {f"gwt_torch.{op}": want}


class _StubHops:
    """A support whose hops copy x: the step's products without the
    diffusion kernels, at the same shapes."""

    def __init__(self, sp):
        self.n_nodes = sp.n_nodes
        if hasattr(sp, "mix2_2d"):
            self.mix2_2d = lambda x2: (x2.clone(), x2.clone())

    def mix_2d(self, x2):
        return x2.clone()


def test_sparse_step_counts_each_hop_once():
    """A 512-node block-flat train step (spatial graph, RCM, bf16): the
    count is the stubbed step's (the dense products) plus, for every op
    the real step dispatches, its formula over the call's shapes; no
    product inside an op's plain version is counted again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from graph_wavenet_tpu_torch import benchmarks as B

    n, batch, seq = 512, 2, 12
    sup = B.sparse_supports(n, "block-flat", graph="spatial",
                            ordering="rcm", device=CPU)
    assert any(hasattr(s, "mix2_2d") for s in sup)
    cfg = replace(B.FLAGSHIP, num_nodes=n, out_dim=seq, dtype="bfloat16",
                  addaptadj=False)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, seq, n, 2)).astype(np.float32)
    y = rng.normal(size=(batch, seq, n, 2)).astype(np.float32) + 50.0

    formulas = []

    class Calls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if func.namespace == "gwt_torch":
                blocks, slot, xs = args[:3]
                r = xs.shape[2]
                if name == "mix_flat":
                    formulas.append(2 * slot.numel() * blocks.shape[1]
                                    * blocks.shape[2] * r)
                elif name == "mix_flat2":
                    formulas.append(4 * slot.numel() * blocks.shape[1]
                                    * blocks.shape[2] * r)
                else:
                    raise AssertionError(f"unexpected op {name}")
            return func(*args, **(kwargs or {}))

    def step(supports):
        eng = B._engine(cfg, torch.device(CPU))
        return B._count_step(eng.train_step, x, y, supports)[1]

    with Calls():
        total = step(sup)
    dense = step([_StubHops(s) for s in sup])
    assert formulas and all(f > 0 for f in formulas)
    assert total == dense + sum(formulas)


@pytest.mark.parametrize("name", ["metr-la-temporal", "metr-la-gcn",
                                  "metr-la-full"])
def test_dense_count_against_xla(name, jax_mods):
    """The port's count of one eager step at batch 4 against JAX
    ``_compile_step``'s XLA count of the compiled step: XLA counts
    elementwise work too, so the port reads a little less (0.944, 0.974
    and 0.982 of it)."""
    import jax.numpy as jnp

    from graph_wavenet_tpu.config import TrainConfig
    from graph_wavenet_tpu.data.scaler import StandardScaler
    from graph_wavenet_tpu.train.engine import Engine
    from graph_wavenet_tpu_torch import benchmarks as B

    jb = jax_mods[0]
    cfg = jb.CONFIGS[name]
    eng = Engine(cfg, TrainConfig(), StandardScaler(54.0, 20.0))
    x, y, sup = jb._random_inputs(cfg, 4, 12)
    sup = None if sup is None else [jnp.asarray(s) for s in sup]
    _, xla = jb._compile_step(eng.train_step, eng, eng.state,
                              jnp.asarray(x), jnp.asarray(y), sup)
    got = B.train_step_flops(B.CONFIGS[name], batch=4, device=CPU)
    assert 0.90 <= got / xla <= 1.00, (got, xla)


# ---------------------------------------------------------------------------
# rows on the CPU
# ---------------------------------------------------------------------------

RATE_KEYS = {"step_ms", "flops_per_step", "eff_tflops", "peak_tflops_bf16",
             "mfu"}


@pytest.fixture(scope="module")
def jax_rows(jax_mods):
    """JAX's rows of the small smoke configuration on the CPU."""
    jb = jax_mods[0]
    return {
        "train": jb.bench_train_step(jb.SMALL_SMOKE, batch=4, seq=6,
                                     steps=3, warmup=1),
        "inference": jb.bench_inference(jb.SMALL_SMOKE, seq=6, batches=(2,),
                                        steps=3, horizon_steps=2),
        "sparse": jb.bench_sparse_train_step(n_nodes=256, batch=2, seq=6,
                                             steps=1, form="block"),
    }


def assert_cpu_rates(row: dict) -> None:
    assert row["mfu"] is None and row["peak_tflops_bf16"] is None
    assert row["flops_per_step"] > 0 and row["step_ms"] > 0


def test_train_row_keys_match_jax(jax_rows):
    from graph_wavenet_tpu_torch import benchmarks as B

    r = B.bench_train_step(B.SMALL_SMOKE, batch=4, seq=6, steps=3,
                           warmup=1, device=CPU)
    assert set(r) == set(jax_rows["train"]) >= RATE_KEYS
    assert_cpu_rates(r)
    assert r["flops_per_step"] == B.train_step_flops(B.SMALL_SMOKE, 4, 6,
                                                     device=CPU)


def test_inference_row_keys_match_jax(jax_rows):
    from graph_wavenet_tpu_torch import benchmarks as B

    r = B.bench_inference(B.SMALL_SMOKE, seq=6, batches=(2,), steps=3,
                          horizon_steps=2, device=CPU)
    want = jax_rows["inference"]
    assert set(r) == set(want)
    for k in r:
        assert set(r[k]) == set(want[k]), k
    assert r["autoregressive"]["batch"] == want["autoregressive"]["batch"]


@pytest.mark.parametrize("form", ["block", "block-flat", "ell"])
def test_sparse_row_keys_match_jax(form, jax_rows):
    from graph_wavenet_tpu_torch import benchmarks as B

    r = B.bench_sparse_train_step(n_nodes=256, batch=2, seq=6, steps=2,
                                  form=form, device=CPU)
    assert set(r) == set(jax_rows["sparse"])
    assert (r["form"], r["graph"], r["ordering"]) == (form, "random",
                                                      "identity")
    assert_cpu_rates(r)
    # two random 2-block-row supports, every slot live
    assert r["n_blocks"] == (None if form == "ell" else 8)
    if form != "ell":
        assert r["n_blocks"] == jax_rows["sparse"]["n_blocks"]


def test_run_all_record_on_the_cpu():
    from graph_wavenet_tpu_torch import benchmarks as B

    rec = B.run_all(batch=1, steps=1, dtype="float32", device=CPU)
    assert list(rec["configs"]) == ["metr-la-temporal", "metr-la-gcn",
                                    "metr-la-full", "pems-bay-full"]
    assert (rec["device"], rec["backend"], rec["power_limit_w"]) == (
        "cpu", "cpu", None)
    assert rec["torch"] == torch.__version__
    for row in rec["configs"].values():
        assert_cpu_rates(row)


@pytest.mark.parametrize("call", [
    "bench_train_step", "bench_inference", "bench_sparse_train_step",
    "weak_scaling", "run_all"])
def test_cuda_without_a_card_raises(call):
    from graph_wavenet_tpu_torch import benchmarks as B

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = {"bench_train_step": (B.SMALL_SMOKE,),
            "bench_inference": (B.SMALL_SMOKE,)}.get(call, ())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(B, call)(*args, device="cuda")


def test_peak_table_is_the_cards():
    from graph_wavenet_tpu_torch import benchmarks as B

    assert B.PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.0}
    assert B._peak_tflops(torch.device(CPU)) is None


# ---------------------------------------------------------------------------
# the rank harnesses (two gloo processes)
# ---------------------------------------------------------------------------

def test_sharded_step_on_two_ranks(group):
    recs = group()
    for rec in recs:
        r = rec["sharded"]
        assert r["devices"] == 2
        assert set(r) == {"devices", "steps_per_s",
                          "node_timesteps_per_s"} | RATE_KEYS
        assert_cpu_rates(r)
    # node-TP halves the dense supports' products: each rank counts its own
    assert recs[0]["sharded"]["flops_per_step"] == \
        recs[1]["sharded"]["flops_per_step"]


def test_weak_scaling_on_two_ranks(group):
    recs = group()
    for rec in recs:
        w = rec["weak"]
        assert sorted(w) == ["1", "2"]
        assert w["1"]["efficiency"] == 1.0
        assert w["2"]["node_timesteps_per_s"] > 0
    assert recs[0]["weak"] == recs[1]["weak"]
    # the first rank's mesh alone: rank 1 is outside it
    assert [rec["first_mesh"] for rec in recs] == [1, None]


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
