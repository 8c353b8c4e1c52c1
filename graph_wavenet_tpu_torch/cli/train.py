"""Training CLI: the METR-format dense path, city-scale graphs, and the
synthetic and CRASH two-modality tasks.

Counterpart of ``graph_wavenet_tpu/cli/train.py``:

- **METR** (``--data DIR --adjdata adj_mx.pkl``): the ``--adjtype``
  supports of a DCRNN-format adjacency pickle, dense, the adaptive
  embeddings SVD-initialized from the first support unless
  ``--randomadj``; ``--aptonly`` drops the fixed supports and keeps the
  adaptive adjacency.
- **City** (``--graph_npz g.npz``): ordered block-sparse doubletransition
  supports (flat, or padded under ``--sparse block|pallas``) from an
  edge-list graph, the data's node axis permuted and padded to match, the
  block-masked adaptive adjacency under ``--addaptadj`` (alone under
  ``--aptonly``), and the node layout, with the supports' storage dtype,
  recorded in every checkpoint sidecar, so the serve and test CLIs rebuild
  the same supports.
- **Synthetic** (``--data syn``): the SBM diffusion task
  (``data.synthetic``), one graph per subject for the per-sample-graph
  model (diff-G: dilations from 4, per-sample supports, ``--fresh_nodevec``
  for the reference's random embeddings; ``--plot`` draws the test
  reconstruction where matplotlib is installed), or one shared graph under
  ``--same_g``.
- **CRASH** (``--data crash``): the fMRI/EEG pipeline (``data.crash``) on
  the synthetic stand-in records, or on records under ``--crash_dir``
  (``--crash_format mat``: the reference's export tree, ``data.crash_raw``;
  ``npz``: ``<subject>/<session>.npz``), with the diff-G model.

Then the runner fits and tests.

    python -m graph_wavenet_tpu_torch.cli.train --data data/METR-LA \\
        --adjdata data/sensor_graph/adj_mx.pkl --num_nodes 207 --gcn_bool \\
        --addaptadj --seq_length 12 --save ckpt/
    python -m graph_wavenet_tpu_torch.cli.train --graph_npz city.npz \\
        --data data/CITY --gcn_bool --addaptadj --dtype bfloat16 \\
        --batch_size 4 --seq_length 12 --epochs 1 --save ckpt/
    python -m graph_wavenet_tpu_torch.cli.train --data syn --gcn_bool \\
        --addaptadj --seq_length 48 --scan_steps 8 --save ckpt/

Every branch keeps the dataset on the device by default (``--resident
device``; ``host`` copies every batch from the host), and takes the
runner's ``--scan_steps`` (optimizer steps per fused call: a CUDA graph
replayed per step on the card), ``--grad_accum``, ``--early_stop``,
``--epoch_timeout`` and ``--resume`` (the shared-graph synthetic task runs
a step per batch); ``--profile DIR`` traces the whole run with
``torch.profiler`` (``train.profiling.trace``).

Parallel training (``parallel``), one process per rank under torchrun::

    torchrun --nproc_per_node W -m graph_wavenet_tpu_torch.cli.train \
        --graph_npz city.npz --data data/CITY --gcn_bool --addaptadj \
        --sparse flat --mesh_model S [--mesh_dp]

``--mesh_model S`` splits the nodes over S ranks (node-TP: the rank's rows
of the dense supports and of the adaptive adjacency on the METR path and
with ``--data syn|crash``, ``parallel.dense_tp``, any node count; the
shards of the flat supports and the mask on the city path with ``--sparse
flat``, whose block-rows S must divide); ``--mesh_time S_t`` splits the
time axis over S_t ranks (time-halo sequence parallelism,
``parallel.halo``); the data axis takes the other W / (S x S_t) ranks, and
``--mesh_dp`` alone is data parallelism over all W. The axes compose on
every path (data x model x time).
``--dist_backend``: nccl (a card per rank, the default on ``cuda``) or gloo
(the default on ``cpu``; ranks may share a card, their collectives staged
through host memory). ``--scan_steps S`` runs under a mesh too: on the card
each fused step is a CUDA graph with its collectives captured, which needs
NCCL, so gloo with a card and more than one rank refuses ``--scan_steps >
1``. Only rank 0 prints and writes checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
import warnings

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-train", description="Train Graph WaveNet on a METR-format "
        "dataset, a city-scale graph (--graph_npz), or the synthetic and "
        "CRASH tasks (--data syn|crash) with the port")
    p.add_argument("--data", type=str, default="data/METR-LA",
                   help="directory of train/val/test.npz window splits, or "
                        "syn / crash")
    p.add_argument("--adjdata", type=str,
                   default="data/sensor_graph/adj_mx.pkl",
                   help="METR: DCRNN-format adjacency pickle")
    p.add_argument("--adjtype", type=str, default="doubletransition",
                   help="METR: support normalization (graphs.normalize."
                        "mod_adj)")
    p.add_argument("--graph_npz", type=str, default=None,
                   help="edge-list graph (.npz with src, dst, weight[, pos, "
                        "n_nodes]); builds the ordered block-sparse "
                        "supports and records the node layout")
    p.add_argument("--ordering", type=str, default="best",
                   choices=("best", "rcm", "hilbert", "identity"))
    p.add_argument("--sparse", type=str, default="auto",
                   choices=("auto", "flat", "block", "pallas"),
                   help="support form: flat live-block kernels (auto) or "
                        "blocks padded per block-row (block, pallas: both "
                        "run the padded kernels)")
    p.add_argument("--block_size", type=int, default=128,
                   help="node block size (the CUDA kernels need 128)")
    p.add_argument("--support_dtype", type=str, default="auto",
                   choices=("auto", "float32", "bfloat16"),
                   help="storage dtype of the fixed supports' blocks (auto "
                        "= follow --dtype); bfloat16 under --dtype float32 "
                        "rounds the supports and warns")
    p.add_argument("--adaptive_hops", type=int, default=1,
                   help="with --addaptadj: widen the learned adjacency's "
                        "mask to the k-hop block closure of the supports' "
                        "pattern")
    p.add_argument("--gcn_bool", action="store_true")
    p.add_argument("--aptonly", action="store_true",
                   help="no fixed supports: the adaptive adjacency alone")
    p.add_argument("--addaptadj", action="store_true")
    p.add_argument("--randomadj", action="store_true",
                   help="METR: random adaptive embeddings instead of the "
                        "SVD of the first support")
    p.add_argument("--seq_length", type=int, default=48)
    p.add_argument("--nhid", type=int, default=32)
    p.add_argument("--in_dim", type=int, default=2)
    p.add_argument("--num_nodes", type=int, default=80,
                   help="METR: sensors in the dataset (207 for METR-LA)")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--lr_decay", type=float, default=1.0)
    p.add_argument("--lr_decay_every", type=int, default=10)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--print_every", type=int, default=50)
    p.add_argument("--save", type=str, default="./garage")
    p.add_argument("--expid", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="activation dtype (parameters and accumulation stay "
                        "fp32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda)")
    p.add_argument("--resident", type=str, default="device",
                   choices=("device", "host"),
                   help="dataset residency: device = on --device with the "
                        "batches gathered there (default), host = numpy "
                        "batches copied per step")
    p.add_argument("--scan_steps", type=int, default=1,
                   help="fused multi-step training: optimizer steps per "
                        "call (--resident device only; a CUDA graph "
                        "replayed per step on the card)")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="micro-batches per optimizer step (averaged "
                        "gradients; not with --scan_steps > 1)")
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop after this many epochs without a validation "
                        "improvement; 0 trains every epoch")
    p.add_argument("--epoch_timeout", type=float, default=0.0,
                   help="abort with save_dir/emergency.json if an epoch "
                        "exceeds this many seconds; 0 disables")
    p.add_argument("--profile", type=str, default=None,
                   help="write a torch.profiler trace of the whole run "
                        "(host and CUDA activity) to DIR/trace.json "
                        "(Perfetto / chrome://tracing); under a mesh rank "
                        "r > 0 writes DIR/rank<r>/trace.json")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume training from (full train "
                        "state); the run continues at its epoch + 1")
    par = p.add_argument_group("parallel training under torchrun")
    par.add_argument("--mesh_dp", action="store_true",
                     help="data parallelism over every rank (with "
                          "--mesh_model: over the ranks it leaves)")
    par.add_argument("--mesh_model", type=int, default=1,
                     help="node-TP: ranks that split the nodes (dense "
                          "supports, or the city path's --sparse flat)")
    par.add_argument("--mesh_time", type=int, default=1,
                     help="time-halo sequence parallelism: ranks that split "
                          "the time axis")
    par.add_argument("--dist_backend", type=str, default=None,
                     choices=("nccl", "gloo"),
                     help="process-group backend (default nccl on cuda, "
                          "gloo on cpu); gloo lets ranks share a card")
    syn = p.add_argument_group("synthetic and CRASH tasks (--data syn|crash)")
    syn.add_argument("--same_g", action="store_true",
                     help="syn: one shared graph instead of one per subject")
    syn.add_argument("--n_train", type=int, default=80,
                     help="syn: training subjects")
    syn.add_argument("--n_valid", type=int, default=20)
    syn.add_argument("--n_test", type=int, default=4)
    syn.add_argument("--num_timestep", type=int, default=1000,
                     help="syn: steps rolled out per subject")
    syn.add_argument("--fresh_nodevec", action="store_true",
                     help="diff-G: the reference's quirk of fresh random "
                          "adaptive embeddings every forward")
    syn.add_argument("--plot", type=str, default=None,
                     help="diff-G syn: write the test reconstruction (real "
                          "and predicted F/E of one node) to this image "
                          "(needs matplotlib; skipped with a line without)")
    syn.add_argument("--crash_dir", type=str, default=None,
                     help="CRASH records: the reference's export tree "
                          "(--crash_format mat) or <subject>/<session>.npz "
                          "files (npz); omit for the synthetic stand-ins")
    syn.add_argument("--crash_format", type=str, default="mat",
                     choices=("mat", "npz"))
    syn.add_argument("--crash_num_region", type=int, default=200,
                     help="CRASH mat: Schaefer parcel count (200 or 400)")
    syn.add_argument("--crash_K", type=int, default=None,
                     help="CRASH window length (default: ceil(F_t)*5 for "
                          "mat records, int(F_t*5) otherwise)")
    syn.add_argument("--fmri_time_res", type=float, default=None,
                     help="CRASH: seconds per fMRI frame (default 0.910 for "
                          "mat records, else 2.0)")
    syn.add_argument("--eeg_time_res", type=float, default=None,
                     help="CRASH: seconds per EEG sample (default 1/640 for "
                          "mat records, else 0.5)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    mesh, started = _mesh(args)
    t0 = time.time()
    try:
        with contextlib.ExitStack() as quiet:
            if mesh is not None and mesh.rank:      # only rank 0 prints
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            if args.profile:
                from graph_wavenet_tpu_torch.train.profiling import trace

                quiet.enter_context(trace(
                    args.profile if mesh is None or mesh.rank == 0
                    else os.path.join(args.profile, f"rank{mesh.rank}")))
            if args.data == "syn":
                result, runner, supports = _run_syn(args, mesh)
            elif args.data == "crash":
                result, runner, supports = _run_crash(args, mesh)
            elif args.graph_npz:
                result, runner, supports = _run_city(args, mesh)
            else:
                result, runner, supports = _run_metr(args, mesh)
            print(f"Total time spent: {time.time() - t0:.4f}", flush=True)
        if args.profile and (mesh is None or mesh.rank == 0):
            print(f"profiler trace written to {args.profile}", flush=True)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    return {"result": result, "runner": runner, "supports": supports}


def _mesh(args):
    """(the rank's mesh or None, whether this call started the process
    group) for ``--mesh_dp`` / ``--mesh_model`` / ``--mesh_time``;
    ``args.device`` becomes the rank's device."""
    if not (args.mesh_dp or args.mesh_model > 1 or args.mesh_time > 1):
        return None, False
    import torch.distributed as dist

    from graph_wavenet_tpu_torch.config import MeshConfig
    from graph_wavenet_tpu_torch.parallel import multihost
    from graph_wavenet_tpu_torch.parallel.mesh import make_mesh

    started = not dist.is_initialized()
    multihost.initialize(backend=args.dist_backend, device=args.device)
    started = started and dist.is_initialized()
    args.device = str(multihost.rank_device(args.device))
    if (args.scan_steps > 1 and args.device.startswith("cuda")
            and dist.get_backend() == "gloo" and dist.get_world_size() > 1):
        if started:
            dist.destroy_process_group()
        raise SystemExit(
            "--scan_steps > 1 on the card captures each step's collectives "
            "in a CUDA graph, which a gloo group of more than one rank "
            "cannot (it stages CUDA tensors through host memory): use "
            "--dist_backend nccl (a card per rank) or --scan_steps 1")
    mesh = make_mesh(MeshConfig(model_axis=args.mesh_model,
                                time_axis=args.mesh_time),
                     device=args.device)
    if mesh.rank == 0:
        print(f"mesh: {mesh.shape} over {mesh.world_size} rank(s), "
              f"backend {dist.get_backend() if started else 'none'}",
              flush=True)
    return mesh, started


def model_config(args, num_nodes: int, diff_g: bool = False):
    """The model of the flags; ``diff_g``: the per-sample-graph variant
    (dilations from 4, ``--fresh_nodevec``)."""
    from graph_wavenet_tpu_torch.config import ModelConfig

    return ModelConfig(
        num_nodes=num_nodes, in_dim=args.in_dim, out_dim=args.seq_length,
        residual_channels=args.nhid, dilation_channels=args.nhid,
        skip_channels=args.nhid * 8, end_channels=args.nhid * 16,
        blocks=args.blocks, layers=args.layers, dropout=args.dropout,
        gcn_bool=args.gcn_bool, addaptadj=args.addaptadj,
        n_supports=0 if args.aptonly else 2,
        start_dilation=4 if diff_g else 1,
        fresh_nodevec=args.fresh_nodevec and diff_g, dtype=args.dtype)


def train_config(args):
    from graph_wavenet_tpu_torch.config import TrainConfig

    return TrainConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, epochs=args.epochs,
        print_every=args.print_every, seed=args.seed, save_dir=args.save,
        expid=args.expid, lr_decay=args.lr_decay,
        lr_decay_every=args.lr_decay_every, scan_steps=args.scan_steps,
        grad_accum=args.grad_accum, early_stop_patience=args.early_stop,
        epoch_timeout_s=args.epoch_timeout)


def _check_horizon(args, data: dict) -> None:
    horizon = int(data["y_train"].shape[1])
    if args.seq_length != horizon:
        raise SystemExit(
            f"--seq_length {args.seq_length} does not match the dataset's "
            f"target horizon {horizon} ({args.data} was built with "
            f"seq_length_y={horizon}); pass --seq_length {horizon}")


def _fit(args, cfg, data, supports, aptinit=None, extra_meta=None,
         mesh=None):
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    train_cfg = train_config(args)
    engine = Engine(cfg, train_cfg, data["scaler"], device=args.device,
                    seed=args.seed,
                    steps_per_epoch=data["train_loader"].num_batch,
                    aptinit=aptinit, mesh=mesh)
    runner = Runner(engine, train_cfg, extra_meta=extra_meta, mesh=mesh)
    result = runner.fit(data, supports, resume_from=args.resume)
    runner.test(data, supports, result)
    return result, runner, supports


def _run_metr(args, mesh=None):
    """The METR branch: dense supports from the adjacency pickle, whole on
    every rank (under ``--mesh_model`` > 1 the model takes its rows,
    ``parallel.dense_tp``, and the rank loads its node range of the
    data)."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch import resolve_device
    from graph_wavenet_tpu_torch.data.metr import load_dataset
    from graph_wavenet_tpu_torch.graphs.normalize import load_adj

    device = resolve_device(args.device)
    _, _, adj = load_adj(args.adjdata, args.adjtype)
    cfg = model_config(args, args.num_nodes)
    tp = mesh is not None and mesh.model > 1
    data = load_dataset(args.data, args.batch_size, seed=args.seed,
                        resident=args.resident, device=device,
                        nodes=mesh.node_range(cfg.num_nodes) if tp else None)
    _check_horizon(args, data)
    if data["num_nodes"] != cfg.num_nodes or adj[0].shape[0] != cfg.num_nodes:
        raise SystemExit(
            f"--num_nodes {args.num_nodes}, but the data has "
            f"{data['num_nodes']} nodes and {args.adjdata} "
            f"{adj[0].shape[0]}")
    aptinit = (np.asarray(adj[0]) if cfg.gcn_bool and cfg.addaptadj
               and not args.randomadj else None)
    # [] (not None) under aptonly: the adaptive adjacency stays on with no
    # fixed supports, as the test CLI evaluates it
    supports = ([] if args.aptonly else
                [torch.as_tensor(a, device=device) for a in adj])
    _print_dense_tp(mesh, cfg.num_nodes)
    return _fit(args, cfg, data, supports, aptinit=aptinit, mesh=mesh)


def _print_dense_tp(mesh, n: int) -> None:
    """The dense paths' node-TP line (none without a model axis)."""
    if mesh is not None and mesh.model > 1:
        print(f"node-TP over {mesh.model} ranks, exchange: reduce-scatter "
              f"(dense rows, {n} nodes as {mesh.node_counts(n)})",
              flush=True)


def _run_city(args, mesh=None):
    """The --graph_npz branch: ordered block-sparse supports; under
    ``--mesh_model`` > 1 the rank's shards of the flat supports and of the
    mask (only the mask under ``--aptonly``) and its node range of the
    data."""
    import torch

    from graph_wavenet_tpu_torch.data.metr import load_dataset
    from graph_wavenet_tpu_torch.graphs import city

    if not args.gcn_bool:
        raise SystemExit("--graph_npz builds graph supports; pass "
                         "--gcn_bool")
    g = city.load_graph_npz(args.graph_npz)
    supports, mask, layout = city.build_city_supports(
        g["src"], g["dst"], g["weight"], g["n_nodes"], pos=g["pos"],
        ordering=args.ordering, form=args.sparse,
        block_size=args.block_size, addaptadj=args.addaptadj,
        adaptive_hops=args.adaptive_hops, device=args.device)
    sup_dtype = (args.dtype if args.support_dtype == "auto"
                 else args.support_dtype)
    if sup_dtype == "bfloat16" and args.dtype == "float32":
        warnings.warn("--support_dtype bfloat16 under --dtype float32 "
                      "rounds the supports' weights to bf16: the model no "
                      "longer computes in fp32", stacklevel=2)
    if sup_dtype != "float32":
        supports = [s.astype(getattr(torch, sup_dtype)) for s in supports]
    # the serve and test CLIs rebuild the supports in this dtype
    layout["support_dtype"] = sup_dtype
    print(f"graph: {g['n_nodes']} nodes (+{layout['n_pad'] - g['n_nodes']}"
          f" pad), ordering={layout['ordering']}, form={layout['form']}, "
          f"{layout['n_blocks']} live blocks "
          f"({layout['blocks_per_row_mean']:.1f} mean / "
          f"{layout['blocks_per_row_max']} max per row), fused2="
          f"{layout['fused2']}" + (f", adaptive mask {mask.n_live} blocks"
                                   if mask is not None else ""), flush=True)

    tp = mesh is not None and mesh.model > 1
    fixed = [] if args.aptonly else list(supports)
    if tp:
        from graph_wavenet_tpu_torch.ops.block_sparse import (
            FlatBlockSparseSupport,
        )
        from graph_wavenet_tpu_torch.parallel.sparse_tp import (
            shard_adaptive_mask,
            shard_flat_support,
        )

        if not all(isinstance(s, FlatBlockSparseSupport) for s in supports):
            raise SystemExit(
                "--mesh_model > 1 with --graph_npz needs --sparse flat "
                "(node-TP shards the flat live-block form)")
        nb = layout["n_pad"] // args.block_size
        if nb % mesh.model:
            raise SystemExit(
                f"--mesh_model {mesh.model} does not divide the graph's "
                f"{nb} block-rows ({layout['n_pad']} nodes in blocks of "
                f"{args.block_size})")
        fixed = [shard_flat_support(s, mesh) for s in fixed]
        if mask is not None:
            mask = shard_adaptive_mask(mask, mesh)
        forms = sorted({"halo" if s.halo else "all_gather"
                        for s in fixed + ([mask] if mask else [])})
        print(f"node-TP over {mesh.model} ranks, exchange: "
              f"{', '.join(forms)}", flush=True)

    data = load_dataset(args.data, args.batch_size, seed=args.seed,
                        node_layout=layout, resident=args.resident,
                        device=args.device,
                        nodes=mesh.node_range(layout["n_pad"]) if tp
                        else None)
    _check_horizon(args, data)
    cfg = model_config(args, layout["n_pad"])
    sup_list = fixed + ([mask] if args.addaptadj else [])
    return _fit(args, cfg, data, sup_list,
                extra_meta={"graph_layout": layout}, mesh=mesh)


def _syn_runner(args, cfg, data, diff_g: bool, mesh=None):
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    train_cfg = train_config(args)
    engine = Engine(cfg, train_cfg, data["scaler"], device=args.device,
                    seed=args.seed, diff_g=diff_g,
                    steps_per_epoch=data["train_loader"].num_batch,
                    mesh=mesh)
    return Runner(engine, train_cfg, mesh=mesh)


def _run_syn(args, mesh=None):
    """The --data syn branch: per-subject graphs (diff-G) or one shared
    graph (--same_g); under a mesh every rank loads the same data and the
    engine takes its rows and node range."""
    from graph_wavenet_tpu_torch.config import DataConfig
    from graph_wavenet_tpu_torch.data.synthetic import (
        load_dataset_syn,
        stack_support_splits,
    )

    data_cfg = DataConfig(
        adjtype=args.adjtype, num_nodes=args.num_nodes,
        seq_length=args.seq_length, same_g=args.same_g,
        n_train=args.n_train, n_valid=args.n_valid, n_test=args.n_test,
        num_timestep=args.num_timestep)
    data, adjs, F_t, G = load_dataset_syn(
        data_cfg, args.batch_size, seed=args.seed, resident=args.resident,
        device=args.device)
    n_comm = data_cfg.n_communities
    _print_dense_tp(mesh, args.num_nodes)
    if args.same_g:
        runner = _syn_runner(args, model_config(args, args.num_nodes),
                             data, diff_g=False, mesh=mesh)
        supports = [] if args.aptonly else adjs
        result = runner.fit_syn_shared(data, supports, G, F_t, n_comm,
                                       resume_from=args.resume)
        runner.test_syn_shared(data, supports, G, F_t, n_comm, result)
        return result, runner, supports
    runner = _syn_runner(args, model_config(args, args.num_nodes, True),
                         data, diff_g=True, mesh=mesh)
    supports = stack_support_splits(adjs, data_cfg.n_train, data_cfg.n_test)
    if args.aptonly:
        supports = {k: [] for k in supports}
    result = runner.fit_syn(data, supports, G, F_t, n_comm,
                            resume_from=args.resume)
    runner.test_syn(data, supports, G, F_t, n_comm, result)
    if args.plot:
        plot_diffg_reconstruction(result, args.plot)
    return result, runner, supports


def _run_crash(args, mesh=None):
    """The --data crash branch: stand-in records, or records read from
    --crash_dir, with the diff-G model (under ``--mesh_dp`` as in
    :func:`_run_syn`)."""
    import dataclasses

    import numpy as np

    from graph_wavenet_tpu_torch.data.crash import (
        load_dataset_crash,
        load_records_from_dir,
    )

    records = assignment = None
    raw_mat = args.crash_dir is not None and args.crash_format == "mat"
    if args.crash_dir is not None:
        if raw_mat:
            from graph_wavenet_tpu_torch.data import crash_raw

            records = crash_raw.collect_records(
                args.crash_dir, num_region=args.crash_num_region)
            # the export tree's own electrode-region geometry where its
            # coordinate files are present; the ring layout is a stand-in
            try:
                e2r = crash_raw.get_region_assignment(
                    args.crash_dir, args.crash_num_region)
                assignment = crash_raw.invert_assignment(
                    e2r, args.crash_num_region)
                print("CRASH: using electrode-region assignment from "
                      "coordinate files", flush=True)
            except OSError:
                print("CRASH: coordinate files missing under "
                      f"{args.crash_dir} (sc/Parcellations/MNI, "
                      "utils/eeg_coor_conv/ny_x_z); falling back to the "
                      "synthetic ring-layout assignment", flush=True)
        else:
            records = load_records_from_dir(args.crash_dir)
        if not records:
            raise SystemExit(f"no complete CRASH records under "
                             f"{args.crash_dir} (format={args.crash_format})")
    # the real rates (0.910 s BOLD bins, 640 Hz EEG) for an export tree;
    # the stand-ins keep small ones
    fmri_res = (args.fmri_time_res if args.fmri_time_res is not None
                else (0.910 if raw_mat else 2.0))
    eeg_res = (args.eeg_time_res if args.eeg_time_res is not None
               else (1.0 / 640.0 if raw_mat else 0.5))
    K = args.crash_K
    if K is None and raw_mat:
        # a multiple of the integer F-pool factor, so pooling keeps it
        K = int(np.ceil(fmri_res / eeg_res)) * 5
    data, supports, F_t, G = load_dataset_crash(
        batch_size=args.batch_size, records=records, adjtype=args.adjtype,
        fmri_time_res=fmri_res, eeg_time_res=eeg_res, K=K, seed=args.seed,
        assignment=assignment, resident=args.resident, device=args.device)
    cfg = dataclasses.replace(
        model_config(args, int(data["x_train"].shape[2]), True),
        out_dim=data["K"])
    if args.aptonly:
        supports = {k: [] for k in supports}
    _print_dense_tp(mesh, cfg.num_nodes)
    runner = _syn_runner(args, cfg, data, diff_g=True, mesh=mesh)
    result = runner.fit_syn(data, supports, G, F_t, data["n_communities"],
                            resume_from=args.resume)
    runner.test_syn(data, supports, G, F_t, data["n_communities"], result)
    return result, runner, supports


def plot_diffg_reconstruction(result, out_path: str, node: int = 0):
    """Reverse the stride-1 test windows and plot the real and predicted
    F/E sequences of one node (matplotlib where installed; else a printed
    line). Returns the four reconstructed sequences."""
    import numpy as np

    from graph_wavenet_tpu_torch.data.windows import reverse_sliding_window

    tm = result.test_metrics
    reals = tm["reals"]                               # (n, K, N, 2)
    rec = reverse_sliding_window(
        [np.transpose(reals[..., 0], (0, 2, 1)),
         np.transpose(reals[..., 1], (0, 2, 1)), tm["pred_F"], tm["pred_E"]])
    try:
        import matplotlib
    except ImportError:
        print("plot skipped: matplotlib is not installed", flush=True)
        return rec
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 4))
    for series, label in zip(rec, ("real F", "real E", "pred F", "pred E")):
        plt.plot(series[node], label=label)
    plt.legend()
    plt.title(f"diff-G test reconstruction, node {node}")
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()
    print(f"saved reconstruction figure to {out_path}", flush=True)
    return rec


def cli() -> None:
    """Console-script entry: ``main``'s dict would become the exit
    status, so drop it."""
    main()


if __name__ == "__main__":
    main()
