"""Training CLI: the METR-format dense path and city-scale graphs.

Counterpart of ``graph_wavenet_tpu/cli/train.py``'s METR and
``--graph_npz`` branches:

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

Then the runner fits and tests.

    python -m graph_wavenet_tpu_torch.cli.train --data data/METR-LA \\
        --adjdata data/sensor_graph/adj_mx.pkl --num_nodes 207 --gcn_bool \\
        --addaptadj --seq_length 12 --save ckpt/
    python -m graph_wavenet_tpu_torch.cli.train --graph_npz city.npz \\
        --data data/CITY --gcn_bool --addaptadj --dtype bfloat16 \\
        --batch_size 4 --seq_length 12 --epochs 1 --save ckpt/

Both branches keep the dataset on the device by default (``--resident
device``; ``host`` copies every batch from the host), and take the
runner's ``--scan_steps`` (optimizer steps per fused call: a CUDA graph
replayed per step on the card), ``--grad_accum``, ``--early_stop``,
``--epoch_timeout`` and ``--resume``. The synthetic and CRASH datasets
(``--data syn|crash``) wait for the diff-G slice, and the options listed in
:data:`LATER` for the slice each names (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import time
import warnings

# flags of the reference CLI that wait for a later slice of ROADMAP.md:
# (type, the default that keeps them off, the slice); a bool is a
# store_true switch
LATER = {"mesh_model": (int, 1, "7"), "mesh_time": (int, 1, "7"),
         "mesh_dp": (bool, False, "7")}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-train", description="Train Graph WaveNet on a METR-format "
        "dataset or a city-scale graph (--graph_npz) with the port")
    p.add_argument("--data", type=str, default="data/METR-LA",
                   help="directory of train/val/test.npz window splits")
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
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint to resume training from (full train "
                        "state); the run continues at its epoch + 1")
    later = p.add_argument_group("not ported yet (ROADMAP.md); refused "
                                 "unless left at their defaults")
    for name, (kind, default, _) in LATER.items():
        if kind is bool:
            later.add_argument(f"--{name}", action="store_true")
        else:
            later.add_argument(f"--{name}", type=kind, default=default)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    later = {f"--{k}": where for k, (_, v, where) in LATER.items()
             if getattr(args, k) != v}
    if later:
        raise SystemExit(
            f"{', '.join(later)}: not ported yet (slice "
            f"{', '.join(sorted(set(later.values())))} of ROADMAP.md)")
    if args.data in ("syn", "crash"):
        raise SystemExit(
            f"--data {args.data}: the synthetic and CRASH datasets come with "
            "the diff-G slice (slice 6 of ROADMAP.md)")
    t0 = time.time()
    if args.graph_npz:
        result, runner, supports = _run_city(args)
    else:
        result, runner, supports = _run_metr(args)
    print(f"Total time spent: {time.time() - t0:.4f}", flush=True)
    return {"result": result, "runner": runner, "supports": supports}


def model_config(args, num_nodes: int):
    from graph_wavenet_tpu_torch.config import ModelConfig

    return ModelConfig(
        num_nodes=num_nodes, in_dim=args.in_dim, out_dim=args.seq_length,
        residual_channels=args.nhid, dilation_channels=args.nhid,
        skip_channels=args.nhid * 8, end_channels=args.nhid * 16,
        blocks=args.blocks, layers=args.layers, dropout=args.dropout,
        gcn_bool=args.gcn_bool, addaptadj=args.addaptadj,
        n_supports=0 if args.aptonly else 2, dtype=args.dtype)


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


def _fit(args, cfg, data, supports, aptinit=None, extra_meta=None):
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    train_cfg = train_config(args)
    engine = Engine(cfg, train_cfg, data["scaler"], device=args.device,
                    seed=args.seed,
                    steps_per_epoch=data["train_loader"].num_batch,
                    aptinit=aptinit)
    runner = Runner(engine, train_cfg, extra_meta=extra_meta)
    result = runner.fit(data, supports, resume_from=args.resume)
    runner.test(data, supports, result)
    return result, runner, supports


def _run_metr(args):
    """The METR branch: dense supports from the adjacency pickle."""
    import numpy as np
    import torch

    from graph_wavenet_tpu_torch import resolve_device
    from graph_wavenet_tpu_torch.data.metr import load_dataset
    from graph_wavenet_tpu_torch.graphs.normalize import load_adj

    device = resolve_device(args.device)
    _, _, adj = load_adj(args.adjdata, args.adjtype)
    data = load_dataset(args.data, args.batch_size, seed=args.seed,
                        resident=args.resident, device=device)
    _check_horizon(args, data)
    cfg = model_config(args, args.num_nodes)
    n_data = int(data["x_train"].shape[2])
    if n_data != cfg.num_nodes or adj[0].shape[0] != cfg.num_nodes:
        raise SystemExit(
            f"--num_nodes {args.num_nodes}, but the data has {n_data} nodes "
            f"and {args.adjdata} {adj[0].shape[0]}")
    aptinit = (np.asarray(adj[0]) if cfg.gcn_bool and cfg.addaptadj
               and not args.randomadj else None)
    # [] (not None) under aptonly: the adaptive adjacency stays on with no
    # fixed supports, as the test CLI evaluates it
    supports = ([] if args.aptonly else
                [torch.as_tensor(a, device=device) for a in adj])
    return _fit(args, cfg, data, supports, aptinit=aptinit)


def _run_city(args):
    """The --graph_npz branch: ordered block-sparse supports."""
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

    data = load_dataset(args.data, args.batch_size, seed=args.seed,
                        node_layout=layout, resident=args.resident,
                        device=args.device)
    _check_horizon(args, data)
    cfg = model_config(args, layout["n_pad"])
    sup_list = ([] if args.aptonly else list(supports)) + (
        [mask] if args.addaptadj else [])
    return _fit(args, cfg, data, sup_list,
                extra_meta={"graph_layout": layout})


def cli() -> None:
    """Console-script entry: ``main``'s dict would become the exit
    status, so drop it."""
    main()


if __name__ == "__main__":
    main()
