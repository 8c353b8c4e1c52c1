"""Training CLI for city-scale graphs.

Counterpart of ``graph_wavenet_tpu/cli/train.py``'s ``--graph_npz``
branch: ordered block-sparse doubletransition supports (flat, or padded
under ``--sparse block|pallas``) from an edge-list graph, the data's node
axis permuted and padded to match, the block-masked adaptive adjacency
under ``--addaptadj``, and the node layout recorded in every checkpoint
sidecar, so the serve CLI rebuilds the same supports. Then the runner fits
and tests.

    python -m graph_wavenet_tpu_torch.cli.train --graph_npz city.npz \\
        --data data/CITY --gcn_bool --addaptadj --dtype bfloat16 \\
        --batch_size 4 --seq_length 12 --epochs 1 --save ckpt/

The METR dense path, the synthetic and CRASH datasets and the runner's
options listed in :data:`LATER` wait for later slices (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import time
import warnings

# flags of the reference CLI that wait for a later slice: (type, the
# default that keeps them off); a bool is a store_true switch
LATER = {"scan_steps": (int, 1), "grad_accum": (int, 1),
         "early_stop": (int, 0), "epoch_timeout": (float, 0.0),
         "resume": (str, None), "mesh_model": (int, 1),
         "mesh_time": (int, 1), "mesh_dp": (bool, False)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-train", description="Train Graph WaveNet on a "
        "city-scale graph (--graph_npz) with the port's CUDA kernels")
    p.add_argument("--data", type=str, default="data/METR-LA",
                   help="directory of train/val/test.npz window splits")
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
    p.add_argument("--addaptadj", action="store_true")
    p.add_argument("--seq_length", type=int, default=48)
    p.add_argument("--nhid", type=int, default=32)
    p.add_argument("--in_dim", type=int, default=2)
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
    later = p.add_argument_group("not ported yet (ROADMAP.md); refused "
                                 "unless left at their defaults")
    for name, (kind, default) in LATER.items():
        if kind is bool:
            later.add_argument(f"--{name}", action="store_true")
        else:
            later.add_argument(f"--{name}", type=kind, default=default)
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    later = [f"--{k}" for k, (_, v) in LATER.items()
             if getattr(args, k) != v]
    if later:
        raise SystemExit(f"{', '.join(later)}: not ported yet (the "
                         "dense/runner and parallelism slices of ROADMAP.md)")
    if not args.graph_npz:
        raise SystemExit(
            f"--data {args.data} without --graph_npz: the METR dense path "
            "is the dense slice and --data syn/crash the diff-G slice of "
            "ROADMAP.md; this CLI trains --graph_npz graphs")
    if not args.gcn_bool:
        raise SystemExit("--graph_npz builds graph supports; pass "
                         "--gcn_bool")
    t0 = time.time()
    result, runner, supports = _run_city(args)
    print(f"Total time spent: {time.time() - t0:.4f}", flush=True)
    return {"result": result, "runner": runner, "supports": supports}


def _run_city(args):
    import torch

    from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig
    from graph_wavenet_tpu_torch.data.metr import load_dataset
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

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
    print(f"graph: {g['n_nodes']} nodes (+{layout['n_pad'] - g['n_nodes']}"
          f" pad), ordering={layout['ordering']}, form={layout['form']}, "
          f"{layout['n_blocks']} live blocks "
          f"({layout['blocks_per_row_mean']:.1f} mean / "
          f"{layout['blocks_per_row_max']} max per row), fused2="
          f"{layout['fused2']}" + (f", adaptive mask {mask.n_live} blocks"
                                   if mask is not None else ""), flush=True)

    data = load_dataset(args.data, args.batch_size, seed=args.seed,
                        node_layout=layout)
    horizon = int(data["y_train"].shape[1])
    if args.seq_length != horizon:
        raise SystemExit(
            f"--seq_length {args.seq_length} does not match the dataset's "
            f"target horizon {horizon}; pass --seq_length {horizon}")
    cfg = ModelConfig(
        num_nodes=layout["n_pad"], in_dim=args.in_dim,
        out_dim=args.seq_length, residual_channels=args.nhid,
        dilation_channels=args.nhid, skip_channels=args.nhid * 8,
        end_channels=args.nhid * 16, blocks=args.blocks, layers=args.layers,
        dropout=args.dropout, gcn_bool=args.gcn_bool,
        addaptadj=args.addaptadj, n_supports=2, dtype=args.dtype)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, epochs=args.epochs,
        print_every=args.print_every, seed=args.seed, save_dir=args.save,
        expid=args.expid, lr_decay=args.lr_decay,
        lr_decay_every=args.lr_decay_every, async_checkpoint=False)
    sup_list = list(supports) + ([mask] if args.addaptadj else [])
    engine = Engine(cfg, train_cfg, data["scaler"], device=args.device,
                    seed=args.seed,
                    steps_per_epoch=data["train_loader"].num_batch)
    runner = Runner(engine, train_cfg, extra_meta={"graph_layout": layout})
    result = runner.fit(data, sup_list)
    runner.test(data, sup_list, result)
    return result, runner, sup_list


def cli() -> None:
    main()


if __name__ == "__main__":
    main()
