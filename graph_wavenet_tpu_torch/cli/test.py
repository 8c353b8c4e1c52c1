"""Evaluation CLI: per-horizon test metrics of a checkpoint, the adaptive
adjacency heatmap and a predictions CSV for one node.

Counterpart of ``graph_wavenet_tpu/cli/test.py``. The model, scaler and
configs come from the checkpoint's sidecar:

- **METR** checkpoints: the ``--adjtype`` supports of ``--adjdata``, dense
  (none for an aptonly checkpoint, whose config has ``n_supports`` 0: the
  adaptive adjacency alone; ``--aptonly`` is accepted and changes
  nothing);
- **city** checkpoints (the sidecar has a ``graph_layout``): ``--graph_npz``
  is fingerprint-checked and the supports rebuilt under the persisted
  layout, in the dtype they trained in (``graphs.city.
  supports_from_layout``); the data's node axis is mapped into model order
  and ``--csv_node`` is an original node id.

The inputs are standardized with the sidecar's scaler. The heatmap is the
dense adaptive adjacency, or at city scale (over 4,096 nodes) its
block-space mass; it is plotted with matplotlib where that is installed and
skipped with a printed line where it is not. A checkpoint of the reference
package converts with ``convert.params_from_jax`` first.

    python -m graph_wavenet_tpu_torch.cli.test --checkpoint ckpt/exp1.pt \\
        --data data/METR-LA --adjdata data/sensor_graph/adj_mx.pkl
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-test", description="Evaluate a Graph WaveNet checkpoint "
        "per horizon with the port")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--data", type=str, default="data/METR-LA")
    p.add_argument("--adjdata", type=str,
                   default="data/sensor_graph/adj_mx.pkl")
    p.add_argument("--adjtype", type=str, default="doubletransition")
    p.add_argument("--graph_npz", type=str, default=None,
                   help="edge-list graph a city checkpoint trained on "
                        "(fingerprint-verified)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--aptonly", action="store_true",
                   help="accepted for the reference CLI's sake; the "
                        "checkpoint says it (n_supports 0)")
    p.add_argument("--plotheatmap", type=str, default="True")
    p.add_argument("--heatmap_out", type=str, default="emb.pdf")
    p.add_argument("--csv_out", type=str, default="wave.csv")
    p.add_argument("--csv_node", type=int, default=99,
                   help="node whose horizon-3/12 predictions go to the CSV")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (default cuda)")
    return p


def block_space_heatmap(fixed_supports, nodevec1, nodevec2, hops: int = 1):
    """(nb, nb) block-space mass of the learned masked adaptive adjacency:
    per live block, its summed weight, at (source block-row, destination
    block-row). ``hops`` must match the trained mask. Returns ``(grid,
    mask)``."""
    import torch

    from graph_wavenet_tpu_torch.ops.adaptive_block import mask_from_supports

    amask = mask_from_supports(fixed_supports, hops=hops)
    with torch.no_grad():
        sp = amask.materialize(nodevec1, nodevec2)
        mass = sp.blocks_flat[:amask.n_live].float().sum((1, 2))
    nb = amask.n_src_blocks
    grid = np.zeros((nb, nb), np.float32)
    grid[amask.live_src.cpu().numpy(), amask.live_dst.cpu().numpy()] = (
        mass.cpu().numpy())
    return grid, amask


def _plot(grid: np.ndarray, path: str, title: str) -> None:
    """Save ``grid`` as a heatmap; print why where it cannot."""
    try:
        import matplotlib
    except ImportError as e:
        print(f"heatmap skipped: {e}", flush=True)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(grid, cmap="RdYlBu", aspect="auto")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    print(f"saved heatmap to {path}", flush=True)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import torch

    from graph_wavenet_tpu_torch import resolve_device
    from graph_wavenet_tpu_torch.data.metr import load_dataset
    from graph_wavenet_tpu_torch.graphs import city
    from graph_wavenet_tpu_torch.graphs.normalize import load_adj
    from graph_wavenet_tpu_torch.ops.adaptive import adaptive_adjacency
    from graph_wavenet_tpu_torch.train import checkpoint as ckpt
    from graph_wavenet_tpu_torch.train.engine import Engine
    from graph_wavenet_tpu_torch.train.runner import Runner

    device = resolve_device(args.device)
    meta = ckpt.load_metadata(args.checkpoint)
    model_cfg = meta["model_cfg"]
    layout = (meta.get("extra") or {}).get("graph_layout")
    if layout is not None:
        if not args.graph_npz:
            raise SystemExit(
                "this checkpoint was trained on a city-scale graph "
                f"(fingerprint {layout['fingerprint']}); pass --graph_npz "
                "with the graph it was trained on")
        try:
            supports = city.supports_from_layout(args.graph_npz, layout,
                                                 model_cfg, device=device)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    else:
        _, _, adj = load_adj(args.adjdata, args.adjtype)
        # an aptonly model (n_supports 0) takes [] (not None): the adaptive
        # adjacency stays on
        supports = ([] if model_cfg.n_supports == 0 else
                    [torch.as_tensor(a, device=device) for a in adj])
    # the sidecar's scaler where it has one, else a fit on this data
    data = load_dataset(args.data, args.batch_size,
                        scaler=meta.get("scaler"), node_layout=layout)
    scaler = data["scaler"]
    # evaluation never steps the optimizer, so the lr schedule (which
    # would ask for steps_per_epoch) is off
    train_cfg = dataclasses.replace(meta["train_cfg"], lr_decay=1.0)
    engine = Engine(model_cfg, train_cfg, scaler, device=device)
    engine.model.load_state_dict(ckpt.load_state_dict(args.checkpoint,
                                                      device=device))

    runner = Runner(engine, train_cfg)
    result = runner.test(data, supports,
                         return_predictions=bool(args.csv_out))
    out: dict = {"per_horizon": result.per_horizon,
                 "test_metrics": result.test_metrics}

    model = engine.model
    if args.plotheatmap == "True" and hasattr(model, "nodevec1"):
        if layout is not None and layout["n_pad"] > 4096:
            # the dense (N, N) view would take O(N^2) at city scale
            fixed = [s for s in supports
                     if not getattr(s, "adaptive_mask", False)]
            grid, amask = block_space_heatmap(
                fixed, model.nodevec1, model.nodevec2,
                hops=int(layout.get("adaptive_hops", 1)))
            out["adaptive_adjacency_blocks"] = grid
            _plot(grid, args.heatmap_out,
                  f"learned adaptive adjacency, block-space mass "
                  f"({amask.bs_src}-node blocks, model node order)")
        else:
            with torch.no_grad():
                adp = adaptive_adjacency(model.nodevec1, model.nodevec2)
            out["adaptive_adjacency"] = adp.float().cpu().numpy()
            _plot(out["adaptive_adjacency"], args.heatmap_out,
                  "adaptive adjacency softmax(relu(E1 E2))")

    # the reference's wave.csv: real12, pred12, real3, pred3 of one node,
    # from the test pass's predictions
    if args.csv_out:
        yhat = result.test_metrics.pop("yhat")
        real = np.transpose(data["y_test"][..., 0], (0, 2, 1))
        if layout is not None:
            node = int(np.asarray(layout["perm"])[
                min(args.csv_node, layout["n_raw"] - 1)])
        else:
            node = min(args.csv_node, real.shape[1] - 1)
        horizon = yhat.shape[-1]
        h12, h3 = min(11, horizon - 1), min(2, horizon - 1)
        cols = {"real12": real[:, node, h12],
                "pred12": scaler.inverse_transform(yhat[:, node, h12]),
                "real3": real[:, node, h3],
                "pred3": scaler.inverse_transform(yhat[:, node, h3])}
        np.savetxt(args.csv_out, np.stack(list(cols.values()), axis=1),
                   delimiter=",", header=",".join(cols), comments="")
        print(f"saved predictions to {args.csv_out}", flush=True)
    return out


def cli() -> None:
    """Console-script entry: ``main``'s dict would become the exit
    status, so drop it."""
    main()


if __name__ == "__main__":
    main()
