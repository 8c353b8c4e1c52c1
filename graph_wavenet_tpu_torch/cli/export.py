"""Export CLI: a checkpoint as a ``torch.export`` deployment artifact.

Counterpart of ``graph_wavenet_tpu/cli/export.py``. Loads a port checkpoint
under the mode its flags pick (``--graph_npz`` for a city-scale checkpoint,
``--adjdata`` for dense supports, neither for an aptonly or temporal-only
one, ``--graph_bank`` for a diff-G one; the rules of ``gwt-torch-serve``)
and writes the predict forward as a ``.pt2`` with the weights and supports
baked in; a diff-G artifact bakes the bank and is called as ``(x,
adj_idx)``. The artifact names the
hand kernels' ops, so ``gwt-torch-serve --artifact`` (or
``train.serving.load_exported_forecaster``, or ``torch.export.load`` after
importing ``graph_wavenet_tpu_torch.ops.cuda.block_diffusion``) serves it
without the model code. It runs on the device type it was exported on.

    python -m graph_wavenet_tpu_torch.cli.export --checkpoint city.pt \\
        --graph_npz city_graph.npz --out city.pt2 --batch_size 8 \\
        [--seq_len 13] [--device cuda]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-export", description="Write a checkpoint's predictor as "
        "a torch.export artifact")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="artifact output path (.pt2)")
    p.add_argument("--adjdata", type=str, default=None,
                   help="adjacency pickle of a dense checkpoint's fixed "
                        "supports")
    p.add_argument("--adjtype", type=str, default="doubletransition")
    p.add_argument("--graph_npz", type=str, default=None,
                   help="edge-list graph of a city-scale checkpoint "
                        "(fingerprint-verified; the artifact's node axis "
                        "speaks original node ids)")
    p.add_argument("--aptonly", action="store_true",
                   help="accepted for the reference CLI's sake; a checkpoint "
                        "trained with --aptonly (n_supports 0) is exported "
                        "with the learned adjacency alone either way")
    p.add_argument("--graph_bank", type=str, default=None,
                   help="graph bank of a diff-G checkpoint: baked into the "
                        "artifact, which then takes (x, adj_idx)")
    p.add_argument("--batch_size", type=int, default=64,
                   help="batch dimension baked into the artifact")
    p.add_argument("--seq_len", type=int, default=0,
                   help="input window baked into the artifact; 0 = the "
                        "model's receptive field (diff-G: the trained K); "
                        "shorter inputs are left-zero-padded by the loader")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the artifact runs on (default cuda)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from graph_wavenet_tpu_torch.cli.serve import load_forecaster
    from graph_wavenet_tpu_torch.train import serving

    fc = load_forecaster(args)
    export = (serving.export_diffg_forecaster
              if isinstance(fc, serving.DiffGForecaster)
              else serving.export_forecaster)
    path = export(fc, args.out, batch_size=args.batch_size,
                  seq_len=args.seq_len or None)
    meta = serving.artifact_metadata(path)
    print(f"exported {path}: input {tuple(meta['in_shape'])}, device "
          f"{meta['device']}", flush=True)
    return {"path": path, "in_shape": tuple(meta["in_shape"]),
            "device": meta["device"]}


def cli() -> None:
    """Console-script entry: drop ``main``'s dict so the script exits 0."""
    main()


if __name__ == "__main__":
    main()
