"""Offline ETL CLI: a traffic h5 -> windowed {train,val,test}.npz.

A copy of ``graph_wavenet_tpu/cli/generate_training_data.py``: the
reference's flags and split semantics, without its interactive overwrite
prompt (pass --force). Reading the h5 needs pandas.

    python -m graph_wavenet_tpu_torch.cli.generate_training_data \\
        --traffic_df_filename data/metr-la.h5 --output_dir data/METR-LA
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "gwt-torch-generate-training-data",
        description="Window a traffic h5 into train/val/test npz splits")
    p.add_argument("--output_dir", type=str, default="data/METR-LA")
    p.add_argument("--traffic_df_filename", type=str,
                   default="data/metr-la.h5")
    p.add_argument("--seq_length_x", type=int, default=12)
    p.add_argument("--seq_length_y", type=int, default=12)
    p.add_argument("--y_start", type=int, default=1)
    p.add_argument("--dow", action="store_true",
                   help="add day-of-week feature")
    p.add_argument("--force", action="store_true",
                   help="overwrite an existing output dir without asking")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from graph_wavenet_tpu_torch.data.traffic_etl import (
        generate_train_val_test,
        load_hdf_readings,
    )

    if os.path.isfile(args.output_dir):
        raise SystemExit(
            f"{args.output_dir} exists and is not a directory")
    if os.path.isdir(args.output_dir) and not args.force:
        existing = [f for f in os.listdir(args.output_dir)
                    if f.endswith(".npz")]
        if existing:
            raise SystemExit(
                f"{args.output_dir} already has npz splits; pass --force")
    values, index = load_hdf_readings(args.traffic_df_filename)
    shapes = generate_train_val_test(
        values, args.output_dir, index=index,
        seq_length_x=args.seq_length_x, seq_length_y=args.seq_length_y,
        y_start=args.y_start, add_day_in_week=args.dow)
    for cat, shape in shapes.items():
        print(cat, "x:", shape)
    return shapes


def cli() -> None:
    """Console-script entry: ``main``'s dict would become the exit
    status, so drop it."""
    main()


if __name__ == "__main__":
    main()
