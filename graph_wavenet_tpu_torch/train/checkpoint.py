"""Checkpoints: a ``torch.save`` payload plus a JSON sidecar.

Counterpart of ``graph_wavenet_tpu/train/checkpoint.py``. The payload is
``{"model": state_dict}`` plus, from the trainer, ``"optimizer"``,
``"step"`` and ``"generator"`` (the dropout generator's state). The sidecar
keeps the reference schema (``model_cfg``, ``train_cfg``, ``scaler``,
``extra.graph_layout``) under ``"format": "graph_wavenet_tpu_torch/v2"``,
and :func:`load_metadata` also reads the reference package's sidecars.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Any

import torch

from graph_wavenet_tpu_torch.config import ModelConfig, TrainConfig, from_dict
from graph_wavenet_tpu_torch.data.scaler import StandardScaler

FORMAT = "graph_wavenet_tpu_torch/v2"


def save_checkpoint(path: str, state_dict: dict,
                    model_cfg: ModelConfig | None = None,
                    train_cfg: TrainConfig | None = None,
                    scaler: StandardScaler | None = None,
                    extra: dict | None = None,
                    train_state: dict | None = None) -> None:
    """Write ``path`` (the state dict on the CPU, and ``train_state``'s
    entries, e.g. :meth:`train.engine.Engine.train_state`) and
    ``path + ".json"``. Both publish atomically, the sidecar first."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    meta: dict[str, Any] = {"format": FORMAT}
    if model_cfg is not None:
        meta["model_cfg"] = asdict(model_cfg)
    if train_cfg is not None:
        meta["train_cfg"] = asdict(train_cfg)
    if scaler is not None:
        meta["scaler"] = {"mean": scaler.mean, "std": scaler.std}
    if extra:
        meta["extra"] = extra
    jtmp = path + ".json.tmp"
    with open(jtmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(jtmp, path + ".json")
    tmp = path + ".tmp"
    payload = {"model": {k: v.detach().cpu()
                         for k, v in state_dict.items()},
               **(train_state or {})}
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_state_dict(path: str, device: torch.device | str = "cpu") -> dict:
    """The model's state dict of a checkpoint."""
    meta = load_metadata(path)
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path} is a {meta.get('format')!r} checkpoint, not {FORMAT!r}; "
            "convert reference-package weights with "
            "convert.params_from_jax first")
    return torch.load(path, map_location=device, weights_only=True)["model"]


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        meta = json.load(f)
    if "model_cfg" in meta:
        meta["model_cfg"] = from_dict(ModelConfig, meta["model_cfg"])
    if "train_cfg" in meta:
        meta["train_cfg"] = from_dict(TrainConfig, meta["train_cfg"])
    if "scaler" in meta:
        meta["scaler"] = StandardScaler(**meta["scaler"])
    return meta
