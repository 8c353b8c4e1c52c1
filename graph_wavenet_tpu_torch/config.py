"""Configuration dataclasses, field for field the reference package's
(``graph_wavenet_tpu/config.py``), so that its checkpoint sidecars load.

``TrainConfig.rng_impl`` names a TPU random-bit generator; it is accepted and
ignored here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Graph WaveNet architecture configuration."""

    num_nodes: int = 207
    in_dim: int = 2
    out_dim: int = 12            # forecast horizon
    residual_channels: int = 32
    dilation_channels: int = 32
    skip_channels: int = 256
    end_channels: int = 512
    kernel_size: int = 2
    blocks: int = 4
    layers: int = 2
    dropout: float = 0.3
    gcn_bool: bool = True
    addaptadj: bool = True
    adapt_rank: int = 10
    diffusion_order: int = 2
    n_supports: int = 2          # fixed supports (doubletransition = 2)
    start_dilation: int = 1      # 4 for the diff-G variant
    fresh_nodevec: bool = False
    dtype: str = "float32"       # activation dtype ("float32" | "bfloat16")
    param_dtype: str = "float32"
    gcn_mode: str = "auto"       # dense-support dataflow; unused by the port
    remat: bool = False

    def __post_init__(self):
        if self.gcn_mode not in ("auto", "fused", "stacked", "concat"):
            raise ValueError(
                f"gcn_mode must be one of auto/fused/stacked/concat, "
                f"got {self.gcn_mode!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be float32 or bfloat16, got {self.dtype!r}")

    @property
    def supports_len(self) -> int:
        n = self.n_supports
        if self.gcn_bool and self.addaptadj:
            n += 1
        return n

    @property
    def receptive_field(self) -> int:
        """True receptive field from the dilations actually used."""
        return 1 + (self.kernel_size - 1) * sum(self.dilations())

    def dilations(self) -> list[int]:
        """Per-layer dilation schedule, e.g. [1,2,1,2,1,2,1,2]."""
        out = []
        for _ in range(self.blocks):
            d = self.start_dilation
            for _ in range(self.layers):
                out.append(d)
                d *= 2
        return out


@dataclass(frozen=True)
class TrainConfig:
    """Optimization configuration. ``train.engine`` and ``train.runner``
    read the optimizer, schedule, epoch and checkpoint fields; ``prefetch``,
    ``async_checkpoint``, ``grad_accum``, ``early_stop_patience``,
    ``epoch_timeout_s``, ``scan_steps`` and ``keep_checkpoints`` are carried
    through sidecars only (their runner features are not ported yet)."""

    batch_size: int = 64
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    grad_clip: float = 5.0
    epochs: int = 100
    print_every: int = 50
    seed: int = 0
    save_dir: str = "garage"
    expid: int = 1
    keep_checkpoints: int = 0
    lr_decay: float = 1.0
    lr_decay_every: int = 10
    min_lr: float = 2e-6
    rng_impl: str = "rbg"        # accepted and ignored
    prefetch: int = 0
    async_checkpoint: bool = True
    grad_accum: int = 1
    early_stop_patience: int = 0
    epoch_timeout_s: float = 0.0
    scan_steps: int = 1


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
