"""Configuration dataclasses, field for field the reference package's
(``graph_wavenet_tpu/config.py``), so that its checkpoint sidecars load:
the model, the optimization, the synthetic datasets' ``DataConfig`` and
the grid of ranks' ``MeshConfig``; beside them DCRNN's ``DCRNNConfig``,
which the reference package does not have.

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
    gcn_mode: str = "auto"       # dense-support dataflow (ops.diffusion)
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
    def resolved_gcn_mode(self) -> str:
        """The reference's rule, measured on the TPU: ``concat`` for bf16
        activations, ``fused`` for fp32 (``chip_smoke.py`` times all three
        modes on the H100)."""
        if self.gcn_mode != "auto":
            return self.gcn_mode
        return "concat" if self.dtype == "bfloat16" else "fused"

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
class DCRNNConfig:
    """DCRNN (Li, Yu, Shahabi and Liu, ICLR 2018, arXiv:1707.01926): the
    diffusion-convolutional GRU encoder-decoder, its defaults the released
    ``data/model/dcrnn_la.yaml``'s model block. ``n_supports`` 2 is its
    ``dual_random_walk`` filter (the doubletransition pair); the
    curriculum feeds the decoder the label in training with probability
    ``tau / (tau + exp(step / tau))``, ``tau = cl_decay_steps``.
    ``dtype``: the activations; the recurrent states are carried in
    float32 whatever it is (``models.dcrnn``)."""

    num_nodes: int = 207
    input_dim: int = 2
    output_dim: int = 1
    rnn_units: int = 64
    num_rnn_layers: int = 2
    max_diffusion_step: int = 2
    n_supports: int = 2
    seq_len: int = 12
    horizon: int = 12
    cl_decay_steps: int = 2000
    dtype: str = "float32"
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"dtype must be float32 or bfloat16, got {self.dtype!r}")
        if self.max_diffusion_step < 1 or self.n_supports < 1:
            raise ValueError("DCRNN diffuses over at least one support by "
                             "at least one step")


@dataclass(frozen=True)
class TrainConfig:
    """Optimization configuration, read by ``train.engine`` and
    ``train.runner``:

    - ``scan_steps``: optimizer steps per fused call on a device-resident
      train loader (a CUDA graph replayed per step on the card, under a
      process group too where it is NCCL); 1 runs a call per step;
    - ``grad_accum``: micro-batches per optimizer step, gradients averaged
      before one clip and one Adam step (not with ``scan_steps`` > 1);
    - ``early_stop_patience``: stop after this many epochs without a new
      best validation loss (0: never);
    - ``epoch_timeout_s``: an epoch that runs longer writes
      ``emergency.json`` and raises ``DeviceWedgedError`` (0: no watchdog);
    - ``async_checkpoint``: write epoch checkpoints on a thread;
    - ``keep_checkpoints``: keep the best this many (0: all);
    - ``prefetch``: batches a host-resident loader copies to the device
      ahead of the step, on a thread (``data.prefetch``; 0: none); not
      under a mesh, where the loaders are device-resident.
    """

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

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")
        if self.grad_accum > 1 and self.batch_size % self.grad_accum:
            raise ValueError(
                f"batch_size {self.batch_size} must divide by "
                f"grad_accum {self.grad_accum}")
        if self.scan_steps < 1:
            raise ValueError(f"scan_steps must be >= 1, got "
                             f"{self.scan_steps}")


@dataclass(frozen=True)
class DataConfig:
    """The synthetic SBM task's constants (the reference's ``util.py``
    values): ``n_train``/``n_valid``/``n_test`` subjects of
    ``num_timestep`` steps each, one graph per subject unless ``same_g``."""

    adjtype: str = "doubletransition"
    seq_length: int = 12
    num_nodes: int = 80
    n_communities: int = 5
    prob_intra: float = 0.8
    prob_inter: float = 0.2
    n_train: int = 80
    n_valid: int = 20
    n_test: int = 4
    num_timestep: int = 1000
    sigma_spatial: float = 0.1
    sigma_temporal: float = 0.1
    rho_spatial: float = 0.0
    rho_temporal: float = 0.0
    same_g: bool = False
    pooltype: str = "avg"


@dataclass(frozen=True)
class MeshConfig:
    """The grid of ranks (``parallel.mesh.make_mesh``): ``model_axis``
    ranks split the nodes (node-TP of the dense supports and of the flat
    block-sparse ones), ``time_axis`` ranks split the time axis (time-halo
    sequence parallelism), and the data axis takes the rest of the
    world."""

    model_axis: int = 1
    time_axis: int = 1

    def __post_init__(self):
        if self.model_axis < 1 or self.time_axis < 1:
            raise ValueError(f"the model and time axes must be >= 1, got "
                             f"{self.model_axis} and {self.time_axis}")


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
