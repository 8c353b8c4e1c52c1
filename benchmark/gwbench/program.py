"""What the harness takes from the program (``graph_wavenet_tpu_torch``):
its model configuration built from a configuration file, and the
benchmark's weights copied into its module. Imported only where a
traffic kind runs the program."""

from __future__ import annotations

import torch

from graph_wavenet_tpu_torch.config import ModelConfig


def model_config(cfg: dict) -> ModelConfig:
    m = cfg["model"]
    return ModelConfig(
        num_nodes=cfg["graph"]["nodes"], in_dim=m["in_dim"],
        out_dim=m["out_dim"], residual_channels=m["residual_channels"],
        dilation_channels=m["dilation_channels"],
        skip_channels=m["skip_channels"], end_channels=m["end_channels"],
        kernel_size=m["kernel_size"], blocks=m["blocks"],
        layers=m["layers"], dropout=m["dropout"], gcn_bool=m["gcn_bool"],
        addaptadj=m["addaptadj"], adapt_rank=m["adapt_rank"],
        diffusion_order=m["diffusion_order"], n_supports=m["n_supports"],
        dtype=cfg["precision"]["activations"],
        param_dtype=cfg["precision"]["parameters"])


def shapes(module: torch.nn.Module) -> dict:
    """The floating-point entries of the module's state, by name."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if v.is_floating_point()}


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the module's own tensors (an optimizer built
    over them keeps them)."""
    state = module.state_dict()
    for k, v in weights.items():
        state[k].copy_(v)
