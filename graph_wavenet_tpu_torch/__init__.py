"""Graph WaveNet in PyTorch and CUDA for NVIDIA Hopper.

A port of ``graph_wavenet_tpu`` (the JAX reference, kept beside it). This
package imports torch, numpy and scipy only: never jax, flax or anything of
``graph_wavenet_tpu``. Its block-sparse diffusion hops run hand-written
CUDA kernels (``csrc/``) on a CUDA device and their plain PyTorch versions
on CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a caller asked for. ``cuda`` without a card raises; nothing
    drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device=\"cpu\" "
            "to run on the CPU")
    return dev
