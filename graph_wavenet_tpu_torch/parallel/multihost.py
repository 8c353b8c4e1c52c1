"""Bring up ``torch.distributed``: one process per rank.

Counterpart of ``graph_wavenet_tpu/parallel/multihost.py``. ``torchrun``
(``python -m torch.distributed.run``) starts the processes and sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address;
:func:`initialize` reads them, or takes ``rank``, ``world_size`` and
``init_method`` from the caller. With neither it does nothing: one process,
no process group.

A rank computes on ``cuda:{LOCAL_RANK}``. NCCL refuses two ranks on one
card, so it needs a card per rank; ranks that share a card run on gloo
(``backend="gloo"``), rank i on card ``i % device_count``, their
collectives staged through host memory (``parallel.collectives``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from graph_wavenet_tpu_torch.parallel import collectives


def _launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device: torch.device | str) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's rank on its host (0 without a process group)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """The rank's device: ``cuda:{local rank % cards}`` for a CUDA device
    type, the CPU otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(backend: str | None = None, rank: int | None = None,
               world_size: int | None = None,
               init_method: str | None = None, *,
               device: torch.device | str = "cuda",
               timeout_s: float = 600.0) -> dict:
    """Start the process group (once per process) and return the layout:
    ``process_index``, ``process_count``, ``local_devices`` (cards this
    process sees, 1 on the CPU) and ``global_devices`` (one per rank).

    Reads torchrun's environment, or the explicit ``rank``, ``world_size``
    and ``init_method`` (e.g. ``"file:///tmp/rdzv"``); with neither, one
    process and no group. ``backend``: ``"nccl"`` or ``"gloo"`` (default:
    :func:`default_backend` of ``device``). ``timeout_s`` bounds every
    collective, so a hang fails instead of blocking."""
    explicit = any(v is not None for v in (rank, world_size, init_method))
    dev = torch.device(device)
    if (explicit or _launched()) and not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        backend = backend or default_backend(dev)
        if backend == "nccl":
            cards = torch.cuda.device_count()
            per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
            if per_host > cards:
                raise ValueError(
                    f"NCCL needs a card per rank: {per_host} ranks on this "
                    f"host, {cards} card(s); ranks that share a card need "
                    "backend=\"gloo\" (--dist_backend gloo)")
        if dev.type == "cuda":
            torch.cuda.set_device(rank_device(dev))
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": (torch.cuda.device_count() if dev.type == "cuda"
                          else 1),
        "global_devices": count,
    }


def replicate_pytree(tree, mesh=None):
    """Overwrite every tensor of a (nested) dict or list, e.g. a
    ``state_dict``, with rank 0's values, in place; returns ``tree``. The
    identity without a process group."""
    if mesh is None or mesh.world is None:
        return tree

    def walk(t):
        if torch.is_tensor(t):
            collectives.broadcast_(t, 0, mesh.world)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(tree)
    return tree
