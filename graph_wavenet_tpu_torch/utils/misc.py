"""Small runtime utilities.

Counterpart of ``graph_wavenet_tpu/utils/misc.py``, the reference's
``miscTools``: a number made filename-safe (:func:`num2filename`), random
states saved and restored (:func:`save_seed` / :func:`load_seed`, for numpy
Generators and ``torch.Generator`` states in the place of JAX keys) and
``key = value`` experiment logs (:func:`write_var_values`). JAX's
``enable_compilation_cache`` has no PyTorch counterpart.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def num2filename(x, d: str = "_") -> str:
    """A number rendered filename-safe: 0.1 -> '0_1', 2.0 -> '2'."""
    if x == int(x):
        return str(int(x))
    return str(x).replace(".", d)


def save_seed(save_dir: str, rng_states: list[dict[str, Any]],
              filename: str = "randomSeedUsed.pkl") -> None:
    """Pickle a list of random-state dicts, each with its ``"state"``: a
    numpy Generator or a ``torch.Generator`` is stored as its state (kind
    ``"numpy"`` or ``"torch"``, the torch one with its device)."""
    os.makedirs(save_dir, exist_ok=True)
    serializable = []
    for st in rng_states:
        entry = dict(st)
        state = entry.get("state")
        if isinstance(state, np.random.Generator):
            entry["state"] = state.bit_generator.state
            entry["kind"] = "numpy"
        elif isinstance(state, torch.Generator):
            entry["device"] = str(state.device)
            entry["state"] = state.get_state().numpy()
            entry["kind"] = "torch"
        serializable.append(entry)
    with open(os.path.join(save_dir, filename), "wb") as f:
        pickle.dump({"randomStates": serializable}, f)


def load_seed(load_dir: str,
              filename: str = "randomSeedUsed.pkl") -> list[dict[str, Any]]:
    """The states :func:`save_seed` wrote: numpy entries come back as live
    Generators of the saved bit generator, torch ones as Generators on the
    saved device."""
    with open(os.path.join(load_dir, filename), "rb") as f:
        states = pickle.load(f)["randomStates"]
    out = []
    for entry in states:
        entry = dict(entry)
        if entry.get("kind") == "numpy":
            # the saved bit generator: a PCG64 state does not fit MT19937
            bg_name = entry["state"]["bit_generator"]
            gen = np.random.Generator(getattr(np.random, bg_name)())
            gen.bit_generator.state = entry["state"]
            entry["state"] = gen
        elif entry.get("kind") == "torch":
            gen = torch.Generator(device=entry.pop("device", "cpu"))
            gen.set_state(torch.as_tensor(entry["state"]))
            entry["state"] = gen
        out.append(entry)
    return out


def write_var_values(file_to_write: str, var_values: dict) -> None:
    """Append ``key = value`` lines and a blank line."""
    with open(file_to_write, "a+") as f:
        for key, value in var_values.items():
            f.write(f"{key} = {value}\n")
        f.write("\n")
