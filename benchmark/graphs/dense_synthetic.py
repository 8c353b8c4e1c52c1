"""A road graph of a few hundred sensors with dense supports: a seeded
adjacency built as DCRNN builds METR-LA's ``adj_mx`` (a Gaussian kernel
of the distances between sensors, entries under 0.1 set to 0), and its
doubletransition pair. Dense supports' values change no shape and no
work. The adjacency is the benchmark's; each side normalizes it
itself."""

from __future__ import annotations

import numpy as np


def raw(g: dict) -> dict:
    pos = np.random.default_rng(g["points_seed"]).random((g["nodes"], 2))
    d = np.sqrt(((pos[:, None] - pos[None]) ** 2).sum(-1))
    adj = np.exp(-(d / d.std()) ** 2)
    adj[adj < g["threshold"]] = 0.0
    return {"adj": adj.astype(np.float32)}


def program(raw: dict, g: dict, dtype, device) -> dict:
    """The port's dense doubletransition supports (``graphs.normalize``),
    fp32 on the card, as its training CLI loads them."""
    import torch

    from graph_wavenet_tpu_torch.graphs.normalize import mod_adj

    sup = [torch.as_tensor(a, device=device)
           for a in mod_adj(raw["adj"], "doubletransition")]
    return {"supports": sup, "layout": None}


def reference(raw: dict, g: dict, device) -> dict:
    from reference import graph_ref

    return {"fixed": graph_ref.doubletransition_dense(raw["adj"], device),
            "pairs": None, "perm": None}
