"""A city of sensors: seeded uniform points, a k-NN graph with Gaussian
weights, the doubletransition pair in 128-node blocks under the RCM
order, and the adaptive adjacency on the union of their live blocks and
the diagonal. The points are the benchmark's; each side builds the rest
itself."""

from __future__ import annotations

import numpy as np


def raw(g: dict) -> dict:
    """The points both sides are given."""
    pos = np.random.default_rng(g["points_seed"]).random((g["nodes"], 2))
    return {"pos": pos}


def program(raw: dict, g: dict, dtype, device) -> dict:
    """The port's supports (fixed ones in ``dtype``, then the adaptive
    mask) and node layout, through ``graphs.spatial`` and
    ``graphs.city.build_city_supports``."""
    from graph_wavenet_tpu_torch.graphs.city import build_city_supports
    from graph_wavenet_tpu_torch.graphs.spatial import knn_graph_edges

    src, dst, w = knn_graph_edges(raw["pos"], g["k"])
    sup, mask, layout = build_city_supports(
        src, dst, w, g["nodes"], pos=raw["pos"], ordering=g["ordering"],
        form="flat", block_size=g["block_size"], addaptadj=True,
        adaptive_hops=g["adaptive_hops"], device=device)
    return {"supports": [s.astype(dtype) for s in sup] + [mask],
            "layout": layout,
            "live_blocks": [s.n_live for s in sup],
            "adaptive_live_blocks": mask.n_live}


def reference(raw: dict, g: dict, device) -> dict:
    """The reference's own supports, order and block mask."""
    import torch

    from reference import graph_ref

    if g["ordering"] != "rcm":
        raise ValueError("the reference orders city graphs by RCM only")
    n, bs = g["nodes"], g["block_size"]
    src, dst, w = graph_ref.knn_edges(raw["pos"], g["k"])
    perm = graph_ref.rcm_order(src, dst, n)
    fixed = graph_ref.doubletransition_blocks(src, dst, w, n, perm, bs,
                                              device)
    vb, wb = graph_ref.adaptive_pairs(fixed)
    return {"fixed": fixed,
            "pairs": (torch.as_tensor(vb, device=device),
                      torch.as_tensor(wb, device=device), bs),
            "perm": torch.as_tensor(perm, device=device),
            "live_blocks": [s.n_live for s in fixed],
            "adaptive_live_blocks": len(vb)}
