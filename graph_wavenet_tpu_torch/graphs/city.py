"""City-scale graph pipeline: edge-list graph -> ordered block-sparse
supports + a persisted node layout.

A copy of ``graph_wavenet_tpu/graphs/city.py``. The layout record
(permutation, padding, ordering, form, graph fingerprint, and
``adaptive_hops`` when the model learns the block-masked adaptive
adjacency) has the same keys and values as the reference's, so a checkpoint
sidecar written by either package rebuilds the same supports in the other,
whichever of the four forms it records. The port's training CLI adds
``support_dtype``, the storage dtype of the blocks it trained on, which
:func:`supports_from_layout` restores. ``form="auto"`` resolves to
``"flat"`` on every device (the reference picks ``"block"`` off the TPU):
the flat kernels do the least work.

Graph file format (``--graph_npz``): an .npz with ``src``, ``dst`` int
arrays (A[src, dst] = weight), optional ``weight``, ``pos`` (N, 2) and
``n_nodes``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def save_graph_npz(path: str, src, dst, weight=None, pos=None,
                   n_nodes: int | None = None) -> None:
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    arrays = dict(src=src, dst=dst)
    arrays["weight"] = (np.ones(len(src), np.float32) if weight is None
                        else np.asarray(weight, np.float32))
    if pos is not None:
        arrays["pos"] = np.asarray(pos, np.float32)
    if n_nodes is not None:
        arrays["n_nodes"] = np.int64(n_nodes)
    np.savez(path, **arrays)


def load_graph_npz(path: str) -> dict:
    with np.load(path) as z:
        src = z["src"].astype(np.int64)
        dst = z["dst"].astype(np.int64)
        weight = (z["weight"].astype(np.float32) if "weight" in z
                  else np.ones(len(src), np.float32))
        pos = z["pos"].astype(np.float64) if "pos" in z else None
        n_nodes = (int(z["n_nodes"]) if "n_nodes" in z
                   else int(max(src.max(), dst.max())) + 1)
    if not len(src) == len(dst) == len(weight):
        raise ValueError(f"{path}: ragged edge arrays")
    return dict(src=src, dst=dst, weight=weight, pos=pos, n_nodes=n_nodes)


def graph_fingerprint(src, dst, weight, n_nodes: int) -> str:
    """Stable digest of the edge list, recorded in the checkpoint sidecar
    and verified at serving time (order-invariant, duplicates included)."""
    h = hashlib.sha256()
    h.update(np.int64(n_nodes).tobytes())
    order = np.lexsort((np.asarray(weight, np.float32),
                        np.asarray(dst, np.int64),
                        np.asarray(src, np.int64)))
    h.update(np.asarray(src, np.int64)[order].tobytes())
    h.update(np.asarray(dst, np.int64)[order].tobytes())
    h.update(np.asarray(weight, np.float32)[order].tobytes())
    return h.hexdigest()[:16]


def _full_perm(perm_raw, n_raw: int, n_pad: int) -> np.ndarray:
    """Extend an n_raw permutation with identity pad ids (pad nodes sit
    at the tail)."""
    if perm_raw is None:
        return np.arange(n_pad, dtype=np.int64)
    return np.concatenate([np.asarray(perm_raw, np.int64),
                           np.arange(n_raw, n_pad, dtype=np.int64)])


def build_city_supports(src, dst, weight, n_nodes: int, *, pos=None,
                        ordering: str = "best", form: str = "auto",
                        block_size: int = 128, addaptadj: bool = False,
                        adaptive_hops: int = 1,
                        device: torch.device | str = "cuda"):
    """Edge list -> (supports, adaptive_mask_or_None, layout).

    ordering: "best" (fewest live blocks among RCM/Hilbert, preferring a
    fusable band), "rcm", "hilbert" (needs ``pos``) or "identity".
    form: "flat", "flat-rect", "block", "pallas" (the padded forms; their
    layout records ``fused2`` false) or "auto" (= "flat"). ``addaptadj``: also
    build the block-masked adaptive mask on the union of the supports'
    patterns, widened to the ``adaptive_hops``-hop block closure; the layout
    records ``adaptive_hops`` so every rebuild reproduces the trained
    pattern.
    """
    from graph_wavenet_tpu_torch.graphs import ordering as O
    from graph_wavenet_tpu_torch.graphs import spatial
    from graph_wavenet_tpu_torch.ops.block_sparse import Fused2FlatSupport

    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    if form == "auto":
        form = "flat"
    n_raw = int(n_nodes)
    n_pad = -(-n_raw // block_size) * block_size
    if ordering == "best":
        perm_raw, chosen, _ = O.best_block_ordering(
            src, dst, n_raw, pos=pos, block_size=block_size)
    elif ordering == "rcm":
        perm_raw, chosen = O.rcm_order_edges(src, dst, n_raw), "rcm"
    elif ordering == "hilbert":
        if pos is None:
            raise ValueError("ordering='hilbert' needs node coordinates "
                             "(a 'pos' array in the graph npz)")
        perm_raw, chosen = O.hilbert_order_points(pos), "hilbert"
    elif ordering == "identity":
        perm_raw, chosen = None, "identity"
    else:
        raise ValueError(f"unknown ordering {ordering!r}")
    perm = _full_perm(perm_raw, n_raw, n_pad)
    stats = O.block_locality_stats(src, dst, n_pad, perm, block_size)
    supports = spatial.doubletransition_block_supports(
        src, dst, weight, n_pad, perm=perm, form=form,
        block_size=block_size, device=device)
    mask = None
    if addaptadj:
        from graph_wavenet_tpu_torch.ops.adaptive_block import (
            mask_from_supports,
        )

        mask = mask_from_supports(supports, hops=adaptive_hops)
    layout = {
        **({"adaptive_hops": int(adaptive_hops)} if addaptadj else {}),
        "perm": perm.tolist(),
        "ordering": chosen,
        "n_raw": n_raw,
        "n_pad": n_pad,
        "block_size": block_size,
        "form": form,
        "fingerprint": graph_fingerprint(src, dst, weight, n_raw),
        "n_blocks": stats["n_blocks"],
        "blocks_per_row_mean": stats["blocks_per_row_mean"],
        "blocks_per_row_max": stats["blocks_per_row_max"],
        "fused2": any(isinstance(s, Fused2FlatSupport) for s in supports),
    }
    return supports, mask, layout


def layout_support_dtype(layout: dict, model_dtype: str) -> str:
    """Storage dtype of the fixed supports' blocks a checkpoint trained
    with: the layout's ``support_dtype``. Where the key is absent (the
    reference package's checkpoints, the port's before it recorded one):
    bf16 for a bf16 model, whose hops cast the blocks to bf16 on every use,
    so storing them so changes no bit; fp32 otherwise."""
    return layout.get("support_dtype",
                      "bfloat16" if model_dtype == "bfloat16" else "float32")


def supports_from_layout(graph_npz: str, layout: dict, model_cfg, *,
                         device: torch.device | str = "cuda") -> list:
    """The supports a city checkpoint trained on, rebuilt from the graph
    file under its persisted layout: the graph fingerprint verified, never a
    fresh ordering, the blocks stored in :func:`layout_support_dtype`, and
    the adaptive mask (widened by the layout's ``adaptive_hops``) appended
    when the model learned one. A model trained aptonly (``n_supports``
    0) gets the mask alone, as the reference's ``from_city_checkpoint``
    gives it under ``aptonly=True``."""
    from graph_wavenet_tpu_torch.graphs.spatial import (
        doubletransition_block_supports,
    )

    g = load_graph_npz(graph_npz)
    fp = graph_fingerprint(g["src"], g["dst"], g["weight"], g["n_nodes"])
    if fp != layout["fingerprint"]:
        raise ValueError(
            f"graph fingerprint mismatch: checkpoint trained on "
            f"{layout['fingerprint']}, {graph_npz} is {fp}")
    supports = doubletransition_block_supports(
        g["src"], g["dst"], g["weight"], layout["n_pad"],
        perm=np.asarray(layout["perm"], np.int64), form=layout["form"],
        block_size=layout["block_size"], device=device)
    sup_dtype = layout_support_dtype(layout, model_cfg.dtype)
    if sup_dtype != "float32":
        supports = [s.astype(getattr(torch, sup_dtype)) for s in supports]
    fixed = supports if model_cfg.n_supports else []
    if model_cfg.addaptadj:
        from graph_wavenet_tpu_torch.ops.adaptive_block import (
            mask_from_supports,
        )

        return fixed + [mask_from_supports(
            supports, hops=int(layout.get("adaptive_hops", 1)))]
    return fixed


def apply_node_layout(arr: np.ndarray, layout: dict,
                      axis: int = -2) -> np.ndarray:
    """Raw node order -> model (permuted + padded) order along ``axis``;
    pad positions are zero."""
    perm = np.asarray(layout["perm"], np.int64)
    n_raw, n_pad = layout["n_raw"], layout["n_pad"]
    arr = np.asarray(arr)
    axis = axis % arr.ndim
    if arr.shape[axis] != n_raw:
        raise ValueError(f"axis {axis} has {arr.shape[axis]} nodes, layout "
                         f"expects {n_raw}")
    shape = list(arr.shape)
    shape[axis] = n_pad
    out = np.zeros(shape, arr.dtype)
    idx = [slice(None)] * arr.ndim
    idx[axis] = perm[:n_raw]
    out[tuple(idx)] = arr
    return out


def apply_layout_to_data(data: dict, layout: dict) -> dict:
    """Permute and pad every split's node axis in a dataset dict in place
    (before the loaders are built). x_*/y_* arrays are (B, T, N, F)."""
    for k in list(data):
        if k.startswith(("x_", "y_")) and isinstance(data[k], np.ndarray):
            data[k] = apply_node_layout(data[k], layout, axis=2)
    return data


def invert_node_layout(arr: np.ndarray, layout: dict,
                       axis: int = -2) -> np.ndarray:
    """Model (permuted + padded) order -> raw node order along ``axis``."""
    perm = np.asarray(layout["perm"], np.int64)
    n_raw, n_pad = layout["n_raw"], layout["n_pad"]
    arr = np.asarray(arr)
    axis = axis % arr.ndim
    if arr.shape[axis] != n_pad:
        raise ValueError(f"axis {axis} has {arr.shape[axis]} nodes, layout "
                         f"expects {n_pad}")
    idx = [slice(None)] * arr.ndim
    idx[axis] = perm[:n_raw]
    return arr[tuple(idx)]
