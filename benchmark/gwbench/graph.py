"""A configuration's graph for each side, built once per process: the
raw inputs the benchmark makes (``graphs/<kind>.py``'s ``raw``), the
program's supports and the reference's own, each checked against the
live-block counts the configuration states."""

from __future__ import annotations

import torch

from gwbench import registry

STATED = ("live_blocks", "adaptive_live_blocks")


def _check(side: str, built: dict, g: dict) -> None:
    stated = {k: g[k] for k in STATED if k in g}
    got = {k: built[k] for k in stated}
    if got != stated:
        raise RuntimeError(f"the {side} built {got}, the configuration "
                           f"states {stated}")


def program(ctx, cache: dict) -> dict:
    """The program's supports and layout (``cache["program"]``)."""
    g = ctx.config["graph"]
    if "program" not in cache:
        cache["gk"] = registry.graph_kind(g["kind"])
        cache["raw"] = cache["gk"].raw(g)
        dtype = getattr(torch, ctx.config["precision"]["activations"])
        cache["program"] = cache["gk"].program(cache["raw"], g, dtype,
                                               ctx.device)
        _check("program", cache["program"], g)
    return cache["program"]


def reference(ctx, cache: dict) -> dict:
    """The reference's supports, order and mask (``cache["reference"]``);
    the raw inputs are the ones the program was given."""
    g = ctx.config["graph"]
    if "reference" not in cache:
        if "raw" not in cache:
            cache["gk"] = registry.graph_kind(g["kind"])
            cache["raw"] = cache["gk"].raw(g)
        cache["reference"] = cache["gk"].reference(cache["raw"], g,
                                                   ctx.device)
        _check("reference", cache["reference"], g)
    return cache["reference"]
