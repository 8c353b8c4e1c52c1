"""The program's spans (``graph_wavenet_tpu_torch.train.profiling``) for
the per-layer readers: what the serving front's ``MicroBatcher`` kept of
each call and request, in ns on the clock of the traced segment's host
events (``Trace`` holds seconds on it). A program without the span store
has no spans, and a reader of them reads nothing."""

from __future__ import annotations

import numpy as np


def named(name: str) -> list[dict]:
    """The spans ``name`` in the program's ring, oldest first."""
    from graph_wavenet_tpu_torch.train import profiling

    spans = getattr(profiling, "spans", None)
    return [] if spans is None else [s for s in spans() if s["name"] == name]


def before(rec: dict, name: str) -> list[dict]:
    """The spans ``name`` that ended before the traced segment began: the
    warm-up and the measured window."""
    lo = rec["trace"].window[0]
    return [s for s in named(name) if s["end_ns"] * 1e-9 < lo]


def percentile(spans: list[dict], q: float) -> float | None:
    """The ``q``-th percentile (numpy, linear) of the spans' lengths in
    ms; None without spans."""
    if not spans:
        return None
    return float(np.percentile(
        [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans], q))
