"""The numbers that decide ``correct``, each held to its limit.

Training: each of the first steps' loss against the reference's; the
norm of the first gradient as Adam takes it, leaf by leaf; and the norm
of each leaf's change over the first steps. A gap of norms is taken by
the worst leaf and measured against the larger of the reference leaf's
norm and the median leaf's. Leaves whose reference gradient is under a
thousandth of the median leaf's (round-off, moved by Adam on its sign
alone) are left out; a leaf that one side moves and the other does not
reads a gap of 1.

Serving: for each sampled answer, the root-mean-square gap to the
reference's forecast over the RMS of the reference's deviation from the
scaler's mean, and the widest gap in units of the scaler's std.
"""

from __future__ import annotations

import statistics

import torch

FLOOR = 1e-3


def loss_gap(prog: list, ref: list) -> float:
    if len(prog) != len(ref):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def norms(tensors: dict) -> dict:
    return {k: (None if v is None else float(v.double().norm()))
            for k, v in tensors.items()}


def leaf_gap(prog: dict, ref: dict, ref_grad: dict) -> tuple:
    """(worst gap, its leaf) of two ``{leaf: norm or None}``; leaves are
    chosen by the reference's gradient norms ``ref_grad``."""
    live = [v for v in ref_grad.values() if v]
    med_g = statistics.median(live)
    keep = [k for k in ref if ref_grad.get(k) is not None
            and ref_grad[k] >= FLOOR * med_g]
    worst, leaf = 0.0, None
    base = statistics.median([ref[k] for k in keep])
    for k in sorted(set(ref) | set(prog)):
        p = prog.get(k)
        if ref_grad.get(k) is None:
            gap = 1.0 if p else 0.0
        elif k not in keep:
            continue
        elif p is None:
            gap = 1.0
        else:
            gap = abs(p - ref[k]) / max(ref[k], base)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf


def forecast_gaps(prog: torch.Tensor, ref: torch.Tensor,
                  scaler: dict) -> tuple[float, float]:
    """(nrmse, widest gap / std) of one forecast (H, N)."""
    d = (prog.double() - ref.double())
    dev = ref.double() - scaler["mean"]
    nrmse = float(d.pow(2).mean().sqrt() / dev.pow(2).mean().sqrt())
    return nrmse, float(d.abs().max()) / scaler["std"]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and ``{name: {"value", "limit"}}``: every number at or
    under its limit; a number without a limit is not correct."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        out[name] = {"value": value, "limit": lim}
        if lim is None or not value <= lim:
            ok = False
    return ok and bool(numbers), out
