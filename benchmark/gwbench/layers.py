"""Arithmetic shared by the per-layer readers (``metrics/``) over a traced
segment's records: ``kind`` ("train" or "serve"), ``trace``, ``work``
(the counted work of each step or call traced), ``flops_window`` and
``window_s`` (the measured window's counted FLOPs and host seconds),
``counters``, ``tail`` (a serving cell below the knee, whose end-to-end
metric is its tail), ``kernels`` (``kernels/*.json``) and ``peaks``.
A reader reads the records of one kind, with or without the tail."""

from __future__ import annotations

from gwbench import trace


def reads(rec: dict, kind: str, tail: bool = False) -> bool:
    return rec["kind"] == kind and bool(rec.get("tail")) == tail


def hand_s(rec: dict) -> float:
    """Device seconds in which a hand kernel ran (union of intervals)."""
    pats = [k["pattern"] for k in rec["kernels"]]
    return trace.covered(trace.matching(rec["trace"], pats))


def busy_s(rec: dict) -> float:
    return trace.busy_s(rec["trace"])


def mfu(rec: dict, kind: str) -> float | None:
    if not reads(rec, kind) or not rec.get("peaks"):
        return None
    rate = rec["flops_window"] / rec["window_s"]
    return 100.0 * rate / rec["peaks"]["bf16_flops"]


def dense_ms(rec: dict, kind: str) -> float | None:
    if not reads(rec, kind) or not rec["work"]:
        return None
    return 1e3 * (busy_s(rec) - hand_s(rec)) / len(rec["work"])


def kernel_roofline(rec: dict, kind: str) -> float | None:
    """Least time of the hand kernels' counted work over their device
    time, in percent; None where no hand kernel ran."""
    if not reads(rec, kind) or not rec.get("peaks"):
        return None
    spent = hand_s(rec)
    if spent <= 0:
        return None
    p = rec["peaks"]
    least = sum(w.least_s(p["bf16_flops"], p["hbm_bytes_per_s"])
                for w in rec["work"])
    return 100.0 * least / spent


def idle(rec: dict, kind: str, tail: bool = False) -> float | None:
    if not reads(rec, kind, tail):
        return None
    tr = rec["trace"]
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)
