"""Counted FLOPs of the window's completed steps over its host-clock time,
as a share of the card's dense bf16 peak, in the dense METR-LA training
family (the whole step's share; the benchmark's own count, elementwise
work not counted)."""

from gwbench.layers import mfu

UNIT = "%"


def read(rec):
    return mfu(rec, "metr_train")
