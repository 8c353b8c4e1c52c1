"""Counted FLOPs of the window's completed calls over its host-clock time,
as a share of the card's dense bf16 peak (the whole step's share; the
benchmark's own count, elementwise work not counted).
Read in a serving cell above the knee, whose end-to-end metric is its
rate."""

from gwbench.layers import mfu

UNIT = "%"


def read(rec):
    return mfu(rec, "serve")
