"""Counted FLOPs of a rank's share of the window's completed steps over
the window's host-clock time, as a share of one card's dense bf16 peak,
in the four-card data-parallel city training family (the whole step's
share on each card; the benchmark's own count, elementwise work and the
all-reduce not counted)."""

from gwbench.layers import mfu

UNIT = "%"


def read(rec):
    return mfu(rec, "train_dp4")
