"""Counted FLOPs of the window's completed steps over its host-clock time,
as a share of the card's dense bf16 peak, in the DCRNN training family
(the whole step's share; ``gwbench/count_dcrnn.py``, elementwise work not
counted)."""

from gwbench.layers import mfu

UNIT = "%"


def read(rec):
    return mfu(rec, "dcrnn_train")
