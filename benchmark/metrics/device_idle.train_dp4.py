"""Share of rank 0's traced segment in which no operation ran on its
card, in the four-card data-parallel city training family."""

from gwbench.layers import idle

UNIT = "%"


def read(rec):
    return idle(rec, "train_dp4")
