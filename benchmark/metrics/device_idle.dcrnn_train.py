"""Share of the traced segment in which no operation ran on the card, in
the DCRNN training family."""

from gwbench.layers import idle

UNIT = "%"


def read(rec):
    return idle(rec, "dcrnn_train")
