"""Share of the traced segment in which no operation ran on the card, in
the dense METR-LA training family."""

from gwbench.layers import idle

UNIT = "%"


def read(rec):
    return idle(rec, "metr_train")
