"""Share of the traced segment in which no operation ran on the card."""

from gwbench.layers import idle

UNIT = "%"


def read(rec):
    return idle(rec, "train")
