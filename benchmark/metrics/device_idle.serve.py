"""Share of the traced segment in which no operation ran on the card.
Read in a serving cell above the knee, whose end-to-end metric is its
rate."""

from gwbench.layers import idle

UNIT = "%"


def read(rec):
    return idle(rec, "serve")
