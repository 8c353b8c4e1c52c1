"""Share of the traced segment in which no operation ran on the card, in a
serving cell below the knee (the open loop's slack, the batcher's window
and the host path between calls)."""

from gwbench.layers import idle

UNIT = "%"


def read(rec):
    return idle(rec, "serve", tail=True)
