"""Median time a ``MicroBatcher`` call spends stacking its requests and
pad rows into one host array (the program's ``serve.stack`` spans), over
the calls before the traced segment, in a serving cell above the knee."""

from gwbench import spans
from gwbench.layers import reads

UNIT = "ms/call"


def read(rec):
    if not reads(rec, "serve"):
        return None
    return spans.percentile(spans.before(rec, "serve.stack"), 50)
