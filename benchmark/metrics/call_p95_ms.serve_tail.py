"""95th percentile of a ``MicroBatcher`` call, from taking its first
request to handing back its last answer (the program's ``serve.call``
spans: the batching window, the stack, the predict, the read back), over
the calls before the traced segment (warm-up and window), in a serving
cell below the knee."""

from gwbench import spans
from gwbench.layers import reads

UNIT = "ms"


def read(rec):
    if not reads(rec, "serve", tail=True):
        return None
    return spans.percentile(spans.before(rec, "serve.call"), 95)
