"""95th percentile of a request's wait in ``MicroBatcher``'s queue, from
its ``submit`` to the worker taking it (the program's ``serve.queued``
spans), over the requests taken before the traced segment (warm-up and
window), in a serving cell below the knee, where the wait is part of the
tail."""

from gwbench import spans
from gwbench.layers import reads

UNIT = "ms"


def read(rec):
    if not reads(rec, "serve", tail=True):
        return None
    return spans.percentile(spans.before(rec, "serve.queued"), 95)
