"""Median time of a batch-8 predict as ``MicroBatcher`` calls it, from the
host array to the answers back on the host (the program's
``serve.predict`` spans at bucket 8: the copy to the card, the forward,
the read back), over the calls before the traced segment, in a serving
cell above the knee, where the calls run at bucket 8."""

from gwbench import spans
from gwbench.layers import reads

UNIT = "ms/call"
BUCKET = 8


def read(rec):
    if not reads(rec, "serve"):
        return None
    return spans.percentile(
        [s for s in spans.before(rec, "serve.predict")
         if s["attrs"].get("bucket") == BUCKET], 50)
