"""Device busy time (union of intervals) less the hand kernels' time, per
traced call: the dense ops (GEMMs, casts, copies, elementwise).
Read in a serving cell above the knee, whose end-to-end metric is its
rate."""

from gwbench.layers import dense_ms

UNIT = "ms/call"


def read(rec):
    return dense_ms(rec, "serve")
