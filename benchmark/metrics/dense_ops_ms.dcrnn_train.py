"""Device busy time (union of intervals) less the hand kernels' time, per
traced step of the DCRNN training family: the projections, the gates and
the state updates, casts and copies."""

from gwbench.layers import dense_ms

UNIT = "ms/step"


def read(rec):
    return dense_ms(rec, "dcrnn_train")
