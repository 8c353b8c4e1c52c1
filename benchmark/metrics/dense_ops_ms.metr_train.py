"""Device busy time (union of intervals) less the hand kernels' time, per
traced step of the dense METR-LA training family: the dense ops (GEMMs,
casts, copies, elementwise)."""

from gwbench.layers import dense_ms

UNIT = "ms/step"


def read(rec):
    return dense_ms(rec, "metr_train")
