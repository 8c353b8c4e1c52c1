"""Device busy time (union of intervals) less the hand kernels' time, per
traced step on rank 0's card, in the four-card data-parallel city training
family: the dense ops and the all-reduce's exposed part
(``allreduce_ms.train_dp4``)."""

from gwbench.layers import dense_ms

UNIT = "ms/step"


def read(rec):
    return dense_ms(rec, "train_dp4")
