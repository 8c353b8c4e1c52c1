"""The counted least time of a rank's block-sparse hops and weight
cotangents over the device time of the hand kernels (kernels/*.json) on
rank 0's card, in the four-card data-parallel city training family; none
where no hand kernel runs."""

from gwbench.layers import kernel_roofline

UNIT = "%"


def read(rec):
    return kernel_roofline(rec, "train_dp4")
