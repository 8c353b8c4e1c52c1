"""The counted least time of the block-sparse hops and weight cotangents
over the device time of the hand kernels (kernels/*.json); none where no
hand kernel runs."""

from gwbench.layers import kernel_roofline

UNIT = "%"


def read(rec):
    return kernel_roofline(rec, "train")
