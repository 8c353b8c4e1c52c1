"""The counted least time of the block-sparse hops and weight cotangents
over the device time of the hand kernels (kernels/*.json); none where no
hand kernel runs.
Read in a serving cell above the knee, whose end-to-end metric is its
rate."""

from gwbench.layers import kernel_roofline

UNIT = "%"


def read(rec):
    return kernel_roofline(rec, "serve")
