"""The counted least time of DCRNN's block-sparse hop pairs (forward and
transposed, ``gwbench/count_dcrnn.py``) over the device time of the hand
kernels (kernels/*.json); none where no hand kernel runs."""

from gwbench.layers import kernel_roofline

UNIT = "%"


def read(rec):
    return kernel_roofline(rec, "dcrnn_train")
