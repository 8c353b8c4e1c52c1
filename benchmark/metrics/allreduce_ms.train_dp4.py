"""NCCL kernel time per traced step on rank 0's card during which no
other kernel runs: the gradient all-reduce's exposed part (the union of
NCCL and other device intervals less the union of the others), in the
four-card data-parallel city training family."""

from gwbench import trace
from gwbench.layers import reads

UNIT = "ms/step"
PATTERN = "nccl"


def read(rec):
    if not reads(rec, "train_dp4") or not rec["work"]:
        return None
    tr = rec["trace"]
    ivs = tr.clipped(tr.device)
    nccl = [iv for iv in ivs if PATTERN in iv[2].lower()]
    if not nccl:
        return None
    others = [iv for iv in ivs if PATTERN not in iv[2].lower()]
    exposed = trace.covered(ivs) - trace.covered(others)
    return 1e3 * exposed / len(rec["work"])
