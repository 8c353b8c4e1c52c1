"""Block-kernel launches in one replay of the captured DCRNN train step,
all kernels summed: the program's counter ``models.dcrnn.COUNTS``
(``step_launches``, read from ``block_diffusion.LAUNCHES`` at capture).
None where the program has no such counter."""

from gwbench.layers import reads

UNIT = "launches/step"


def read(rec):
    if not reads(rec, "dcrnn_train"):
        return None
    launches = (rec.get("counters") or {}).get("step_launches")
    return float(sum(launches.values())) if launches else None
