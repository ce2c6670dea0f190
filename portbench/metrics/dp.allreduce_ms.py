"""Card time of the collectives (nccl kernels) per step on rank 0, in the
traced window: the data-parallel exchange of ``parallel/mesh``."""

from portbench.trace import kernel_seconds


def read(rec: dict):
    trace, steps = rec.get("trace"), len(rec.get("ran", ()))
    if trace is None or not steps or rec.get("world", 1) < 2:
        return None
    seconds = kernel_seconds(trace, "nccl")
    return 1e3 * seconds / steps if seconds else None
