"""What the per-layer metrics read from a traced run's record. Each metric's
file in ``portbench/metrics/`` names its reader; a reader that finds
nothing to read returns None, and the run leaves that metric out."""

from __future__ import annotations

from portbench import work
from portbench.trace import busy, kernel_seconds, launches


def launches_per_step(rec: dict):
    """Card launches (kernels; copies and fills left out) per train step."""
    trace, steps = rec.get("trace"), len(rec.get("ran", ()))
    if trace is None or not steps or not trace["kernels"]:
        return None
    return launches(trace) / steps


def idle_share(rec: dict):
    """Per cent of the traced window in which no operation ran on the card."""
    trace = rec.get("trace")
    if trace is None or not trace["kernels"]:
        return None
    on, window = busy(trace)
    return 100.0 * (1.0 - on / window)


def walk_roofline(rec: dict, backward: bool):
    """The walks' (#1 ``fwd_walk``, or #2 ``bwd_walk``) work over their
    profiled time, as a share of the roofline: the steps' valid frames in a
    train step, the inference calls' in serving (no cell-state stream)."""
    trace = rec.get("trace")
    seconds = kernel_seconds(trace, "bwd_walk" if backward else "fwd_walk") if trace else 0.0
    if not seconds:
        return None
    if rec.get("serving"):
        rows = [lens for _, lens in rec.get("infer_calls", ())]
    else:
        rows = [rec["batches"][i][0] for i in rec.get("ran", ())]
    if not rows:
        return None
    ops = nbytes = 0.0
    for lens in rows:
        o, b = work.walk_work(rec["exp"], lens, backward=backward,
                              training=not rec.get("serving"))
        ops, nbytes = ops + o, nbytes + b
    return work.roofline_share(ops, nbytes, seconds, work.PEAK_TF32_FLOPS)


def fwd_walk_roofline(rec: dict):
    return walk_roofline(rec, backward=False)


def bwd_walk_roofline(rec: dict):
    return walk_roofline(rec, backward=True)


def train_mfu(rec: dict):
    """The window's model operations (``work.train_step_ops``) over its time,
    on each card, against the bf16 dense peak."""
    if not rec.get("ran") or rec.get("trace") is None:
        return None
    ops = sum(work.train_step_ops(rec["exp"], rec["num_classes"], *rec["batches"][i])
              for i in rec["ran"])
    return work.mfu(ops, rec["elapsed_s"])
