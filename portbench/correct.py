"""The numbers that decide ``correct``, each read against the plain reference.

Training (the first three steps of the timed object, on the timed batches):

- ``loss_gap``: the largest relative gap between a step's loss and the
  reference's.
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  first clipped gradient as the program's Adam received it (its first moment
  after one step, over 1 - 0.9) and the reference's, over the larger of
  the reference leaf's norm and the median leaf's.
- ``change_gap``: the same for the norm of each leaf's change over the three
  steps, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (their change is round-off under Adam).

Serving (greedy CTC): ``token_gap``, over a sample of the finished requests
drawn from the seed with the longest among them, the widest gap by which a
served token's reference logit lies below the reference's best in its
frame, along the alignment of the served ids that keeps that gap least;
``lost``, the requests due in the window that never got an answer.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

NOUGHT = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    names = [k for k in ref if keep(k)]
    median = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in names)


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"loss": [..], "grad1": {leaf: norm}, "delta": {leaf: norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]) or not all(map(math.isfinite, prog["loss"])):
        loss = math.inf
    g_median = statistics.median(ref["grad1"].values())
    moving = lambda k: ref["grad1"][k] >= NOUGHT * g_median  # noqa: E731
    return {"loss_gap": loss,
            "grad_gap": _leaf_gap(prog["grad1"], ref["grad1"], lambda k: True),
            "change_gap": _leaf_gap(prog["delta"], ref["delta"], moving)}


def served_gap(logits: np.ndarray, length: int, ids, blank: int) -> float:
    """Least over CTC alignments of ``ids`` (collapsed, no blanks) to the
    first ``length`` frames of ``logits`` [T, C] of the widest per-frame gap
    ``max logit - logit of the aligned class``; inf when none fits."""
    x = np.asarray(logits[:length], np.float64)
    gap = x.max(1, keepdims=True) - x  # [T, C]
    ids = [int(i) for i in ids]
    ext = [blank]
    for i in ids:
        ext += [i, blank]
    ext = np.asarray(ext)
    s = len(ext)
    if length == 0:
        return 0.0 if not ids else math.inf
    skip = np.zeros(s, bool)  # may enter state j from j - 2
    skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    cost = np.full(s, math.inf)
    cost[0] = gap[0, ext[0]]
    if s > 1:
        cost[1] = gap[0, ext[1]]
    for t in range(1, length):
        best = cost.copy()
        best[1:] = np.minimum(best[1:], cost[:-1])
        best[2:] = np.where(skip[2:], np.minimum(best[2:], cost[:-2]), best[2:])
        cost = np.maximum(best, gap[t, ext])
    return float(min(cost[-1], cost[-2] if s > 1 else math.inf))
