"""Batch mean of per-utterance losses and L2 weight decay.

Counterpart of ``batch_mean`` and ``l2_weight_decay`` in
``tensorflow_end2end_speech_recognition_tpu/ops/losses.py``. Parameters are
a dict of tensors (``state_dict`` keys).
"""

from __future__ import annotations

import torch


def batch_mean(per_utt: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over the batch; with ``weight``, the weighted mean (filler rows weigh 0)."""
    if weight is None:
        return per_utt.mean()
    w = weight.to(torch.float32)
    return (per_utt * w).sum() / w.sum().clamp_min(1.0)


def l2_weight_decay(params: dict, coeff: float) -> torch.Tensor:
    """``coeff`` times the sum of ``0.5 * ||w||^2`` over weight matrices (no biases)."""
    first = next(iter(params.values()))
    if coeff == 0.0:
        return first.new_zeros(())
    total = first.new_zeros(())
    for leaf in params.values():
        if leaf.dim() >= 2:
            total = total + 0.5 * leaf.square().sum()
    return coeff * total
