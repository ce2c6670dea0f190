"""Batch mean, smoothed cross entropy, the joint λ mix and L2 weight decay.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/ops/losses.py``.
Parameters are a dict of tensors (``state_dict`` keys).
"""

from __future__ import annotations

import torch


def batch_mean(per_utt: torch.Tensor, weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over the batch; with ``weight``, the weighted mean (filler rows weigh 0)."""
    if weight is None:
        return per_utt.mean()
    w = weight.to(torch.float32)
    return (per_utt * w).sum() / w.sum().clamp_min(1.0)


def smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-utterance [B] mean over valid positions of the cross entropy of
    ``logits`` [B, U, V] against ``targets`` [B, U] (-1 on padding), with
    uniform label smoothing over the whole vocabulary (``-mean(logp)``)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = torch.where(targets >= 0, targets, 0).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(dim=-1)
    mask = mask.to(torch.float32)
    return (nll * mask).sum(dim=-1) / mask.sum(dim=-1).clamp_min(1.0)


def joint_loss(ctc_nll, att_nll, ctc_loss_weight: float):
    """λ·L_ctc + (1−λ)·L_att."""
    return ctc_loss_weight * ctc_nll + (1.0 - ctc_loss_weight) * att_nll


def l2_weight_decay(params: dict, coeff: float) -> torch.Tensor:
    """``coeff`` times the sum of ``0.5 * ||w||^2`` over weight matrices (no biases).

    Inside a train step whose leaves are split over model or expert ranks
    (``parallel.mesh.global_batch``) ``params`` holds this rank's blocks:
    their squares are summed over the axes that split them (*g*:
    ``parallel.tp.reduce_from``), so the value counts each element once and
    each block's gradient stays its own. A replicated leaf counts whole on
    every rank."""
    first = next(iter(params.values()))
    if coeff == 0.0:
        return first.new_zeros(())
    from ..parallel.mesh import DATA_AXIS, step_placement
    from ..parallel.tp import reduce_from

    mesh, specs = step_placement()
    total = first.new_zeros(())
    split = {}
    for k, leaf in params.items():
        if leaf.dim() < 2:
            continue
        axes = () if specs is None else tuple(a for a in specs[k] if a not in (None, DATA_AXIS))
        term = 0.5 * leaf.square().sum()
        axes = mesh.split_axes(axes)
        if axes:
            split[axes] = split.get(axes, first.new_zeros(())) + term
        else:
            total = total + term
    for axes in sorted(split):
        total = total + reduce_from(split[axes], mesh.along(*axes).group)
    return coeff * total
