"""Plain CTC acoustic model: frontend, BLSTM stack, affine head, CTC loss.

The head reads the encoder's output (stored in the compute type) as
float32: ``logits = x @ W + b``. The loss is the batch mean of each
utterance's CTC negative log-likelihood (blank last), from a float64
log-softmax, plus ``weight_decay`` times half the squared norm of every
matrix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import blstm, frontend


def forward(p: dict, exp: dict, wav, samples, q, generator=None):
    """(logits [B, T', C+1] float32, lengths [B])."""
    feats, lengths = frontend.features(wav, samples, exp)
    x, lengths = blstm.encoder(feats, lengths, p, exp, q, generator)
    return x @ p["head.w"] + p["head.b"], lengths


def ctc_nll(logits, lengths, labels, label_len) -> torch.Tensor:
    """[B] negative log-likelihoods, blank the last class."""
    logp = torch.log_softmax(logits.double(), -1).transpose(0, 1)
    return F.ctc_loss(logp, labels.long().clamp(min=0), lengths.long(), label_len.long(),
                      blank=logits.shape[-1] - 1, reduction="none", zero_infinity=False)


def weight_decay(p: dict, coeff: float) -> torch.Tensor:
    if not coeff:
        return torch.zeros((), dtype=torch.float64, device=next(iter(p.values())).device)
    return coeff * sum(0.5 * v.double().square().sum() for v in p.values() if v.dim() >= 2)


def row_sum(p: dict, exp: dict, batch: dict, q, generator=None, step: int = 0) -> torch.Tensor:
    """The sum over ``batch``'s rows (device tensors) of each row's term of
    the objective: its CTC negative log-likelihood."""
    logits, lengths = forward(p, exp, batch["inputs"], batch["input_len"], q, generator)
    return ctc_nll(logits, lengths, batch["labels"], batch["label_len"]).sum()
