"""Joint CTC-attention rescoring of attention beams (Hori et al. 2017).

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/decoding/
joint_rescoring.py``: each of the B·W hypotheses gets the CTC
log-likelihood of the joint head, and the beam is re-ranked by

    (1 - λ) · logP_att + λ · logP_ctc + (raw - att)   (the LM term kept)

divided by the GNMT length norm ``((5 + len) / 6) ** length_penalty``. The
JAX function maps the loss-only CTC over the beam axis; here it is one call
of ``ops/ctc.ctc_loss(need_grad=False)`` on N = B·W rows (kernel #6 on the
card), each utterance's CTC logits repeated W times. A hypothesis may hold
the sos id, which equals the CTC blank, and one longer than its frames has
no alignment: its loss is floored at about 1e30, as in training.
"""

from __future__ import annotations

import torch

from ..ops.ctc import ctc_loss
from .attention_beam import BeamSearchResult


def joint_rescore(result: BeamSearchResult, ctc_weight: float, blank_id: int,
                  length_penalty: float = 0.0) -> BeamSearchResult:
    """Re-rank the attention beams by the joint CTC-attention score."""
    if result.ctc_logits is None:
        raise ValueError("beam result has no CTC head outputs; model is not joint")
    b, w, u = result.tokens.shape
    logits = result.ctc_logits.repeat_interleave(w, dim=0).contiguous()  # [B*W, T, C]
    ctc_lp = -ctc_loss(logits, result.ctc_logit_len.repeat_interleave(w),
                       result.tokens.reshape(b * w, u), result.lengths.reshape(b * w),
                       blank_id=blank_id, need_grad=False).reshape(b, w)
    # raw = att + lm_weight · logP_lm (attention_beam), so the difference is
    # the weighted LM term, which survives the re-ranking
    lm_term = result.raw_scores - result.att_scores
    joint = (1.0 - ctc_weight) * result.att_scores + ctc_weight * ctc_lp + lm_term
    norm = ((5.0 + result.lengths.to(torch.float32)) / 6.0) ** length_penalty
    final = joint / norm.clamp_min(1e-6)
    order = torch.argsort(-final, dim=1, stable=True)
    take = lambda x: x.gather(1, order)  # noqa: E731
    return result._replace(
        tokens=result.tokens.gather(1, order[..., None].expand_as(result.tokens)),
        lengths=take(result.lengths), scores=take(final), raw_scores=take(result.raw_scores),
        att_scores=take(result.att_scores),
    )
