"""Batched attention beam search, with optional RNN-LM shallow fusion.

Counterpart of ``attention_beam_search`` in
``tensorflow_end2end_speech_recognition_tpu/decoding/attention_beam.py``:
beams are folded into the batch (``B*W`` rows), every step is one batched
decoder step, a top-k over ``W*V`` candidates per utterance picks the
survivors, and the parent rows of ``(h, c, context, align)``, the scores,
lengths and token history are gathered after it. Finished beams extend only by EOS at zero cost; EOS
is stripped from the final lengths and history, and the ranking uses the
GNMT length normalisation ``score / ((5 + len) / 6) ** length_penalty``.

The JAX search repeats each utterance's encoder output, keys and mask W
times. A scorer with the fused read (``Attention.fused_read``: location or
hybrid) keeps them at B rows and reads them in groups of W decoder rows
(kernel #7's ``group``), so its keys are projected and read once per
utterance; every other scorer takes the repeated copies, as in JAX.

Ties are broken as ``jax.lax.top_k`` and ``jnp.argsort`` break them: the
lower index first (stable sorts). The loop checks "all finished" on the
host once every ``decode_unroll_factor(max_len)`` steps, as the JAX
``while_loop`` runs that many steps per iteration; steps past the
all-finished point change nothing. Shallow fusion adds ``lm_weight`` times
an RNN-LM's log-probs (``models/lm.lm_step`` on the B·W tokens of each
step, its state gathered by the parent rows like the decoder's) to the
beam score; ``att_scores`` keep the attention log-probs alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.lm import RNNLM, lm_init_state, lm_step
from ..models.seq2seq import (
    EncodeOutput,
    Seq2SeqModel,
    _decoder_step,
    _init_decoder_carry,
    decode_unroll_factor,
    enc_mask_of,
    encode,
)

_NEG = -1e30


class BeamSearchResult(NamedTuple):
    tokens: torch.Tensor  # [B, W, U] int32, -1 padded, best first
    lengths: torch.Tensor  # [B, W] int32
    scores: torch.Tensor  # [B, W] length-normalised total scores
    raw_scores: torch.Tensor  # [B, W] unnormalised log-prob sums
    att_scores: torch.Tensor  # [B, W] attention-only log-prob sums
    ctc_logits: torch.Tensor | None = None  # joint head outputs, for rescoring
    ctc_logit_len: torch.Tensor | None = None
    steps: int = 0  # decoder steps run (the port's own count)


def attention_beam_search(model: Seq2SeqModel, feats, feat_len, beam_width: int = 4,
                          length_penalty: float = 0.0, lm: RNNLM | None = None,
                          lm_weight: float = 0.0,
                          precomputed: EncodeOutput | None = None) -> BeamSearchResult:
    """Beam search to ``max_decode_length``; ``precomputed`` is ``encode``'s
    result, to share one encoder pass. ``lm`` with a non-zero ``lm_weight``
    fuses the RNN-LM (its vocabulary is the decoder's) into the scores."""
    cfg = model.cfg
    b, w, v = feats.shape[0], beam_width, cfg.vocab
    if lm is not None and lm.cfg.vocab != v:
        raise ValueError(f"the LM's vocabulary ({lm.cfg.vocab}) is not the decoder's ({v}): "
                         "it was trained for another label set")
    max_len = cfg.max_decode_length
    k = decode_unroll_factor(max_len)

    enc = precomputed if precomputed is not None else encode(model, feats, feat_len)
    # decoder row n reads encoder row n // group. Valid at every step because
    # a survivor's parent is a beam of its own utterance (flat_parent below
    # stays in [row_base, row_base + w)), so row n always belongs to
    # utterance n // w
    group = w if model.attention.fused_read else 1
    enc_out, enc_len = enc.outputs, enc.lengths
    if group == 1:  # [B*W, T, He]
        enc_out, enc_len = (x.repeat_interleave(w, dim=0) for x in (enc_out, enc_len))
    enc_keys = model.attention.precompute_keys(enc_out)
    enc_mask = enc_mask_of(enc_out, enc_len)
    dev = enc_out.device

    carry = _init_decoder_carry(cfg, b * w, enc_out)  # flat [B*W, ...]
    scores = torch.full((b, w), _NEG, device=dev)
    scores[:, 0] = 0.0
    att_scores = torch.zeros((b, w), device=dev)
    tokens = torch.full((b * w,), cfg.sos_id, dtype=torch.int32, device=dev)
    finished = torch.zeros((b, w), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b, w), dtype=torch.int32, device=dev)
    history = torch.full((b, w, max_len), -1, dtype=torch.int32, device=dev)
    eos_only = torch.full((v,), _NEG, device=dev)
    eos_only[cfg.eos_id] = 0.0
    row_base = (torch.arange(b, device=dev) * w)[:, None]
    use_lm = lm is not None and lm_weight != 0.0
    lm_state = lm_init_state(lm.cfg, b * w, dev) if use_lm else ()

    si = 0
    while si < max_len and (si == 0 or not bool(finished.all())):
        for _ in range(k):
            carry, logits = _decoder_step(model, enc_out, enc_keys, enc_mask, carry, tokens,
                                          group=group)
            logp = torch.log_softmax(logits, dim=-1).reshape(b, w, v)
            # finished beams: only the EOS continuation, at zero cost
            att_step = torch.where(finished[..., None], eos_only, logp)
            step_scores = att_step
            if use_lm:
                lm_state, lm_lp = lm_step(lm, lm_state, tokens)
                step_scores = torch.where(finished[..., None], eos_only,
                                          logp + lm_weight * lm_lp.reshape(b, w, v))
            flat = (scores[..., None] + step_scores).reshape(b, w * v)
            # top-k with the lower index first on ties, as lax.top_k
            new_scores, sel = torch.sort(flat, dim=1, descending=True, stable=True)
            new_scores, sel = new_scores[:, :w], sel[:, :w]
            parent = torch.div(sel, v, rounding_mode="floor")
            tok = (sel % v).to(torch.int32)
            flat_parent = (parent + row_base).reshape(-1)
            carry = tuple(x[flat_parent] for x in carry)
            lm_state = tuple((h[flat_parent], c[flat_parent]) for h, c in lm_state)
            att_tok = att_step.reshape(b, w * v).gather(1, sel)  # (parent, token) pairs
            att_scores = att_scores.gather(1, parent) + att_tok
            was_finished = finished.gather(1, parent)
            finished = was_finished | (tok == cfg.eos_id)
            lengths = lengths.gather(1, parent) + (~was_finished).to(torch.int32)
            history = history.gather(1, parent[..., None].expand(b, w, max_len))
            history[:, :, si] = torch.where(was_finished, history[:, :, si], tok)
            scores, tokens = new_scores, tok.reshape(-1)
            si += 1

    # strip the EOS token from lengths where it was emitted
    is_eos = history == cfg.eos_id
    out_len = lengths - is_eos.any(dim=-1).to(torch.int32)
    history = torch.where(is_eos, -1, history)
    norm = ((5.0 + out_len.to(torch.float32)) / 6.0) ** length_penalty
    final = scores / norm.clamp_min(1e-6)
    order = torch.argsort(-final, dim=1, stable=True)
    take = lambda x: x.gather(1, order)  # noqa: E731
    return BeamSearchResult(
        tokens=history.gather(1, order[..., None].expand_as(history)),
        lengths=take(out_len), scores=take(final), raw_scores=take(scores),
        att_scores=take(att_scores), ctc_logits=enc.ctc_logits,
        ctc_logit_len=enc.ctc_logit_len, steps=si,
    )
