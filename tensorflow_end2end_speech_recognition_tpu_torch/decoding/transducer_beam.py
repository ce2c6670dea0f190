"""RNN-T beam search (time-synchronous, batched, fixed shapes) on the device.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/decoding/
transducer_beam.py``, with the same split into ``beam_init``,
``beam_advance`` and ``beam_finalize`` (streaming drives ``beam_advance``
chunk by chunk). Per encoder frame the beam alternates label expansion and
blank commitment for up to ``max_symbols`` rounds:

- every live hypothesis proposes ``V`` label extensions (score += ``lp[k]``,
  the prediction net advances) and one blank commitment (score +=
  ``lp[blank]``; the hypothesis waits for the next frame);
- blank commitments merge into the next frame's pool by a running top-W;
  label extensions keep the top-W live set for the next round.

Tensors are [B, W, ...] throughout, parents gathered per round. Identical
prefixes are not merged: a transducer hypothesis's score is its own
alignment path. The top hypothesis's path score is at least greedy's
(greedy commits the first argmax blank; the beam scores every label run
ending in a blank).

Ties break as ``lax.top_k`` and ``jnp.argsort`` break them, the lower index
first (stable sorts, ``ctc_prefix_beam._top_k``). RNN-LM shallow fusion
(``fusion_lm``, a ``ctc_prefix_beam.FusionLM`` from
``models/lm.make_fusion_lm(lm, cfg.vocab_with_blank)``: both class layouts
put blank last) adds ``lm_weight * lm_logp[k]`` to label expansions only;
the LM state rides the beam as [B, W, H] leaves, gathered by parent and
advanced once per accepted label, so it carries across streaming chunks.
The search is plain PyTorch, as the JAX one is plain XLA; its frame loop
reads the frame count back once per call and runs no frame past it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.transducer import TransducerModel, pred_initial_states
from .ctc_prefix_beam import _top_k, tree_map

_NEG = -1e30


class TransducerBeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, W, L] int32, -1-padded, best first
    lengths: torch.Tensor  # [B, W] int32
    scores: torch.Tensor  # [B, W] log path probability (fused objective with an LM)


def _gather_beam(beam: dict, idx: torch.Tensor) -> dict:
    """Gather dim 1 by ``idx`` [B, W'] on every [B, W, ...] leaf."""

    def one(x):
        ix = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(*idx.shape, *x.shape[2:])
        return x.gather(1, ix)

    return tree_map(one, beam)


def _flat_pred_step(model: TransducerModel, states, tokens: torch.Tensor):
    """Advance the prediction net for [B, W] tokens; state leaves [B, W, H]."""
    b, w = tokens.shape
    flat = tree_map(lambda x: x.reshape(b * w, *x.shape[2:]), states)
    g, new = model.predict(tokens.reshape(b * w, 1).long(), initial_states=flat)
    unflat = lambda x: x.reshape(b, w, *x.shape[1:])  # noqa: E731
    return unflat(g[:, 0]), tree_map(unflat, new)


def beam_init(model: TransducerModel, batch_size: int, beam_width: int, max_len: int,
              fusion_lm=None, device=None) -> dict:
    """The initial beam: one live hypothesis (SOS consumed), the others dead.

    A dict of [B, W, ...] tensors (``score``, ``g``, ``states``, ``prefix``,
    ``plen``, and ``lm_state`` / ``lm_logp`` with ``fusion_lm``), so it can
    ride a stream's state across chunks; ``beam_advance`` must then get the
    same ``fusion_lm``.
    """
    cfg = model.cfg
    b, w = batch_size, beam_width
    sos = torch.full((b * w, 1), cfg.blank_id, dtype=torch.int64, device=device)
    g0, states0 = model.predict(sos, initial_states=pred_initial_states(cfg, b * w, device))
    unflat = lambda x: x.reshape(b, w, *x.shape[1:])  # noqa: E731
    score = torch.full((b, w), _NEG, dtype=torch.float32, device=device)
    score[:, 0] = 0.0
    beam = {
        "score": score,
        "g": unflat(g0[:, 0]),
        "states": tree_map(unflat, states0),
        "prefix": torch.full((b, w, max_len), -1, dtype=torch.int32, device=device),
        "plen": torch.zeros((b, w), dtype=torch.int32, device=device),
    }
    if fusion_lm is not None:
        beam["lm_state"], beam["lm_logp"] = fusion_lm.init(b, w)
    return beam


def beam_advance(model: TransducerModel, beam: dict, f_proj: torch.Tensor,
                 n_valid: torch.Tensor, max_symbols: int | None = None, fusion_lm=None,
                 lm_weight: float = 0.0) -> dict:
    """Advance the beam over the first ``n_valid`` [B] frames of ``f_proj``
    [B, F, J]; rows past their count keep the incoming beam bit for bit.

    With ``fusion_lm`` and a non-zero ``lm_weight`` (the beam built by
    ``beam_init(..., fusion_lm=...)``) ``score`` accumulates the fused
    objective, AM path + ``lm_weight`` * LM prefix.
    """
    cfg = model.cfg
    b, t, _ = f_proj.shape
    w = beam["score"].shape[1]
    s = max_symbols or cfg.max_symbols_per_frame
    max_len = beam["prefix"].shape[2]
    blank = cfg.blank_id
    v = cfg.vocab_with_blank - 1  # label classes
    use_lm = fusion_lm is not None and lm_weight
    if use_lm and "lm_logp" not in beam:
        raise ValueError("fusion_lm passed but the beam carries no LM state: build it with "
                         "beam_init(..., fusion_lm=...)")
    n_valid = n_valid.to(f_proj.device)
    for ti in range(min(t, int(n_valid.max()))):
        f_t = f_proj[:, ti, None, :]  # [B, 1, J]
        live, committed = beam, None
        # s expansion rounds need s + 1 blank scorings: a run of exactly s
        # labels still commits its terminating blank after the last one
        for r in range(s + 1):
            lp = torch.log_softmax(model.joint_logits(f_t, live["g"]), dim=-1)  # [B, W, V+1]
            blank_score = live["score"] + lp[..., blank]
            if committed is None:
                committed = {**live, "score": blank_score}
            else:
                pool = tree_map(lambda a, c: torch.cat([a, c], dim=1), committed,
                                {**live, "score": blank_score})
                committed = _gather_beam(pool, _top_k(pool["score"], w)[1])
            if r == s:
                break
            lab = live["score"][..., None] + lp[..., :blank]  # [B, W, V]
            if use_lm:
                lab = lab + lm_weight * live["lm_logp"][..., :blank]
            lab = torch.where((live["plen"] < max_len)[..., None], lab, _NEG)
            top_scores, flat_idx = _top_k(lab.reshape(b, w * v), w)
            parent = torch.div(flat_idx, v, rounding_mode="floor")
            token = (flat_idx % v).to(torch.int32)
            new_live = _gather_beam(live, parent)
            g_new, st_new = _flat_pred_step(model, new_live["states"], token)
            pos = new_live["plen"].clamp_max(max_len - 1).long()[..., None]
            live = {
                "score": top_scores,
                "g": g_new,
                "states": st_new,
                "prefix": new_live["prefix"].scatter(2, pos, token[..., None]),
                "plen": (new_live["plen"] + 1).clamp_max(max_len),
            }
            if use_lm:  # advance the LM once per accepted token
                live["lm_state"], live["lm_logp"] = fusion_lm.step(new_live["lm_state"], token)
            elif "lm_state" in beam:  # carried LM leaves at zero weight: gathered only
                live["lm_state"], live["lm_logp"] = new_live["lm_state"], new_live["lm_logp"]
        ok = (ti < n_valid).reshape(b, 1)
        beam = tree_map(lambda n, o: torch.where(ok.reshape(b, *([1] * (n.dim() - 1))), n, o),
                        committed, beam)
    return beam


def beam_finalize(beam: dict) -> TransducerBeamResult:
    """Hypotheses sorted best-first."""
    order = torch.argsort(-beam["score"], dim=1, stable=True)
    beam = _gather_beam(beam, order)
    return TransducerBeamResult(beam["prefix"], beam["plen"], beam["score"])


def transducer_beam_search(model: TransducerModel, f_proj: torch.Tensor, enc_len: torch.Tensor,
                           beam_width: int = 8, max_symbols: int | None = None,
                           max_len: int | None = None, fusion_lm=None,
                           lm_weight: float = 0.0) -> TransducerBeamResult:
    """Beam search over joint-space encoder activations ``f_proj`` [B, T, J].

    Returns the hypotheses best first; scores are log path probabilities, or
    the fused ``AM + lm_weight * LM`` objective with fusion (length
    normalisation is the caller's policy). ``max_len`` caps a hypothesis;
    the default ``T * max_symbols`` is greedy's output width.
    """
    b, t, _ = f_proj.shape
    s = max_symbols or model.cfg.max_symbols_per_frame
    beam = beam_init(model, b, beam_width, max_len or t * s, fusion_lm, f_proj.device)
    beam = beam_advance(model, beam, f_proj, enc_len, s, fusion_lm, lm_weight)
    return beam_finalize(beam)
