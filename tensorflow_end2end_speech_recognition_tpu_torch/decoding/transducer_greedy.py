"""RNN-T greedy decoding (frame-synchronous best path) on the device.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/decoding/
transducer_greedy.py``, with the JAX loop's static shape: on every encoder
frame, ``max_symbols_per_frame`` inner steps each take the joint's argmax
(the first maximum, as ``jnp.argmax``), emit it unless it is blank or an
earlier step of the frame stopped (``active = emit``), and advance the
prediction net only on the rows that emit (a ``torch.where`` on g and on
every ``(h, c)``). The [B, T' * S] emission grid is compacted with
``compact_rows``. A frame costs S prediction-net steps of small launches
each, so the decode is bound by the host's enqueue.
"""

from __future__ import annotations

import torch

from ..models.transducer import TransducerModel, pred_initial_states
from .ctc_greedy import compact_rows


def _pred_step(model: TransducerModel, states, token):
    """Advance the prediction net one token. token: [B] -> (g [B, J], states)."""
    g, new_states = model.predict(token[:, None], initial_states=states)
    return g[:, 0], new_states


def _where_state(emit, new, old):
    pick = emit[:, None]
    return [(torch.where(pick, hn, ho), torch.where(pick, cn, co))
            for (hn, cn), (ho, co) in zip(new, old)]


def decoder_init(model: TransducerModel, batch_size: int, device=None):
    """Initial (g, prediction states): the SOS (blank) step."""
    cfg = model.cfg
    token = torch.full((batch_size,), cfg.blank_id, dtype=torch.int64, device=device)
    return _pred_step(model, pred_initial_states(cfg, batch_size, device), token)


def decode_frame(model: TransducerModel, carry, f_t, frame_ok, max_symbols: int | None = None):
    """One frame's emissions. carry = (g, states); f_t [B, J]; frame_ok [B] bool.

    Returns (carry, emitted [B, S] int32 with -1 in non-emitting slots).
    """
    cfg = model.cfg
    s = max_symbols or cfg.max_symbols_per_frame
    g, states = carry
    blank = cfg.blank_id
    active = frame_ok
    emits = []
    for _ in range(s):
        k = torch.argmax(model.joint_logits(f_t, g), dim=-1)
        emit = active & (k != blank)
        g_new, st_new = _pred_step(model, states, torch.where(emit, k, blank))
        g = torch.where(emit[:, None], g_new, g)
        states = _where_state(emit, st_new, states)
        emits.append(torch.where(emit, k, -1).to(torch.int32))
        active = emit
    return (g, states), torch.stack(emits, dim=-1)


def transducer_greedy_decode(model: TransducerModel, f_proj, enc_len,
                             max_symbols: int | None = None):
    """[B, T', J] joint-space encoder activations -> (-1-padded ids [B, T' * S]
    int32, lengths [B] int32); lengths count the symbols emitted per row."""
    b, t, _ = f_proj.shape
    carry = decoder_init(model, b, f_proj.device)
    frame_ok = torch.arange(t, device=f_proj.device)[:, None] < enc_len.to(f_proj.device)[None, :]
    em = []
    for i in range(t):
        carry, e = decode_frame(model, carry, f_proj[:, i], frame_ok[i], max_symbols)
        em.append(e)
    em = torch.stack(em, dim=1).reshape(b, -1)  # [B, T' * S]
    return compact_rows(em, em >= 0)
