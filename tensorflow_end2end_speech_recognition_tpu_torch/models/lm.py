"""LSTM language model for shallow fusion in the beams.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/lm.py``:
an embedding, ``num_layers`` plain LSTM layers (``rnn.lstm_step``: the
reference's ``wx [D,4H]``, ``wh [H,4H]``, ``b [4H]`` and forget bias 1.0)
and an output affine over the label vocabulary, which includes the sos and
eos ids of the task it fuses with (sos = vocab - 2, eos = vocab - 1).
``RNNLM``'s module tree mirrors ``init_lm``'s parameter tree
(``embedding``, ``layers.i.{wx, wh, b}``, ``out.{w, b}``), so JAX weights
cross with ``utils/bridge.params_from_jax``. The state is a tuple of
``(h, c)`` per layer, so beam-parent gathers can reindex it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .ctc import Affine
from .rnn import LSTMParams, lstm_step


class LMConfig(NamedTuple):
    vocab: int  # includes the sos / eos ids of the task it fuses with
    num_units: int = 256
    embedding_dim: int = 128
    num_layers: int = 1

    @property
    def sos_id(self) -> int:  # the task convention: sos = vocab - 2, eos = vocab - 1
        return self.vocab - 2


class RNNLM(nn.Module):
    """Weights uniform in +-``scale`` from ``generator`` (biases zero), as
    ``init_lm`` draws them; ``forward`` is ``lm_sequence_nll``."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator | None = None,
                 scale: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(
            (torch.rand((cfg.vocab, cfg.embedding_dim), generator=generator) * 2.0 - 1.0) * scale)
        dims = [cfg.embedding_dim] + [cfg.num_units] * (cfg.num_layers - 1)
        self.layers = nn.ModuleList(LSTMParams(d, cfg.num_units, scale, generator) for d in dims)
        self.out = Affine(cfg.num_units, cfg.vocab, scale, generator)

    def forward(self, tokens, lengths):
        """Teacher-forced NLL per sequence [B], the ``<eos>`` step included."""
        return lm_sequence_nll(self, tokens, lengths, sos_id=self.cfg.sos_id)


def lm_init_state(cfg: LMConfig, batch: int, device=None):
    """Zero ``(h, c)`` per layer, each [batch, num_units]."""
    zeros = lambda: torch.zeros((batch, cfg.num_units), device=device)  # noqa: E731
    return tuple((zeros(), zeros()) for _ in range(cfg.num_layers))


def lm_step(lm: RNNLM, state, tokens: torch.Tensor):
    """Advance the LM by one token per row: ``(new_state, logp [B, vocab])``."""
    x = lm.embedding[tokens.long()]
    new_state = []
    for layer, carry in zip(lm.layers, state):
        carry = lstm_step(layer.wh, carry, torch.matmul(x, layer.wx) + layer.b)
        x = carry[0]
        new_state.append(carry)
    return tuple(new_state), torch.log_softmax(lm.out(x), dim=-1)


def _unroll(lm: RNNLM, inputs: torch.Tensor) -> torch.Tensor:
    """Log-probs after each input token from ``<sos>``'s zero state: [B, S, vocab]."""
    state = lm_init_state(lm.cfg, inputs.shape[0], inputs.device)
    logps = []
    for s in range(inputs.shape[1]):
        state, logp = lm_step(lm, state, inputs[:, s])
        logps.append(logp)
    return torch.stack(logps, dim=1)


def lm_prefix_logp(lm: RNNLM, prefixes: torch.Tensor, lengths: torch.Tensor, sos_id: int):
    """Next-token log-probs after each beam prefix: [B, W, L] -> [B, W, vocab].

    Runs the LM over every prefix from ``<sos>`` and reads the distribution
    at each prefix's length: the stateless hook of the CTC prefix beam
    (``lm_logp_fn``), O(L) LM steps per frame.
    """
    b, w, l_max = prefixes.shape
    flat = prefixes.reshape(b * w, l_max)
    inputs = torch.cat([torch.full_like(flat[:, :1], sos_id), flat.clamp_min(0)], dim=1)
    logps = _unroll(lm, inputs)  # [BW, L+1, V]
    idx = lengths.reshape(b * w).long()[:, None, None].expand(-1, 1, logps.shape[-1])
    return logps.gather(1, idx)[:, 0].reshape(b, w, lm.cfg.vocab)


def make_fusion_lm(lm: RNNLM, num_ctc_classes: int):
    """Carried-state shallow fusion for the CTC prefix beam.

    Maps the LM vocabulary (units + sos / eos) onto the CTC classes (units +
    a trailing blank): unit columns align and the blank column is 0 (blanks
    never extend a prefix, so it is never read). State leaves are [B, W, H],
    advanced once per accepted token from ``<sos>``: O(T) LM steps per
    utterance. Returns a ``decoding.ctc_prefix_beam.FusionLM``; raises
    ``ValueError`` unless the LM's units are the model's.
    """
    from ..decoding.ctc_prefix_beam import FusionLM  # decoding imports this module

    if lm.cfg.vocab != num_ctc_classes + 1:
        raise ValueError(
            f"the LM's vocabulary ({lm.cfg.vocab}) is not the CTC model's units plus sos and "
            f"eos ({num_ctc_classes - 1} + 2): it was trained for another label set")

    def map_vocab(logp, b, w):  # [B*W, V] -> [B, W, C]
        units = logp[:, : num_ctc_classes - 1]
        return torch.cat([units, torch.zeros_like(units[:, :1])], dim=-1).reshape(
            b, w, num_ctc_classes)

    def flatten(state, b, w):
        return tuple((h.reshape(b * w, -1), c.reshape(b * w, -1)) for h, c in state)

    def unflatten(state, b, w):
        return tuple((h.reshape(b, w, -1), c.reshape(b, w, -1)) for h, c in state)

    def init(b, w):
        dev = lm.embedding.device
        state = lm_init_state(lm.cfg, b * w, dev)
        state, logp = lm_step(lm, state, torch.full((b * w,), lm.cfg.sos_id, device=dev))
        return unflatten(state, b, w), map_vocab(logp, b, w)

    def step(state, tokens):  # tokens [B, W]
        b, w = tokens.shape
        state, logp = lm_step(lm, flatten(state, b, w), tokens.reshape(b * w))
        return unflatten(state, b, w), map_vocab(logp, b, w)

    return FusionLM(init=init, step=step)


def lm_sequence_nll(lm: RNNLM, tokens: torch.Tensor, lengths: torch.Tensor, sos_id: int,
                    eos_id: int | None = None) -> torch.Tensor:
    """Teacher-forced NLL per sequence [B], the ``<eos>`` step included.

    Targets ``l1..lU, <eos>`` under inputs ``<sos>, l1..lU``. The eos step
    must be supervised: fusion adds the LM's log-prob of eos too, and an LM
    that never saw eos as a target would penalise every ending hypothesis.
    """
    if eos_id is None:
        eos_id = sos_id + 1  # the task convention: sos = vocab - 2, eos = vocab - 1
    b, u = tokens.shape
    safe = tokens.clamp_min(0).long()
    logps = _unroll(lm, torch.cat([torch.full_like(safe[:, :1], sos_id), safe], dim=1))
    idx = torch.arange(u + 1, device=tokens.device)[None, :]
    lengths = lengths.long()[:, None]
    tgt = torch.where(idx < lengths, torch.nn.functional.pad(safe, (0, 1)), eos_id)
    nll = -logps.gather(2, tgt[..., None])[..., 0]
    return (nll * (idx <= lengths).to(nll.dtype)).sum(dim=-1)  # incl. the eos step
