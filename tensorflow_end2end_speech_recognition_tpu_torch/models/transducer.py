"""RNN-Transducer model: encoder + prediction network + additive joint.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/
transducer.py``. ``TransducerModel``'s module tree mirrors
``init_transducer``'s parameter tree (``encoder``, ``embed`` [V+1, E],
``pred.<i>`` {``wx``, ``wh``, ``b``}, ``enc_proj``, ``pred_proj``, ``out``
{``w``, ``b``}), so weights cross with ``utils/bridge.py``. The encoder is
any ported encoder (the causal ``lstm`` stack runs kernel #3); the
prediction net is the plain ``lstm_scan`` with a carried ``(h, c)``, as the
JAX package runs it through the scan branch. Blank takes the last class
index (``blank_id == num_classes``) and doubles as the SOS token.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .ctc import Affine
from .encoders import Encoder, EncoderConfig
from .rnn import LSTMParams, dropout, lstm_scan


class TransducerConfig(NamedTuple):
    """Same fields and defaults as the JAX ``TransducerConfig``."""

    encoder: EncoderConfig
    num_classes: int
    pred_num_units: int = 256
    pred_num_layers: int = 1
    embedding_dim: int = 128
    joint_dim: int = 256
    parameter_init: float = 0.1
    pred_dropout_keep_prob: float = 1.0
    # greedy decode: symbols allowed per encoder frame before forcing blank
    max_symbols_per_frame: int = 4

    @property
    def vocab_with_blank(self) -> int:
        return self.num_classes + 1

    @property
    def blank_id(self) -> int:
        return self.num_classes


class TransducerOutput(NamedTuple):
    f_proj: torch.Tensor  # [B, T', J] encoder contribution to the joint
    enc_len: torch.Tensor  # [B]
    g_proj: torch.Tensor | None = None  # [B, U', J] prediction-net contribution
    decoded: torch.Tensor | None = None  # [B, T' * S] greedy ids, -1-padded
    dec_len: torch.Tensor | None = None  # [B]
    aux_loss: torch.Tensor | None = None  # MoE load-balance loss (weighted)


def pred_tokens(labels: torch.Tensor, blank_id: int) -> torch.Tensor:
    """Prediction-net input ``[SOS(blank), y_1 .. y_U]``, padded labels fed as blank."""
    sos = torch.full((labels.shape[0], 1), blank_id, dtype=labels.dtype, device=labels.device)
    return torch.cat([sos, torch.where(labels >= 0, labels, blank_id)], dim=1)


def pred_initial_states(cfg: TransducerConfig, batch_size: int, device=None):
    """Zero ``(h, c)`` per prediction-net layer."""
    zeros = lambda: torch.zeros((batch_size, cfg.pred_num_units), device=device)  # noqa: E731
    return [(zeros(), zeros()) for _ in range(cfg.pred_num_layers)]


class TransducerModel(nn.Module):
    """Weights uniform in +-parameter_init from ``generator`` (biases zero),
    as ``init_transducer`` draws them; move the model with ``.to(device)``."""

    def __init__(self, cfg: TransducerConfig, input_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        s = cfg.parameter_init
        self.encoder = Encoder(cfg.encoder, input_dim, generator)
        self.embed = nn.Parameter(
            (torch.rand((cfg.vocab_with_blank, cfg.embedding_dim), generator=generator) * 2.0
             - 1.0) * s)
        dims = [cfg.embedding_dim] + [cfg.pred_num_units] * (cfg.pred_num_layers - 1)
        self.pred = nn.ModuleList(LSTMParams(d, cfg.pred_num_units, s, generator) for d in dims)
        self.enc_proj = Affine(cfg.encoder.output_dim, cfg.joint_dim, s, generator)
        self.pred_proj = Affine(cfg.pred_num_units, cfg.joint_dim, s, generator)
        self.out = Affine(cfg.joint_dim, cfg.vocab_with_blank, s, generator)

    def encode(self, feats, feat_len, train: bool = False,
               generator: torch.Generator | None = None):
        """Features -> (joint-space encoder activations [B, T', J], lengths [B])."""
        return self._encode(feats, feat_len, train, generator)[:2]

    def _encode(self, feats, feat_len, train: bool = False,
                generator: torch.Generator | None = None):
        """``encode`` with the encoder's MoE load-balance loss (or None) third."""
        enc = self.encoder(feats, feat_len, train, generator)
        return self.enc_proj(enc.outputs), enc.lengths, enc.aux_loss

    def predict(self, tokens, initial_states=None, train: bool = False,
                generator: torch.Generator | None = None):
        """Prediction net over ``tokens`` [B, U'] (blank as SOS and padding):
        ``(g_proj [B, U', J], final (h, c) per layer)``. Every step is valid
        (no length mask), as the JAX ``predict`` runs it."""
        x = self.embed[tokens]
        keep = self.cfg.pred_dropout_keep_prob
        if train and generator is not None:
            x = dropout(x, keep, train, generator)
        states = []
        for i, layer in enumerate(self.pred):
            x, fin = lstm_scan(layer, x, initial_states[i] if initial_states is not None else None)
            states.append(fin)
            if train and generator is not None:
                x = dropout(x, keep, train, generator)
        return self.pred_proj(x), states

    def joint_logits(self, f_t, g_u):
        """One lattice node's logits: ``tanh(f + g) @ W_out + b``; f_t, g_u [..., J]."""
        return self.out(torch.tanh(f_t + g_u))

    def forward(self, feats, feat_len, tokens=None, train: bool = False,
                generator: torch.Generator | None = None, decode: bool = False):
        """Encoder, the prediction net over ``tokens`` (if given) and, with
        ``decode``, the greedy decode of the encoder output: one call, so a
        step can run them all on a dict of weights (``functional_call``)."""
        f_proj, enc_len, aux = self._encode(feats, feat_len, train, generator)
        g_proj = None if tokens is None else self.predict(tokens, train=train,
                                                          generator=generator)[0]
        if not decode:
            return TransducerOutput(f_proj, enc_len, g_proj, aux_loss=aux)
        from ..decoding.transducer_greedy import transducer_greedy_decode

        return TransducerOutput(f_proj, enc_len, g_proj,
                                *transducer_greedy_decode(self, f_proj, enc_len), aux_loss=aux)
