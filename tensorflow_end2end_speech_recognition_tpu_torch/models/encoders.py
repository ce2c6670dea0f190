"""LSTM, BLSTM and pyramidal BLSTM encoder stacks.

Counterpart of the ``lstm``, ``blstm`` and ``pyramidal_blstm`` (alias
``pblstm``) branches of ``apply_encoder`` in
``tensorflow_end2end_speech_recognition_tpu/models/encoders.py``: a stack of
``LSTM`` (one direction, causal) or ``BiLSTM`` layers over ``[B, T, D]``
with the true lengths carried alongside, and, in training, dropout after
every layer, the last one included. The pyramidal stack concatenates
adjacent frame pairs after each of its first ``num_pyramid_levels`` layers
(by default all but the last), halving T and doubling the next layer's
input width (``_pyramid_reduce``). The JAX package routes inputs longer than
T = 400 to its scan path because of TPU toolchain limits; the kernels here
run at every T. Other encoder types (``vgg_lstm``, ``multitask_lstm``, ...)
and cell options raise ``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .rnn import LSTM, BiLSTM, dropout

PYRAMIDAL_TYPES = ("pyramidal_blstm", "pblstm")
PORTED_TYPES = ("lstm", "blstm") + PYRAMIDAL_TYPES


class EncoderConfig(NamedTuple):
    """The (B)LSTM-path fields of the JAX ``EncoderConfig``, same names and defaults."""

    encoder_type: str = "blstm"
    num_units: int = 256
    num_layers: int = 2
    num_proj: int | None = None
    use_peephole: bool = False
    clip_activation: float | None = None
    parameter_init: float = 0.1
    dropout_keep_prob: float = 1.0  # applied after every layer in training
    num_pyramid_levels: int | None = None  # None: a reduction after all but the last layer
    compute_dtype: str = "float32"

    @property
    def bidirectional(self) -> bool:
        return self.encoder_type != "lstm"

    @property
    def output_dim(self) -> int:
        return self.num_units * (2 if self.bidirectional else 1)

    @property
    def is_pyramidal(self) -> bool:
        return self.encoder_type in PYRAMIDAL_TYPES

    def reduces_after(self, layer: int) -> bool:
        """Whether a pyramidal 2x time reduction follows ``layer`` (0-based)."""
        levels = (self.num_pyramid_levels if self.num_pyramid_levels is not None
                  else self.num_layers - 1)
        return self.is_pyramidal and layer < levels


def check_supported(cfg: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.encoder_type not in PORTED_TYPES:
        raise NotImplementedError(f"encoder_type {cfg.encoder_type!r} is not ported yet")
    for name, unset in (("num_proj", cfg.num_proj is None),
                        ("use_peephole", not cfg.use_peephole),
                        ("clip_activation", not cfg.clip_activation)):
        if not unset:
            raise NotImplementedError(f"LSTM option {name} is not ported yet")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {cfg.compute_dtype!r} is not ported yet (bf16 streams)"
        )


def _pyramid_reduce(xs: torch.Tensor, lengths: torch.Tensor):
    """Concat adjacent frame pairs: [B, T, H] -> [B, ceil(T/2), 2H].

    An odd T gains one zero frame; lengths become ``ceil(len / 2)`` and
    frames past them are zeroed, as ``_pyramid_reduce`` in the JAX package.
    """
    b, t, h = xs.shape
    if t % 2:
        xs = F.pad(xs, (0, 0, 0, 1))
        t += 1
    out = xs.reshape(b, t // 2, 2 * h)
    new_len = torch.div(lengths + 1, 2, rounding_mode="floor")
    mask = (torch.arange(t // 2, device=xs.device)[None, :]
            < new_len.to(xs.device)[:, None])[..., None]
    return out * mask, new_len


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, input_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        dims, dim = [], input_dim
        for layer in range(cfg.num_layers):
            dims.append(dim)
            dim = cfg.output_dim * (2 if cfg.reduces_after(layer) else 1)
        layer = BiLSTM if cfg.bidirectional else LSTM
        self.layers = nn.ModuleList(
            layer(d, cfg.num_units, cfg.parameter_init, generator=generator) for d in dims
        )
        self.cfg = cfg
        self.keep_prob = cfg.dropout_keep_prob

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        """[B, T, D] -> ([B, T', output_dim], lengths'); T' = T unless pyramidal.

        With ``train`` and a ``generator`` (on the inputs' device), each
        layer's output goes through dropout, as ``apply_encoder`` does when
        it is given an rng; without a generator no dropout is drawn.
        """
        for i, layer in enumerate(self.layers):
            xs = layer(xs, lengths)
            if train and generator is not None:
                xs = dropout(xs, self.keep_prob, train, generator)
            if self.cfg.reduces_after(i):
                xs, lengths = _pyramid_reduce(xs, lengths)
        return xs, lengths
