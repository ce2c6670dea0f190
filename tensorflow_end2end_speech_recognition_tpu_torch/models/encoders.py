"""BLSTM encoder stack.

Counterpart of the ``blstm`` branch of ``apply_encoder`` in
``tensorflow_end2end_speech_recognition_tpu/models/encoders.py``: a stack of
``BiLSTM`` layers over ``[B, T, D]`` with the true lengths carried alongside,
and, in training, dropout after every layer, the last one included. The JAX
package routes inputs longer than
T = 400 to its scan path because of TPU toolchain limits; the kernel here
runs at every T. Other encoder types and cell options raise
``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .rnn import BiLSTM, dropout


class EncoderConfig(NamedTuple):
    """The BLSTM-path fields of the JAX ``EncoderConfig``, same names and defaults."""

    encoder_type: str = "blstm"
    num_units: int = 256
    num_layers: int = 2
    num_proj: int | None = None
    use_peephole: bool = False
    clip_activation: float | None = None
    parameter_init: float = 0.1
    dropout_keep_prob: float = 1.0  # applied after every layer in training
    compute_dtype: str = "float32"

    @property
    def output_dim(self) -> int:
        return 2 * self.num_units


def check_supported(cfg: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.encoder_type != "blstm":
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


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, input_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        check_supported(cfg)
        dims = [input_dim] + [cfg.output_dim] * (cfg.num_layers - 1)
        self.layers = nn.ModuleList(
            BiLSTM(d, cfg.num_units, cfg.parameter_init, generator=generator) for d in dims
        )
        self.keep_prob = cfg.dropout_keep_prob

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        """[B, T, D] -> ([B, T, 2H], lengths).

        With ``train`` and a ``generator`` (on the inputs' device), each
        layer's output goes through dropout, as ``apply_encoder`` does when
        it is given an rng; without a generator no dropout is drawn.
        """
        for layer in self.layers:
            xs = layer(xs, lengths)
            if train and generator is not None:
                xs = dropout(xs, self.keep_prob, train, generator)
        return xs, lengths
