"""LSTM, BLSTM, pyramidal BLSTM, conformer and transformer encoder stacks.

Counterpart of the ``lstm``, ``blstm``, ``pyramidal_blstm`` (alias
``pblstm``), ``conformer`` and ``transformer`` branches of ``apply_encoder``
in ``tensorflow_end2end_speech_recognition_tpu/models/encoders.py``: a stack
of ``LSTM`` (one direction, causal) or ``BiLSTM`` layers over ``[B, T, D]``
with the true lengths carried alongside, and, in training, dropout after
every layer, the last one included. The pyramidal stack concatenates
adjacent frame pairs after each of its first ``num_pyramid_levels`` layers
(by default all but the last), halving T and doubling the next layer's
input width (``_pyramid_reduce``). The JAX package routes inputs longer than
T = 400 to its scan path because of TPU toolchain limits; the kernels here
run at every T. The conformer and transformer types run ``conformer.
Conformer`` (parameters under ``conformer``), whose MoE load-balance loss
comes back as ``EncoderOutput.aux_loss`` when ``moe_experts > 1``. Other
encoder types (``vgg_lstm``, ``multitask_lstm``, ...) and cell options raise
``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .conformer import Conformer, ConformerSpec
from .rnn import LSTM, BiLSTM, dropout

PYRAMIDAL_TYPES = ("pyramidal_blstm", "pblstm")
CONFORMER_TYPES = ("conformer", "transformer")
PORTED_TYPES = ("lstm", "blstm") + PYRAMIDAL_TYPES + CONFORMER_TYPES


class EncoderConfig(NamedTuple):
    """The (B)LSTM, conformer and transformer fields of the JAX
    ``EncoderConfig``, same names and defaults."""

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
    # conformer / transformer (models/conformer.py)
    num_heads: int = 4
    conv_kernel_size: int = 15
    ff_expansion: int = 4
    depthwise_impl: str = "conv"  # "conv" | "shifts": the same function in the port
    moe_experts: int = 0  # > 1: each block's final FF is a top-k expert bank
    moe_top_k: int = 2
    moe_aux_weight: float = 1e-2
    pos_encoding: str = "absolute"  # "absolute" | "relative" | "rotary"
    left_context: int = -1  # >= 0: chunk-causal attention window and causal conv

    @property
    def bidirectional(self) -> bool:
        return self.encoder_type != "lstm"

    @property
    def is_conformer(self) -> bool:
        return self.encoder_type in CONFORMER_TYPES

    @property
    def output_dim(self) -> int:
        if self.is_conformer:
            return self.num_units
        return self.num_units * (2 if self.bidirectional else 1)

    def conformer_spec(self) -> ConformerSpec:
        return ConformerSpec(
            dim=self.num_units, num_layers=self.num_layers, num_heads=self.num_heads,
            conv_kernel_size=self.conv_kernel_size, ff_expansion=self.ff_expansion,
            compute_dtype=self.compute_dtype, block=self.encoder_type,
            depthwise_impl=self.depthwise_impl, moe_experts=self.moe_experts,
            moe_top_k=self.moe_top_k, moe_aux_weight=self.moe_aux_weight,
            pos_encoding=self.pos_encoding, left_context=self.left_context,
        )

    @property
    def is_pyramidal(self) -> bool:
        return self.encoder_type in PYRAMIDAL_TYPES

    def reduces_after(self, layer: int) -> bool:
        """Whether a pyramidal 2x time reduction follows ``layer`` (0-based)."""
        levels = (self.num_pyramid_levels if self.num_pyramid_levels is not None
                  else self.num_layers - 1)
        return self.is_pyramidal and layer < levels


class EncoderOutput(NamedTuple):
    outputs: torch.Tensor  # [B, T', H]
    lengths: torch.Tensor  # [B]
    aux_loss: torch.Tensor | None = None  # weighted MoE load-balance loss (moe_experts > 1)


def check_supported(cfg: EncoderConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.encoder_type not in PORTED_TYPES:
        raise NotImplementedError(f"encoder_type {cfg.encoder_type!r} is not ported yet")
    if cfg.is_conformer:
        cfg.conformer_spec().validate()
        return
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
        self.cfg = cfg
        self.keep_prob = cfg.dropout_keep_prob
        if cfg.is_conformer:
            self.conformer = Conformer(cfg.conformer_spec(), input_dim, generator)
            return
        dims, dim = [], input_dim
        for layer in range(cfg.num_layers):
            dims.append(dim)
            dim = cfg.output_dim * (2 if cfg.reduces_after(layer) else 1)
        layer = BiLSTM if cfg.bidirectional else LSTM
        self.layers = nn.ModuleList(
            layer(d, cfg.num_units, cfg.parameter_init, generator=generator) for d in dims
        )

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> EncoderOutput:
        """[B, T, D] -> ``EncoderOutput`` ([B, T', output_dim], lengths', aux);
        T' = T unless pyramidal.

        With ``train`` and a ``generator`` (on the inputs' device), dropout
        is drawn as ``apply_encoder`` draws it when it is given an rng (after
        each recurrent layer; at the conformer's four sites per layer);
        without a generator no dropout is drawn.
        """
        if self.cfg.is_conformer:
            out, aux = self.conformer(xs, lengths, train, generator, self.keep_prob)
            return EncoderOutput(out, lengths, aux)
        for i, layer in enumerate(self.layers):
            xs = layer(xs, lengths)
            if train and generator is not None:
                xs = dropout(xs, self.keep_prob, train, generator)
            if self.cfg.reduces_after(i):
                xs, lengths = _pyramid_reduce(xs, lengths)
        return EncoderOutput(xs, lengths)
