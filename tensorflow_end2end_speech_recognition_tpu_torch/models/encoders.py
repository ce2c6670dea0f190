"""The encoder zoo: (B)LSTM, (B)GRU, pyramidal, VGG, multitask, ``cnn_zhang``,
conformer and transformer encoders.

Counterpart of every branch of ``apply_encoder`` in
``tensorflow_end2end_speech_recognition_tpu/models/encoders.py``: a stack of
recurrent layers over ``[B, T, D]`` with the true lengths carried alongside
(``lstm``, ``gru`` and the ``vgg_lstm`` / ``multitask_lstm`` types one
direction, causal; ``blstm``, ``bgru`` and the rest both), and, in
training, dropout after every layer, the last one included. The plain LSTM
cell runs on the kernels (``BiLSTM`` / ``LSTM``); GRU, and the LSTM with a
peephole, a projection ``num_proj`` or a cell clip (each read by truth: 0
is off), run the scan path (``ScanBiRNN`` / ``ScanRNN``), as the reference
does at every backend; a projection makes each direction ``num_proj`` wide.
The pyramidal stack concatenates adjacent frame pairs after each of its
first ``num_pyramid_levels`` layers (by default all but the last), halving
T and doubling the next layer's input width (``_pyramid_reduce``). The VGG
types put two blocks of two 3x3 SAME convolutions (64, 64 then 128, 128
channels, ReLU) and a 2x2 SAME max-pool before the stack, over the features
split into ``input_channels`` planes ``[static | delta | delta-delta]``:
time and frequency shrink 4x, and the stack reads ``ceil(F / 4) * 128``
features per frame. ``cnn_zhang`` has no recurrence: four 5x3 (time x
frequency) SAME convolutions of 128, 128, 256 and 256 channels with ReLU,
a 1x2 max-pool over frequency after the second and the fourth, then a
stack of ``fc_units`` dense layers on each frame (ReLU between them; in
training dropout after each, the last one included); T is kept. The
multitask types also return the output of layer ``num_layers_sub`` (after
its dropout) for the sub head. The JAX package routes inputs longer than
T = 400 to its scan path because of TPU toolchain limits; the kernels here
run at every T. The conformer and transformer types run
``conformer.Conformer`` (parameters under ``conformer``), whose MoE
load-balance loss comes back as ``EncoderOutput.aux_loss`` when
``moe_experts > 1``. ``compute_dtype: bfloat16`` runs every type in the
reference's bf16 mode: the kernels' LSTM layers with bf16 streams (bf16
outputs, which the pyramid's reduction, the dropout and the multitask tap
keep; the VGG stack stays float32 and the first BLSTM rounds its output),
the option LSTM with bf16 ``h @ Wh`` products and float32 outputs, the
conformer's products with bf16 inputs; GRU and ``cnn_zhang`` cast nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .conformer import Conformer, ConformerSpec
from .rnn import LSTM, BiLSTM, RNNSpec, ScanBiRNN, ScanRNN, dropout

PYRAMIDAL_TYPES = ("pyramidal_blstm", "pblstm")
CONFORMER_TYPES = ("conformer", "transformer")
VGG_TYPES = ("vgg_blstm", "vgg_lstm")
MULTITASK_TYPES = ("multitask_blstm", "multitask_lstm")
BIDIRECTIONAL_TYPES = ("blstm", "bgru", "vgg_blstm", "multitask_blstm") + PYRAMIDAL_TYPES
ENCODER_TYPES = (("lstm", "blstm", "gru", "bgru") + PYRAMIDAL_TYPES + VGG_TYPES
                 + ("cnn_zhang",) + MULTITASK_TYPES + CONFORMER_TYPES)
VGG_CHANNELS = ((64, 64), (128, 128))  # two conv-conv-pool blocks
ZHANG_CHANNELS = (128, 128, 256, 256)  # cnn_zhang: a frequency pool after every second


class EncoderConfig(NamedTuple):
    """The one-device fields of the JAX ``EncoderConfig`` and its pipeline
    microbatches, same names and defaults."""

    encoder_type: str = "blstm"
    num_units: int = 256
    num_layers: int = 2
    num_proj: int | None = None
    use_peephole: bool = False
    clip_activation: float | None = None
    parameter_init: float = 0.1
    dropout_keep_prob: float = 1.0  # applied after every layer in training
    num_layers_sub: int = 1  # multitask: the layer (1-based) whose output feeds the sub head
    num_pyramid_levels: int | None = None  # None: a reduction after all but the last layer
    input_channels: int = 3  # VGG, cnn_zhang: feature planes (static, delta, delta-delta)
    fc_units: tuple = (1024,)  # cnn_zhang: the dense layers' widths
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
    # pipeline stages (parallel/pp.py; the train step's mesh places them): the
    # microbatches a stage runs its layers over
    pipeline_microbatches: int = 8

    @property
    def bidirectional(self) -> bool:
        return self.encoder_type in BIDIRECTIONAL_TYPES

    @property
    def cell(self) -> str:
        return "gru" if "gru" in self.encoder_type else "lstm"

    @property
    def is_cnn(self) -> bool:
        return self.encoder_type == "cnn_zhang"

    @property
    def has_vgg(self) -> bool:
        return self.encoder_type in VGG_TYPES

    @property
    def is_multitask(self) -> bool:
        return self.encoder_type in MULTITASK_TYPES

    @property
    def is_conformer(self) -> bool:
        return self.encoder_type in CONFORMER_TYPES

    @property
    def output_dim(self) -> int:
        if self.is_cnn:
            return self.fc_units[-1]
        if self.is_conformer:
            return self.num_units
        return self.spec().out_dim * (2 if self.bidirectional else 1)

    def spec(self) -> RNNSpec:
        return RNNSpec(cell=self.cell, num_units=self.num_units, num_proj=self.num_proj,
                       use_peephole=self.use_peephole, clip_activation=self.clip_activation,
                       compute_dtype=self.compute_dtype)

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
    sub_outputs: torch.Tensor | None = None  # multitask: layer num_layers_sub's output
    sub_lengths: torch.Tensor | None = None


def check_supported(cfg: EncoderConfig) -> None:
    """Raise ``ValueError`` for an encoder type or compute dtype that does not exist."""
    if cfg.encoder_type not in ENCODER_TYPES:
        raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}; expected one of "
                         f"{ENCODER_TYPES}")
    if cfg.is_conformer:
        cfg.conformer_spec().validate()
        return
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 or bfloat16")


class Conv2d(nn.Module):
    """A SAME convolution (3x3, or ``kernel`` time x frequency, odd) with the
    JAX layout: w [kt, kf, cin, cout] (HWIO), b [cout]; He-normal weights and
    zero biases, as ``_conv_init`` draws them."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator | None = None,
                 kernel: tuple = (3, 3)):
        super().__init__()
        kt, kf = kernel
        self.w = nn.Parameter(torch.randn((kt, kf, cin, cout), generator=generator)
                              * math.sqrt(2.0 / (kt * kf * cin)))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T, F] -> [B, cout, T, F]."""
        kt, kf = self.w.shape[:2]
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b, padding=(kt // 2, kf // 2))


class Affine(nn.Module):
    """x @ w + b with the JAX layout w [D, O], b [O]; a bf16 ``x`` (a bf16
    encoder's output) is upcast first, as JAX promotes it in ``_affine``:
    the output is float32."""

    def __init__(self, din: int, dout: int, scale: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w = nn.Parameter((torch.rand((din, dout), generator=generator) * 2.0 - 1.0) * scale)
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.to(self.w.dtype), self.w) + self.b


def split_freq_channels(xs: torch.Tensor, channels: int) -> torch.Tensor:
    """[B, T, C*F] laid out ``[static | delta | delta-delta]`` -> [B, C, T, F]
    (``_split_freq_channels`` there gives the same planes as [B, T, F, C])."""
    b, t, d = xs.shape
    if d % channels:
        raise ValueError(f"feature dim {d} not divisible by {channels} channels")
    return xs.reshape(b, t, channels, d // channels).transpose(1, 2)


def vgg_output_dim(input_dim: int, channels: int) -> int:
    """Features per frame after the VGG blocks: ceil(F / 4) * 128."""
    return -(-(input_dim // channels) // 4) * VGG_CHANNELS[-1][-1]


class VGG(nn.ModuleList):
    """``_apply_vgg``: two blocks of conv-ReLU, conv-ReLU, 2x2 max-pool."""

    def __init__(self, cin: int, generator: torch.Generator | None = None):
        blocks = []
        for block in VGG_CHANNELS:
            convs = []
            for cout in block:
                convs.append(Conv2d(cin, cout, generator))
                cin = cout
            blocks.append(nn.ModuleList(convs))
        super().__init__(blocks)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        """[B, C, T, F] -> ([B, ceil(T/4), ceil(F/4) * 128], ceil(lengths / 4)).

        The SAME pool pads -inf on the high side of an odd size, as
        ``ceil_mode`` does; the flatten runs over (frequency, channel) with
        the channel fastest, and only the frames past the new lengths are
        zeroed, after the last pool (pad frames reach valid ones through the
        convolutions, as in the JAX encoder).
        """
        for block in self:
            for conv in block:
                x = torch.relu(conv(x))
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        b, c, t, f = x.shape
        out = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
        out_len = torch.div(lengths + 3, 4, rounding_mode="floor")
        mask = (torch.arange(t, device=x.device)[None, :]
                < out_len.to(x.device)[:, None])[..., None]
        return out * mask, out_len


def zhang_output_dim(input_dim: int, channels: int) -> int:
    """Features per frame after ``cnn_zhang``'s convolutions: F halved (ceil)
    twice, times 256 channels."""
    freq = input_dim // channels
    for _ in range(len(ZHANG_CHANNELS) // 2):
        freq = -(-freq // 2)
    return freq * ZHANG_CHANNELS[-1]


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
        if cfg.is_cnn:
            cin, convs = cfg.input_channels, []
            for cout in ZHANG_CHANNELS:
                convs.append(Conv2d(cin, cout, generator, kernel=(5, 3)))
                cin = cout
            self.convs = nn.ModuleList(convs)
            dims = (zhang_output_dim(input_dim, cfg.input_channels),) + tuple(cfg.fc_units)
            self.fcs = nn.ModuleList(Affine(d, w, cfg.parameter_init, generator)
                                     for d, w in zip(dims, cfg.fc_units))
            return
        dim = input_dim
        if cfg.has_vgg:
            self.vgg = VGG(cfg.input_channels, generator)
            dim = vgg_output_dim(input_dim, cfg.input_channels)
        dims = []
        for layer in range(cfg.num_layers):
            dims.append(dim)
            dim = cfg.output_dim * (2 if cfg.reduces_after(layer) else 1)
        spec = cfg.spec()
        if spec.on_kernels:
            layer = BiLSTM if cfg.bidirectional else LSTM
            layers = (layer(d, cfg.num_units, cfg.parameter_init, generator=generator,
                            compute_dtype=cfg.compute_dtype) for d in dims)
        else:  # GRU or the LSTM options: the scan path
            layer = ScanBiRNN if cfg.bidirectional else ScanRNN
            layers = (layer(spec, d, cfg.parameter_init, generator) for d in dims)
        self.layers = nn.ModuleList(layers)

    def _cnn_zhang(self, xs: torch.Tensor, lengths: torch.Tensor, train: bool,
                   generator: torch.Generator | None) -> EncoderOutput:
        """``cnn_zhang``: convolutions with frequency pools, then the dense stack
        per frame; frames past the lengths zeroed at the end."""
        x = split_freq_channels(xs.float(), self.cfg.input_channels)
        for i, conv in enumerate(self.convs):
            x = torch.relu(conv(x))
            if i % 2 == 1:  # a SAME 1x2 pool over frequency only
                x = F.max_pool2d(x, (1, 2), (1, 2), ceil_mode=True)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)  # (frequency, channel), channel fastest
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = torch.relu(x)
            if train and generator is not None:
                x = dropout(x, self.keep_prob, train, generator)
        mask = (torch.arange(t, device=x.device)[None, :]
                < lengths.to(x.device)[:, None])[..., None]
        return EncoderOutput(x * mask, lengths)

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> EncoderOutput:
        """[B, T, D] -> ``EncoderOutput`` ([B, T', output_dim], lengths', aux,
        and for the multitask types the tap and its lengths); T' = T unless
        pyramidal or VGG.

        With ``train`` and a ``generator`` (on the inputs' device), dropout
        is drawn as ``apply_encoder`` draws it when it is given an rng (after
        each recurrent or dense layer; at the conformer's four sites per
        layer); without a generator no dropout is drawn.
        """
        if self.cfg.is_conformer:
            out, aux = self.conformer(xs, lengths, train, generator, self.keep_prob,
                                      self.cfg.pipeline_microbatches)
            return EncoderOutput(out, lengths, aux)
        if self.cfg.is_cnn:
            return self._cnn_zhang(xs, lengths, train, generator)
        if self.cfg.has_vgg:
            xs, lengths = self.vgg(split_freq_channels(xs, self.cfg.input_channels), lengths)
        sub_outputs = sub_lengths = None
        for i, layer in enumerate(self.layers):
            xs = layer(xs, lengths)
            if train and generator is not None:
                xs = dropout(xs, self.keep_prob, train, generator)
            if self.cfg.is_multitask and i + 1 == self.cfg.num_layers_sub:
                sub_outputs, sub_lengths = xs, lengths
            if self.cfg.reduces_after(i):
                xs, lengths = _pyramid_reduce(xs, lengths)
        return EncoderOutput(xs, lengths, None, sub_outputs, sub_lengths)
