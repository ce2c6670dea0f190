"""Attention scorers: content / location / hybrid / dot-product / Luong family.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/
attention.py``: ``Attention`` holds the parameters ``init_attention`` makes
for each ``attention_type`` under the same names (``w_dec``, ``v``, ``b``,
``w_enc``, ``conv`` [W, 1, C], ``w_loc``, ``w_gen``), ``precompute_keys``
hoists the encoder projection out of the decoder loop, and ``attend`` is one
read. With ``fused=True`` a location or hybrid scorer without sigmoid
smoothing (``Attention.fused_read``) goes through
``ops.attention.location_attend`` (kernel #7 on the card, its plain version
on the CPU), which adds the bias ``b`` to the keys itself, in the JAX
package's order ``((keys + b) + loc) + q``, and can serve ``group`` rows per
utterance from one copy of the encoder output (the beam's rows); every
other read is the unfused arithmetic, in the JAX order of additions, on one
encoder row per decoder row.

A bf16 ``enc_out`` (``compute_dtype: bfloat16``) is widened to float32
where the JAX package's products promote it: the keys' projection, the
dot-product scores and the unfused context. Each read widens it anew, so
that autograd sums a decoder unroll's per-step bf16 gradients into the bf16
``enc_out``, as the transpose of the reference's scan does; the fused read
hands the bf16 rows to kernel #7.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..ops.attention import conv_same, location_attend

ATTENTION_TYPES = (
    "content", "location", "hybrid", "dot_product", "scaled_dot",
    "luong_dot", "luong_general", "luong_concat",
)
_NEG = -1e30


class AttentionConfig(NamedTuple):
    attention_type: str = "hybrid"
    attention_dim: int = 128
    conv_num_channels: int = 10
    conv_width: int = 101  # centred conv over the previous alignment
    sharpening_factor: float = 1.0
    sigmoid_smoothing: bool = False

    @property
    def uses_content(self) -> bool:
        return self.attention_type in ("content", "hybrid")

    @property
    def uses_location(self) -> bool:
        return self.attention_type in ("location", "hybrid")

    @property
    def additive(self) -> bool:
        return self.attention_type in ("content", "location", "hybrid", "luong_concat")


class Attention(nn.Module):
    """Weights uniform in +-``scale`` (``b`` zero), as ``init_attention`` draws them."""

    def __init__(self, cfg: AttentionConfig, enc_dim: int, dec_dim: int, scale: float = 0.1,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.attention_type not in ATTENTION_TYPES:
            raise ValueError(
                f"unknown attention_type {cfg.attention_type!r}; expected {ATTENTION_TYPES}")
        self.cfg = cfg

        def uniform(*shape):
            return nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * scale)

        a = cfg.attention_dim
        if cfg.additive:
            self.w_dec = uniform(dec_dim, a)
            self.v = uniform(a)
            self.b = nn.Parameter(torch.zeros(a))
            if cfg.uses_content or cfg.attention_type == "luong_concat":
                self.w_enc = uniform(enc_dim, a)
            if cfg.uses_location:
                self.conv = uniform(cfg.conv_width, 1, cfg.conv_num_channels)
                self.w_loc = uniform(cfg.conv_num_channels, a)
        elif cfg.attention_type == "luong_general" or dec_dim != enc_dim:
            # dot-product scorers with unequal widths get the JAX fix-up matrix
            self.w_gen = uniform(dec_dim, enc_dim)

    def precompute_keys(self, enc_out: torch.Tensor) -> torch.Tensor:
        """Per-utterance encoder projection, hoisted out of the decoder loop."""
        if self.cfg.additive and hasattr(self, "w_enc"):
            return torch.matmul(enc_out.float(), self.w_enc)
        return enc_out

    @property
    def fused_read(self) -> bool:
        """Whether ``attend(fused=True)`` takes kernel #7 (which also serves
        grouped rows), rather than the unfused arithmetic."""
        return self.cfg.uses_location and not self.cfg.sigmoid_smoothing

    def attend(self, enc_out, enc_keys, enc_mask, dec_state, prev_align, fused: bool = False,
               group: int = 1):
        """One read: ``(context [N, He], align [N, T])``.

        ``enc_out`` [U, T, He], ``enc_keys`` from ``precompute_keys``,
        ``enc_mask`` [U, T] bool, ``dec_state`` [N, Hd], ``prev_align``
        [N, T], with N = U * ``group``: row n reads utterance n // group.
        ``group > 1`` needs the fused read.
        """
        cfg = self.cfg
        if fused and self.fused_read:
            q = torch.matmul(dec_state, self.w_dec)
            return location_attend(enc_keys if cfg.uses_content else None, enc_out, q,
                                   prev_align.contiguous(), enc_mask, self.conv, self.w_loc,
                                   self.v, cfg.sharpening_factor, b=self.b, group=group)
        if group != 1:
            raise ValueError(f"attend: group={group} needs the fused read; the "
                             f"{cfg.attention_type!r} scorer here takes one encoder row per "
                             "decoder row")
        if cfg.additive:
            pre = self.b
            if hasattr(self, "w_enc"):
                pre = pre + enc_keys  # [B, T, A]
            q = torch.matmul(dec_state, self.w_dec)
            pre = pre + q[:, None, :]
            if cfg.uses_location:
                pre = pre + torch.matmul(conv_same(prev_align, self.conv), self.w_loc)
            energies = torch.matmul(torch.tanh(pre), self.v)
        else:
            q = dec_state
            if hasattr(self, "w_gen"):
                q = torch.matmul(q, self.w_gen)
            energies = torch.bmm(enc_out.float(), q[:, :, None])[..., 0]
            if cfg.attention_type == "scaled_dot":
                energies = energies / math.sqrt(enc_out.shape[-1])
        energies = torch.where(enc_mask, energies * cfg.sharpening_factor, _NEG)
        if cfg.sigmoid_smoothing:
            sig = torch.sigmoid(energies) * enc_mask
            align = sig / sig.sum(dim=-1, keepdim=True).clamp_min(1e-8)
        else:
            align = torch.softmax(energies, dim=-1)
        context = torch.bmm(align[:, None, :], enc_out.float())[:, 0]
        return context, align
