"""CTC acoustic model: encoder -> optional bottleneck -> affine head.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/models/ctc.py``
(``init_ctc`` / ``apply_ctc``). Logits are batch-major ``[B, T, C]`` and the
blank is the trailing class ``num_classes``. With ``num_classes_sub`` (a
multitask encoder) a second head, ``sub_head``, reads the encoder's tap and
gives the sub task's logits, its blank ``num_classes_sub``. The module tree
mirrors the JAX parameter pytree, so ``state_dict`` keys are its paths
joined by dots (``encoder.layers.0.fwd.wx``, ``head.w``; ``utils/bridge.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .encoders import Affine, Encoder, EncoderConfig


class CTCConfig(NamedTuple):
    encoder: EncoderConfig = EncoderConfig()
    num_classes: int = 61  # real units; blank is index num_classes
    bottleneck_dim: int | None = None
    num_classes_sub: int | None = None  # multitask: the sub head's real units

    @property
    def vocab_with_blank(self) -> int:
        return self.num_classes + 1

    @property
    def blank_id(self) -> int:
        return self.num_classes


class CTCOutput(NamedTuple):
    logits: torch.Tensor  # [B, T', num_classes+1]
    logit_len: torch.Tensor  # [B]
    aux_loss: torch.Tensor | None = None  # MoE load-balance loss (weighted)
    sub_logits: torch.Tensor | None = None  # [B, T', num_classes_sub+1], multitask
    sub_logit_len: torch.Tensor | None = None


class CTCModel(nn.Module):
    """Weights drawn uniform in +-parameter_init from ``generator`` (biases
    zero), as ``init_ctc`` draws them; move the model with ``.to(device)``."""

    def __init__(self, cfg: CTCConfig, input_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.num_classes_sub is not None and not cfg.encoder.is_multitask:
            raise ValueError("num_classes_sub requires a multitask_* encoder")
        self.cfg = cfg
        scale = cfg.encoder.parameter_init
        self.encoder = Encoder(cfg.encoder, input_dim, generator)
        head_in = cfg.encoder.output_dim
        if cfg.bottleneck_dim:
            self.bottleneck = Affine(head_in, cfg.bottleneck_dim, scale, generator)
            head_in = cfg.bottleneck_dim
        self.head = Affine(head_in, cfg.vocab_with_blank, scale, generator)
        if cfg.num_classes_sub is not None:
            self.sub_head = Affine(cfg.encoder.output_dim, cfg.num_classes_sub + 1, scale,
                                   generator)

    def project(self, enc_out: torch.Tensor) -> torch.Tensor:
        """Encoder outputs -> logits: the bottleneck, if any, then the head."""
        if self.cfg.bottleneck_dim:
            enc_out = self.bottleneck(enc_out)
        return self.head(enc_out)

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> CTCOutput:
        """``train`` and ``generator`` pass to the encoder's dropout (``apply_ctc``)."""
        enc = self.encoder(feats, feat_len, train, generator)
        sub = ((None, None) if self.cfg.num_classes_sub is None
               else (self.sub_head(enc.sub_outputs), enc.sub_lengths))
        return CTCOutput(self.project(enc.outputs), enc.lengths, enc.aux_loss, *sub)
