"""SpecAugment-style feature masking on the device.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/frontend/
augment.py``: ``num_freq_masks`` frequency bands of width up to
``freq_mask_width`` and ``num_time_masks`` time spans of width up to
``time_mask_frac`` of each row's valid length are zeroed. The work is split
in two: ``draw_masks`` draws each mask's ``[B]`` widths and starts from a
``torch.Generator`` on the features' device (frequency masks first, then
time masks; width before start), with the reference's bounds, and
``keep_mask`` builds the ``[B, T, D]`` keep mask from the draws. The draws
cannot equal ``jax.random``'s; given the same draws the mask is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpecAugmentConfig(NamedTuple):
    freq_mask_width: int = 8
    num_freq_masks: int = 2
    time_mask_frac: float = 0.05  # each time mask <= frac * valid length
    num_time_masks: int = 2


class MaskDraws(NamedTuple):
    """Per-mask draws, int64: frequency masks [num_freq_masks, B], time masks [num_time_masks, B]."""

    freq_width: torch.Tensor
    freq_start: torch.Tensor
    time_width: torch.Tensor
    time_start: torch.Tensor


def draw_masks(feat_len: torch.Tensor, feat_dim: int, cfg: SpecAugmentConfig,
               generator: torch.Generator) -> MaskDraws:
    """The widths and starts of every mask, drawn from ``generator`` (on
    ``feat_len``'s device).

    Frequency: width uniform in [0, F], start uniform in [0, max(D - F, 0)]
    (so a band can reach the top bin). Time: max_w = max(floor(len · frac), 1),
    width = floor(u · (max_w + 1)) and start = floor(u · max(len - width + 1, 1))
    for uniform u, so a mask lands on valid frames.
    """
    dev, b = feat_len.device, feat_len.shape[0]
    fw, fs, tw, ts = [], [], [], []
    for _ in range(cfg.num_freq_masks):
        fw.append(torch.randint(0, cfg.freq_mask_width + 1, (b,), generator=generator, device=dev))
        fs.append(torch.randint(0, max(feat_dim - cfg.freq_mask_width, 0) + 1, (b,),
                                generator=generator, device=dev))
    max_w = (feat_len.to(torch.float32) * cfg.time_mask_frac).to(torch.int32).clamp_min(1)
    for _ in range(cfg.num_time_masks):
        u = torch.rand((b,), generator=generator, device=dev)
        width = torch.floor(u * (max_w + 1).to(torch.float32)).to(torch.int64)
        lo = (feat_len - width + 1).clamp_min(1).to(torch.float32)
        u = torch.rand((b,), generator=generator, device=dev)
        tw.append(width)
        ts.append(torch.floor(u * lo).to(torch.int64))

    def stack(xs):
        return torch.stack(xs) if xs else torch.zeros((0, b), dtype=torch.int64, device=dev)

    return MaskDraws(stack(fw), stack(fs), stack(tw), stack(ts))


def keep_mask(draws: MaskDraws, t: int, d: int) -> torch.Tensor:
    """[B, T, D] float32: 0 inside any drawn band or span, else 1."""
    dev = draws.freq_width.device
    freq = torch.arange(d, device=dev)[None, None, :]  # [1, 1, D]
    time = torch.arange(t, device=dev)[None, :, None]  # [1, T, 1]
    b = draws.freq_width.shape[1]
    masked = torch.zeros((b, t, d), dtype=torch.bool, device=dev)
    for width, start in zip(draws.freq_width, draws.freq_start):
        start = start[:, None, None]
        masked = masked | ((freq >= start) & (freq < start + width[:, None, None]))
    for width, start in zip(draws.time_width, draws.time_start):
        start = start[:, None, None]
        masked = masked | ((time >= start) & (time < start + width[:, None, None]))
    return (~masked).to(torch.float32)


def spec_augment(feats: torch.Tensor, feat_len: torch.Tensor, generator: torch.Generator,
                 cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """feats [B, T, D], feat_len [B] -> the masked features."""
    _, t, d = feats.shape
    return feats * keep_mask(draw_masks(feat_len, d, cfg, generator), t, d).to(feats.dtype)
