"""Acoustic frontend: framing, log-mel filterbank, deltas, CMVN.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/frontend/
features.py``. The window, DFT and mel projection are dense matrices built
once in numpy (the same ``_dft_mats`` / ``_mel_matrix`` construction), and
the pipeline is

    unfold (framing) -> matmul (cos DFT) / matmul (sin DFT) -> square-add
    -> matmul (mel) -> log [-> matmul (DCT): MFCC] -> deltas
    -> masked mean/var (CMVN)

The JAX package frames with ``_frame_blocks``, a reshape-and-slice that
avoids a slow TPU gather; here framing is ``Tensor.unfold``, a strided view.
All shapes follow the padded waveform; the number of valid frames is carried
separately as ``feat_len``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class FrontendConfig(NamedTuple):
    """Static frontend hyperparameters; same fields and defaults as the JAX one."""

    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_step_ms: float = 10.0
    num_mels: int = 40
    feature_type: str = "fbank"  # "fbank" | "mfcc" (reference `feature` key)
    num_ceps: int = 13  # MFCC coefficients kept after the DCT
    fft_length: int = 512
    preemphasis: float = 0.97
    use_energy: bool = True  # append log frame energy => num_mels + 1 dims
    window: str = "hamming"  # "hamming" | "hann" | "povey" | "rect"
    lower_edge_hz: float = 20.0
    upper_edge_hz: float | None = None  # default: nyquist - 400
    add_deltas: bool = True  # append delta + delta-delta (3x feature dim)
    delta_window: int = 2
    cmvn: str = "utterance"  # "utterance" | "speaker" | "none"; "speaker" is
    # mask-only here, as in the JAX frontend
    cmvn_var_norm: bool = True
    log_floor: float = 1e-10

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def frame_step(self) -> int:
        return int(self.sample_rate * self.frame_step_ms / 1000.0)

    @property
    def base_dim(self) -> int:
        n = self.num_ceps if self.feature_type == "mfcc" else self.num_mels
        return n + (1 if self.use_energy else 0)

    @property
    def feature_dim(self) -> int:
        return self.base_dim * (3 if self.add_deltas else 1)


def _window_fn(name: str, n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * t / (n - 1))
    if name == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * t / (n - 1))
    if name == "povey":
        return (0.5 - 0.5 * np.cos(2 * np.pi * t / (n - 1))) ** 0.85
    if name == "rect":
        return np.ones(n)
    raise ValueError(f"unknown window {name!r}")


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def _dft_mats(cfg: FrontendConfig):
    """Window-folded real-DFT matrices [frame_length, bins]: frames @ C, frames @ S."""
    n, nfft = cfg.frame_length, cfg.fft_length
    w = _window_fn(cfg.window, n)
    k = np.arange(nfft // 2 + 1)[None, :]
    t = np.arange(n)[:, None]
    ang = 2.0 * np.pi * t * k / nfft
    cos_m = (np.cos(ang) * w[:, None]).astype(np.float32)
    sin_m = (-np.sin(ang) * w[:, None]).astype(np.float32)
    return cos_m, sin_m


@functools.lru_cache(maxsize=None)
def _mel_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Triangular mel filterbank, [num_fft_bins, num_mels] (HTK-style)."""
    nfft, sr = cfg.fft_length, cfg.sample_rate
    bins = nfft // 2 + 1
    upper = cfg.upper_edge_hz if cfg.upper_edge_hz is not None else sr / 2.0 - 400.0
    mel_pts = np.linspace(_hz_to_mel(cfg.lower_edge_hz), _hz_to_mel(upper), cfg.num_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_hz = np.arange(bins) * sr / nfft
    fb = np.zeros((bins, cfg.num_mels), dtype=np.float64)
    for m in range(cfg.num_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_hz - left) / max(center - left, 1e-12)
        down = (right - bin_hz) / max(right - center, 1e-12)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_matrix(cfg: FrontendConfig) -> np.ndarray:
    """Orthonormal DCT-II matrix [num_mels, num_ceps] for MFCC."""
    n, k = cfg.num_mels, cfg.num_ceps
    mat = np.cos(np.pi / n * (np.arange(n)[:, None] + 0.5) * np.arange(k)[None, :])
    mat *= np.sqrt(2.0 / n)
    mat[:, 0] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_mats(cfg: FrontendConfig, device: torch.device):
    """(cos, sin, mel, DCT or None) matrices on ``device``, copied there once."""
    dct = _dct_matrix(cfg) if cfg.feature_type == "mfcc" else None
    return (*(torch.from_numpy(m).to(device) for m in (*_dft_mats(cfg), _mel_matrix(cfg))),
            None if dct is None else torch.from_numpy(dct).to(device))


def num_frames(num_samples: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Frame count for signals of ``num_samples`` valid samples."""
    return torch.clamp(1 + (num_samples - cfg.frame_length) // cfg.frame_step, min=0)


def frame_signal(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[..., N] samples -> [..., T, frame_length] overlapping frames (a view)."""
    if wav.shape[-1] < cfg.frame_length:
        raise ValueError(
            f"padded waveform length {wav.shape[-1]} is shorter than one frame "
            f"({cfg.frame_length} samples); pad batches to >= frame_length"
        )
    return wav.unfold(-1, cfg.frame_length, cfg.frame_step)


def preemphasize(wav: torch.Tensor, coeff: float, context=None) -> torch.Tensor:
    """x[t] - coeff*x[t-1]; x[0] uses itself (= (1-c)*x[0]), or ``context``
    [..., 1], the sample just before this buffer, when given (a streaming
    chunk: its first sample then preemphasizes as in the whole signal)."""
    if coeff == 0.0:
        return wav
    prev = wav[..., :1] if context is None else context
    first = wav[..., :1] - coeff * prev
    rest = wav[..., 1:] - coeff * wav[..., :-1]
    return torch.cat([first, rest], dim=-1)


def log_mel_spectrogram(wav: torch.Tensor, cfg: FrontendConfig,
                        preemph_context=None) -> torch.Tensor:
    """[..., N] float32 waveform -> [..., T, base_dim] log-mel or MFCC
    (+ log-energy)."""
    if cfg.feature_type not in ("fbank", "mfcc"):
        raise ValueError(f"unknown feature_type {cfg.feature_type!r}")
    wav = preemphasize(wav.to(torch.float32), cfg.preemphasis, preemph_context)
    frames = frame_signal(wav, cfg)
    cos_m, sin_m, mel_m, dct_m = _device_mats(cfg, wav.device)
    re = torch.matmul(frames, cos_m)
    im = torch.matmul(frames, sin_m)
    mel = torch.matmul(re * re + im * im, mel_m)
    logmel = torch.log(torch.clamp(mel, min=cfg.log_floor))
    if dct_m is not None:
        logmel = torch.matmul(logmel, dct_m)
    if cfg.use_energy:
        energy = torch.sum(frames * frames, dim=-1, keepdim=True)
        logmel = torch.cat([torch.log(torch.clamp(energy, min=cfg.log_floor)), logmel], dim=-1)
    return logmel


def add_deltas(feats: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Append regression delta and delta-delta along the feature axis.

    d_t = sum_k k*(x_{t+k} - x_{t-k}) / (2*sum k^2), edge-replicated in time.
    """
    denom = 2.0 * sum(k * k for k in range(1, window + 1))

    def delta(x):
        t = x.shape[-2]
        src = torch.clamp(torch.arange(-window, t + window, device=x.device), 0, t - 1)
        xp = x[..., src, :]
        out = torch.zeros_like(x)
        for k in range(1, window + 1):
            out = out + k * (xp[..., window + k : window + k + t, :]
                             - xp[..., window - k : window - k + t, :])
        return out / denom

    d1 = delta(feats)
    return torch.cat([feats, d1, delta(d1)], dim=-1)


def _frame_mask(feats: torch.Tensor, feat_len: torch.Tensor) -> torch.Tensor:
    t = feats.shape[-2]
    return (torch.arange(t, device=feats.device)[:, None]
            < feat_len[..., None, None]).to(feats.dtype)  # [..., T, 1]


def cmvn_utterance(feats: torch.Tensor, feat_len: torch.Tensor,
                   var_norm: bool = True) -> torch.Tensor:
    """Per-utterance mean (and variance) normalization over valid frames;
    padded frames are excluded from the statistics and zeroed on output."""
    mask = _frame_mask(feats, feat_len)
    denom = torch.clamp(mask.sum(dim=-2, keepdim=True), min=1.0)
    out = feats - (feats * mask).sum(dim=-2, keepdim=True) / denom
    if var_norm:
        var = ((out * mask) ** 2).sum(dim=-2, keepdim=True) / denom
        out = out * torch.rsqrt(var + 1e-8)
    return out * mask


def extract_features(wav: torch.Tensor, wav_len: torch.Tensor,
                     cfg: FrontendConfig = FrontendConfig(), preemph_context=None):
    """[..., N] waveform + valid-sample counts -> (feats [..., T, feature_dim], feat_len [...]).

    ``preemph_context`` [..., 1]: the sample before this buffer (a streaming
    chunk; see ``preemphasize``).
    """
    feats = log_mel_spectrogram(wav, cfg, preemph_context)
    feat_len = num_frames(wav_len, cfg)
    if cfg.add_deltas:
        feats = add_deltas(feats, cfg.delta_window)
    if cfg.cmvn == "utterance":
        return cmvn_utterance(feats, feat_len, cfg.cmvn_var_norm), feat_len
    return feats * _frame_mask(feats, feat_len), feat_len
