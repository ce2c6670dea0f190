"""Plain log-mel frontend with deltas and per-utterance CMVN, then stacking.

The recipe of ``configs/ls100_ctc.yml`` (40 mel, no energy, Δ and ΔΔ, 3/3
stacking), on the padded batch: pre-emphasis 0.97 (the first sample against
itself), 25 ms Hamming frames every 10 ms, the power of a 512-point real
FFT, a triangular HTK mel bank from 20 Hz to 7600 Hz, log with a floor of
1e-10, regression deltas over ±2 frames replicated at the padded edges,
mean and variance normalised over each row's valid frames (1e-8 inside the
root) and zeroed past them; then frame t of the stack holds frames
3t .. 3t+2 (zeros past the end). All float32.
"""

from __future__ import annotations

import math

import torch

SAMPLE_RATE = 16000
FRAME, STEP, NFFT = 400, 160, 512
PREEMPHASIS = 0.97
LOG_FLOOR = 1e-10


def _mel(hz):
    return 2595.0 * math.log10(1.0 + hz / 700.0)


def mel_bank(num_mels: int, device) -> torch.Tensor:
    """[257, num_mels] triangles, evenly spaced on the mel scale."""
    lo, hi = _mel(20.0), _mel(SAMPLE_RATE / 2.0 - 400.0)
    pts = [lo + (hi - lo) * i / (num_mels + 1) for i in range(num_mels + 2)]
    hz = torch.tensor([700.0 * (10.0 ** (m / 2595.0) - 1.0) for m in pts], dtype=torch.float64)
    f = torch.arange(NFFT // 2 + 1, dtype=torch.float64) * SAMPLE_RATE / NFFT
    left, centre, right = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    rise = (f[None, :] - left) / (centre - left)
    fall = (right - f[None, :]) / (right - centre)
    return torch.clamp(torch.minimum(rise, fall), min=0.0).t().to(torch.float32).to(device)


def deltas(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """[B, T, F] -> Σ_k k (x[t+k] - x[t-k]) / (2 Σ k²), edges replicated."""
    t = x.shape[1]
    pad = torch.cat([x[:, :1].expand(-1, window, -1), x, x[:, -1:].expand(-1, window, -1)], 1)
    out = sum(k * (pad[:, window + k:window + k + t] - pad[:, window - k:window - k + t])
              for k in range(1, window + 1))
    return out / (2.0 * sum(k * k for k in range(1, window + 1)))


def features(wav: torch.Tensor, samples: torch.Tensor, exp: dict):
    """[B, N] waveforms, [B] valid samples -> (stacked features [B, T', D], T' lengths)."""
    x = wav.to(torch.float32)
    x = torch.cat([x[:, :1] * (1.0 - PREEMPHASIS), x[:, 1:] - PREEMPHASIS * x[:, :-1]], 1)
    frames = x.unfold(1, FRAME, STEP)  # [B, T, 400]
    n = torch.arange(FRAME, dtype=torch.float64, device=x.device)
    window = (0.54 - 0.46 * torch.cos(2 * math.pi * n / (FRAME - 1))).to(torch.float32)
    spec = torch.fft.rfft(frames * window, n=NFFT)
    power = spec.real.square() + spec.imag.square()
    feats = torch.log(torch.clamp(power @ mel_bank(exp.get("input_size", 40), x.device),
                                  min=LOG_FLOOR))
    if exp.get("use_energy", True):
        energy = torch.log(torch.clamp(frames.square().sum(-1, keepdim=True), min=LOG_FLOOR))
        feats = torch.cat([energy, feats], -1)
    if exp.get("use_delta", True):
        d1 = deltas(feats)
        feats = torch.cat([feats, d1, deltas(d1)], -1)
    length = torch.clamp(1 + (samples.to(x.device).long() - FRAME) // STEP, min=0)
    valid = (torch.arange(feats.shape[1], device=x.device)[None, :]
             < length[:, None]).to(torch.float32)[..., None]
    count = valid.sum(1, keepdim=True).clamp(min=1.0)
    centred = feats - (feats * valid).sum(1, keepdim=True) / count
    var = (centred * valid).square().sum(1, keepdim=True) / count
    feats = centred * torch.rsqrt(var + 1e-8) * valid
    stack, skip = exp.get("num_stack", 1), exp.get("num_skip", 1)
    b, t, d = feats.shape
    t_out = -(-t // skip)
    feats = torch.nn.functional.pad(feats, (0, 0, 0, max(t_out * skip + stack - t, 0)))
    idx = torch.arange(t_out, device=x.device)[:, None] * skip + torch.arange(stack,
                                                                              device=x.device)
    return feats[:, idx].reshape(b, t_out, stack * d), -(-length // skip)
