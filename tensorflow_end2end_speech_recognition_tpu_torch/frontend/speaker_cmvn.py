"""Per-speaker CMVN: corpus-level speaker statistics + batch application.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/frontend/
speaker_cmvn.py``. The speaker statistics are computed once per run: a
waveform corpus goes through ``extract_features`` with CMVN off, batch by
batch on ``device`` (the card unless the caller asks for the CPU); a
precomputed-feature corpus accumulates its stored frames. Sums accumulate
in float64 on the host. Each batch then carries its rows' (mean, inv-std)
(``batch_cmvn_rows``), and ``train/ctc_task.device_pipeline`` normalizes
with them on the device.
"""

from __future__ import annotations

import numpy as np
import torch

GLOBAL_KEY = "<global>"  # fallback stats for utterances without a speaker id


def compute_speaker_stats(utterances, frontend_cfg=None, batch_size: int = 16,
                          device="cuda") -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """{speaker: (mean [D], inv_std [D])} float32, plus a ``GLOBAL_KEY`` row
    holding the whole corpus's statistics.

    ``frontend_cfg`` set: utterances carry waveforms, whose features are
    extracted on ``device`` with CMVN off (fill rows skipped).
    ``frontend_cfg`` None: utterances carry [T, D] features already.
    """
    sums: dict[str, np.ndarray] = {}
    sqs: dict[str, np.ndarray] = {}
    counts: dict[str, int] = {}

    def accumulate(speaker, frames: np.ndarray):
        s = speaker or GLOBAL_KEY
        f = frames.astype(np.float64)
        if s not in sums:
            sums[s] = f.sum(0)
            sqs[s] = (f * f).sum(0)
            counts[s] = f.shape[0]
        else:
            sums[s] += f.sum(0)
            sqs[s] += (f * f).sum(0)
            counts[s] += f.shape[0]

    if frontend_cfg is None:
        for u in utterances:
            accumulate(u.speaker, u.wav)
    else:
        from ..data.dataset import Dataset
        from .features import extract_features

        cfg = frontend_cfg._replace(cmvn="none")
        by_name = {u.name: u for u in utterances}
        for batch in Dataset(utterances, batch_size, sort_utt=True).batches(0):
            with torch.no_grad():
                feats, feat_len = extract_features(
                    torch.from_numpy(batch["inputs"]).to(device),
                    torch.from_numpy(batch["input_len"]).to(device), cfg)
            feats, feat_len = feats.cpu().numpy(), feat_len.cpu().numpy()
            for i, name in enumerate(batch["names"]):
                if name is None:  # a fill row repeating an earlier utterance
                    continue
                accumulate(by_name[name].speaker, feats[i, : feat_len[i]])

    g_sum = np.zeros_like(next(iter(sums.values())))
    g_sq = np.zeros_like(g_sum)
    g_n = 0
    for s in sums:
        g_sum += sums[s]
        g_sq += sqs[s]
        g_n += counts[s]
    # GLOBAL_KEY holds the whole corpus's statistics even where speakerless
    # rows accumulated under it: unseen speakers fall back to it
    stats: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for s in list(sums) + [GLOBAL_KEY]:
        total, sq, n = (g_sum, g_sq, g_n) if s == GLOBAL_KEY else (sums[s], sqs[s], counts[s])
        mean = total / max(n, 1)
        var = np.maximum(sq / max(n, 1) - mean * mean, 0.0)
        stats[s] = (mean.astype(np.float32), (1.0 / np.sqrt(var + 1e-8)).astype(np.float32))
    return stats


def batch_cmvn_rows(stats, utterances) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-utterance (mean, inv_std) rows -> ([B, D], [B, D])."""
    means, inv_stds = [], []
    for u in utterances:
        key = u.speaker if u.speaker in stats else GLOBAL_KEY
        m, r = stats[key]
        means.append(m)
        inv_stds.append(r)
    return np.stack(means), np.stack(inv_stds)
