"""Deterministic synthetic speech corpus (the toy corpus of the configs).

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/toy_corpus.py``
for the character and ``phone61`` label types: every unit is rendered as a
unit-specific chord of two sines of unit-specific duration, an utterance is
a run of such segments plus noise, and speakers differ by gain. The same
seed gives the same utterances, bit for bit, as the JAX package's corpus.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tokenizers import Tokenizer, build_tokenizer

SAMPLE_RATE = 16000
NOISE = 0.02  # std of the added white noise
NUM_SPEAKERS = 4  # speakers differ by gain


@dataclass
class Utterance:
    name: str
    wav: np.ndarray  # float32 [num_samples]
    label_ids: list
    text: str
    speaker: str | None = None


class ToyCorpus:
    def __init__(
        self,
        label_type: str = "phone61",
        num_utts: int = 128,
        min_units: int = 3,
        max_units: int = 10,
        seed: int = 0,
        vocab_size: int | None = None,  # restrict labels to the first N units
    ):
        self.label_type = label_type
        self.tokenizer: Tokenizer = build_tokenizer(label_type)
        rng = np.random.RandomState(seed)
        v = self.tokenizer.num_units
        draw_v = min(vocab_size, v) if vocab_size else v
        # unit-specific formant pairs spread over [200, 3800] Hz
        f1 = 200.0 + 3000.0 * rng.permutation(v) / max(v - 1, 1)
        f2 = 500.0 + 3300.0 * rng.permutation(v) / max(v - 1, 1)
        dur = rng.randint(int(0.06 * SAMPLE_RATE), int(0.12 * SAMPLE_RATE), size=v)
        self._unit_params = (f1, f2, dur)
        gains = 0.5 + rng.rand(NUM_SPEAKERS) * 1.5
        self.utterances: list[Utterance] = []
        for i in range(num_utts):
            n_units = rng.randint(min_units, max_units + 1)
            ids = rng.randint(0, draw_v, size=n_units).tolist()
            text = " ".join(self.tokenizer.units[j] for j in ids)
            wav = self._render(ids, rng)
            spk = i % NUM_SPEAKERS
            self.utterances.append(
                Utterance(f"toy{i:05d}", (wav * gains[spk]).astype(np.float32), ids, text,
                          speaker=f"spk{spk:02d}")
            )

    def _render(self, ids, rng) -> np.ndarray:
        f1, f2, dur = self._unit_params
        segs = []
        for j in ids:
            n = int(dur[j])
            t = np.arange(n) / SAMPLE_RATE
            env = np.hanning(n)
            segs.append(env * (0.6 * np.sin(2 * np.pi * f1[j] * t)
                               + 0.4 * np.sin(2 * np.pi * f2[j] * t)))
        wav = np.concatenate(segs) + NOISE * rng.randn(sum(int(dur[j]) for j in ids))
        return wav.astype(np.float32)
