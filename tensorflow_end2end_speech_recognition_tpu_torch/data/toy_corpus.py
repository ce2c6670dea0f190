"""Deterministic synthetic speech corpus (the toy corpus of the configs).

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/toy_corpus.py``:
every unit is rendered as a unit-specific chord of two sines of
unit-specific duration, an utterance is a run of such segments plus noise,
and speakers differ by gain. Word and BPE units learn their vocabulary from
a fixed list of 40 words (``toy_tokenizer``); a word or subword unit lasts
as long as its characters, and BPE labels encode word sequences. The same
seed gives the same utterances, bit for bit, as the JAX package's corpus.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tokenizers import Tokenizer, build_tokenizer

SAMPLE_RATE = 16000
NOISE = 0.02  # std of the added white noise
NUM_SPEAKERS = 4  # speakers differ by gain
# the word list of the word and BPE label types, repeated 3 times in the
# learning text so BPE pair counts pass the >= 2 merge threshold
TOY_WORDS = [f"w{i:02d}" for i in range(40)]


@dataclass
class Utterance:
    name: str
    wav: np.ndarray  # float32 [num_samples]
    label_ids: list
    text: str
    sub_ids: list | None = None  # multitask sub-task labels (characters under phones)
    speaker: str | None = None


def learns_units(label_type: str) -> bool:
    """Whether the label type's units are learned from corpus text (words, BPE)."""
    return label_type.startswith(("word", "bpe"))


def toy_tokenizer(label_type: str) -> Tokenizer:
    """The tokenizer ``ToyCorpus(label_type)`` labels with."""
    if learns_units(label_type):
        return build_tokenizer(label_type, corpus_texts=[" ".join(TOY_WORDS * 3)])
    return build_tokenizer(label_type)


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
        self.tokenizer: Tokenizer = toy_tokenizer(label_type)
        rng = np.random.RandomState(seed)
        v = self.tokenizer.num_units
        draw_v = min(vocab_size, v) if vocab_size else v
        # unit-specific formant pairs spread over [200, 3800] Hz
        f1 = 200.0 + 3000.0 * rng.permutation(v) / max(v - 1, 1)
        f2 = 500.0 + 3300.0 * rng.permutation(v) / max(v - 1, 1)
        dur = rng.randint(int(0.06 * SAMPLE_RATE), int(0.12 * SAMPLE_RATE), size=v)
        if learns_units(label_type):
            # a word or subword unit is spoken over its characters (▁ excluded)
            dur = dur * np.array([max(1, len(u.lstrip("▁"))) for u in self.tokenizer.units])
        self._unit_params = (f1, f2, dur)
        gains = 0.5 + rng.rand(NUM_SPEAKERS) * 1.5
        self.utterances: list[Utterance] = []
        for i in range(num_utts):
            n_units = rng.randint(min_units, max_units + 1)
            if label_type.startswith("bpe"):  # BPE labels encode word sequences
                text = " ".join(TOY_WORDS[j] for j in rng.randint(0, len(TOY_WORDS),
                                                                   size=n_units))
                ids = self.tokenizer.encode_text(text)
            else:
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
