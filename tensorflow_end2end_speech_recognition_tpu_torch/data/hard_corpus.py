"""Discriminative synthetic corpus (``toy_profile: hard`` and ``harder``).

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/hard_corpus.py``:
20 letter-units in 10 minimal pairs that differ only by a small F2 ratio
(``confusability``), formants that glide between segments, per-speaker
formant scale, gain and channel tilt, per-utterance speaking rate and SNR,
and transcripts that are sequences of pseudo-words from a seeded lexicon
(word, BPE and character labels encode the words; phone and kana labels map
letter i to unit i). ``max_utt_seconds`` splits a long script at its
inter-word pause midpoints. The same arguments give the same utterances,
bit for bit, as the JAX package's corpus.
"""

from __future__ import annotations

import numpy as np

from .tokenizers import Tokenizer, build_tokenizer
from .toy_corpus import Utterance

_ALPHABET = list("abcdefghijklmnopqrst")  # 20 letters = 10 confusable pairs


def _make_lexicon(rng: np.random.RandomState, num_words: int = 50) -> list[str]:
    """Deterministic pseudo-word lexicon over the 20-letter alphabet."""
    words, seen = [], set()
    while len(words) < num_words:
        n = rng.randint(2, 7)  # 2-6 letters
        w = "".join(_ALPHABET[j] for j in rng.randint(0, len(_ALPHABET), size=n))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def lexicon_tokenizer(label_type: str, lexicon: list[str]) -> Tokenizer:
    """The tokenizer of a hard corpus over ``lexicon``: word and BPE units
    learn from the lexicon, repeated so BPE pair counts pass the >= 2 merge
    threshold and ``word_freqN`` thresholds admit every lexicon word."""
    if label_type.startswith(("word", "bpe")):
        reps = 10 if label_type.startswith("word") else 3
        return build_tokenizer(label_type, corpus_texts=[" ".join(lexicon * reps)])
    return build_tokenizer(label_type)


def hard_tokenizer(label_type: str, seed: int = 0, num_words: int = 50) -> Tokenizer:
    """The tokenizer ``HardCorpus(label_type, seed=seed, num_words=num_words)``
    labels with; the lexicon is the first draw of the corpus's generator."""
    return lexicon_tokenizer(label_type, _make_lexicon(np.random.RandomState(seed), num_words))


class HardCorpus:
    """Confusable-unit synthetic corpus; see module docstring.

    Constructor mirrors ``ToyCorpus`` where it can so ``train/loop.py``
    can switch on ``toy_profile: hard`` without new plumbing:
    ``min_units``/``max_units`` count WORDS per utterance here.
    """

    def __init__(
        self,
        label_type: str = "character",
        num_utts: int = 512,
        min_units: int = 4,
        max_units: int = 10,
        sample_rate: int = 16000,
        seed: int = 0,
        num_speakers: int = 16,
        confusability: float = 0.10,  # within-pair F2 ratio gap
        speaker_formant_spread: float = 0.12,  # ±12% vocal-tract scale
        snr_db: tuple = (8.0, 25.0),
        num_words: int = 50,
        vocab_size: int | None = None,  # accepted for ToyCorpus-arg parity
        max_utt_seconds: float | None = None,
    ):
        """``max_utt_seconds`` bounds utterance duration by splitting long
        scripts at inter-word pause midpoints: each part is a verbatim slice
        of the uncut waveform (same render, channel filter and noise draw)
        with its word-aligned transcript."""
        del vocab_size  # the lexicon fixes the inventory; knob kept for parity
        self.label_type = label_type
        self.sample_rate = sample_rate
        rng = np.random.RandomState(seed)
        self.lexicon = _make_lexicon(rng, num_words)
        self.tokenizer: Tokenizer = lexicon_tokenizer(label_type, self.lexicon)

        # ---- unit acoustics: 10 minimal pairs over [350, 3400] Hz ----------
        n_letters = len(_ALPHABET)
        n_pairs = n_letters // 2
        # pair centers spread log-uniformly so pairs are mutually distinct
        c1 = 350.0 * (2.2 ** (rng.permutation(n_pairs) / max(n_pairs - 1, 1)))
        c2 = 900.0 * (3.8 ** (rng.permutation(n_pairs) / max(n_pairs - 1, 1)))
        f1 = np.empty(n_letters)
        f2 = np.empty(n_letters)
        for p in range(n_pairs):
            f1[2 * p] = f1[2 * p + 1] = c1[p]  # shared F1 within the pair
            f2[2 * p] = c2[p]
            f2[2 * p + 1] = c2[p] * (1.0 + confusability)  # the ONLY cue
        self._f1, self._f2 = f1, f2

        # ---- speakers: formant scale, gain, channel tilt -------------------
        ns = max(num_speakers, 1)
        spk_scale = 1.0 + speaker_formant_spread * (2.0 * rng.rand(ns) - 1.0)
        spk_gain = 0.4 + 1.6 * rng.rand(ns)
        spk_tilt = 1.2 * rng.rand(ns) - 0.6

        # ---- fixed-inventory label mapping (letter i -> inventory unit i),
        # for tokenizers without text encoding (phones, kana/kanji) ---------
        self._letter_ids = None
        if not hasattr(self.tokenizer, "encode_text"):
            inv = self.tokenizer.units
            if len(inv) < n_letters:
                raise ValueError(
                    f"{label_type} inventory ({len(inv)}) smaller than the "
                    f"hard-corpus alphabet ({n_letters})"
                )
            self._letter_ids = {
                ch: self.tokenizer.unit_to_idx[inv[i]] for i, ch in enumerate(_ALPHABET)
            }

        self.utterances: list[Utterance] = []
        cap = None if max_utt_seconds is None else int(max_utt_seconds * sample_rate)
        for i in range(num_utts):
            n_words = rng.randint(min_units, max_units + 1)
            words = [self.lexicon[j] for j in rng.randint(0, len(self.lexicon), size=n_words)]
            spk = int(rng.randint(0, ns))
            wav, cuts = self._render(
                words, rng,
                formant_scale=spk_scale[spk],
                tilt=spk_tilt[spk],
                rate=0.75 + 0.55 * rng.rand(),
                snr_db=snr_db[0] + (snr_db[1] - snr_db[0]) * rng.rand(),
            )
            wav = (wav * spk_gain[spk]).astype(np.float32)
            if cap is None or len(wav) <= cap:
                chunks = [(0, len(words))]
            else:
                # greedy split at pause midpoints: extend each part while it
                # stays under the cap (a single over-cap word is kept whole —
                # impossible at this lexicon's 2-6 letters, guarded anyway)
                bounds = [0, *cuts, len(wav)]
                chunks, start = [], 0
                for end in range(1, len(words) + 1):
                    last = end == len(words)
                    if last or bounds[end + 1] - bounds[start] > cap:
                        chunks.append((start, end))
                        start = end
            bounds = [0, *cuts, len(wav)]
            for part, (ws, we) in enumerate(chunks):
                text = " ".join(words[ws:we])
                suffix = "" if len(chunks) == 1 else chr(ord("a") + part)
                self.utterances.append(
                    Utterance(
                        f"hard{i:05d}{suffix}", wav[bounds[ws]:bounds[we]],
                        self._label_ids(text), text, speaker=f"spk{spk:02d}",
                    )
                )

    # -------------------------------------------------------------------
    def _label_ids(self, text: str) -> list:
        if self._letter_ids is not None:
            return [self._letter_ids[c] for c in text if c != " "]
        return self.tokenizer.encode_text(text)

    def _render(self, words, rng, formant_scale, tilt, rate, snr_db):
        """Returns ``(wav, cuts)``: the rendered waveform and the sample
        position of each inter-word pause midpoint (len(words)-1 of them),
        used by the ``max_utt_seconds`` splitter."""
        sr = self.sample_rate
        f1s, f2s = self._f1 * formant_scale, self._f2 * formant_scale
        segs = []  # (f1_target, f2_target, n_samples, voiced)
        cuts, pos_est = [], 0
        for w, word in enumerate(words):
            if w:  # inter-word pause renders the transcript space
                n = int((0.03 + 0.05 * rng.rand()) * rate * sr)
                segs.append((0.0, 0.0, n, False))
                cuts.append(pos_est + n // 2)
                pos_est += n
            for ch in word:
                j = _ALPHABET.index(ch)
                dur = (0.05 + 0.05 * rng.rand()) * rate * (0.8 + 0.45 * rng.rand())
                n = max(int(dur * sr), 8)
                segs.append((f1s[j], f2s[j], n, True))
                pos_est += n

        total = sum(s[2] for s in segs)
        wav = np.zeros(total, np.float64)
        pos = 0
        prev = (f1s[0], f2s[0])  # glide source for the first segment
        for tf1, tf2, n, voiced in segs:
            if voiced:
                glide = min(int(0.025 * sr), max(n // 3, 1))
                ramp = np.minimum(np.arange(n) / glide, 1.0)
                f1_t = prev[0] + (tf1 - prev[0]) * ramp
                f2_t = prev[1] + (tf2 - prev[1]) * ramp
                ph1 = 2 * np.pi * np.cumsum(f1_t) / sr
                ph2 = 2 * np.pi * np.cumsum(f2_t) / sr
                # trapezoid envelope: 8 ms edges, sustained middle (hanning
                # would modulate the whole segment and re-mark boundaries)
                e = int(0.008 * sr)
                env = np.ones(n)
                k = min(e, n // 2)
                if k > 0:
                    env[:k] = np.linspace(0.0, 1.0, k)
                    env[-k:] = np.linspace(1.0, 0.0, k)
                wav[pos:pos + n] = env * (0.6 * np.sin(ph1) + 0.4 * np.sin(ph2))
                prev = (tf1, tf2)
            pos += n

        # per-speaker channel: one-tap tilt filter y[t] = x[t] - tilt*x[t-1]
        wav = wav - tilt * np.concatenate([[0.0], wav[:-1]])
        # additive noise at the drawn SNR (over the voiced-average power)
        sig_pow = float(np.mean(wav**2)) or 1e-8
        noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
        wav = wav + np.sqrt(noise_pow) * rng.randn(total)
        return wav.astype(np.float32), cuts
