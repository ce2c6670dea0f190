"""Label units: TIMIT phones (61/48/39), characters, words, BPE, kana, unit files.

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/tokenizers.py``
(that package's ``data/__init__`` imports jax), the same units in the same
order: the 61-phone TIMIT inventory and its 61 -> 48 -> 39 folding,
LibriSpeech characters (plain or capital-divided), frequency-thresholded
words with ``<unk>``, BPE units learned from corpus text (``bpe_N``: N
merges, ties settled by ``Counter.most_common`` as there), the built-in kana
inventory and unit files. Classes ``0..V-1`` are real units, index ``V`` is
the CTC blank (and the attention ``<sos>``, ``V + 1`` its ``<eos>``), ``-1``
pads labels.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# The 61-phone TIMIT inventory (TIMITDIC order is irrelevant; sorted for
# determinism) and the standard 60-48-39 folding. `q` is folded to silence
# here (common practice when it is not deleted outright).
TIMIT_PHONE61 = [
    "aa", "ae", "ah", "ao", "aw", "ax", "ax-h", "axr", "ay", "b", "bcl",
    "ch", "d", "dcl", "dh", "dx", "eh", "el", "em", "en", "eng", "epi",
    "er", "ey", "f", "g", "gcl", "h#", "hh", "hv", "ih", "ix", "iy", "jh",
    "k", "kcl", "l", "m", "n", "ng", "nx", "ow", "oy", "p", "pau", "pcl",
    "q", "r", "s", "sh", "t", "tcl", "th", "uh", "uw", "ux", "v", "w",
    "y", "z", "zh",
]

_FOLD_61_TO_48 = {
    "ax-h": "ax", "axr": "er", "bcl": "vcl", "dcl": "vcl", "gcl": "vcl",
    "pcl": "cl", "tcl": "cl", "kcl": "cl", "em": "m", "eng": "ng",
    "h#": "sil", "pau": "sil", "hv": "hh", "nx": "n",
    "q": "sil", "ux": "uw",
}

_FOLD_61_TO_39 = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n", "eng": "ng",
    "zh": "sh", "ux": "uw", "pcl": "sil", "tcl": "sil", "kcl": "sil",
    "bcl": "sil", "dcl": "sil", "gcl": "sil", "h#": "sil", "pau": "sil",
    "epi": "sil", "q": "sil",
}


def fold_phones(phones: list[str], target: str) -> list[str]:
    """Fold a 61-phone sequence to the 48 or 39 set (identity for 61)."""
    if target == "phone61":
        return list(phones)
    fold = _FOLD_61_TO_48 if target == "phone48" else _FOLD_61_TO_39
    if target not in ("phone48", "phone39"):
        raise ValueError(f"unknown phone fold target {target!r}")
    return [fold.get(p, p) for p in phones]


def phone_inventory(label_type: str) -> list[str]:
    return sorted(set(fold_phones(TIMIT_PHONE61, label_type)))


# LibriSpeech-style character set: space, apostrophe, a-z.
CHAR_UNITS = [" ", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
# character_capital_divide: word-initial capitals are distinct units, and the
# space is dropped (capitals mark the word boundary) — reference label_type.
CHAR_CAPITAL_UNITS = ["'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)] + [
    chr(c) for c in range(ord("A"), ord("Z") + 1)
]


@dataclass
class Tokenizer:
    """Bidirectional unit<->index map with CTC/attention specials.

    ``units`` excludes specials. CTC blank = ``num_units`` (trailing, as in
    the reference's num_classes+1 layout). Attention adds <sos>=num_units,
    <eos>=num_units+1.
    """

    units: list[str]
    unit_to_idx: dict = field(init=False)

    def __post_init__(self):
        self.unit_to_idx = {u: i for i, u in enumerate(self.units)}
        if len(self.unit_to_idx) != len(self.units):
            raise ValueError("duplicate units in inventory")

    @property
    def num_units(self) -> int:
        return len(self.units)

    @property
    def blank_id(self) -> int:  # CTC
        return len(self.units)

    @property
    def sos_id(self) -> int:  # attention
        return len(self.units)

    @property
    def eos_id(self) -> int:  # attention
        return len(self.units) + 1

    def encode(self, tokens: list[str]) -> list[int]:
        return [self.unit_to_idx[t] for t in tokens]

    def decode(self, ids) -> list[str]:
        specials = {self.blank_id, self.eos_id, -1}
        return [self.units[int(i)] for i in ids if int(i) not in specials and 0 <= int(i) < len(self.units)]


class CharTokenizer(Tokenizer):
    def __init__(self, capital_divide: bool = False):
        self.capital_divide = capital_divide
        super().__init__(list(CHAR_CAPITAL_UNITS if capital_divide else CHAR_UNITS))

    def encode_text(self, text: str) -> list[int]:
        if self.capital_divide:
            # word boundary = capitalized first LETTER (the reference's
            # character_capital_divide scheme). Words whose first character
            # has no uppercase form (digits/symbols) carry the marker on
            # their first letter instead, so boundaries survive inputs like
            # "4th" — without this the words would merge on decode.
            toks = []
            for word in text.lower().split():
                chars = list(word)
                for i, c in enumerate(chars):
                    if c.upper() != c:  # first capitalizable char marks it
                        chars[i] = c.upper()
                        break
                toks.extend(chars)
            return self.encode([t for t in toks if t in self.unit_to_idx])
        text = text.lower()
        return self.encode([c for c in text if c in self.unit_to_idx])

    def decode_text(self, ids) -> str:
        toks = self.decode(ids)
        if self.capital_divide:
            out = []
            for t in toks:
                if t.isupper():
                    out.append(" " + t.lower())
                else:
                    out.append(t)
            return "".join(out).strip()
        return "".join(toks)


class PhoneTokenizer(Tokenizer):
    """TIMIT phones at a given granularity, with fold-for-scoring support."""

    def __init__(self, label_type: str = "phone61"):
        self.label_type = label_type
        super().__init__(phone_inventory(label_type))

    def encode_phones(self, phones61: list[str]) -> list[int]:
        return self.encode(fold_phones(phones61, self.label_type))

    def fold_for_scoring(self, phones: list[str]) -> list[str]:
        """Map this tokenizer's phones to the 39 set and squeeze repeats of sil.

        Mirrors the reference's 61->39 mapping-file step before PER
        computation (SURVEY.md §2.7 metrics glue). Handles both 61-set and
        48-set inputs: the 48-set closure symbols ``vcl``/``cl`` (which the
        61->39 keys don't cover) fold to ``sil`` so phone48 models score
        over the same 39 symbols as phone61 models. Folding creates adjacent
        ``sil`` runs (e.g. ``vcl sil`` -> ``sil sil``); those are squeezed to
        one, as the reference's mapping step did.
        """
        fold = {**_FOLD_61_TO_39, "vcl": "sil", "cl": "sil"}
        out = []
        for p in phones:
            p = fold.get(p, p)
            if p == "sil" and out and out[-1] == "sil":
                continue
            out.append(p)
        return out


class WordTokenizer(Tokenizer):
    """Frequency-thresholded word vocabulary with <unk> (reference word_freqN)."""

    def __init__(self, corpus_texts: list[str] | None = None, vocab: list[str] | None = None, min_freq: int = 1):
        if vocab is None:
            from collections import Counter

            counts = Counter(w for t in corpus_texts or [] for w in t.lower().split())
            vocab = sorted(w for w, c in counts.items() if c >= min_freq)
        self.unk = "<unk>"
        super().__init__(list(vocab) + [self.unk])

    def encode_text(self, text: str) -> list[int]:
        return [self.unit_to_idx.get(w, self.unit_to_idx[self.unk]) for w in text.lower().split()]

    def decode_text(self, ids) -> str:
        return " ".join(self.decode(ids))


def _apply_merge(sym: list[str], a: str, b: str) -> list[str]:
    """One left-to-right BPE pair merge — the SINGLE implementation shared
    by vocabulary learning and encode-time replay (they must stay in sync)."""
    out, i = [], 0
    while i < len(sym):
        if i + 1 < len(sym) and sym[i] == a and sym[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(sym[i])
            i += 1
    return out


class BPETokenizer(Tokenizer):
    """Byte-pair-encoding subword units learned from corpus text.

    Beyond the reference's unit systems (it had chars and freq-thresholded
    words) but the standard modern ASR choice; label_type ``bpe_N`` learns an
    N-merge vocabulary. Words are encoded independently with a leading "▁"
    word-boundary marker (sentencepiece convention), greedy longest-match at
    encode time, exact inverse at decode time.
    """

    WB = "▁"  # ▁ word-boundary marker

    def __init__(self, corpus_texts: list[str], num_merges: int = 500):
        from collections import Counter

        words = Counter()
        for t in corpus_texts:
            for w in t.lower().split():
                words[self.WB + w] += 1
        # start from characters; merge the most frequent adjacent pair
        vocab = {w: list(w) for w in words}
        base_units = sorted({c for w in vocab.values() for c in w})
        merges = []
        for _ in range(num_merges):
            pairs = Counter()
            for w, count in words.items():
                sym = vocab[w]
                for a, b in zip(sym, sym[1:]):
                    pairs[(a, b)] += count
            if not pairs:
                break
            (a, b), n = pairs.most_common(1)[0]
            if n < 2:
                break
            merges.append((a, b))
            for w, sym in vocab.items():
                vocab[w] = _apply_merge(sym, a, b)
        units = sorted(set(base_units) | {a + b for a, b in merges})
        self.merges = merges
        self.unk = "<unk>"
        # symbols outside the learned inventory (unseen characters) map to
        # <unk> rather than being silently dropped — dropping would mutilate
        # reference label sequences and corrupt WER
        super().__init__(units + [self.unk])

    def _encode_word(self, word: str) -> list[str]:
        sym = list(self.WB + word)
        for a, b in self.merges:  # replay merges in learned order
            sym = _apply_merge(sym, a, b)
        return sym

    def encode_text(self, text: str) -> list[int]:
        unk = self.unit_to_idx[self.unk]
        ids = []
        for w in text.lower().split():
            ids.extend(self.unit_to_idx.get(t, unk) for t in self._encode_word(w))
        return ids

    def decode_text(self, ids) -> str:
        return "".join(self.decode(ids)).replace(self.WB, " ").strip()


def load_unit_file(path: str) -> Tokenizer:
    """Generic inventory from a text file, one unit per line (CSJ kana/kanji).

    Only the line terminator is stripped (``\\n`` / ``\\r\\n``): a
    whitespace unit line (e.g. the space character in a character
    inventory) is a VALID unit — filtering it would silently shift every
    subsequent unit id and corrupt all encodes for the corpus. Only fully
    empty lines are skipped.
    """
    with open(path, newline="") as f:
        units = [
            line.rstrip("\r\n") for line in f if line.rstrip("\r\n") != ""
        ]
    return Tokenizer(units)


def build_tokenizer(label_type: str, **kwargs) -> Tokenizer:
    """Factory keyed by the reference's ``label_type`` config strings."""
    if label_type.startswith("phone"):
        return PhoneTokenizer(label_type)
    if label_type == "character":
        return CharTokenizer()
    if label_type == "character_capital_divide":
        return CharTokenizer(capital_divide=True)
    if label_type.startswith("word"):
        min_freq = int(label_type.split("_freq")[-1]) if "_freq" in label_type else 1
        return WordTokenizer(min_freq=min_freq, **kwargs)
    if label_type.startswith("bpe"):
        num_merges = int(label_type.split("_")[-1]) if "_" in label_type else 500
        return BPETokenizer(num_merges=num_merges, **kwargs)
    if label_type in ("kana", "kanji"):
        path = kwargs.get("unit_file")
        if path:
            return load_unit_file(path)
        # no CSJ data in this environment: a small built-in kana inventory so
        # CSJ-shaped configs remain runnable on the toy corpus
        kana = [chr(c) for c in range(ord("ぁ"), ord("ん") + 1)] + ["ー", "、", "。"]
        return Tokenizer(kana)
    raise ValueError(f"unknown label_type {label_type!r}")
