"""Label units: characters and the 61 TIMIT phones.

A copy of the character and ``phone61`` parts of
``tensorflow_end2end_speech_recognition_tpu/data/tokenizers.py`` (that
package's ``data/__init__`` imports jax). Classes ``0..V-1`` are real units,
index ``V`` is the CTC blank, ``-1`` pads labels. Other label types (words,
BPE, capital-divided characters, phone48/39 targets, kana) raise
``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# The 61-phone TIMIT inventory, sorted, and the standard 61 -> 39 folding
# used for PER scoring (`q` folds to silence).
TIMIT_PHONE61 = [
    "aa", "ae", "ah", "ao", "aw", "ax", "ax-h", "axr", "ay", "b", "bcl",
    "ch", "d", "dcl", "dh", "dx", "eh", "el", "em", "en", "eng", "epi",
    "er", "ey", "f", "g", "gcl", "h#", "hh", "hv", "ih", "ix", "iy", "jh",
    "k", "kcl", "l", "m", "n", "ng", "nx", "ow", "oy", "p", "pau", "pcl",
    "q", "r", "s", "sh", "t", "tcl", "th", "uh", "uw", "ux", "v", "w",
    "y", "z", "zh",
]

_FOLD_61_TO_39 = {
    "ao": "aa", "ax": "ah", "ax-h": "ah", "axr": "er", "hv": "hh",
    "ix": "ih", "el": "l", "em": "m", "en": "n", "nx": "n", "eng": "ng",
    "zh": "sh", "ux": "uw", "pcl": "sil", "tcl": "sil", "kcl": "sil",
    "bcl": "sil", "dcl": "sil", "gcl": "sil", "h#": "sil", "pau": "sil",
    "epi": "sil", "q": "sil",
}

# LibriSpeech-style character set: space, apostrophe, a-z.
CHAR_UNITS = [" ", "'"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]

UNITS = {"character": CHAR_UNITS, "phone61": TIMIT_PHONE61}


@dataclass
class Tokenizer:
    """Unit <-> index map; the CTC blank is ``num_units``."""

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
    def blank_id(self) -> int:
        return len(self.units)

    @property
    def eos_id(self) -> int:
        return len(self.units) + 1

    def encode(self, tokens: list[str]) -> list[int]:
        return [self.unit_to_idx[t] for t in tokens]

    def decode(self, ids) -> list[str]:
        specials = {self.blank_id, self.eos_id, -1}
        return [self.units[int(i)] for i in ids
                if int(i) not in specials and 0 <= int(i) < len(self.units)]


class CharTokenizer(Tokenizer):
    def __init__(self):
        super().__init__(list(CHAR_UNITS))

    def encode_text(self, text: str) -> list[int]:
        return self.encode([c for c in text.lower() if c in self.unit_to_idx])

    def decode_text(self, ids) -> str:
        return "".join(self.decode(ids))


class PhoneTokenizer(Tokenizer):
    """The 61 TIMIT phones, folded to the 39 set for scoring."""

    def __init__(self):
        super().__init__(list(TIMIT_PHONE61))

    def fold_for_scoring(self, phones: list[str]) -> list[str]:
        """Fold to the 39 set and squeeze the ``sil`` runs folding creates."""
        fold = {**_FOLD_61_TO_39, "vcl": "sil", "cl": "sil"}
        out = []
        for p in phones:
            p = fold.get(p, p)
            if p == "sil" and out and out[-1] == "sil":
                continue
            out.append(p)
        return out


def build_tokenizer(label_type: str) -> Tokenizer:
    """The tokenizer of a config's ``label_type`` (``character`` or ``phone61``)."""
    if label_type == "character":
        return CharTokenizer()
    if label_type == "phone61":
        return PhoneTokenizer()
    raise NotImplementedError(f"label_type {label_type!r} is not ported yet")
