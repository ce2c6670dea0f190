"""On-disk corpus loader: per-utterance ``.npy`` feature files + transcripts.

A copy of ``tensorflow_end2end_speech_recognition_tpu/data/npy_corpus.py``
(plain numpy). Layout under ``data_root``, as ``bin/prepare`` writes it:

    <data_root>/<split>/feats/<utt_id>.npy      float32 [T, D]
    <data_root>/<split>/transcripts.tsv         utt_id<TAB>token token ...
                                            or  utt_id<TAB>speaker<TAB>tokens
                                                (3 columns: per-speaker CMVN
                                                grouping available)

Character, word and BPE tokenizers encode the transcript text
(``encode_text``); phone inventories look up its space-separated tokens.
Features load eagerly into RAM and flow through ``Dataset`` in its features
mode. ``corpus_split_names`` picks the train, dev and test splits as the JAX
loop's ``build_corpus_splits`` does, and ``corpus_tokenizer`` learns word and
BPE units from the train split's transcripts.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

from .tokenizers import Tokenizer, build_tokenizer
from .toy_corpus import Utterance, learns_units


def read_transcripts(data_root: str | Path, split: str) -> list[str]:
    """Transcript texts of one split (e.g. to learn a BPE vocabulary)."""
    tsv = Path(data_root) / split / "transcripts.tsv"
    texts = []
    for line in tsv.read_text().splitlines():
        if line.strip():
            texts.append(line.split("\t")[-1])
    return texts


def available_splits(data_root: str | Path) -> list[str]:
    """Split names on disk (subdirs holding a transcripts.tsv), sorted."""
    root = Path(data_root)
    if not root.is_dir():
        raise FileNotFoundError(f"data_root {root} is not a directory")
    return sorted(p.name for p in root.iterdir() if (p / "transcripts.tsv").exists())


def pick_split(splits: list[str], *prefixes: str) -> str | None:
    """First split exactly matching, then first by prefix, in prefix order."""
    for pre in prefixes:
        if pre in splits:
            return pre
    for pre in prefixes:
        for s in splits:
            if s.startswith(pre):
                return s
    return None


def corpus_split_names(data_root: str | Path, train_data_size: str | None = None):
    """(train, dev, test) split names: ``train_data_size`` when it is on disk,
    else the first "train" split; the first "dev" split; the first "test" or
    "eval" split, or the dev split (with a warning) when there is none."""
    names = available_splits(data_root)
    train_name = (train_data_size if train_data_size and train_data_size in names
                  else pick_split(names, "train"))
    dev_name = pick_split(names, "dev")
    test_name = pick_split(names, "test", "eval")
    if test_name is None:
        warnings.warn(f"data_root {data_root} has no test/eval split; "
                      "reporting the dev split as 'test'")
        test_name = dev_name
    if train_name is None or dev_name is None:
        raise FileNotFoundError(f"data_root {data_root} needs train+dev splits; found {names}")
    return train_name, dev_name, test_name


def corpus_tokenizer(data_root: str | Path, label_type: str, train_name: str) -> Tokenizer:
    """The tokenizer of ``label_type``; word and BPE units learn from the
    train split's transcripts."""
    kwargs = {}
    if learns_units(label_type):
        kwargs["corpus_texts"] = read_transcripts(data_root, train_name)
    return build_tokenizer(label_type, **kwargs)


def load_npy_split(data_root: str | Path, split: str, tokenizer: Tokenizer,
                   load_features: bool = True) -> list[Utterance]:
    """``load_features=False`` skips the per-utterance .npy reads (labels and
    transcripts only, as LM training needs)."""
    root = Path(data_root) / split
    tsv = root / "transcripts.tsv"
    if not tsv.exists():
        raise FileNotFoundError(f"missing {tsv}")
    utts: list[Utterance] = []
    for line in tsv.read_text().splitlines():
        if not line.strip():
            continue
        parts = line.split("\t", 2)
        if len(parts) == 3:
            utt_id, speaker, text = parts
        else:
            utt_id, text = parts
            speaker = None
        if load_features:
            feat_path = root / "feats" / f"{utt_id}.npy"
            feats = np.load(feat_path).astype(np.float32)
            if feats.ndim != 2:
                raise ValueError(f"{feat_path}: expected [T, D] features, got {feats.shape}")
        else:
            feats = np.zeros((0, 1), np.float32)
        if hasattr(tokenizer, "encode_text"):  # char / word / BPE tokenizers
            ids = tokenizer.encode_text(text)
        else:  # phone / raw-unit inventories: space-separated tokens
            ids = tokenizer.encode(text.split())
        utts.append(Utterance(utt_id, feats, ids, text, speaker=speaker))
    if not utts:
        raise ValueError(f"no utterances in {tsv}")
    return utts
