"""The port's tokenizers, toy and hard corpora, scoring units and the four
configs of the VGG, multitask, BPE and word models against the JAX package.

Every comparison is exact: units, BPE merges, encoded ids and decoded text;
the corpora's waveforms bit for bit (16-32 utterances) with their ids,
transcripts, names and sub labels; the scoring-unit and word sequences; the
configs as typed configs, field for field.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import yaml

from tensorflow_end2end_speech_recognition_tpu.data import hard_corpus as jhard
from tensorflow_end2end_speech_recognition_tpu.data import tokenizers as jtok
from tensorflow_end2end_speech_recognition_tpu.data import toy_corpus as jtoy
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.utils import metrics as jmetrics
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.data import hard_corpus, tokenizers
from tensorflow_end2end_speech_recognition_tpu_torch.data import toy_corpus
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import (
    build_corpus_splits,
    build_task,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils import metrics
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    ExperimentConfig,
    corpus_tokenizer,
    load_task,
)

REPO = Path(__file__).resolve().parent.parent
STATIC_TYPES = ("phone61", "phone48", "phone39", "character", "character_capital_divide",
                "kana")
NEW_CONFIGS = ("csj_joint", "timit_multitask_ctc", "ls960_joint_bpe", "ls_word_ctc")
TEXTS = ("the cat sat", "4th of july's", "a  b\tc", "bookkeeper's book", "", "zz top x")


def _raw(name: str) -> dict:
    return yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())


def _same_tokenizer(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.units == want.units and got.unit_to_idx == want.unit_to_idx
    assert (got.num_units, got.blank_id, got.eos_id) == (want.num_units, want.blank_id,
                                                         want.eos_id)
    assert getattr(got, "merges", None) == getattr(want, "merges", None)


@pytest.mark.parametrize("label_type", STATIC_TYPES)
def test_static_units_match_jax(label_type):
    got, want = tokenizers.build_tokenizer(label_type), jtok.build_tokenizer(label_type)
    _same_tokenizer(got, want)
    assert got.num_units == {"phone61": 61, "phone48": 48, "phone39": 39, "character": 28,
                             "character_capital_divide": 53, "kana": 86}[label_type]
    ids = list(range(got.num_units)) + [got.blank_id, got.eos_id, -1]
    assert got.decode(ids) == want.decode(ids)
    if label_type.startswith("phone"):
        phones = list(tokenizers.TIMIT_PHONE61) * 2
        assert got.encode_phones(phones) == want.encode_phones(phones)
        assert got.fold_for_scoring(got.units + ["vcl", "cl"]) == \
            want.fold_for_scoring(want.units + ["vcl", "cl"])
    if label_type.startswith("character"):
        for text in TEXTS:
            ids = got.encode_text(text)
            assert ids == want.encode_text(text), text
            assert got.decode_text(ids) == want.decode_text(ids), text


def _bpe_texts(seed: int) -> list[str]:
    """Words over a four-letter alphabet: many equal pair counts (ties)."""
    rng = np.random.RandomState(seed)
    words = ["".join("abcd"[j] for j in rng.randint(0, 4, rng.randint(1, 6)))
             for _ in range(60)]
    return [" ".join(words[i:i + 7]) for i in range(0, 60, 7)]


@pytest.mark.parametrize("num_merges", [0, 7, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_bpe_merges_and_codec_match_jax(num_merges, seed):
    texts = _bpe_texts(seed)
    got = tokenizers.BPETokenizer(texts, num_merges)
    want = jtok.BPETokenizer(texts, num_merges)
    _same_tokenizer(got, want)
    assert len(got.merges) == (min(num_merges, len(got.merges)))
    for text in texts + ["dcba abcd e", "x", ""]:  # e, x: <unk>
        ids = got.encode_text(text)
        assert ids == want.encode_text(text), text
        assert got.decode_text(ids) == want.decode_text(ids), text
    assert got.decode_text(got.encode_text("abc dab")) == "abc dab"  # ▁ decodes to a space


@pytest.mark.parametrize("min_freq", [1, 2, 5])
def test_word_units_and_codec_match_jax(min_freq):
    texts = _bpe_texts(2)
    got = tokenizers.WordTokenizer(texts, min_freq=min_freq)
    want = jtok.WordTokenizer(texts, min_freq=min_freq)
    _same_tokenizer(got, want)
    for text in texts + ["never seen here"]:
        ids = got.encode_text(text)
        assert ids == want.encode_text(text)
        assert got.decode_text(ids) == want.decode_text(ids)


def test_unit_file_keeps_whitespace_units(tmp_path):
    path = tmp_path / "units.txt"
    path.write_bytes("あ\r\n \n\nい\n\t\nう".encode())
    got, want = tokenizers.load_unit_file(str(path)), jtok.load_unit_file(str(path))
    assert got.units == want.units == ["あ", " ", "い", "\t", "う"]
    assert tokenizers.build_tokenizer("kana", unit_file=str(path)).units == got.units


def _same_utterances(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.name, g.text, g.label_ids, g.sub_ids, g.speaker) == \
            (w.name, w.text, w.label_ids, w.sub_ids, w.speaker)
        assert g.wav.dtype == w.wav.dtype == np.float32
        np.testing.assert_array_equal(g.wav, w.wav)


@pytest.mark.parametrize("label_type,vocab_size", [
    ("bpe_1000", None), ("bpe_20", None), ("word_freq1", None), ("kana", 40),
    ("character_capital_divide", None), ("phone48", None)])
def test_toy_corpus_matches_jax(label_type, vocab_size):
    kw = dict(label_type=label_type, num_utts=16, min_units=2, max_units=5, seed=3,
              vocab_size=vocab_size)
    got, want = toy_corpus.ToyCorpus(**kw), jtoy.ToyCorpus(**kw)
    _same_tokenizer(got.tokenizer, want.tokenizer)
    _same_tokenizer(toy_corpus.toy_tokenizer(label_type), want.tokenizer)
    _same_utterances(got.utterances, want.utterances)


@pytest.mark.parametrize("raw", [
    {"label_type": "word_freq5", "toy_profile": "hard"},
    {"label_type": "bpe_30", "toy_profile": "hard", "toy_lexicon_words": 80},
    {"label_type": "character", "toy_profile": "harder", "max_utt_seconds": 1.2},
    {"label_type": "phone61", "toy_profile": "hard", "model_type": "multitask_ctc",
     "label_type_sub": "character", "toy_seed": 4},
], ids=["word_freq5", "bpe_lexicon80", "harder_split", "phone61_multitask"])
def test_hard_corpus_splits_match_jax(raw):
    raw = dict(raw, toy_num_utts=24, toy_min_units=2, toy_max_units=6)
    exp, jexp = ExperimentConfig.from_dict(raw), JExperimentConfig.from_dict(raw)
    got, want = build_corpus_splits(exp), jloop.build_corpus_splits(jexp)
    _same_tokenizer(got[3], want[3])
    _same_tokenizer(corpus_tokenizer(exp), want[3])
    for g, w in zip(got[:3], want[:3]):
        _same_utterances(g, w)
    utts = [u for split in got[:3] for u in split]
    if raw.get("max_utt_seconds"):  # long scripts split at their pauses
        assert any(u.name[-1].isalpha() for u in utts)
        assert max(len(u.wav) for u in utts) <= raw["max_utt_seconds"] * 16000
    if raw.get("label_type_sub"):
        assert all(u.sub_ids for u in utts)


def test_hard_tokenizer_matches_the_corpus():
    corpus = jhard.HardCorpus(label_type="bpe_1000", num_utts=2, seed=5, num_words=70)
    _same_tokenizer(hard_corpus.hard_tokenizer("bpe_1000", 5, 70), corpus.tokenizer)


def _ids(rng, tok, n):
    return [int(i) for i in rng.randint(0, tok.num_units, n)]


@pytest.mark.parametrize("label_type", STATIC_TYPES + ("bpe_1000", "word_freq5"))
def test_scoring_tokens_match_jax(label_type):
    raw = {"label_type": label_type, "toy_num_utts": 2}
    if label_type == "word_freq5":
        raw["toy_profile"] = "hard"
    tok = corpus_tokenizer(ExperimentConfig.from_dict(raw))
    jtokenizer = jloop.build_corpus_splits(JExperimentConfig.from_dict(raw))[3]
    rng = np.random.RandomState(7)
    for _ in range(6):
        ref, hyp = _ids(rng, tok, rng.randint(0, 9)), _ids(rng, tok, rng.randint(0, 9))
        assert metrics.scoring_tokens(ref, hyp, tok, label_type) == \
            jmetrics.scoring_tokens(ref, hyp, jtokenizer, label_type)
        assert metrics.word_tokens(ref, hyp, tok, label_type) == \
            jmetrics.word_tokens(ref, hyp, jtokenizer, label_type)
    if label_type.startswith("bpe"):  # words, not subword units
        ref = tok.encode_text("w01 w02 w13")
        assert metrics.scoring_tokens(ref, ref[:-1], tok, label_type)[0] == \
            ["w01", "w02", "w13"]


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_config_matches_jax_field_for_field(name):
    raw = _raw(name)
    exp, jexp = ExperimentConfig.from_dict(raw), JExperimentConfig.from_dict(raw)
    for f in dataclasses.fields(exp):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    exp.check_trainable()
    small = dict(raw, toy_num_utts=16)  # the tokenizer does not depend on the count
    jtokenizer = jloop.build_corpus_splits(JExperimentConfig.from_dict(small))[3]
    task, units, label_type = load_task(REPO / "configs" / f"{name}.yml")
    assert units == jtokenizer.units and label_type == raw["label_type"]
    assert len(units) == {"csj_joint": 86, "timit_multitask_ctc": 61, "ls960_joint_bpe": 58,
                          "ls_word_ctc": 51}[name]
    jtask, _ = jloop.build_task(jexp, jtokenizer)
    got_task, _ = build_task(exp, corpus_tokenizer(exp))
    assert got_task == task
    assert tuple(task.frontend) == tuple(jtask.frontend)
    for f in ("num_stack", "num_skip", "splice", "weight_decay", "input_dim"):
        assert getattr(task, f) == getattr(jtask, f), f
    for f in EncoderConfig._fields + ("output_dim", "bidirectional"):
        assert getattr(task.model.encoder, f) == getattr(jtask.model.encoder, f), f
    for f in type(task.model)._fields:
        if f != "encoder" and f != "attention":
            assert getattr(task.model, f) == getattr(jtask.model, f), f
    if "attention" in exp.model_type:
        assert tuple(task.model.attention) == tuple(jtask.model.attention)
        for f in ("label_smoothing", "guided_attention_weight", "ctc_weight_init",
                  "ctc_weight_anneal_steps", "scheduled_sampling_ramp_max_step"):
            assert getattr(task, f) == getattr(jtask, f), f
    else:
        assert task.main_task_weight == jtask.main_task_weight


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yml")), ids=lambda p: p.stem)
def test_every_config_loads_and_trains_in_the_port(path):
    task, units, _ = load_task(path)
    ExperimentConfig.from_yaml(path).check_trainable()
    assert task.model.num_classes == len(units)
