"""The port's on-disk corpora against the JAX package, on the CPU: the ``.npy``
split loader, ``bin/prepare``, MFCC, per-speaker CMVN, the features mode of
``Dataset``, ``device_pipeline`` with CMVN rows, ``build_corpus_splits`` with
``data_root``, and ``bin/train`` -> ``bin/eval`` -> ``bin/decode`` on a
prepared corpus with gradient accumulation.

The inputs are the toy corpus's utterances (under 0.4 s each), written here
as 16-bit PCM wavs, and seeded numpy feature matrices. Tolerances, float32:

- the split loader, ``pick_split``, tokenizer units, the features-mode
  batches, ``batch_cmvn_rows`` and ``transcripts.tsv``: exact;
- ``bin/prepare``'s ``.npy`` files: atol 5e-4. A toy utterance is a chord
  of two sines: most mel bands hold little more than the noise floor, and
  the log of a small band power turns the DFT sums' float32 differences
  into up to 2.8e-4 of log-mel (seen at -6.8, and after either CMVN);
  MFCC, which mixes the bands, within 6e-5;
- MFCC features: atol 1e-4, rtol 1e-5 (the same; cepstra reach about 100);
- speaker statistics: mean and inv-std within atol 1e-6, rtol 1e-6 (float64
  sums of the same frames); from waveforms rtol 1e-5, the frames differing
  as the frontend's do (seen: 1.6e-6 of an inv-std);
- ``device_pipeline`` with CMVN rows: exact lengths; from waveforms the
  frontend's atol 1e-4, rtol 1e-5, from precomputed features atol 1e-6;
- end to end: every split's error rates equal to the JAX eval step's on the
  same weights, the loss within 1e-4 relative.
"""

import json
import warnings
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.bin import prepare as jprepare
from tensorflow_end2end_speech_recognition_tpu.data import Dataset as JDataset
from tensorflow_end2end_speech_recognition_tpu.data import npy_corpus as jnpy
from tensorflow_end2end_speech_recognition_tpu.frontend import features as jf
from tensorflow_end2end_speech_recognition_tpu.frontend import speaker_cmvn as jspk
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.utils import jax_setup
from tensorflow_end2end_speech_recognition_tpu.utils import metrics as jmetrics
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import prepare
from tensorflow_end2end_speech_recognition_tpu_torch.bin import serve as serve_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.data import npy_corpus
from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
from tensorflow_end2end_speech_recognition_tpu_torch.data.tokenizers import phone_inventory
from tensorflow_end2end_speech_recognition_tpu_torch.data.toy_corpus import ToyCorpus, Utterance
from tensorflow_end2end_speech_recognition_tpu_torch.frontend import features as tf_
from tensorflow_end2end_speech_recognition_tpu_torch.frontend import speaker_cmvn
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import build_corpus_splits
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_to_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    experiment_from_dict,
    task_from_dict,
)

torch.set_num_threads(1)

SR = 16000
FEAT_TOL = dict(atol=1e-4, rtol=1e-5)
PREPARE_ATOL = 5e-4
STATS_TOL = dict(atol=1e-6, rtol=1e-6)
WAV_STATS_TOL = dict(atol=1e-6, rtol=1e-5)
LOSS_RTOL = 1e-4
# configs/ls100_ctc.yml shrunk: BLSTM-8 x 2, a prepared corpus, two microbatches
TINY_LS100 = dict(model_type="ctc", corpus="librispeech", label_type="character",
                  train_data_size="train100h", input_size=40, use_energy=False,
                  use_delta=True, num_stack=3, num_skip=3, encoder_type="blstm",
                  num_units=8, num_layers=2, dropout=1.0, batch_size=4, num_epoch=1,
                  optimizer="adam", learning_rate=1e-3, clip_grad_norm=5.0,
                  weight_decay=1e-8, beam_width=1, grad_accum_steps=2)


def _write_wav(path, wav, rate=SR, width=2):
    pcm = np.clip(wav * 0.5, -1, 1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes((pcm * 32767).astype(np.int16).tobytes() if width == 2
                      else ((pcm + 1) * 127).astype(np.uint8).tobytes())


def _write_scp(path: Path, utts, wav_dir: Path, speakers: bool = True) -> Path:
    lines = []
    for u in utts:
        wav = wav_dir / f"{u.name}.wav"
        if not wav.exists():
            _write_wav(wav, u.wav)
        lines.append(f"{u.name}\t{wav}\t{u.speaker}\t{u.text}" if speakers
                     else f"{u.name}\t{wav}\t{u.text}")
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """28 toy utterances of 4 speakers written as wavs, with 4-column scps:
    train (16), dev_clean and dev_other (4 each), test_clean (4)."""
    root = tmp_path_factory.mktemp("wavs")
    utts = ToyCorpus(label_type="character", num_utts=28, max_units=3, seed=4).utterances
    splits = {"train": utts[:16], "dev_clean": utts[16:20], "dev_other": utts[20:24],
              "test_clean": utts[24:]}
    return root, {name: _write_scp(root / f"{name}.scp", us, root) for name, us in
                  splits.items()}, utts


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    # JAX's bin/prepare turns on a persistent compile cache under HOME
    monkeypatch.setattr(jax_setup, "setup", lambda *a, **k: None)


# ---- the .npy split loader ---------------------------------------------------


def _fake_corpus(root: Path, splits: dict, seed: int = 0) -> Path:
    """Splits of seeded [T, 6] features: {split: [(utt, speaker or None, text)]}."""
    rng = np.random.RandomState(seed)
    for split, rows in splits.items():
        (root / split / "feats").mkdir(parents=True)
        lines = []
        for utt, spk, text in rows:
            np.save(root / split / "feats" / f"{utt}.npy",
                    rng.randn(rng.randint(20, 40), 6).astype(np.float64))
            lines.append(f"{utt}\t{spk}\t{text}" if spk else f"{utt}\t{text}")
        (root / split / "transcripts.tsv").write_text("\n".join(lines) + "\n\n")
    return root


WORDS = ["the cat sat", "a cat ran far", "the dog sat down", "a dog ran"]
PHONES = phone_inventory("phone61")[:12]


def _rows(n, words=True, speakers=True, prefix="u"):
    rng = np.random.RandomState(n)
    return [(f"{prefix}{i}", f"s{i % 2}" if speakers and i % 3 else None,
             WORDS[i % 4] if words else " ".join(rng.choice(PHONES, 4)))
            for i in range(n)]


@pytest.mark.parametrize("label_type,words", [("character", True), ("bpe_20", True),
                                              ("word", True), ("phone61", False)])
def test_load_npy_split_matches_jax(tmp_path, label_type, words):
    root = _fake_corpus(tmp_path, {"train": _rows(6, words), "dev": _rows(3, words, False)})
    assert npy_corpus.available_splits(root) == jnpy.available_splits(root) == ["dev", "train"]
    assert npy_corpus.read_transcripts(root, "train") == jnpy.read_transcripts(root, "train")
    jexp = JExperimentConfig.from_dict({"label_type": label_type, "data_root": str(root)})
    tok = npy_corpus.corpus_tokenizer(root, label_type, "train")
    jtok = jloop.build_corpus_splits(jexp, need=())[3]
    assert tok.units == jtok.units
    for split in ("train", "dev"):
        for load in (True, False):
            got = npy_corpus.load_npy_split(root, split, tok, load)
            want = jnpy.load_npy_split(root, split, jtok, load)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert (g.name, g.label_ids, g.text, g.speaker) == \
                    (w.name, w.label_ids, w.text, w.speaker)
                assert g.wav.dtype == np.float32 and g.wav.shape == w.wav.shape
                np.testing.assert_array_equal(g.wav, w.wav)


@pytest.mark.parametrize("splits,prefixes", [
    (["dev", "dev_clean", "train"], ("dev",)),
    (["dev_clean", "dev_other", "train100h"], ("dev",)),
    (["eval1", "eval2", "train"], ("test", "eval")),
    (["test_other", "eval1"], ("test", "eval")),
    (["train"], ("test", "eval")),
])
def test_pick_split_matches_jax(splits, prefixes):
    assert npy_corpus.pick_split(splits, *prefixes) == jnpy.pick_split(splits, *prefixes)


def test_bad_split_layouts_raise_as_jax(tmp_path):
    root = _fake_corpus(tmp_path / "c", {"train": _rows(2)})
    np.save(root / "train" / "feats" / "u0.npy", np.zeros((3, 2, 2), np.float32))
    tok = npy_corpus.corpus_tokenizer(root, "character", "train")
    for fn in (npy_corpus.load_npy_split, jnpy.load_npy_split):
        with pytest.raises(ValueError, match=r"expected \[T, D\]"):
            fn(root, "train", tok)
        with pytest.raises(FileNotFoundError, match="missing"):
            fn(root, "dev", tok)
    for fn in (npy_corpus.available_splits, jnpy.available_splits):
        with pytest.raises(FileNotFoundError, match="not a directory"):
            fn(tmp_path / "absent")


@pytest.mark.parametrize("case", ["character", "bpe", "multitask"])
def test_build_corpus_splits_matches_jax(tmp_path, case):
    """train_data_size wins over "train"; dev and test by prefix; without a
    test split the dev split stands in with the JAX warning; splits outside
    ``need`` come back empty; multitask utterances carry their sub labels."""
    words = case != "multitask"
    splits = {"train": _rows(5, words), "train100h": _rows(7, words, prefix="h"),
              "dev_other": _rows(3, words, prefix="d"), "dev_clean": _rows(2, words, False)}
    if case != "bpe":
        splits["test_clean"] = _rows(2, words, prefix="t")
    root = _fake_corpus(tmp_path, splits)
    raw = {"character": {"label_type": "character", "train_data_size": "train100h"},
           "bpe": {"label_type": "bpe_20"},
           "multitask": {"model_type": "multitask_ctc", "label_type": "phone61",
                         "label_type_sub": "character"}}[case] | {"data_root": str(root)}
    exp, jexp = experiment_from_dict(raw), JExperimentConfig.from_dict(raw)
    for need in (("train", "dev", "test"), ("dev",)):
        with warnings.catch_warnings(record=True) as got_warn:
            warnings.simplefilter("always")
            got = build_corpus_splits(exp, need=need)
        with warnings.catch_warnings(record=True) as want_warn:
            warnings.simplefilter("always")
            want = jloop.build_corpus_splits(jexp, need=need)
        assert [str(w.message) for w in got_warn] == [str(w.message) for w in want_warn]
        assert bool(got_warn) == (case == "bpe")
        assert got[3].units == want[3].units
        for g_split, w_split in zip(got[:3], want[:3]):
            assert [(u.name, u.label_ids, u.sub_ids, u.speaker) for u in g_split] == \
                [(u.name, u.label_ids, u.sub_ids, u.speaker) for u in w_split]
    assert [u.name for u in got[1]] == ["u0", "u1"]  # dev_clean sorts before dev_other
    # the tokenizer of a data_root config without loading it (task_from_dict, bin/serve)
    _, units, _ = task_from_dict(raw)
    assert units == list(want[3].units)


# ---- bin/prepare -------------------------------------------------------------

PREPARE_CASES = {
    "fbank-utterance": [],
    "fbank-speaker": ["--cmvn", "speaker", "--no-energy"],
    "fbank-none": ["--cmvn", "none", "--no-delta"],
    "mfcc-utterance": ["--feature", "mfcc"],
    "mfcc-speaker": ["--feature", "mfcc", "--cmvn", "speaker", "--input-size", "23"],
}


@pytest.mark.parametrize("case", sorted(PREPARE_CASES))
def test_prepare_matches_jax(tmp_path, wavs, case, capsys):
    _, scps, utts = wavs
    args = ["train", "--wav-scp", str(scps["train"]), "--batch", "8", *PREPARE_CASES[case]]
    prepare.main([str(tmp_path / "port"), *args, "--device", "cpu"])
    got_out = capsys.readouterr().out
    jprepare.main([str(tmp_path / "jax"), *args])
    want_out = capsys.readouterr().out
    assert got_out.replace("/port/", "/jax/") == want_out
    got, want = tmp_path / "port" / "train", tmp_path / "jax" / "train"
    assert (got / "transcripts.tsv").read_bytes() == (want / "transcripts.tsv").read_bytes()
    for u in utts[:16]:
        g, w = np.load(got / "feats" / f"{u.name}.npy"), np.load(want / "feats" / f"{u.name}.npy")
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=PREPARE_ATOL, rtol=0, err_msg=u.name)


def test_prepare_rejects_bad_inputs_as_jax(tmp_path, wavs):
    root, scps, utts = wavs
    bad_rate, bad_width = tmp_path / "r.wav", tmp_path / "w.wav"
    _write_wav(bad_rate, utts[0].wav, rate=8000)
    _write_wav(bad_width, utts[0].wav, width=1)
    for path, match in ((bad_rate, "sample rate 8000"), (bad_width, "16-bit")):
        with pytest.raises(ValueError, match=match) as got:
            prepare.read_wav(path, SR)
        with pytest.raises(ValueError, match=match) as want:
            jprepare.read_wav(path, SR)
        assert str(got.value) == str(want.value)
    scp = _write_scp(tmp_path / "nospk.scp", utts[:2], root, speakers=False)
    assert prepare.parse_scp(scp) == jprepare.parse_scp(scp)
    for main in (lambda a: prepare.main([*a, "--device", "cpu"]), jprepare.main):
        with pytest.raises(ValueError, match="4-column scp"):
            main([str(tmp_path / "o"), "train", "--wav-scp", str(scp), "--cmvn", "speaker"])
    (tmp_path / "short.scp").write_text("u1\tonly_two\n")
    for parse in (prepare.parse_scp, jprepare.parse_scp):
        with pytest.raises(ValueError, match="bad scp line"):
            parse(tmp_path / "short.scp")


def test_prepare_mixes_stereo_down_as_jax(tmp_path):
    rng = np.random.RandomState(0)
    pcm = (rng.randn(800, 2) * 3000).astype(np.int16)
    with wave.open(str(tmp_path / "s.wav"), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())
    np.testing.assert_array_equal(prepare.read_wav(tmp_path / "s.wav", SR),
                                  jprepare.read_wav(tmp_path / "s.wav", SR))


# ---- MFCC --------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(use_energy=False, add_deltas=False, cmvn="none"),
                                dict(num_mels=23, num_ceps=12, cmvn="none")])
def test_mfcc_features_match_jax(kw):
    rng = np.random.RandomState(3)
    wav = (rng.randn(2, 6000) * 0.1).astype(np.float32)
    lens = np.asarray([6000, 3100], np.int32)
    wav[1, 3100:] = 0.0
    want, want_len = jf.extract_features(jnp.asarray(wav), jnp.asarray(lens),
                                         jf.FrontendConfig(feature_type="mfcc", **kw))
    cfg = tf_.FrontendConfig(feature_type="mfcc", **kw)
    got, got_len = tf_.extract_features(torch.from_numpy(wav), torch.from_numpy(lens), cfg)
    assert got.shape[-1] == cfg.feature_dim == jf.FrontendConfig(feature_type="mfcc",
                                                                  **kw).feature_dim
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)
    np.testing.assert_array_equal(tf_._dct_matrix(cfg), jf._dct_matrix(
        jf.FrontendConfig(feature_type="mfcc", **kw)))


def test_mfcc_frontend_config_counts_cepstra_as_jax():
    raw = {"feature": "mfcc", "input_size": 13, "use_energy": True, "use_delta": True}
    got, want = experiment_from_dict(raw).frontend_config(), \
        JExperimentConfig.from_dict(raw).frontend_config()
    assert tuple(got) == tuple(want) and got.feature_dim == want.feature_dim == 42


# ---- per-speaker CMVN --------------------------------------------------------


def _feature_utts(seed, n=9, d=5):
    """[T, d] feature utterances of 3 speakers (every third has none), offset by speaker."""
    rng = np.random.RandomState(seed)
    return [Utterance(f"f{i}", (rng.randn(rng.randint(17, 60), d) * (1 + i % 3) + i % 3)
                      .astype(np.float32), [i % 4, 1], "x", speaker=f"s{i % 3}" if i % 3
                      else None) for i in range(n)]


def _assert_stats_equal(got, want, tol=STATS_TOL):
    assert set(got) == set(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, **tol, err_msg=k)


def test_speaker_stats_of_features_match_jax():
    utts = _feature_utts(0)
    got, want = speaker_cmvn.compute_speaker_stats(utts), jspk.compute_speaker_stats(utts)
    _assert_stats_equal(got, want)
    # GLOBAL_KEY holds the whole corpus, not the speakerless rows
    frames = np.concatenate([u.wav for u in utts]).astype(np.float64)
    np.testing.assert_allclose(got[speaker_cmvn.GLOBAL_KEY][0], frames.mean(0), rtol=1e-6)
    unseen = utts[:2] + [Utterance("new", utts[0].wav, [1], "x", speaker="unseen")]
    for g, w in zip(speaker_cmvn.batch_cmvn_rows(got, unseen), jspk.batch_cmvn_rows(got, unseen)):
        np.testing.assert_array_equal(g, w)


def test_speaker_stats_of_waveforms_match_jax(wavs):
    utts = wavs[2][:10]
    cfg, jcfg = tf_.FrontendConfig(cmvn="speaker"), jf.FrontendConfig(cmvn="speaker")
    got = speaker_cmvn.compute_speaker_stats(utts, cfg, 4, device="cpu")
    _assert_stats_equal(got, jspk.compute_speaker_stats(utts, jcfg, 4), WAV_STATS_TOL)
    assert len(got) == 5  # 4 speakers and GLOBAL_KEY


# ---- the features mode of Dataset and device_pipeline --------------------------


def test_features_dataset_batches_match_jax():
    utts = _feature_utts(1, n=22)
    stats = speaker_cmvn.compute_speaker_stats(utts)
    kw = dict(cmvn_stats=stats, max_frames_per_batch=150, min_batch_rows=4, seed=2)
    for epoch in (0, 1):
        got = list(Dataset(utts, 8, sort_stop_epoch=1, **kw).batches(epoch))
        want = list(JDataset(utts, 8, sort_stop_epoch=1, **kw).batches(epoch))
        assert len(got) == len(want) and len(got) > 3
        for g, w in zip(got, want):
            assert set(g) == set(w) and g["names"] == w["names"]
            assert len(g["names"]) % 4 == 0
            for k in g:
                if k != "names":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    ds = Dataset(utts, 8, **kw)
    assert ds.input_kind == "features" and ds.num_batches == JDataset(utts, 8, **kw).num_batches


def test_halving_keeps_a_multiple_of_the_row_floor():
    """24 rows at a floor of 8 halve to 8, not 12 (which 8 microbatches
    cannot split), as the JAX Dataset does."""
    utts = [Utterance(f"u{i}", np.zeros((100, 2), np.float32), [1], "x") for i in range(24)]
    for cls in (Dataset, JDataset):
        assert cls(utts, 24, max_frames_per_batch=1500, min_batch_rows=8).num_batches == 3


def _pipeline_batch(seed, d):
    rng = np.random.RandomState(seed)
    return rng, {"cmvn_mean": rng.randn(3, d).astype(np.float32),
                 "cmvn_inv_std": (0.5 + rng.rand(3, d)).astype(np.float32)}


@pytest.mark.parametrize("mode", ["features", "wav"])
def test_device_pipeline_with_cmvn_rows_matches_jax(mode):
    enc = dict(encoder_type="blstm", num_units=8, num_layers=1)
    if mode == "features":
        d = 7
        rng, batch = _pipeline_batch(5, d)
        batch["inputs"] = rng.randn(3, 29, d).astype(np.float32)
        batch["input_len"] = np.asarray([29, 11, 20], np.int32)
        kw = dict(frontend=None, feature_dim=d, num_stack=3, num_skip=2, splice=1)
        jkw, tol = dict(kw), dict(atol=1e-6, rtol=0)
    else:
        d = 41
        rng, batch = _pipeline_batch(6, d)
        batch["inputs"] = (rng.randn(3, 4000) * 0.1).astype(np.float32)
        batch["input_len"] = np.asarray([4000, 2500, 900], np.int32)
        kw = dict(frontend=tf_.FrontendConfig(cmvn="speaker", add_deltas=False), num_stack=2,
                  num_skip=2)
        jkw = dict(kw, frontend=jf.FrontendConfig(cmvn="speaker", add_deltas=False))
        tol = FEAT_TOL
    task = ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=4),
                                  **kw)
    jtask = jctc.CTCTaskConfig(model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=4),
                               **jkw)
    got, got_len = ctc_task.device_pipeline(task, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    want, want_len = jctc.device_pipeline(jtask, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---- end to end: bin/prepare -> bin/train (accumulation) -> bin/eval, bin/decode --


@pytest.fixture(scope="module")
def trained(wavs, tmp_path_factory):
    """A tiny ls100_ctc trained by bin/train from a --cmvn none prepared corpus,
    with cmvn: speaker and grad_accum_steps: 2."""
    _, scps, _ = wavs
    root = tmp_path_factory.mktemp("e2e")
    for split, scp in scps.items():
        prepare.main([str(root / "data"), split, "--wav-scp", str(scp), "--no-energy",
                      "--cmvn", "none", "--device", "cpu"])
    raw = dict(TINY_LS100, data_root=str(root / "data"), cmvn="speaker")
    cfg = root / "tiny.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    summary = train_cli.main([str(cfg), str(root / "m"), "--device", "cpu"])
    return raw, root / "m", summary


def test_bin_train_eval_decode_from_data_root_equal_jax(trained, capsys):
    raw, model_dir, summary = trained
    assert summary["steps"] == 4 and summary["nonfinite_steps"] == 0
    assert np.isfinite(summary["train_loss"])
    got = eval_cli.main([str(model_dir), "--device", "cpu"])
    assert list(got) == ["dev_clean", "dev_other", "test_clean"]  # every non-train split
    # the JAX eval step on the same weights, split by split, each with its own speaker stats
    jexp = JExperimentConfig.from_dict(raw)
    _, _, _, tok = jloop.build_corpus_splits(jexp, need=())
    _, state = CheckpointManager(model_dir / "checkpoints").restore({"params": None})
    params = jax.tree.map(jnp.asarray, params_to_jax(state["params"]))
    for split, m in got.items():
        utts = jnpy.load_npy_split(raw["data_root"], split, tok)
        jtask, jmod = jloop.build_task(jexp, tok, jloop.feature_dim_of(utts))
        ds = JDataset(utts, jexp.batch_size, cmvn_stats=jloop.cmvn_stats_for(jexp, jtask, utts))
        want = jmetrics.evaluate_ctc(jmod.make_eval_step(jtask), params, ds, tok,
                                     jexp.label_type)
        for k in ("error_rate", "sub_rate", "ins_rate", "del_rate", "num_utts", "wer"):
            assert m[k] == want[k], (split, k)
        np.testing.assert_allclose(m["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=split)
    lines = decode_cli.main([str(model_dir), "--device", "cpu", "--num-utts", "3"])
    assert sum(s.startswith("[toy") for s in lines) == 3
    assert sum(s.startswith("  HYP") for s in lines) == 3


def test_serving_a_data_root_model_raises(trained, tmp_path):
    raw, _, _ = trained
    cfg = tmp_path / "c.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    with pytest.raises(NotImplementedError, match="export"):
        serve_cli.load_model(cfg, tmp_path / "w.npz", torch.device("cpu"))
