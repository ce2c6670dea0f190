"""The port's training loop around the step: data, eval, config, ``bin/train``.

- the toy corpus and ``Dataset`` give the JAX package's batches for one seed;
- ``evaluate_ctc`` gives the JAX rates on the same decoded ids;
- ``ExperimentConfig`` reads the CTC configs as the JAX one does;
- ``bin/train`` runs end to end on the CPU, writes its files, and a resumed
  run continues from the saved epoch to the same weights as an
  uninterrupted one (bit for bit: the CPU path is deterministic).
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.data import Dataset as JDataset
from tensorflow_end2end_speech_recognition_tpu.data import ToyCorpus as JToyCorpus
from tensorflow_end2end_speech_recognition_tpu.utils import metrics as jmetrics
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
from tensorflow_end2end_speech_recognition_tpu_torch.data.toy_corpus import ToyCorpus
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit
from tensorflow_end2end_speech_recognition_tpu_torch.utils import metrics
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    ExperimentConfig,
    experiment_from_dict,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.edit_distance import levenshtein

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(model_type="ctc", corpus="toy", label_type="character", input_size=40,
            use_energy=False, use_delta=True, num_stack=3, num_skip=3,
            encoder_type="blstm", num_units=8, num_layers=2, dropout=0.8, batch_size=4,
            num_epoch=2, optimizer="adam", learning_rate=1e-3, clip_grad_norm=5.0,
            weight_decay=1e-8, sort_utt=True, sort_stop_epoch=1, toy_num_utts=12,
            toy_max_units=4)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["names"] == w["names"]
        assert set(g) == set(w)
        for k in g:
            if k != "names":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("label_type,kw", [
    ("character", dict(batch_size=5, sort_stop_epoch=1)),
    ("phone61", dict(batch_size=4, sort_utt=False, seed=3)),
    ("character", dict(batch_size=8, max_frames_per_batch=600, samples_per_frame=160)),
])
def test_dataset_batches_match_jax(label_type, kw):
    corpus = ToyCorpus(label_type=label_type, num_utts=13, max_units=6, seed=5)
    jcorpus = JToyCorpus(label_type=label_type, num_utts=13, max_units=6, seed=5)
    for u, ju in zip(corpus.utterances, jcorpus.utterances):
        assert (u.name, u.label_ids, u.text, u.speaker) == (ju.name, ju.label_ids, ju.text,
                                                            ju.speaker)
        np.testing.assert_array_equal(u.wav, ju.wav)
    ds, jds = Dataset(corpus.utterances, **kw), JDataset(jcorpus.utterances, **kw)
    assert ds.num_batches == jds.num_batches
    for epoch in (0, 2):
        _assert_same_batches(list(ds.batches(epoch)), list(jds.batches(epoch)))


def _fake_eval_step(labels, blank):
    """Decoded ids made from the labels by a fixed edit: drop, swap, insert."""
    labels = np.asarray(labels)
    out = np.full((labels.shape[0], labels.shape[1] + 2), blank, np.int32)
    lens = np.zeros((labels.shape[0],), np.int32)
    for i, row in enumerate(labels):
        ids = [int(j) for j in row if j >= 0]
        ids = ids[1:] if i % 3 == 0 else ids
        if i % 3 == 1 and ids:
            ids[0] = (ids[0] + 1) % blank
        if i % 3 == 2:
            ids = ids + [i % blank, 0]
        out[i, : len(ids)] = ids
        lens[i] = len(ids)
    nll = np.arange(labels.shape[0], dtype=np.float32) + 0.5
    return out, lens, nll


@pytest.mark.parametrize("label_type", ["character", "phone61"])
def test_evaluate_ctc_matches_jax_rates(label_type):
    corpus = ToyCorpus(label_type=label_type, num_utts=11, max_units=7, seed=6)
    jcorpus = JToyCorpus(label_type=label_type, num_utts=11, max_units=7, seed=6)
    blank = corpus.tokenizer.blank_id

    def step(_, batch):
        return tuple(torch.from_numpy(x) for x in _fake_eval_step(batch["labels"], blank))

    def jstep(_, batch):
        return tuple(jnp.asarray(x) for x in _fake_eval_step(batch["labels"], blank))

    got = metrics.evaluate_ctc(step, None, Dataset(corpus.utterances, 4), corpus.tokenizer,
                               label_type, device="cpu")
    want = jmetrics.evaluate_ctc(jstep, None, JDataset(jcorpus.utterances, 4),
                                 jcorpus.tokenizer, label_type, multihost=False)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert 0 < got["error_rate"] < 1 and got["num_utts"] == 11


def test_levenshtein_counts():
    assert levenshtein([], []) == (0, 0, 0, 0)
    assert levenshtein([1, 2, 3], []) == (3, 0, 0, 3)
    assert levenshtein([], [4, 5]) == (2, 0, 2, 0)
    assert levenshtein([1, 2, 3, 4], [1, 9, 3, 4, 5]) == (2, 1, 1, 0)


@pytest.mark.parametrize("name", ["ls100_ctc", "timit_ctc_blstm"])
def test_experiment_config_matches_jax(name):
    import yaml

    raw = yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())
    exp, jexp = experiment_from_dict(raw), JExperimentConfig.from_dict(raw)
    assert exp == ExperimentConfig.from_yaml(REPO / "configs" / f"{name}.yml")
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name


def test_experiment_config_rejects_unknown_and_unported():
    with pytest.raises(KeyError, match="num_pipeline_stage_count"):
        experiment_from_dict({"num_pipeline_stage_count": 2})
    assert experiment_from_dict({"num_pipeline_microbatches": 2}).num_pipeline_microbatches == 2
    assert experiment_from_dict({"dropout_encoder": 0.5}).dropout == 0.5
    assert experiment_from_dict({"learning_rate": "3e-3"}).learning_rate == 3e-3
    conformer = {"encoder_type": "conformer", "num_layers": 2}
    # pipeline stages are ported: they train, and a batch the microbatches do
    # not divide raises the JAX fit's ValueError
    experiment_from_dict(dict(conformer, num_pipeline_stages=2)).check_trainable()
    with pytest.raises(ValueError, match="not divisible by num_pipeline_microbatches 8"):
        experiment_from_dict(dict(conformer, num_pipeline_stages=2, batch_size=12)
                             ).check_trainable()
    # the other mesh axes are ported; what JAX refuses raises its ValueError
    for raw in ({"num_expert_shards": 2}, {"num_sequence_shards": 2}):
        with pytest.raises(ValueError):
            experiment_from_dict(raw).check_trainable()
    for raw in ({"num_model_shards": 2}, dict(conformer, num_sequence_shards=2),
                dict(conformer, moe_num_experts=4, num_expert_shards=2),
                {"num_devices": 4, "fsdp": True, "num_model_shards": 2}):
        experiment_from_dict(raw).check_trainable()
    # data parallelism and ZeRO-3 are ported; fsdp needs a data axis to shard over
    experiment_from_dict({"num_devices": 4}).check_trainable()
    experiment_from_dict({"num_devices": 4, "fsdp": True}).check_trainable()
    with pytest.raises(ValueError, match="data-parallel degree"):
        experiment_from_dict({"fsdp": True}).check_trainable()
    # on-disk corpora and gradient accumulation are ported
    experiment_from_dict({"grad_accum_steps": 2, "data_root": "/data"}).check_trainable()
    with pytest.raises(ValueError, match="model_type"):
        experiment_from_dict({"model_type": "attention"}).ctc_config(28)


def test_fit_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(experiment_from_dict(TINY), tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):  # profiling is ported: the card still refused
        fit(experiment_from_dict(TINY), tmp_path, profile_steps=(2, 5))


def test_bin_train_end_to_end_and_resume(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in TINY.items()))
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    summary = train_cli.main([str(cfg), str(straight), "--device", "cpu"])
    assert summary["epochs"] == 2 and summary["steps"] == 6  # 10 train utterances, batch 4
    assert summary["nonfinite_steps"] == 0 and np.isfinite(summary["train_loss"])
    for f in ("metrics.csv", "train.log", "summary.json", "config.yml"):
        assert (straight / f).exists(), f
    assert len((straight / "metrics.csv").read_text().splitlines()) == 3
    assert "FINAL" in (straight / "train.log").read_text()
    assert ExperimentConfig.from_yaml(straight / "config.yml") == experiment_from_dict(TINY)

    train_cli.main([str(cfg), str(resumed), "--device", "cpu", "--epochs", "1"])
    assert CheckpointManager(resumed / "checkpoints").latest_epoch == 0
    summary2 = train_cli.main([str(cfg), str(resumed), "--device", "cpu"])
    assert "resuming from checkpoint epoch 0" in (resumed / "train.log").read_text()
    assert summary2["epochs"] == 2 and summary2["steps"] == 6
    _, a = CheckpointManager(straight / "checkpoints").restore({"params": 0, "extra": 0}, 1)
    _, b = CheckpointManager(resumed / "checkpoints").restore({"params": 0, "extra": 0}, 1)
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    assert a["extra"]["step"] == b["extra"]["step"] == 6
    assert torch.equal(a["extra"]["opt_state"]["count"], b["extra"]["opt_state"]["count"])
