"""Joint rescoring, the beam eval steps and the eval / decode CLIs of the port,
against the JAX package on the CPU.

- ``joint_rescore`` on hand-made beams that hold what the attention beam
  can hand it: the sos id (which is the CTC blank), hypotheses of length 0,
  hypotheses longer than their CTC frames (no alignment: the loss is
  floored at about 1e30 on both sides) and -1 past each length. Tokens,
  lengths and ranking must be equal, scores within 1e-5 relative.
- ``ctc_task.make_beam_eval_step`` (prefix beam) and
  ``att_task.make_beam_eval_step`` (joint rescoring, length penalty 0.6) on
  bridged weights: ids and lengths equal, the NLL within 1e-4 + 1e-5
  relative (the frontend's log-mel and the recurrences sum in other orders).
- ``bin/train`` -> ``bin/eval`` -> ``bin/decode`` on the CPU for a CTC model
  (beam 3) and a joint model (beam 2, ``--joint-rescore``, ``--nbest 2``):
  the printed lines, and ``bin/eval``'s error rate equal to
  ``utils/metrics.evaluate_ctc`` of the beam eval step on the restored
  weights; a transducer (greedy in both CLIs; its beam raises).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.decoding import attention_beam as jbeam
from tensorflow_end2end_speech_recognition_tpu.decoding.joint_rescoring import (
    joint_rescore as jjoint_rescore,
)
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.seq2seq import (
    Seq2SeqConfig as JSeq2SeqConfig,
)
from tensorflow_end2end_speech_recognition_tpu.ops.ctc import ctc_loss as jctc_loss
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import attention_beam
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.joint_rescoring import (
    joint_rescore,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import Seq2SeqConfig
from tensorflow_end2end_speech_recognition_tpu_torch.ops.ctc import ctc_loss
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import (
    build_corpus_splits,
    build_task,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import ExperimentConfig
from tensorflow_end2end_speech_recognition_tpu_torch.utils.metrics import evaluate_ctc

torch.set_num_threads(1)

NUM = 4000  # padded samples: 24 frames
NLL_TOL = dict(atol=1e-4, rtol=1e-5)
NUM_CLASSES = 5  # sos = blank = 5, eos = 6


# ---- joint rescoring ------------------------------------------------------------


def _beams():
    """B = 3 utterances x W = 4 hypotheses of up to U = 6 tokens over CTC
    logits of T = 8 frames with 8, 3 and 0 valid (a filler row)."""
    rows = [
        [[0, 1, 2], [5, 5, 1], [], [3, 3, 3, 3, 3, 3]],  # sos (= blank) twice; length 0
        [[1, 1], [2], [0, 1, 2, 3, 4, 0], [4, 5, 4]],  # 2 repeats need 4 > 3 frames; 6 > 3
        [[], [0], [5], [1, 2]],  # a filler row: 0 frames
    ]
    b, w, u = len(rows), 4, 6
    tokens = np.full((b, w, u), -1, np.int32)
    lengths = np.zeros((b, w), np.int32)
    for i, hyps in enumerate(rows):
        for j, h in enumerate(hyps):
            tokens[i, j, : len(h)] = h
            lengths[i, j] = len(h)
    rng = np.random.RandomState(0)
    att = (-rng.rand(b, w) * 10).astype(np.float32)
    raw = (att - rng.rand(b, w) * 2).astype(np.float32)  # a weighted LM term
    logits = (rng.randn(b, 8, NUM_CLASSES + 1) * 2).astype(np.float32)
    logit_len = np.asarray([8, 3, 0], np.int32)
    fields = dict(tokens=tokens, lengths=lengths, scores=raw, raw_scores=raw, att_scores=att,
                  ctc_logits=logits, ctc_logit_len=logit_len)
    return (jbeam.BeamSearchResult(**{k: jnp.asarray(v) for k, v in fields.items()}),
            attention_beam.BeamSearchResult(**{k: torch.from_numpy(v)
                                               for k, v in fields.items()}))


def test_rescoring_ctc_losses_match_jax_on_beam_labels():
    """The loss-only CTC (#6's plain version) on the B·W rows that rescoring
    builds: JAX's scan where an alignment exists, and about 1e30 where none
    does, on both sides (each floors at -1e30 in its own order)."""
    jres, res = _beams()
    b, w, u = res.tokens.shape
    args = (res.ctc_logits.repeat_interleave(w, 0).contiguous(),
            res.ctc_logit_len.repeat_interleave(w), res.tokens.reshape(b * w, u),
            res.lengths.reshape(b * w))
    got = ctc_loss(*args, blank_id=NUM_CLASSES, need_grad=False).numpy()
    want = np.asarray(jctc_loss(*(jnp.asarray(x.numpy()) for x in args),
                                blank_id=NUM_CLASSES, need_grad=False))
    impossible = want > 1e20
    assert impossible.sum() >= 3  # rows 1/0, 1/2, 0/3 (6 labels, 5 repeats, 8 frames)
    np.testing.assert_array_equal(got > 1e20, impossible)
    np.testing.assert_allclose(got[~impossible], want[~impossible], atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got[impossible], want[impossible], rtol=1e-5)


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_joint_rescore_matches_jax(length_penalty):
    jres, res = _beams()
    want = jjoint_rescore(jres, 0.3, NUM_CLASSES, length_penalty)
    got = joint_rescore(res, 0.3, NUM_CLASSES, length_penalty)
    for f in ("tokens", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("scores", "raw_scores", "att_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    # the ranking moved, and the impossible hypotheses went last
    assert not np.array_equal(got.tokens.numpy(), res.tokens.numpy())
    assert (got.scores.numpy()[:2, -1] < -1e28).all()


# ---- the beam eval steps ----------------------------------------------------------


def _batch(seed, label_width=6):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, NUM) * 0.1).astype(np.float32)
    input_len = np.asarray([NUM, 3000, 1200, 0], np.int32)  # the last a filler row
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    label_len = np.asarray([5, 3, 1, 0], np.int32)
    labels = np.full((4, label_width), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, NUM_CLASSES, n)
    return {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len}


def _bridge(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model)


def _compare(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **NLL_TOL)


def test_ctc_beam_eval_step_matches_jax():
    enc = dict(encoder_type="blstm", num_units=16, num_layers=2)
    jtask = jctc.CTCTaskConfig(
        model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=NUM_CLASSES),
        frontend=JFrontendConfig(use_energy=False), num_stack=2, num_skip=2)
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=NUM_CLASSES),
        frontend=FrontendConfig(use_energy=False), num_stack=2, num_skip=2)
    jparams = jctc.init_params(jax.random.PRNGKey(3), jtask)
    params = _bridge(jparams, ctc_task.init_model(task))
    batch = _batch(4)
    want = jctc.make_beam_eval_step(jtask, 3)(jparams, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    got = ctc_task.make_beam_eval_step(task, 3)(params, {k: torch.from_numpy(v)
                                                         for k, v in batch.items()})
    _compare(got, want)
    assert got[0].shape == (4, 12) and int(got[1].sum()) > 0 and int(got[1][3]) == 0


def _att_tasks(max_len=10):
    enc = dict(encoder_type="pyramidal_blstm", num_units=8, num_layers=2)
    att = dict(attention_type="hybrid", attention_dim=8, conv_num_channels=3, conv_width=7)
    common = dict(num_classes=NUM_CLASSES, decoder_num_units=8, embedding_dim=4,
                  max_decode_length=max_len, ctc_loss_weight=0.3)
    jtask = jatt.AttTaskConfig(
        model=JSeq2SeqConfig(encoder=JEncoderConfig(**enc), attention=JAttentionConfig(**att),
                             **common), frontend=JFrontendConfig(use_energy=False))
    task = att_task.AttTaskConfig(
        model=Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att),
                            **common), frontend=FrontendConfig(use_energy=False))
    return jtask, task


@pytest.mark.parametrize("rescore", [0.3, None])
def test_att_beam_eval_step_matches_jax(rescore):
    jtask, task = _att_tasks()
    jparams = jatt.init_params(jax.random.PRNGKey(2), jtask)
    params = _bridge(jparams, att_task.init_model(task))
    batch = _batch(5)
    want = jatt.make_beam_eval_step(jtask, 3, 0.6, joint_rescore_weight=rescore)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = att_task.make_beam_eval_step(task, 3, 0.6, joint_rescore_weight=rescore)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _compare(got, want)
    assert got[0].shape == (4, 10) and got[0].dtype == torch.int32


# ---- bin/train -> bin/eval -> bin/decode on the CPU -----------------------------

CTC_YAML = """model_type: ctc
corpus: toy
label_type: character
input_size: 40
use_energy: false
use_delta: true
num_stack: 3
num_skip: 3
encoder_type: blstm
num_units: 8
num_layers: 2
batch_size: 4
eval_batch_size: 3
num_epoch: 1
optimizer: adam
learning_rate: 0.001
toy_num_utts: 20
toy_max_units: 4
beam_width: 3
"""
JOINT_YAML = """model_type: joint_ctc_attention
corpus: toy
label_type: character
input_size: 40
use_energy: false
use_delta: true
encoder_type: pyramidal_blstm
num_units: 8
num_layers: 2
num_pyramid_levels: 1
attention_type: hybrid
attention_dim: 8
decoder_num_units: 8
embedding_dim: 4
ctc_loss_weight: 0.3
max_decode_length: 12
batch_size: 4
num_epoch: 1
optimizer: adam
learning_rate: 0.001
toy_num_utts: 20
toy_max_units: 4
beam_width: 2
length_penalty: 0.6
"""


def _trained(tmp_path, name, yaml_text):
    cfg = tmp_path / f"{name}.yml"
    cfg.write_text(yaml_text)
    train_cli.main([str(cfg), str(tmp_path / name), "--device", "cpu"])
    return tmp_path / name


def _restored_eval(model_dir, joint: bool):
    """``evaluate_ctc`` of the config's beam eval step on the best checkpoint."""
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    _, dev, _, tok = build_corpus_splits(exp)
    task, mod = build_task(exp, tok)
    _, model = eval_cli.restore_model(model_dir, task, mod, None, "cpu")
    if joint:
        step = mod.make_beam_eval_step(task, exp.beam_width, exp.length_penalty,
                                       joint_rescore_weight=exp.ctc_loss_weight)
    else:
        step = mod.make_beam_eval_step(task, exp.beam_width)
    return evaluate_ctc(step, dict(model.state_dict()), Dataset(dev, exp.eval_batch_size
                                                                or exp.batch_size),
                        tok, exp.label_type, device="cpu")


def _check_decode_lines(lines, beam: int, nbest: int, tag: str, n_utts: int):
    assert lines[0].endswith(f"epoch 0 beam {beam}{tag}")
    body = lines[1:]
    assert len(body) == n_utts * (2 + nbest)
    for i in range(n_utts):
        head, ref, *hyps = body[i * (2 + nbest):(i + 1) * (2 + nbest)]
        assert head.startswith("[toy") and " score " in head
        assert ref.startswith("  REF: ") and hyps[0].startswith("  HYP: ")
        for r, h in enumerate(hyps[1:], start=2):
            assert h.startswith(f"  HYP{r} (score ")


def test_ctc_train_eval_decode_cli(tmp_path, capsys):
    model_dir = _trained(tmp_path, "ctc", CTC_YAML)
    capsys.readouterr()
    got = eval_cli.main([str(model_dir), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "decoding with beam width 3"
    assert out[1].startswith("dev (epoch 0): error_rate ") and out[1].endswith("[2 utts]")
    assert out[2].startswith("test (epoch 0): error_rate ")
    want = _restored_eval(model_dir, joint=False)
    assert got["dev"]["error_rate"] == want["error_rate"]
    assert got["dev"]["loss"] == pytest.approx(want["loss"], rel=1e-6)
    lines = decode_cli.main([str(model_dir), "--device", "cpu", "--beam-width", "3",
                             "--nbest", "2", "--num-utts", "2"])
    _check_decode_lines(lines, 3, 2, "", 2)
    greedy = decode_cli.main([str(model_dir), "--device", "cpu", "--num-utts", "2"])
    _check_decode_lines(greedy, 1, 1, "", 2)


def test_joint_train_eval_decode_cli(tmp_path, capsys):
    model_dir = _trained(tmp_path, "joint", JOINT_YAML)
    capsys.readouterr()
    got = eval_cli.main([str(model_dir), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "decoding with beam width 2"
    assert out[1].startswith("dev (epoch 0): error_rate ") and " wer " in out[1]
    want = _restored_eval(model_dir, joint=True)
    assert got["dev"]["error_rate"] == want["error_rate"]
    assert got["dev"]["loss"] == pytest.approx(want["loss"], rel=1e-6)
    lines = decode_cli.main([str(model_dir), "--device", "cpu", "--beam-width", "2",
                             "--joint-rescore", "--nbest", "2", "--num-utts", "2",
                             "--length-penalty", "0.6"])
    _check_decode_lines(lines, 2, 2, " +joint-rescore", 2)


def test_clis_default_to_the_card(tmp_path):
    """Without ``--device`` the CLIs ask for the card, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        eval_cli.main([str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA card"):
        decode_cli.main([str(tmp_path)])
    from tensorflow_end2end_speech_recognition_tpu_torch.bin import train_lm

    with pytest.raises(RuntimeError, match="CUDA card"):
        train_lm.main([str(tmp_path / "x.yml"), str(tmp_path / "lm")])



def test_transducer_eval_decode_cli(tmp_path, capsys):
    """The transducer decodes greedily in both CLIs, and with its beam at a
    beam width above 1."""
    model_dir = _trained(tmp_path, "rnnt", "model_type: transducer\nlabel_type: character\n"
                         "input_size: 40\nuse_energy: false\nuse_delta: false\ncmvn: none\n"
                         "num_stack: 3\nnum_skip: 3\nencoder_type: lstm\nnum_units: 8\n"
                         "num_layers: 2\npred_num_units: 8\nembedding_dim: 4\njoint_dim: 8\n"
                         "batch_size: 4\nnum_epoch: 1\ntoy_num_utts: 20\ntoy_max_units: 4\n")
    capsys.readouterr()
    got = eval_cli.main([str(model_dir), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("dev (epoch 0): error_rate ") and len(out) == 2
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    _, dev, _, tok = build_corpus_splits(exp)
    task, mod = build_task(exp, tok)
    _, model = eval_cli.restore_model(model_dir, task, mod, None, "cpu")
    want = evaluate_ctc(mod.make_eval_step(task), dict(model.state_dict()),
                        Dataset(dev, exp.batch_size), tok, exp.label_type, device="cpu")
    assert got["dev"]["error_rate"] == want["error_rate"]
    _check_decode_lines(decode_cli.main([str(model_dir), "--device", "cpu", "--num-utts", "2"]),
                        1, 1, "", 2)
    capsys.readouterr()
    got = eval_cli.main([str(model_dir), "--device", "cpu", "--beam-width", "2"])
    assert capsys.readouterr().out.splitlines()[0] == "decoding with beam width 2"
    want = evaluate_ctc(mod.make_beam_eval_step(task, 2), dict(model.state_dict()),
                        Dataset(dev, exp.batch_size), tok, exp.label_type, device="cpu")
    assert got["dev"]["error_rate"] == want["error_rate"]
    _check_decode_lines(decode_cli.main([str(model_dir), "--device", "cpu", "--num-utts", "2",
                                         "--beam-width", "2", "--nbest", "2"]), 2, 2, "", 2)
