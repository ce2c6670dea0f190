"""The port's VGG and multitask encoders, the sub head and their training against
the JAX package, on the CPU.

Both sides start from the same JAX-initialised weights (bridged) and take the
same seeded numpy inputs. The encoders run at odd T and odd frequency widths
(F = 13 and 11, as the configs' 41 pool 41 -> 21 -> 11), ragged lengths that
include 1 and T; the JAX BLSTM runs on its scan, as the JAX tests run it on
the CPU. Dropout stays at keep 1.0 and scheduled sampling at 0 (jax.random
cannot be replayed in torch). Tolerances, float32:

- encoder outputs, taps and logits: atol 1e-5 (3x3 convolutions, pools and a
  few recurrent layers summing in other orders);
- train steps: the loss terms within 1e-4 relative; SGD's update of every
  weight (lr times its clipped gradient) within 1e-3 of the tensor's largest
  entry, or of 1e-3 of the largest entry of all updates where that is
  larger (the float32 noise of a gradient that nearly cancels: a location
  scorer's ``attention.b`` sums terms of both signs to about 1e-7);
- end to end: ``bin/eval`` on shrunk copies of the four configs gives the
  dev set's error rates of the JAX eval step on the same weights exactly,
  the loss within 1e-4 relative (the test set's batches would compile the
  JAX step once more).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.data import Dataset as JDataset
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import ctc as jctc
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu.utils import metrics as jmetrics
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
    vgg_output_dim,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    Seq2SeqModel,
)
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import build_corpus_splits
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    params_from_jax,
    params_to_jax,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
H = 8
NUM = 8000  # samples: 48 frames -> 12 after the VGG pools
LR = 0.1


def _bridge(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _copy(tree):  # the jitted JAX steps donate their inputs
    return jax.tree.map(jnp.array, tree)


def _close_to_largest(got: dict, want: dict, what: str):
    """Each tensor within GRAD_RTOL of its largest entry, or of 1e-3 of the
    largest entry of all tensors where that is larger; none all zero."""
    scales = {k: float(np.abs(w.numpy()).max()) for k, w in want.items()}
    floor = 1e-3 * max(scales.values())
    for k, g in got.items():
        assert scales[k] > 0, f"{what} {k} is zero"
        np.testing.assert_allclose(g.numpy(), want[k].numpy(),
                                   atol=GRAD_RTOL * max(scales[k], floor), rtol=0,
                                   err_msg=f"{what} {k}")


# ---- the encoders and the sub head ---------------------------------------------


ENCODER_CASES = {
    "vgg_blstm F=13": (dict(encoder_type="vgg_blstm", num_layers=1), 3, 13),
    "vgg_blstm one channel F=11": (dict(encoder_type="vgg_blstm", num_layers=1,
                                        input_channels=1), 1, 11),
    "vgg_lstm F=11": (dict(encoder_type="vgg_lstm", num_layers=1), 3, 11),
    "multitask_blstm": (dict(encoder_type="multitask_blstm", num_layers=2,
                             num_layers_sub=1), 1, 10),
    "multitask_lstm": (dict(encoder_type="multitask_lstm", num_layers=2,
                            num_layers_sub=1), 1, 10),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_matches_apply_encoder(case):
    kw, channels, freq = ENCODER_CASES[case]
    kw = dict(kw, num_units=H)
    jcfg, cfg = jencoders.EncoderConfig(**kw), EncoderConfig(**kw)
    d = channels * freq
    params = jencoders.init_encoder(jax.random.PRNGKey(3), jcfg, d)
    enc = Encoder(cfg, d)
    enc.load_state_dict(_bridge(params, enc))
    rng = np.random.RandomState(4)
    t = 37  # odd: the pools' SAME padding
    feats = rng.randn(3, t, d).astype(np.float32)
    lens = np.asarray([t, 1, 22], np.int32)
    feats[1, 1:] = 0.0
    want = jax.jit(lambda p, x, n: jencoders.apply_encoder(p, jcfg, x, n))(
        params, jnp.asarray(feats), jnp.asarray(lens))
    with torch.inference_mode():
        got = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.outputs.shape == want.outputs.shape
    assert got.outputs.shape[-1] == cfg.output_dim == jcfg.output_dim
    np.testing.assert_allclose(got.outputs.numpy(), np.asarray(want.outputs), atol=ATOL, rtol=0)
    if cfg.has_vgg:
        assert jcfg.has_vgg and got.outputs.shape[1] == -(-t // 4)
        assert enc.layers[0].__class__.__name__ in ("BiLSTM", "LSTM")
        first = params["layers"][0]
        wx = first["fwd"]["wx"] if "fwd" in first else first["wx"]
        assert wx.shape[0] == vgg_output_dim(d, channels)
    if cfg.is_multitask:
        np.testing.assert_array_equal(got.sub_lengths.numpy(), np.asarray(want.sub_lengths))
        np.testing.assert_allclose(got.sub_outputs.numpy(), np.asarray(want.sub_outputs),
                                   atol=ATOL, rtol=0)
    else:
        assert got.sub_outputs is None and want.sub_outputs is None


def _mt_ctc_configs(num_sub=5):
    enc = dict(encoder_type="multitask_blstm", num_units=H, num_layers=2, num_layers_sub=1)
    return (jctc.CTCConfig(encoder=jencoders.EncoderConfig(**enc), num_classes=7,
                           num_classes_sub=num_sub),
            CTCConfig(encoder=EncoderConfig(**enc), num_classes=7, num_classes_sub=num_sub))


def test_sub_head_matches_apply_ctc_and_bridges_both_ways():
    jcfg, cfg = _mt_ctc_configs()
    params = jctc.init_ctc(jax.random.PRNGKey(5), jcfg, 12)
    tree = jax.tree.map(np.asarray, params)
    model = CTCModel(cfg, 12)
    model.load_state_dict(params_from_jax(tree, model))
    back = params_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(6)
    feats = rng.randn(3, 15, 12).astype(np.float32)
    lens = np.asarray([15, 9, 1], np.int32)
    want = jax.jit(lambda p, x, n: jctc.apply_ctc(p, jcfg, x, n))(
        params, jnp.asarray(feats), jnp.asarray(lens))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(lens))
    assert got.sub_logits.shape == (3, 15, 6)
    np.testing.assert_array_equal(got.sub_logit_len.numpy(), np.asarray(want.sub_logit_len))
    for g, w in ((got.logits, want.logits), (got.sub_logits, want.sub_logits)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="multitask"):
        CTCModel(cfg._replace(encoder=EncoderConfig(num_units=H)), 12)


def test_vgg_weights_bridge_both_ways():
    kw = dict(encoder_type="vgg_blstm", num_units=H, num_layers=1)
    params = jencoders.init_encoder(jax.random.PRNGKey(7), jencoders.EncoderConfig(**kw), 39)
    tree = jax.tree.map(np.asarray, params)
    enc = Encoder(EncoderConfig(**kw), 39)
    state = params_from_jax(tree, enc)
    assert tuple(state["vgg.0.0.w"].shape) == (3, 3, 3, 64)  # HWIO, as the JAX pytree
    assert tuple(state["vgg.1.1.w"].shape) == (3, 3, 128, 128)
    back = params_to_jax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---- one multitask CTC train step ------------------------------------------------


def _wave_batch(seed, label_width, classes, sub_classes=None):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, NUM) * 0.1).astype(np.float32)
    input_len = np.asarray([NUM, 6000, 3400, NUM], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0

    def labels(n_classes, width):
        label_len = rng.randint(1, 5, 4).astype(np.int32)
        out = np.full((4, width), -1, np.int32)
        for i, n in enumerate(label_len):
            out[i, :n] = rng.randint(0, n_classes, n)
        return out, label_len

    batch = {"inputs": wav, "input_len": input_len, "weight": np.asarray([1, 1, 1, 0],
                                                                         np.float32)}
    batch["labels"], batch["label_len"] = labels(classes, label_width)
    if sub_classes is not None:
        batch["labels_sub"], batch["label_len_sub"] = labels(sub_classes, 8)
    return batch


@pytest.fixture(scope="module")
def multitask_setup():
    enc = dict(encoder_type="multitask_blstm", num_units=H, num_layers=2, num_layers_sub=1)
    common = dict(num_stack=2, num_skip=2, weight_decay=1e-2, main_task_weight=0.8)
    jtask = jctc_task.CTCTaskConfig(
        model=jctc.CTCConfig(encoder=jencoders.EncoderConfig(**enc), num_classes=9,
                             num_classes_sub=5),
        frontend=JFrontendConfig(num_mels=12, use_energy=False), **common)
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=9, num_classes_sub=5),
        frontend=FrontendConfig(num_mels=12, use_energy=False), **common)
    jparams = jctc_task.init_params(jax.random.PRNGKey(8), jtask)
    model = CTCModel(task.model, task.input_dim)
    return dict(jtask=jtask, task=task, jparams=jparams, model=model,
                params=_bridge(jparams, model))


def _train_step_matches(s, task_mod, jtask_mod, batch, step_kw: dict, want_terms: set):
    """One SGD step on both sides: every loss term, and each weight's update."""
    jtask, task, jparams, model = s["jtask"], s["task"], s["jparams"], s["model"]
    jopt, opt = jbuild_optimizer("sgd", 5.0), build_optimizer("sgd", 5.0)
    jnew, _, jaux = jtask_mod.make_train_step(jtask, jopt)(
        _copy(jparams), _copy(jopt.init(jparams)), _jb(batch), LR, jax.random.PRNGKey(1),
        *step_kw.values())
    new, _, aux = task_mod.make_train_step(task, opt)(
        s["params"], opt.init(s["params"]), _tb(batch), LR, **step_kw)
    assert not bool(aux.pop("nonfinite")) and not bool(jaux.pop("nonfinite"))
    assert set(aux) == set(jaux) == want_terms
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=LOSS_RTOL, err_msg=k)
    want_new = _bridge(jnew, model)
    _close_to_largest({k: v - s["params"][k] for k, v in new.items()},
                      {k: v - s["params"][k] for k, v in want_new.items()}, "SGD update")


def test_multitask_train_step_matches_jax(multitask_setup):
    batch = _wave_batch(9, label_width=8, classes=9, sub_classes=5)
    _train_step_matches(multitask_setup, ctc_task, jctc_task, batch, {},
                        {"ctc_nll", "ctc_nll_sub", "loss"})


def test_multitask_sub_labels_default_to_the_main_ones(multitask_setup):
    """Without sub labels in the batch the sub task reads the main labels, as
    the JAX loop's ``_to_device_batch`` fills them; the eval step reads the
    main head, as the JAX one."""
    s = multitask_setup
    batch = _wave_batch(10, label_width=8, classes=5)
    full = dict(batch, labels_sub=batch["labels"], label_len_sub=batch["label_len"])
    with torch.no_grad():
        loss, aux = ctc_task.forward_loss(s["params"], s["task"], _tb(batch), False)
        loss_full, _ = ctc_task.forward_loss(s["params"], s["task"], _tb(full), False)
    assert float(loss) == float(loss_full) and set(aux) == {"ctc_nll", "ctc_nll_sub", "loss"}
    decoded, dec_len, nll = ctc_task.make_eval_step(s["task"])(s["params"], _tb(full))
    jdecoded, jdec_len, jnll = jctc_task.make_eval_step(s["jtask"])(s["jparams"], _jb(full))
    np.testing.assert_array_equal(dec_len.numpy(), np.asarray(jdec_len))
    for i, n in enumerate(dec_len.numpy()):
        np.testing.assert_array_equal(decoded.numpy()[i, :n], np.asarray(jdecoded)[i, :n])
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=LOSS_RTOL)
    served = CTCModel(s["task"].model, s["task"].input_dim)
    served.load_state_dict(s["params"])
    ids, lens = build_inference_fn(s["task"], served)(full["inputs"], full["input_len"])
    np.testing.assert_array_equal(lens.numpy(), dec_len.numpy())  # the served main head
    np.testing.assert_array_equal(ids.numpy(), decoded.numpy())


# ---- one csj_joint-shaped joint train step ---------------------------------------


@pytest.fixture(scope="module")
def joint_setup():
    """vgg_blstm (a BLSTM-8 on 13 x 3 features: 12 mel + energy, deltas),
    location attention without keys, a joint CTC head, every training term."""
    enc = dict(encoder_type="vgg_blstm", num_units=H, num_layers=1)
    att = dict(attention_type="location", attention_dim=8, conv_num_channels=4, conv_width=5)
    common = dict(num_classes=7, decoder_num_units=8, embedding_dim=4, max_decode_length=8,
                  scheduled_sampling_prob=0.0, ctc_loss_weight=0.3)
    task_kw = dict(weight_decay=1e-2, label_smoothing=0.05, guided_attention_weight=5.0,
                   guided_attention_sigma=0.2, guided_attention_decay_steps=20,
                   ctc_weight_init=0.6, ctc_weight_anneal_steps=60)
    jtask = jatt.AttTaskConfig(
        model=jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**enc),
                                     attention=JAttentionConfig(**att), **common),
        frontend=JFrontendConfig(num_mels=12), **task_kw)
    task = att_task.AttTaskConfig(
        model=Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att),
                            **common),
        frontend=FrontendConfig(num_mels=12), **task_kw)
    jparams = jatt.init_params(jax.random.PRNGKey(11), jtask)
    model = Seq2SeqModel(task.model, task.input_dim)
    return dict(jtask=jtask, task=task, jparams=jparams, model=model,
                params=_bridge(jparams, model))


def test_joint_vgg_train_step_matches_jax(joint_setup):
    assert joint_setup["task"].input_dim == 39
    batch = _wave_batch(12, label_width=6, classes=7)
    _train_step_matches(joint_setup, att_task, jatt, batch, {"step": 5},
                        {"att_nll", "ctc_nll", "guided_att", "loss"})


# ---- end to end: bin/eval on shrunk copies of the four configs -------------------

SHRINK = {"num_units": 8, "num_layers": 1, "batch_size": 8, "num_epoch": 1,
          "toy_num_utts": 20, "attention_dim": 8, "decoder_num_units": 8, "embedding_dim": 8,
          "attention_conv_num_channels": 4, "attention_conv_width": 5}
SHRUNK = {
    "csj_joint": {"toy_max_units": 4, "max_decode_length": 12, "input_size": 12},
    "timit_multitask_ctc": {"num_layers": 2, "num_layers_sub": 1, "toy_max_units": 4},
    "ls960_joint_bpe": {"toy_min_units": 2, "toy_max_units": 3, "max_decode_length": 16,
                        "num_layers": 2, "num_pyramid_levels": 1, "beam_width": 3},
    "ls_word_ctc": {"toy_min_units": 2, "toy_max_units": 3, "beam_width": 3},
}


def _shrunk(name: str) -> dict:
    import yaml

    raw = yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())
    att = "attention" in raw["model_type"]
    return raw | {k: v for k, v in SHRINK.items() if k in raw or att} | SHRUNK[name]


def _jax_metrics(raw: dict, state: dict, beam_width: int):
    """The JAX package's eval step and ``evaluate_ctc`` on the port's weights,
    on the dev set."""
    jexp = JExperimentConfig.from_dict(raw)
    _, dev, _, tok = jloop.build_corpus_splits(jexp, need=("dev",))
    task, mod = jloop.build_task(jexp, tok)
    params = jax.tree.map(jnp.asarray, params_to_jax(state))
    if beam_width > 1 and "attention" in jexp.model_type:
        step = mod.make_beam_eval_step(task, beam_width, jexp.length_penalty,
                                       joint_rescore_weight=jexp.ctc_loss_weight)
    elif beam_width > 1:
        step = mod.make_beam_eval_step(task, beam_width)
    else:
        step = mod.make_eval_step(task)
    return jmetrics.evaluate_ctc(step, params, JDataset(dev, jexp.batch_size), tok,
                                 jexp.label_type)


@pytest.mark.parametrize("name", sorted(SHRUNK))
def test_bin_eval_of_a_shrunk_config_equals_jax(tmp_path, name):
    raw = _shrunk(name)
    cfg = tmp_path / f"{name}.yml"
    cfg.write_text("".join(f"{k}: {v!r}\n" if isinstance(v, str) else f"{k}: {v}\n"
                           for k, v in raw.items() if v is not None))
    train_cli.main([str(cfg), str(tmp_path / "m"), "--device", "cpu"])
    got = eval_cli.main([str(tmp_path / "m"), "--device", "cpu"])
    _, state = CheckpointManager(tmp_path / "m" / "checkpoints").restore({"params": None})
    want = _jax_metrics(raw, state["params"], raw["beam_width"])
    for k in ("error_rate", "sub_rate", "ins_rate", "del_rate", "num_utts"):
        assert got["dev"][k] == want[k], k
    np.testing.assert_allclose(got["dev"]["loss"], want["loss"], rtol=LOSS_RTOL)
    assert ("wer" in got["dev"]) == ("wer" in want)
    assert got["test"]["num_utts"] > 0 and np.isfinite(got["test"]["loss"])


def test_multitask_corpus_batches_match_jax():
    raw = _shrunk("timit_multitask_ctc")
    exp, jexp = experiment_from_dict(raw), JExperimentConfig.from_dict(raw)
    train, _, _, tok = build_corpus_splits(exp)
    jtrain, _, _, jtok = jloop.build_corpus_splits(jexp)
    assert [u.sub_ids for u in train] == [u.sub_ids for u in jtrain]
    assert all(u.sub_ids for u in train)
    task, _ = jloop.build_task(jexp, jtok)
    assert exp.task(tok.num_units).model.num_classes_sub == task.model.num_classes_sub == 28
    for got, want in zip(Dataset(train, 4, seed=3).batches(1), JDataset(jtrain, 4, seed=3)
                         .batches(1)):
        assert set(got) == set(want)
        for k in ("labels", "label_len", "labels_sub", "label_len_sub", "weight"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
