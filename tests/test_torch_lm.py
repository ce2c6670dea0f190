"""The port's RNN-LM, its training task and shallow fusion, against the JAX package.

Same JAX-initialised LM weights (bridged) and seeded numpy inputs on both
sides. Tolerances, float32:

- ``lm_step``, ``lm_prefix_logp`` and ``lm_sequence_nll``: atol 1e-5 (a few
  hundred products per step in other orders);
- one ``lm_task`` train step: the loss atol 1e-5; SGD's weights atol 2e-5,
  rtol 1e-4; Adam's weights atol 0.1 · lr (its first update is close to
  ``lr · sign(g)``, as ``tests/test_torch_train_step.py`` has it);
- fusion in the CTC prefix beam and the attention beam: tokens and lengths
  equal in live slots, scores within 1e-4 (LM and acoustic log-probs summed
  over the frames or steps), and the carried-state fusion equal to the
  stateless full-recompute hook within 1e-5;
- ``serving.build_inference_fn(lm=...)`` for a CTC and an attention model:
  JAX's ids and lengths, equal;
- an LM of another label set is refused before either beam runs;
- ``bin/train_lm`` -> ``bin/eval --lm-dir`` runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.bin import train_lm as jtrain_lm
from tensorflow_end2end_speech_recognition_tpu.decoding import ctc_prefix_beam as jbeam
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import lm as jlm
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.seq2seq import (
    Seq2SeqConfig as JSeq2SeqConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import lm_task as jlm_task
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train_lm
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import ctc_prefix_beam as beam
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.attention_beam import (
    attention_beam_search,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models import lm
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import Seq2SeqConfig
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task, lm_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

NUM_CLASSES = 5  # units; the CTC blank = 5; the LM's sos = 5, eos = 6
CFG = dict(vocab=NUM_CLASSES + 2, num_units=12, embedding_dim=6, num_layers=2)
ATOL = 1e-5


def _lms(seed=0, **kw):
    jcfg = jlm.LMConfig(**dict(CFG, **kw))
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    model = lm.RNNLM(lm.LMConfig(**dict(CFG, **kw)))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return jcfg, jparams, model


def _labels(seed, b=4, u=7):
    rng = np.random.RandomState(seed)
    lengths = np.asarray([u, 3, 0, 5][:b], np.int32)
    tokens = np.full((b, u), -1, np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.randint(0, NUM_CLASSES, n)
    return tokens, lengths


def test_bridge_loads_init_lm_strictly():
    jcfg, jparams, model = _lms()
    tree = jax.tree.map(np.asarray, jparams)
    assert sorted(model.state_dict()) == sorted(
        ["embedding", "layers.0.wx", "layers.0.wh", "layers.0.b", "layers.1.wx",
         "layers.1.wh", "layers.1.b", "out.w", "out.b"])
    del tree["out"]["b"]
    with pytest.raises(KeyError, match="out.b"):
        params_from_jax(tree, model)


def test_lm_step_matches_jax():
    jcfg, jparams, model = _lms(1)
    tokens = np.asarray([0, 4, 5, 6], np.int32)
    rng = np.random.RandomState(1)
    state = tuple((rng.randn(4, 12).astype(np.float32) * 0.5,
                   rng.randn(4, 12).astype(np.float32)) for _ in range(2))
    jstate, jlogp = jlm.lm_step(jparams, jcfg, jax.tree.map(jnp.asarray, state),
                                jnp.asarray(tokens))
    with torch.no_grad():
        got_state, logp = lm.lm_step(model, tuple((torch.from_numpy(h), torch.from_numpy(c))
                                                  for h, c in state), torch.from_numpy(tokens))
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), atol=ATOL, rtol=0)
    for (h, c), (jh, jc) in zip(got_state, jstate):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=ATOL, rtol=0)


def test_prefix_logp_and_sequence_nll_match_jax():
    jcfg, jparams, model = _lms(2)
    tokens, lengths = _labels(3)
    prefixes, plen = tokens.reshape(2, 2, 7), lengths.reshape(2, 2)
    want = jlm.lm_prefix_logp(jparams, jcfg, jnp.asarray(prefixes), jnp.asarray(plen), 5)
    want_nll = jlm.lm_sequence_nll(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(lengths), 5)
    with torch.no_grad():
        got = lm.lm_prefix_logp(model, torch.from_numpy(prefixes), torch.from_numpy(plen), 5)
        nll = lm.lm_sequence_nll(model, torch.from_numpy(tokens), torch.from_numpy(lengths), 5)
        fwd = model(torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert got.shape == (2, 2, CFG["vocab"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), atol=ATOL, rtol=1e-6)
    assert torch.equal(fwd, nll) and float(nll[2]) > 0  # the eos step of a length-0 row


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_lm_train_step_matches_jax(name):
    jcfg, jparams, model = _lms(3)
    jtask, task = jlm_task.LMTaskConfig(model=jcfg), lm_task.LMTaskConfig(model=model.cfg)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    tokens, lengths = _labels(4)
    batch = {"labels": tokens, "label_len": lengths,
             "weight": np.asarray([1, 1, 1, 0], np.float32)}  # a fill row
    lr = 0.5 if name == "sgd" else 1e-3
    jopt, opt = jbuild_optimizer(name, 5.0), build_optimizer(name, 5.0)
    jnew, _, jaux = jlm_task.make_train_step(jtask, jopt)(
        jax.tree.map(jnp.array, jparams), jopt.init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()}, lr, jax.random.PRNGKey(0))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    new, _, aux = lm_task.make_train_step(task, opt)(params, opt.init(params), tb, lr)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), atol=ATOL)
    np.testing.assert_allclose(float(aux["ppl"]), float(jaux["ppl"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), model)
    tol = dict(atol=2e-5, rtol=1e-4) if name == "sgd" else dict(atol=0.1 * lr, rtol=0)
    moved = 0.0
    for k, v in new.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **tol)
        moved = max(moved, float((v - params[k]).abs().max()))
    assert moved > 5 * tol["atol"]  # the step moved the weights
    n, t = lm_task.make_eval_step(task)(new, tb)
    jn, jt = jlm_task.make_eval_step(jtask)(jnew, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(n), float(jn), atol=1e-4, rtol=1e-5)
    assert float(t) == float(jt) == 7 + 1 + 3 + 1 + 0 + 1


def test_lm_train_step_keeps_weights_and_state_on_a_nonfinite_loss():
    _, _, model = _lms(4)
    task = lm_task.LMTaskConfig(model=model.cfg)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params["out.b"][0] = float("nan")
    opt = build_optimizer("adam", 5.0)
    state = opt.init(params)
    tokens, lengths = _labels(5)
    new, new_state, aux = lm_task.make_train_step(task, opt)(
        params, state, {"labels": torch.from_numpy(tokens),
                        "label_len": torch.from_numpy(lengths)}, 1e-3)
    assert bool(aux["nonfinite"])
    for k in params:
        assert torch.equal(new[k].nan_to_num(), params[k].nan_to_num())
    assert int(new_state["count"]) == 0


def test_batches_match_jax_modulo_fill():
    from tensorflow_end2end_speech_recognition_tpu_torch.data.toy_corpus import ToyCorpus

    utts = ToyCorpus(label_type="character", num_utts=11, max_units=6, seed=0).utterances
    got = list(train_lm._batches(utts, 4, 7, seed=3))
    want = list(jtrain_lm._batches(utts, 4, 7, seed=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("labels", "label_len", "weight"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    assert got[-1]["weight"].tolist() == [1, 1, 1, 0]


# ---- shallow fusion ---------------------------------------------------------------


def _ctc_logits(seed, b=3, t=16):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, t, NUM_CLASSES + 1) * 1.5).astype(np.float32)
    return logits, np.asarray([t, 9, 1][:b], np.int32)


def _live_equal(got, want, score_tol=1e-4):
    live = np.asarray(want[2]) > -1e29
    np.testing.assert_array_equal(got[2] > -1e29, live)
    np.testing.assert_array_equal(got[1][live], np.asarray(want[1])[live])
    np.testing.assert_array_equal(got[0][live], np.asarray(want[0])[live])
    np.testing.assert_allclose(got[2][live], np.asarray(want[2])[live], atol=score_tol, rtol=0)


def test_ctc_beam_with_carried_fusion_matches_jax_and_the_hook():
    jcfg, jparams, model = _lms(6)
    logits, lens = _ctc_logits(7)
    kw = dict(beam_width=4, top_k_classes=3, lm_weight=0.5)
    want = jbeam.ctc_prefix_beam_search(
        jnp.asarray(logits), jnp.asarray(lens), NUM_CLASSES,
        fusion_lm=jlm.make_fusion_lm(jparams, jcfg, 5, NUM_CLASSES + 1), **kw)
    with torch.no_grad():
        got = [x.numpy() for x in beam.ctc_prefix_beam_search(
            torch.from_numpy(logits), torch.from_numpy(lens), NUM_CLASSES,
            fusion_lm=lm.make_fusion_lm(model, NUM_CLASSES + 1), **kw)]

        def hook(prefixes, lengths):  # the LM vocabulary on the CTC classes
            units = lm.lm_prefix_logp(model, prefixes, lengths, 5)[..., :NUM_CLASSES]
            return torch.cat([units, torch.zeros_like(units[..., :1])], dim=-1)

        by_hook = [x.numpy() for x in beam.ctc_prefix_beam_search(
            torch.from_numpy(logits), torch.from_numpy(lens), NUM_CLASSES, lm_logp_fn=hook,
            **kw)]
        plain = [x.numpy() for x in beam.ctc_prefix_beam_search(
            torch.from_numpy(logits), torch.from_numpy(lens), NUM_CLASSES,
            beam_width=4, top_k_classes=3)]
    _live_equal(got, want)
    _live_equal(by_hook, [torch.from_numpy(x) for x in got], score_tol=ATOL)
    assert not np.allclose(got[2][:, 0], plain[2][:, 0])  # the LM moved the scores


def _att_tasks():
    enc = dict(encoder_type="pyramidal_blstm", num_units=8, num_layers=2)
    att = dict(attention_type="hybrid", attention_dim=8, conv_num_channels=3, conv_width=7)
    common = dict(num_classes=NUM_CLASSES, decoder_num_units=8, embedding_dim=4,
                  max_decode_length=10, ctc_loss_weight=0.3)
    jtask = jatt.AttTaskConfig(
        model=JSeq2SeqConfig(encoder=JEncoderConfig(**enc), attention=JAttentionConfig(**att),
                             **common), frontend=JFrontendConfig(use_energy=False))
    task = att_task.AttTaskConfig(
        model=Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att),
                            **common), frontend=FrontendConfig(use_energy=False))
    return jtask, task


def test_att_beam_eval_step_with_fusion_matches_jax():
    """The attention beam eval step with an LM fused at 0.5 and joint
    rescoring: ids, lengths and the teacher-forced NLL equal JAX's."""
    jtask, task = _att_tasks()
    jparams = jatt.init_params(jax.random.PRNGKey(8), jtask)
    amodel = att_task.init_model(task)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), amodel)
    jcfg, jlm_params, model = _lms(9, num_layers=1)
    rng = np.random.RandomState(10)
    wav = (rng.randn(3, 4000) * 0.1).astype(np.float32)
    input_len = np.asarray([4000, 2500, 0], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    labels, label_len = _labels(11, b=3, u=5)
    batch = {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len}
    want = jatt.make_beam_eval_step(jtask, 3, 0.6, 0.3, lm=(jlm_params, jcfg), lm_weight=0.5)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = att_task.make_beam_eval_step(task, 3, 0.6, 0.3, lm=model, lm_weight=0.5)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=1e-5)


def _ctc_tasks():
    enc = dict(encoder_type="blstm", num_units=8, num_layers=1)
    jtask = jctc.CTCTaskConfig(model=JCTCConfig(encoder=JEncoderConfig(**enc),
                                                num_classes=NUM_CLASSES),
                               frontend=JFrontendConfig(use_energy=False), num_stack=3,
                               num_skip=3)
    task = ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc),
                                                  num_classes=NUM_CLASSES),
                                  frontend=FrontendConfig(use_energy=False), num_stack=3,
                                  num_skip=3)
    return jtask, task


def _bridged(family, seed):
    jtask, task = _ctc_tasks() if family == "ctc" else _att_tasks()
    jmod, mod = (jctc, ctc_task) if family == "ctc" else (jatt, att_task)
    jparams = jmod.init_params(jax.random.PRNGKey(seed), jtask)
    model = mod.init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return jtask, jmod, jparams, task, model


@pytest.mark.parametrize("family", ["ctc", "attention"])
def test_inference_fn_with_fusion_matches_jax_serving(family):
    """``build_inference_fn(beam_width=3, lm=..., lm_weight=2.0)``: JAX's ids
    and lengths on bridged weights, a zero-length filler row included; the
    weight is large enough that the LM changes the tokens of some row."""
    jtask, jmod, jparams, task, model = _bridged(family, 12)
    jcfg, jlm_params, lm_model = _lms(13, num_layers=1)
    rng = np.random.RandomState(14)
    wav = (rng.randn(3, 4000) * 0.1).astype(np.float32)
    lens = np.asarray([4000, 2500, 0], np.int32)
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jmod, jparams, beam_width=3, lm=(jlm_params, jcfg), lm_weight=2.0)(
        jnp.asarray(wav), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model, 3, lm=lm_model, lm_weight=2.0)(wav, lens)
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    plain_ids, plain_len = build_inference_fn(task, model, 3)(wav, lens)
    assert not (torch.equal(plain_ids, got_ids) and torch.equal(plain_len, got_len))


@pytest.mark.parametrize("family", ["ctc", "attention"])
def test_lm_of_another_label_set_is_refused(family):
    _, _, wrong = _lms(15, vocab=NUM_CLASSES + 3)
    if family == "ctc":
        with pytest.raises(ValueError, match="another label set"):
            lm.make_fusion_lm(wrong, NUM_CLASSES + 1)
        return
    _, task = _att_tasks()
    with pytest.raises(ValueError, match="another label set"):  # before the encoder runs
        attention_beam_search(att_task.init_model(task), torch.zeros((1, 8, 40)),
                              torch.tensor([8]), beam_width=2, lm=wrong,
                              lm_weight=0.5)


def test_train_lm_then_eval_with_lm_dir(tmp_path, capsys):
    cfg = tmp_path / "ctc.yml"
    cfg.write_text("model_type: ctc\nlabel_type: character\ninput_size: 40\nuse_energy: false\n"
                   "num_stack: 3\nnum_skip: 3\nnum_units: 8\nnum_layers: 1\nbatch_size: 4\n"
                   "num_epoch: 1\ntoy_num_utts: 20\ntoy_max_units: 4\nbeam_width: 3\n")
    train_cli.main([str(cfg), str(tmp_path / "m"), "--device", "cpu"])
    ppl = train_lm.main([str(cfg), str(tmp_path / "lm"), "--epochs", "2", "--num-units", "8",
                         "--embedding-dim", "4", "--batch-size", "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [s.split(":")[0] for s in out[-3:-1]] == ["epoch 0", "epoch 1"]
    assert out[-1].startswith("FINAL dev_ppl") and np.isfinite(ppl)
    loaded = train_lm.load_lm(tmp_path / "lm", "cpu")
    assert loaded.cfg == lm.LMConfig(vocab=30, num_units=8, embedding_dim=4, num_layers=1)
    res = eval_cli.main([str(tmp_path / "m"), "--device", "cpu", "--lm-dir",
                         str(tmp_path / "lm"), "--lm-weight", "0.5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "decoding with beam width 3 + LM fusion w=0.5"
    assert np.isfinite(res["dev"]["error_rate"]) and res["test"]["num_utts"] == 2
    eval_cli.main([str(tmp_path / "m"), "--device", "cpu", "--beam-width", "1", "--lm-dir",
                   str(tmp_path / "lm")])
    assert capsys.readouterr().out.splitlines()[0] == (
        "warning: --lm-dir requires beam decoding; ignored for greedy")
