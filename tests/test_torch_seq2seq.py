"""The port's pyramidal encoder, seq2seq model, greedy decode and attention
beam search, against the JAX package on the CPU.

Same seeded numpy inputs through both packages, weights carried by
``utils/bridge.params_from_jax``. Tolerances in float32: 1e-5 on one
encoder pass and 1e-4 on what a decode carries through its steps (logits,
alignments, beam scores), which sums in other orders each step; ids,
tokens and lengths must be equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.decoding.attention_beam import (
    attention_beam_search as j_beam,
)
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import attention_beam_search
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    Seq2SeqModel,
    decode_unroll_factor,
    encode,
    greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.attention import location_attend
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import load_task

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
D = 7  # input feature width


def _feats(b, t, lengths, seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, D).astype(np.float32)
    return feats, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("levels", [None, 1])
@pytest.mark.parametrize("encoder_type", ["pyramidal_blstm", "pblstm"])
def test_pyramidal_encoder_matches_jax(levels, encoder_type):
    kw = dict(encoder_type=encoder_type, num_units=8, num_layers=3, num_pyramid_levels=levels)
    jcfg = jencoders.EncoderConfig(**kw)
    params = jencoders.init_encoder(jax.random.PRNGKey(0), jcfg, D)
    enc = Encoder(EncoderConfig(**kw), D)
    enc.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), enc))
    feats, lens = _feats(3, 13, [13, 6, 1], seed=1)  # odd T and odd lengths
    want = jencoders.apply_encoder(params, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got, got_len, *_ = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    t_out = 4 if levels is None else 7  # 13 -> 7 -> 4, or 13 -> 7
    assert got.shape == (3, t_out, 16) and want.outputs.shape == got.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.outputs), atol=1e-5, rtol=0)


def _cfgs(att_type="hybrid", joint=False, max_len=12, conv_width=5, **kw):
    enc = dict(encoder_type="pyramidal_blstm", num_units=8, num_layers=2)
    att = dict(attention_type=att_type, attention_dim=6, conv_num_channels=3,
               conv_width=conv_width, sharpening_factor=kw.pop("sharpening", 1.0))
    common = dict(num_classes=5, decoder_num_units=8, embedding_dim=4, max_decode_length=max_len,
                  ctc_loss_weight=0.3 if joint else 0.0, **kw)
    jcfg = jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**enc),
                                  attention=JAttentionConfig(**att), **common)
    cfg = Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att), **common)
    return jcfg, cfg


def _models(jcfg, cfg, seed=0, eos_bias=0.0):
    params = jseq2seq.init_seq2seq(jax.random.PRNGKey(seed), jcfg, D)
    # a bias towards eos makes rows finish at different steps
    params["out_proj"]["b"] = params["out_proj"]["b"].at[jcfg.eos_id].add(eos_bias)
    model = Seq2SeqModel(cfg, D)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return params, model.eval()


def test_joint_encode_matches_jax():
    jcfg, cfg = _cfgs(joint=True)
    params, model = _models(jcfg, cfg, seed=2)
    feats, lens = _feats(3, 17, [17, 9, 2], seed=3)
    enc, ctc_logits, ctc_len = jseq2seq.encode(params, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got = encode(model, torch.from_numpy(feats), torch.from_numpy(lens))
    assert got.ctc_logits.shape == (3, 9, cfg.num_classes + 1)
    np.testing.assert_allclose(got.outputs.numpy(), np.asarray(enc.outputs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.ctc_logits.numpy(), np.asarray(ctc_logits), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.ctc_logit_len.numpy(), np.asarray(ctc_len))


@pytest.mark.parametrize("max_len,eos_bias,att_type", [
    (12, 0.0, "hybrid"),  # k = 6 steps between checks
    (12, 1.5, "location"),  # rows finish at different steps; early exit
    (13, 0.8, "hybrid"),  # prime max_len: k = 1
    (12, 0.0, "content"),  # no location term: the unfused read
])
def test_greedy_decode_matches_jax(max_len, eos_bias, att_type):
    jcfg, cfg = _cfgs(att_type=att_type, joint=True, max_len=max_len, sharpening=1.5,
                      logits_temperature=0.9)
    params, model = _models(jcfg, cfg, seed=4, eos_bias=eos_bias)
    feats, lens = _feats(4, 18, [18, 11, 3, 0], seed=5)  # a zero-length filler row
    want = jseq2seq.greedy_decode(params, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    before = location_attend.launches
    with torch.no_grad():
        got = greedy_decode(model, torch.from_numpy(feats), torch.from_numpy(lens))
    assert location_attend.launches == before  # CPU: the plain version
    k = decode_unroll_factor(max_len)
    assert k == (6 if max_len == 12 else 1)
    assert got.steps % k == 0 and 0 < got.steps <= max_len
    np.testing.assert_array_equal(got.predicted_ids.numpy(), np.asarray(want.predicted_ids))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.attention_weights.numpy(), np.asarray(want.attention_weights),
                               atol=1e-4, rtol=0)
    if eos_bias == 1.5:  # every row ended before max_len: the loop exited early
        assert got.steps < max_len


@pytest.mark.parametrize("length_penalty,beam_width,eos_bias", [
    (0.0, 3, 0.0), (0.6, 4, 0.0), (0.6, 3, 1.0)])
def test_beam_search_matches_jax(length_penalty, beam_width, eos_bias):
    jcfg, cfg = _cfgs(joint=True, max_len=12, conv_width=4)
    params, model = _models(jcfg, cfg, seed=6, eos_bias=eos_bias)
    feats, lens = _feats(3, 16, [16, 7, 0], seed=7)
    want = j_beam(params, jcfg, jnp.asarray(feats), jnp.asarray(lens), beam_width=beam_width,
                  length_penalty=length_penalty)
    with torch.no_grad():
        got = attention_beam_search(model, torch.from_numpy(feats), torch.from_numpy(lens),
                                    beam_width=beam_width, length_penalty=length_penalty)
    for f in ("tokens", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("scores", "raw_scores", "att_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    np.testing.assert_allclose(got.ctc_logits.numpy(), np.asarray(want.ctc_logits), atol=1e-5)
    assert got.tokens.dtype == torch.int32 and got.steps % decode_unroll_factor(12) == 0
    if eos_bias:  # every beam ended before max_len: the loop exited early
        assert got.steps < 12


@pytest.mark.parametrize("att_type", ["content", "luong_general"])
def test_beam_search_with_an_unfused_scorer_matches_jax(att_type):
    """Scorers without the fused read take the encoder output repeated W
    times, as the JAX search does."""
    jcfg, cfg = _cfgs(att_type=att_type, joint=True, max_len=12)
    params, model = _models(jcfg, cfg, seed=8, eos_bias=0.5)
    assert not model.attention.fused_read
    feats, lens = _feats(3, 16, [16, 9, 0], seed=9)
    want = j_beam(params, jcfg, jnp.asarray(feats), jnp.asarray(lens), beam_width=4,
                  length_penalty=0.6)
    with torch.no_grad():
        got = attention_beam_search(model, torch.from_numpy(feats), torch.from_numpy(lens),
                                    beam_width=4, length_penalty=0.6)
    for f in ("tokens", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("scores", "raw_scores", "att_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=0, err_msg=f)


@pytest.mark.parametrize("att_type", ["hybrid", "location"])
def test_beam_fused_read_reads_one_encoder_row_per_utterance(att_type, monkeypatch):
    """The beam's fused read calls kernel #7 once per step with group = W on
    the B-row encoder output and mask (keys of B rows, or none for location)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.models import attention as port_att

    _, cfg = _cfgs(att_type=att_type, max_len=6)
    model = Seq2SeqModel(cfg, D, torch.Generator().manual_seed(1)).eval()
    feats, lens = _feats(3, 16, [16, 7, 0], seed=2)
    calls = []

    def spy(keys, enc_out, q, prev_align, enc_mask, *args, **kw):
        calls.append((None if keys is None else keys.shape[0], enc_out.shape[0],
                      enc_mask.shape[0], q.shape[0], kw["group"]))
        return location_attend(keys, enc_out, q, prev_align, enc_mask, *args, **kw)

    monkeypatch.setattr(port_att, "location_attend", spy)
    with torch.no_grad():
        got = attention_beam_search(model, torch.from_numpy(feats), torch.from_numpy(lens),
                                    beam_width=4)
    keys_rows = 3 if att_type == "hybrid" else None
    assert calls == [(keys_rows, 3, 3, 12, 4)] * got.steps and got.steps > 0


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_beam_search_with_lm_fusion_matches_jax(length_penalty):
    """Shallow fusion: the RNN-LM steps on the B·W tokens and its state follows
    the parent rows; scores carry the weighted LM term, att_scores do not."""
    from tensorflow_end2end_speech_recognition_tpu.models import lm as jlm
    from tensorflow_end2end_speech_recognition_tpu_torch.models import lm

    jcfg, cfg = _cfgs(joint=True, max_len=12)
    params, model = _models(jcfg, cfg, seed=10, eos_bias=0.5)
    lm_cfg = dict(vocab=cfg.vocab, num_units=10, embedding_dim=6, num_layers=2)
    lm_params = jlm.init_lm(jax.random.PRNGKey(11), jlm.LMConfig(**lm_cfg))
    rnnlm = lm.RNNLM(lm.LMConfig(**lm_cfg))
    rnnlm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, lm_params), rnnlm))
    feats, lens = _feats(3, 16, [16, 9, 0], seed=12)
    want = j_beam(params, jcfg, jnp.asarray(feats), jnp.asarray(lens), beam_width=3,
                  length_penalty=length_penalty, lm_params=lm_params,
                  lm_cfg=jlm.LMConfig(**lm_cfg), lm_weight=0.7)
    with torch.no_grad():
        got = attention_beam_search(model, torch.from_numpy(feats), torch.from_numpy(lens),
                                    beam_width=3, length_penalty=length_penalty, lm=rnnlm,
                                    lm_weight=0.7)
    for f in ("tokens", "lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in ("scores", "raw_scores", "att_scores"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    assert not np.allclose(got.raw_scores.numpy(), got.att_scores.numpy())


@pytest.mark.parametrize("joint,att_type", [(True, "hybrid"), (False, "luong_general")])
def test_bridge_loads_init_seq2seq_strictly(joint, att_type):
    jcfg, cfg = _cfgs(att_type=att_type, joint=joint)
    tree = jax.tree.map(np.asarray, jseq2seq.init_seq2seq(jax.random.PRNGKey(1), jcfg, D))
    model = Seq2SeqModel(cfg, D)
    state = params_from_jax(tree, model)
    model.load_state_dict(state)
    assert ("ctc_head.w" in state) == joint
    if att_type == "hybrid":
        assert tuple(state["attention.conv"].shape) == (5, 1, 3)
    torch.testing.assert_close(model.embedding.detach(), torch.tensor(tree["embedding"]))
    del tree["out_proj"]["b"]
    with pytest.raises(KeyError, match="out_proj.b"):
        params_from_jax(tree, model)
    tree["out_proj"]["b"] = np.zeros((cfg.vocab + 1,), np.float32)
    with pytest.raises(ValueError, match="out_proj.b"):
        params_from_jax(tree, model)


@pytest.mark.parametrize("name", ["ls960_joint", "timit_attention"])
def test_attention_yaml_configs_match_jax(name):
    from tensorflow_end2end_speech_recognition_tpu.data.tokenizers import build_tokenizer
    from tensorflow_end2end_speech_recognition_tpu.train.loop import build_att_task
    from tensorflow_end2end_speech_recognition_tpu.utils.config import ExperimentConfig

    exp = ExperimentConfig.from_yaml(str(REPO / "configs" / f"{name}.yml"))
    tok = build_tokenizer(exp.label_type)
    want = build_att_task(exp, tok)
    task, units, _ = load_task(REPO / "configs" / f"{name}.yml")
    assert units == list(tok.units)
    for f in ("num_stack", "num_skip", "splice", "input_dim", "weight_decay", "label_smoothing",
              "scheduled_sampling_ramp_max_step", "guided_attention_weight",
              "guided_attention_sigma", "guided_attention_decay_steps", "ctc_weight_init",
              "ctc_weight_anneal_steps"):
        assert getattr(task, f) == getattr(want, f), f
    assert tuple(task.frontend) == tuple(want.frontend)
    for f in Seq2SeqConfig._fields:
        if f not in ("encoder", "attention"):
            assert getattr(task.model, f) == getattr(want.model, f), f
    assert tuple(task.model.attention) == tuple(want.model.attention)
    for f in EncoderConfig._fields + ("output_dim", "is_pyramidal"):
        assert getattr(task.model.encoder, f) == getattr(want.model.encoder, f), f
    for f in ("sos_id", "eos_id", "vocab", "is_joint"):
        assert getattr(task.model, f) == getattr(want.model, f), f


def test_chip_smoke_builds_ls960_joint_as_the_yaml():
    """``chip_smoke.py`` builds the config in code (the card has no yaml)."""
    import sys

    import yaml

    sys.path.insert(0, str(REPO))
    import chip_smoke

    raw = yaml.safe_load((REPO / "configs" / "ls960_joint.yml").read_text())
    assert chip_smoke.LS960_JOINT == raw
    task, _, _ = load_task(REPO / "configs" / "ls960_joint.yml")
    assert chip_smoke.ls960_joint_task() == task
