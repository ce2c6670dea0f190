"""The attention and joint CTC-attention families at ``compute_dtype: bfloat16`` against JAX.

The reference's encoder emits bf16 rows on its TPU path; its keys' projection
and every attention read promote them to float32, its location-attention
kernel (#7) reads them as bf16, and the decoder, its carry, the logits and
the alignments stay float32. The port matches that: kernel #7's plain
version widens the bf16 rows, and a teacher-forced unroll sums its steps'
bf16 gradients into the bf16 rows, as the reference's scan transpose does.

The fixtures, the JAX side's path and the tolerances are those of
``tests/test_torch_bf16_models.py``: the module fixture ``pallas`` patches
``EncoderConfig.spec`` to ``impl="pallas"`` (the TPU path, its kernels in
interpret mode), both sides start from the same JAX-initialised weights
(bridged) and take the same seeded numpy inputs at B <= 4, T' <= 16, H = 8;
values rtol = atol = 2e-2, gradients rtol 5e-2 and atol 3e-2 of each
tensor's largest entry, losses 2e-3 relative. On the JAX side the decodes
read attention unfused (its fused read runs on a TPU only). Kernel #7's
plain version on bf16 rows is held to the Pallas kernel on the same rows at
the float32 test's tolerance (atol 1e-5, ``tests/test_torch_attention.py``):
widening bf16 is exact. Decoded ids, beam tokens and lengths must be equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import lm as jlm
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.attention_kernel import (
    _reference_math,
    location_attend_pallas,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train_lm as train_lm_cli
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models import lm
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import (
    EncodeOutput,
    Seq2SeqConfig,
    encode,
    forward_train,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.attention import (
    location_attend,
    location_attend_plain,
)
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
VALUE_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_RTOL, GRAD_ATOL = 5e-2, 3e-2  # atol of each gradient tensor's largest entry
LOSS_RTOL = 2e-3
KERNEL_ATOL = 1e-5  # kernel #7's float32 tolerance
NUM, C = 4000, 5  # 4000 samples: 24 frames -> T' = 12 after one 2x pyramid level
BF16 = "bfloat16"
ENC = dict(encoder_type="pyramidal_blstm", num_units=8, num_layers=2, compute_dtype=BF16)


@pytest.fixture(scope="module")
def pallas():
    """The JAX encoders on the TPU path: ``RNNSpec(impl="pallas")``."""
    with pytest.MonkeyPatch.context() as mp:
        spec = jencoders.EncoderConfig.spec
        mp.setattr(jencoders.EncoderConfig, "spec",
                   lambda self: spec(self)._replace(impl="pallas"))
        yield


def _bridge(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model)


def _grad_close(got: torch.Tensor, want, what: str):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * float(np.abs(want).max()), err_msg=what)


def _tasks(att_type="hybrid", max_len=10):
    att = dict(attention_type=att_type, attention_dim=8, conv_num_channels=3, conv_width=7)
    common = dict(num_classes=C, decoder_num_units=8, embedding_dim=4, max_decode_length=max_len,
                  ctc_loss_weight=0.3)
    fe = dict(use_energy=False)
    jtask = jatt.AttTaskConfig(
        model=jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**ENC),
                                     attention=JAttentionConfig(**att), **common),
        frontend=JFrontendConfig(**fe))
    task = att_task.AttTaskConfig(
        model=Seq2SeqConfig(encoder=EncoderConfig(**ENC), attention=AttentionConfig(**att),
                            **common),
        frontend=FrontendConfig(**fe))
    return jtask, task


def _bridged(att_type):
    jtask, task = _tasks(att_type)
    jparams = jatt.init_params(jax.random.PRNGKey(2), jtask)
    model = att_task.init_model(task)
    model.load_state_dict(_bridge(jparams, model))
    return jtask, task, jparams, model.eval()


@pytest.fixture(scope="module")
def hybrid():
    """A joint model with ls960_joint's hybrid scorer: the JAX tasks and
    weights, the port's model on them."""
    return _bridged("hybrid")


@pytest.fixture(scope="module")
def location():
    """The same with csj_joint's pure location scorer (no keys reach #7)."""
    return _bridged("location")


SCORERS = ["hybrid", "location"]


def _waves(seed, rows=4):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(rows, NUM) * 0.1).astype(np.float32)
    lens = np.asarray([NUM, 3000, 1700, 0][:rows], np.int32)  # the last a filler row
    for i, n in enumerate(lens):
        wav[i, n:] = 0.0
    return wav, lens


def _batch(seed):
    wav, lens = _waves(seed)
    lens[3] = 2400
    labels = np.asarray([[0, 1, 1, 4], [2, -1, -1, -1], [3, 4, -1, -1], [1, 0, 2, -1]], np.int32)
    return {"inputs": wav, "input_len": lens, "labels": labels,
            "label_len": np.asarray([4, 1, 2, 3], np.int32),
            "weight": np.ones((4,), np.float32)}


# ---- kernel #7's plain version on bf16 rows -------------------------------------------


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("with_keys", [True, False], ids=["hybrid", "location"])
def test_location_attend_plain_on_bf16_rows_matches_pallas(with_keys, group):
    """The bf16 encoder rows read by the plain version, in groups of ``group``
    decoder rows, against the Pallas kernel in interpret mode on the same bf16
    rows tiled per decoder row; one utterance has no valid frame (1/T)."""
    rng = np.random.RandomState(3 + group)
    u, t, a, he, c, w = 3, 21, 8, 12, 3, 7
    n = u * group
    enc = jnp.asarray(rng.randn(u, t, he).astype(np.float32)).astype(jnp.bfloat16)
    keys = rng.randn(u, t, a).astype(np.float32) if with_keys else None
    b = ((rng.rand(a) - 0.5) * 0.2).astype(np.float32)
    q = rng.randn(n, a).astype(np.float32)
    e = rng.randn(n, t).astype(np.float32)
    prev = (np.exp(e) / np.exp(e).sum(-1, keepdims=True)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.asarray([t, 9, 0])[:, None]
    conv = ((rng.rand(w, 1, c) - 0.5) * 0.2).astype(np.float32)
    w_loc = ((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32)
    v = ((rng.rand(a) - 0.5) * 0.2).astype(np.float32)
    keys_in = keys + b if with_keys else np.broadcast_to(b, (u, t, a))
    tile = lambda x: jnp.repeat(jnp.asarray(x), group, axis=0)  # noqa: E731
    tiled = (tile(keys_in), tile(enc), jnp.asarray(q), jnp.asarray(prev), tile(mask),
             jnp.asarray(conv), jnp.asarray(w_loc), jnp.asarray(v))
    enc_t = torch.from_numpy(np.array(enc.astype(jnp.float32))).bfloat16()
    before = location_attend.launches, location_attend.launches_bf16
    with torch.no_grad():
        got = location_attend(None if keys is None else torch.from_numpy(keys), enc_t,
                              torch.from_numpy(q), torch.from_numpy(prev), torch.from_numpy(mask),
                              torch.from_numpy(conv), torch.from_numpy(w_loc),
                              torch.from_numpy(v), 1.5, b=torch.from_numpy(b), group=group)
    assert (location_attend.launches, location_attend.launches_bf16) == before  # CPU: plain
    assert all(g.dtype == torch.float32 for g in got)
    for g, wv in zip(got, _reference_math(*tiled, 1.5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv, np.float32), atol=KERNEL_ATOL,
                                   rtol=0)
    # the Pallas kernel gives an empty row 1/t_pad, not 1/T: hold the others to it
    want = location_attend_pallas(*tiled, 1.5, interpret=True)
    rows = 2 * group
    for g, wv in zip(got, want):
        assert wv.dtype == jnp.float32
        np.testing.assert_allclose(g[:rows].numpy(), np.asarray(wv)[:rows], atol=KERNEL_ATOL,
                                   rtol=0)
    np.testing.assert_allclose(got[1][rows:].numpy(), 1.0 / t, atol=1e-7)  # no valid frame


def test_location_attend_bf16_rows_gradient_is_bf16():
    """``LocationAttend`` gives bf16 rows a bf16 gradient: the float32 one of
    the widened rows, rounded, as the transpose of the promotion gives it."""
    rng = np.random.RandomState(7)
    u, t, a, he, n = 2, 9, 4, 6, 4
    enc = torch.from_numpy(rng.randn(u, t, he).astype(np.float32)).bfloat16()
    args = [torch.from_numpy(x) for x in (
        rng.randn(n, a).astype(np.float32), np.full((n, t), 1.0 / t, np.float32))]
    mask = torch.from_numpy(np.arange(t)[None, :] < np.asarray([t, 5])[:, None])
    rest = [torch.from_numpy(x) for x in (rng.randn(5, 1, 2).astype(np.float32) * 0.1,
                                          rng.randn(2, a).astype(np.float32) * 0.1,
                                          rng.randn(a).astype(np.float32))]
    b = torch.zeros(a)
    cot = torch.from_numpy(rng.randn(n, he).astype(np.float32))
    leaf = enc.clone().requires_grad_(True)
    ctx, _ = location_attend(None, leaf, *args, mask, *rest, 1.0, b=b, group=2)
    (g,) = torch.autograd.grad(ctx, [leaf], cot)
    wide = enc.float().requires_grad_(True)
    ctx32, _ = location_attend_plain(None, wide, *args, mask, *rest, 1.0, b=b, group=2)
    (g32,) = torch.autograd.grad(ctx32, [wide], cot)
    assert g.dtype == torch.bfloat16
    assert torch.equal(g, g32.bfloat16())


# ---- decodes and the eval steps ------------------------------------------------------


@pytest.mark.parametrize("scorer,beam", [("hybrid", 1), ("location", 3)])
def test_serving_matches_jax_bf16(pallas, scorer, beam, request):
    """``build_inference_fn`` against JAX's on bf16 encoder rows: greedy with
    the hybrid scorer, the beam at 3 with the pure location scorer (the
    hybrid beam: ``test_beam_eval_step_matches_jax_bf16``); the port's
    encoder output is bf16 and its CTC logits float32."""
    jtask, task, jparams, model = request.getfixturevalue(scorer)
    wav, lens = _waves(seed=1)
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jatt, jparams, beam_width=beam)(jnp.asarray(wav), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model, beam)(wav, lens)
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert int(got_len.sum()) > 0
    feats = att_task.device_pipeline(task, {"inputs": torch.from_numpy(wav),
                                            "input_len": torch.from_numpy(lens)})
    with torch.no_grad():
        enc = encode(model, *feats)
    assert enc.outputs.dtype == torch.bfloat16 and enc.ctc_logits.dtype == torch.float32


@pytest.mark.parametrize("rescore,with_lm", [(0.3, False), (None, False), (0.3, True)],
                         ids=["rescored", "plain", "rescored-lm"])
def test_beam_eval_step_matches_jax_bf16(pallas, hybrid, rescore, with_lm):
    """The beam eval step (beam 3, length penalty 0.6) with and without joint
    rescoring, and with an RNN-LM fused at 0.7: ids and lengths equal, the
    teacher-forced NLL within 2e-3 relative."""
    jtask, task, jparams, model = hybrid
    jlm_arg, lm_arg, lm_weight = None, None, 0.0
    if with_lm:
        lm_cfg = dict(vocab=task.model.vocab, num_units=10, embedding_dim=6, num_layers=2)
        lm_params = jlm.init_lm(jax.random.PRNGKey(11), jlm.LMConfig(**lm_cfg))
        lm_arg = lm.RNNLM(lm.LMConfig(**lm_cfg))
        lm_arg.load_state_dict(_bridge(lm_params, lm_arg))
        jlm_arg, lm_weight = (lm_params, jlm.LMConfig(**lm_cfg)), 0.7
    batch = _batch(seed=4)
    want = jatt.make_beam_eval_step(jtask, 3, 0.6, joint_rescore_weight=rescore, lm=jlm_arg,
                                    lm_weight=lm_weight)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = att_task.make_beam_eval_step(task, 3, 0.6, joint_rescore_weight=rescore, lm=lm_arg,
                                       lm_weight=lm_weight)(
        dict(model.state_dict()), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=LOSS_RTOL)
    assert int(got[1].sum()) > 0


# ---- training ------------------------------------------------------------------------


def test_train_step_loss_and_gradients_match_jax_bf16(pallas, hybrid):
    """``att_task.forward_loss`` at bf16 (dropout off, scheduled sampling 0):
    the loss within 2e-3 relative and every gradient within the bf16
    tolerance; the master weights' gradients float32."""
    jtask, task, jparams, model = hybrid
    batch = _batch(seed=8)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jatt.forward_loss(p, jtask, b, True, jax.random.PRNGKey(1), 0),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in model.state_dict().items()}
    loss, aux = att_task.forward_loss(leaves, task, {k: torch.from_numpy(v)
                                                     for k, v in batch.items()}, True, step=0)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    want = _bridge(jgrads, model)
    # the location scorer's w_dec gradient is about 1e-12 here, 1e-11 of the
    # largest: q shifts every frame's energy alike but for the tanh's slope,
    # and a shift of all energies has no softmax gradient. Both sides hold
    # float32 noise there, so no tensor's atol is taken below float32's
    # resolution (1e-7) of the largest gradient
    floor = 1e-7 * max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, g in grads.items():
        assert g.dtype == torch.float32, k
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=max(GRAD_ATOL * float(np.abs(w).max()), floor), err_msg=k)
        assert float(g.abs().sum()) > 0, k


@pytest.mark.parametrize("scorer", SCORERS)
def test_decoder_unroll_sums_bf16_gradients_into_the_rows(scorer, request):
    """The teacher-forced unroll on given bf16 encoder rows: its logits and
    alignments, and the rows' bf16 gradient summed over the U steps (each
    step's float32 gradient rounded to bf16, the sum kept in bf16, as the
    reference's scan transpose carries it), against JAX's."""
    jtask, task, jparams, model = request.getfixturevalue(scorer)
    rng = np.random.RandomState(9)
    b, t, u = 3, 12, 5
    enc16 = jnp.asarray(rng.randn(b, t, task.model.encoder.output_dim).astype(np.float32)
                        ).astype(jnp.bfloat16)
    lens = np.asarray([t, 7, 1], np.int32)
    labels_in = np.concatenate([np.full((b, 1), task.model.sos_id),
                                rng.randint(0, C, (b, u - 1))], axis=1).astype(np.int32)
    cot = rng.randn(b, u, task.model.vocab).astype(np.float32)
    cot_a = rng.randn(b, u, t).astype(np.float32)
    jcfg = jtask.model

    def jloss(enc_out):
        enc = jencoders.EncoderOutput(enc_out, jnp.asarray(lens))
        out = jseq2seq.forward_train(jparams, jcfg, jnp.zeros((b, 1, 1)), jnp.asarray(lens),
                                     jnp.asarray(labels_in), None, ss_prob=0.0, train=False,
                                     precomputed=(enc, None, None))
        return jnp.sum(out.logits * cot) + jnp.sum(out.attention_weights * cot_a), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(enc16)
    rows = torch.from_numpy(np.array(enc16.astype(jnp.float32))).bfloat16()
    rows.requires_grad_(True)
    out = forward_train(model, None, torch.from_numpy(lens), torch.from_numpy(labels_in),
                        train=False, precomputed=EncodeOutput(rows, torch.from_numpy(lens)))
    assert out.logits.dtype == torch.float32 and out.attention_weights.dtype == torch.float32
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits), **VALUE_TOL)
    np.testing.assert_allclose(out.attention_weights.detach().numpy(),
                               np.asarray(want.attention_weights), **VALUE_TOL)
    loss = (out.logits * torch.from_numpy(cot)).sum() + (
        out.attention_weights * torch.from_numpy(cot_a)).sum()
    (g,) = torch.autograd.grad(loss, [rows])
    assert g.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16
    _grad_close(g, np.asarray(jg.astype(jnp.float32)), "enc_out")


# ---- the four configs and the CLIs ------------------------------------------------------


@pytest.mark.parametrize("name", ["ls960_joint", "csj_joint", "timit_attention",
                                  "ls960_joint_bpe"])
def test_attention_yaml_configs_run_at_bf16(name):
    """Each attention-family YAML with ``compute_dtype: bfloat16`` set on the
    dict it loads (widths shrunk): the task, the model's bf16 encoder and its
    float32 decoder, and serving at greedy and at the config's beam."""
    import yaml

    raw = yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())
    raw.update(compute_dtype=BF16, num_units=8, attention_dim=8, decoder_num_units=8,
               embedding_dim=4, max_decode_length=6)
    exp = experiment_from_dict(raw)
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import corpus_tokenizer

    tok = corpus_tokenizer(exp)
    task = exp.att_task(len(tok.units))
    assert task.model.encoder.compute_dtype == BF16
    model = att_task.init_model(task, torch.Generator().manual_seed(0)).eval()
    wav, lens = _waves(seed=10, rows=2)
    lens[1] = 2500
    with torch.no_grad():
        feats = att_task.device_pipeline(task, {"inputs": torch.from_numpy(wav),
                                                "input_len": torch.from_numpy(lens)})
        enc = encode(model, *feats)
    assert enc.outputs.dtype == torch.bfloat16
    for beam in (1, exp.beam_width):
        ids, n = build_inference_fn(task, model, beam)(wav, lens)
        assert ids.shape == (2, 6) and bool((n <= 6).all())


JOINT_BF16_YAML = """model_type: joint_ctc_attention
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
compute_dtype: bfloat16
"""


def test_joint_bf16_train_eval_decode_cli(tmp_path, capsys):
    """``bin/train`` -> ``bin/eval`` (beam 2 with joint rescoring, then with an
    RNN-LM from ``bin/train_lm``) -> ``bin/decode --joint-rescore`` on a bf16
    joint model, on the CPU."""
    cfg = tmp_path / "joint_bf16.yml"
    cfg.write_text(JOINT_BF16_YAML)
    model_dir = tmp_path / "joint"
    train_cli.main([str(cfg), str(model_dir), "--device", "cpu"])
    capsys.readouterr()
    got = eval_cli.main([str(model_dir), "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "decoding with beam width 2"
    assert np.isfinite(got["dev"]["loss"]) and 0.0 <= got["dev"]["error_rate"]
    train_lm_cli.main([str(cfg), str(tmp_path / "lm"), "--device", "cpu", "--epochs", "1",
                       "--num-units", "8", "--embedding-dim", "4"])
    fused = eval_cli.main([str(model_dir), "--device", "cpu", "--lm-dir", str(tmp_path / "lm")])
    assert np.isfinite(fused["dev"]["loss"])
    lines = decode_cli.main([str(model_dir), "--device", "cpu", "--beam-width", "2",
                             "--joint-rescore", "--nbest", "2", "--num-utts", "2"])
    assert lines[0].endswith("epoch 0 beam 2 +joint-rescore") and len(lines) == 1 + 2 * 4
