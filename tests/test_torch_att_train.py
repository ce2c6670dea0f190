"""The port's attention / joint CTC-attention training against the JAX package, on the CPU.

Both sides start from the same JAX-initialised weights (bridged) and take the
same seeded numpy inputs: a 2-layer pyramidal BLSTM-16 (one 2x reduction),
hybrid attention A = 8, C = 4, W = 5, an LSTM decoder of 16, 6 classes,
B = 4. Dropout stays at keep 1.0 and scheduled sampling at 0 or 1, where
both draws are deterministic (jax.random cannot be replayed in torch).
Tolerances, float32:

- the schedules: rtol 1e-6 (JAX forms them in float32, the port in Python
  floats);
- losses of one utterance's positions, the decoder's logits and alignments:
  atol 1e-5 (sums of a few dozen terms in other orders);
- the task loss: atol 1e-4, rtol 1e-5, as ``tests/test_torch_train_step.py``
  (the frontend's log-mel and the recurrences sum in other orders);
- gradients, and SGD's weights after the step: atol 2e-5, rtol 1e-4;
- Adam: the tolerances of ``tests/test_torch_train_step.py`` (its first
  update is close to ``lr * sign(g)``);
- kernel #7's gradient: atol 1e-5 against ``jax.vjp`` of the fused read.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.ops import losses as jlosses
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.attention_kernel import (
    location_attend_fused,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.augment import SpecAugmentConfig
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    Seq2SeqModel,
    forward_train,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops import losses
from tensorflow_end2end_speech_recognition_tpu_torch.ops.attention import location_attend
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    params_from_jax,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
C = 6
D = 7  # feature width of the model-level tests
NUM = 8000  # samples: 48 frames -> T' = 24 after the pyramid
ATOL = 1e-5
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
SCHED_TOL = dict(rtol=1e-6, atol=1e-7)
ENC = dict(encoder_type="pyramidal_blstm", num_units=16, num_layers=2)
# every training term on: λ anneal, guided attention, smoothing, weight decay
TASK = dict(weight_decay=1e-2, label_smoothing=0.05, scheduled_sampling_ramp_max_step=40,
            guided_attention_weight=5.0, guided_attention_sigma=0.2,
            guided_attention_decay_steps=20, ctc_weight_init=0.6, ctc_weight_anneal_steps=60)


def _cfgs(att_type="hybrid", joint=True, ss=0.2, max_len=10):
    att = dict(attention_type=att_type, attention_dim=8, conv_num_channels=4, conv_width=5)
    common = dict(num_classes=C, decoder_num_units=16, embedding_dim=8, max_decode_length=max_len,
                  scheduled_sampling_prob=ss, ctc_loss_weight=0.3 if joint else 0.0)
    jcfg = jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**ENC),
                                  attention=JAttentionConfig(**att), **common)
    cfg = Seq2SeqConfig(encoder=EncoderConfig(**ENC), attention=AttentionConfig(**att), **common)
    return jcfg, cfg


def _tasks(ss=0.2, **kw):
    jcfg, cfg = _cfgs(ss=ss)
    task_kw = dict(TASK, **kw)
    jtask = jatt.AttTaskConfig(model=jcfg, frontend=JFrontendConfig(use_energy=False), **task_kw)
    task = att_task.AttTaskConfig(model=cfg, frontend=FrontendConfig(use_energy=False), **task_kw)
    return jtask, task


def _bridge(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model)


def _labels(rng, label_len, width):
    labels = np.full((len(label_len), width), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, C, n)
    return labels


def _batch(seed, impossible=False):
    """4 waveforms, ragged; labels of width 8; the last row a filler (weight 0)."""
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, NUM) * 0.1).astype(np.float32)
    input_len = np.asarray([NUM, 6000, 3400, NUM], np.int32)
    label_len = np.asarray([5, 3, 1, 4], np.int32)
    if impossible:  # 10 frames -> T' = 5 for 8 labels: no CTC alignment
        input_len[:] = 1700
        label_len[:] = 8
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    return {"inputs": wav, "input_len": input_len, "labels": _labels(rng, label_len, 8),
            "label_len": label_len, "weight": np.asarray([1, 1, 1, 0], np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _copy(tree):  # the jitted JAX steps donate their inputs
    return jax.tree.map(jnp.array, tree)


@pytest.fixture(scope="module")
def setup():
    """The joint task with every term on but scheduled sampling (its draws
    differ between the packages), its JAX weights, the bridged dict and one
    jitted JAX loss-and-gradient shared by the tests."""
    jtask, task = _tasks(ss=0.0)
    jparams = jatt.init_params(jax.random.PRNGKey(0), jtask)
    model = Seq2SeqModel(task.model, task.input_dim)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b, s: jatt.forward_loss(p, jtask, b, True, jax.random.PRNGKey(1), s),
        has_aux=True))
    return dict(jtask=jtask, task=task, jparams=jparams, params=_bridge(jparams, model),
                model=model, value_and_grad=value_and_grad)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """One jitted JAX train step per optimizer: each compile takes seconds."""
    return {name: jatt.make_train_step(setup["jtask"], jbuild_optimizer(name, 5.0))
            for name in ("sgd", "adam")}


# ---- decoder io, schedules, penalty and losses --------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_make_decoder_io_matches_jax(seed):
    jcfg, cfg = _cfgs()
    rng = np.random.RandomState(seed)
    label_len = np.asarray([5, 0, 3, 8], np.int32)
    labels = _labels(rng, label_len, 8)
    want = jatt.make_decoder_io(jcfg, jnp.asarray(labels), jnp.asarray(label_len))
    got = att_task.make_decoder_io(cfg, torch.from_numpy(labels), torch.from_numpy(label_len))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.float32 and got[0][0, 0] == cfg.sos_id


@pytest.mark.parametrize("step", [0, 5, 10, 19, 20, 30, 40, 59, 60, 200])
def test_schedules_match_jax(step):
    """ss ramps over 40 steps, the guided weight decays over 20 and λ anneals
    over 60: steps before, inside and past each ramp."""
    jtask, task = _tasks()
    for fn, jfn in ((att_task.scheduled_sampling_prob, jatt.scheduled_sampling_prob),
                    (att_task.ga_weight_schedule, jatt.ga_weight_schedule),
                    (att_task.ctc_lambda, jatt.ctc_lambda)):
        got = fn(task, step)
        assert isinstance(got, float), fn.__name__
        np.testing.assert_allclose(got, float(jfn(jtask, jnp.int32(step))), err_msg=fn.__name__,
                                   **SCHED_TOL)


def test_schedules_without_ramps_match_jax():
    jtask, task = _tasks(scheduled_sampling_ramp_max_step=0, guided_attention_decay_steps=0,
                         ctc_weight_init=None)
    for fn, jfn in ((att_task.scheduled_sampling_prob, jatt.scheduled_sampling_prob),
                    (att_task.ga_weight_schedule, jatt.ga_weight_schedule),
                    (att_task.ctc_lambda, jatt.ctc_lambda)):
        assert fn(task, 7) == pytest.approx(float(jfn(jtask, 7)), rel=1e-6)
    assert att_task.scheduled_sampling_prob(task._replace(
        model=task.model._replace(scheduled_sampling_prob=0.0)), 7) == 0.0


@pytest.mark.parametrize("sigma", [0.2, 0.5])
def test_guided_attention_penalty_matches_jax(sigma):
    rng = np.random.RandomState(3)
    e = rng.randn(3, 6, 11).astype(np.float32)
    att_w = (np.exp(e) / np.exp(e).sum(-1, keepdims=True)).astype(np.float32)
    mask = (np.arange(6)[None] < np.asarray([6, 2, 0])[:, None]).astype(np.float32)
    enc_len = np.asarray([11, 4, 0], np.int32)
    want = jatt.guided_attention_penalty(jnp.asarray(att_w), jnp.asarray(mask),
                                         jnp.asarray(enc_len), sigma)
    got = att_task.guided_attention_penalty(torch.from_numpy(att_w), torch.from_numpy(mask),
                                            torch.from_numpy(enc_len), sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert float(got[0]) > 0


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
def test_smoothed_cross_entropy_and_joint_loss_match_jax(smoothing):
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 5, C + 2) * 2).astype(np.float32)
    targets = np.asarray([[0, 3, 7, -1, -1], [6, 1, 2, 5, 7], [-1] * 5], np.int32)
    mask = (targets >= 0).astype(np.float32)
    want = jlosses.smoothed_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                          jnp.asarray(mask), smoothing)
    got = losses.smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                        torch.from_numpy(mask), smoothing)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert float(got[2]) == 0.0  # no valid position: the denominator is 1
    ctc, att = np.float32(7.5), np.float32(2.25)
    np.testing.assert_allclose(float(losses.joint_loss(torch.tensor(ctc), torch.tensor(att), 0.3)),
                               float(jlosses.joint_loss(ctc, att, 0.3)), rtol=1e-6)


# ---- the teacher-forced unroll --------------------------------------------------


_JAX_FORWARD = {}


@pytest.mark.parametrize("att_type", ["hybrid", "content", "location"])
@pytest.mark.parametrize("ss", [0.0, 1.0])
def test_forward_train_matches_jax(att_type, ss):
    """Teacher forcing (ss 0) and the model's own argmax at every step (ss 1)."""
    jcfg, cfg = _cfgs(att_type=att_type, joint=True)
    params = jseq2seq.init_seq2seq(jax.random.PRNGKey(2), jcfg, D)
    model = Seq2SeqModel(cfg, D)
    model.load_state_dict(_bridge(params, model))
    rng = np.random.RandomState(5)
    feats = rng.randn(4, 30, D).astype(np.float32)
    lens = np.asarray([30, 17, 2, 9], np.int32)
    labels_in = np.concatenate([np.full((4, 1), cfg.sos_id), rng.randint(0, C, (4, 6))],
                               axis=1).astype(np.int32)
    if att_type not in _JAX_FORWARD:
        _JAX_FORWARD[att_type] = jax.jit(
            lambda p, f, n, l, s: jseq2seq.forward_train(p, jcfg, f, n, l, jax.random.PRNGKey(3),
                                                         ss_prob=s, train=True))
    want = _JAX_FORWARD[att_type](params, feats, lens, labels_in, jnp.float32(ss))
    with torch.no_grad():
        got = forward_train(model, torch.from_numpy(feats), torch.from_numpy(lens),
                            torch.from_numpy(labels_in), ss_prob=ss, train=True)
    assert got.logits.shape == (4, 7, cfg.vocab) and got.attention_weights.shape == (4, 7, 15)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.attention_weights.numpy(), np.asarray(want.attention_weights),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.ctc_logits.numpy(), np.asarray(want.ctc_logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got.enc_len.numpy(), np.asarray(want.enc_len))


def test_scheduled_sampling_draws_from_the_generator():
    """ss in (0, 1) draws per row and step from the generator: one seed, one result."""
    _, cfg = _cfgs(ss=0.5)
    model = Seq2SeqModel(cfg, D, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(6)
    feats, lens = torch.from_numpy(rng.randn(3, 20, D).astype(np.float32)), torch.tensor([20, 9, 4])
    labels_in = torch.from_numpy(rng.randint(0, C, (3, 8)).astype(np.int32))
    with torch.no_grad():
        outs = [forward_train(model, feats, lens, labels_in, torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
    assert torch.equal(outs[0].logits, outs[1].logits)
    assert not torch.equal(outs[0].logits, outs[2].logits)


# ---- the task: loss, train steps, guard, eval ----------------------------------


@pytest.mark.parametrize("step", [0, 10, 30])
def test_forward_loss_matches_jax(setup, step):
    """Step 0 (λ 0.6, guided weight 5), mid-anneal (step 10: λ 0.55, guided
    weight 2.5) and past the guided decay (step 30: λ 0.45, weight 0)."""
    task = setup["task"]
    (jloss, jaux), _ = setup["value_and_grad"](setup["jparams"], _jb(_batch(7)),
                                               jnp.int32(step))
    with torch.no_grad():
        loss, aux = att_task.forward_loss(setup["params"], task, _tb(_batch(7)), True, step=step)
    assert set(aux) == {"att_nll", "ctc_nll", "guided_att", "loss"} == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=k, **LOSS_TOL)
    lam = att_task.ctc_lambda(task, step)
    mixed = lam * float(aux["ctc_nll"]) + (1 - lam) * float(aux["att_nll"])
    ga = att_task.ga_weight_schedule(task, step) * float(aux["guided_att"])
    assert float(loss) > mixed + ga  # the L2 term
    with torch.no_grad():  # eval: static λ, no guided term
        eval_loss, eval_aux = att_task.forward_loss(setup["params"], task, _tb(_batch(7)), False)
    assert "guided_att" not in eval_aux


def test_gradients_match_jax(setup):
    batch = _batch(8)
    (jloss, _), jgrads = setup["value_and_grad"](setup["jparams"], _jb(batch), jnp.int32(0))
    want = _bridge(jgrads, setup["model"])
    leaves = {k: v.clone().requires_grad_(True) for k, v in setup["params"].items()}
    loss, _ = att_task.forward_loss(leaves, setup["task"], _tb(batch), True, step=0)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
        assert float(g.abs().sum()) > 0, k


def test_sgd_step_matches_jax(setup, jax_steps):
    params, jparams = setup["params"], setup["jparams"]
    opt, jopt = build_optimizer("sgd", 5.0), jbuild_optimizer("sgd", 5.0)
    batch = _batch(9)
    jnew, _, jaux = jax_steps["sgd"](_copy(jparams), _copy(jopt.init(jparams)), _jb(batch), 0.1,
                                     jax.random.PRNGKey(1), 3)
    new, _, aux = att_task.make_train_step(setup["task"], opt)(params, opt.init(params),
                                                                _tb(batch), 0.1, step=3)
    assert not bool(aux["nonfinite"]) and not bool(jaux["nonfinite"])
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), **LOSS_TOL)
    want = _bridge(jnew, setup["model"])
    for k, v in new.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
        assert not torch.equal(v, params[k]), k


def test_adam_steps_match_jax(setup, jax_steps):
    lr, steps = 1e-3, 2
    params, jparams, model = setup["params"], setup["jparams"], setup["model"]
    opt, jopt = build_optimizer("adam", 5.0), jbuild_optimizer("adam", 5.0)
    state, jstate = opt.init(params), jopt.init(jparams)
    jparams = _copy(jparams)
    train_step = att_task.make_train_step(setup["task"], opt)
    for i in range(steps):
        batch = _batch(10 + i)
        jparams, jstate, jaux = jax_steps["adam"](jparams, jstate, _jb(batch), lr,
                                                  jax.random.PRNGKey(1), i)
        params, state, aux = train_step(params, state, _tb(batch), lr, step=i)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), **LOSS_TOL)
    want = _bridge(jparams, model)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=0.1 * lr * steps, rtol=0,
                                   err_msg=k)
    jadam = adam_state_from_jax(jax.tree.map(np.asarray, jstate), model)
    assert int(state["count"]) == int(jadam["count"]) == steps
    for m in ("mu", "nu"):
        for k, v in state[m].items():
            w = jadam[m][k].numpy()
            # 1e-3 of the tensor's largest entry, as tests/test_torch_train_step.py; and
            # no tighter than the gradients' atol carried into the moment: attention.b's
            # gradient is all cancellation (the softmax over frames is nearly blind to a
            # bias added to every frame), about 1e-7 from sums of terms near 1e-2
            g_max = float(np.sqrt(np.abs(jadam["nu"][k].numpy()).max() / (1 - 0.999)))
            floor = GRAD_TOL["atol"] * ((1 - 0.9) if m == "mu" else (1 - 0.999) * 2 * g_max)
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-3, err_msg=f"{m}.{k}",
                                       atol=1e-3 * float(np.abs(w).max()) + floor)


def _leaves(state):
    if torch.is_tensor(state):
        return [state]
    return [x for v in state.values() for x in _leaves(v)]


def test_infeasible_alignment_rolls_back_params_and_state(setup, jax_steps):
    """U > T' for the joint CTC term: both packages keep the weights and Adam's state."""
    params, jparams = setup["params"], setup["jparams"]
    opt, jopt = build_optimizer("adam", 5.0), jbuild_optimizer("adam", 5.0)
    train_step = att_task.make_train_step(setup["task"], opt)
    params, state, _ = train_step(params, opt.init(params), _tb(_batch(12)), 1e-3, step=0)
    jparams, jstate, _ = jax_steps["adam"](_copy(jparams), _copy(jopt.init(jparams)),
                                           _jb(_batch(12)), 1e-3, jax.random.PRNGKey(1), 0)
    batch = _batch(13, impossible=True)
    new, new_state, aux = train_step(params, state, _tb(batch), 1e-3, step=1)
    keep = jax.tree.map(np.asarray, (jparams, jstate))  # the step donates its inputs
    jnew, jnew_state, jaux = jax_steps["adam"](jparams, jstate, _jb(batch), 1e-3,
                                               jax.random.PRNGKey(1), 1)
    assert bool(aux["nonfinite"]) and bool(jaux["nonfinite"])
    assert float(aux["loss"]) >= 1e20
    for k in params:
        assert torch.equal(new[k], params[k]), k
    for a, b in zip(_leaves(new_state), _leaves(state)):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves((jnew, jnew_state)), jax.tree.leaves(keep)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_eval_step_matches_jax(setup):
    batch = _batch(14)
    jtask, task = setup["jtask"], setup["task"]
    want = jatt.make_eval_step(jtask)(setup["jparams"], _jb(batch))
    got = att_task.make_eval_step(task)(setup["params"], _tb(batch))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=ATOL, rtol=0)
    assert got[0].shape == (4, task.model.max_decode_length)


def test_unported_step_options_raise(setup):
    opt = build_optimizer("sgd", 5.0)
    # gradient accumulation is ported (tests/test_torch_grad_accum.py): rows must divide by A
    step = att_task.make_train_step(setup["task"], opt, grad_accum=2)
    three_rows = {k: v[:3] for k, v in _tb(_batch(14)).items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        step(setup["params"], opt.init(setup["params"]), three_rows, 0.1, step=0)
    # SpecAugment is ported: the step builds with it (tests/test_torch_conformer_train.py)
    att_task.make_train_step(setup["task"]._replace(spec_augment=SpecAugmentConfig()), opt)


# ---- kernel #7's gradient -------------------------------------------------------


@pytest.mark.parametrize("group,with_keys", [(1, True), (2, True), (2, False)])
def test_location_attend_gradient_matches_jax_vjp(group, with_keys):
    """The port's read (``LocationAttend``: the forward, then autograd through
    the recomputed plain read) against ``jax.vjp`` of ``location_attend_fused``
    (the Pallas kernel in interpret mode, its ``_fused_bwd``) on tiled inputs."""
    rng = np.random.RandomState(group + 2 * with_keys)
    u, t, a, he, c, w = 2, 13, 8, 6, 4, 5
    n = u * group
    e = rng.randn(n, t).astype(np.float32)
    arrays = dict(
        keys=rng.randn(u, t, a).astype(np.float32) * 0.5,
        enc=rng.randn(u, t, he).astype(np.float32),
        q=rng.randn(n, a).astype(np.float32) * 0.5,
        prev=(np.exp(e) / np.exp(e).sum(-1, keepdims=True)).astype(np.float32),
        conv=((rng.rand(w, 1, c) - 0.5) * 0.2).astype(np.float32),
        w_loc=((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32),
        v=((rng.rand(a) - 0.5) * 0.2).astype(np.float32),
        b=(rng.randn(a) * 0.3).astype(np.float32))
    mask = np.arange(t)[None, :] < np.asarray([t, 6])[:, None]
    g_ctx = rng.randn(n, he).astype(np.float32)
    g_align = rng.randn(n, t).astype(np.float32)
    names = ["keys", "enc", "q", "prev", "conv", "w_loc", "v", "b"]
    if not with_keys:
        names.remove("keys")
    leaves = {k: torch.from_numpy(arrays[k]).requires_grad_(True) for k in names}
    ctx, align = location_attend(leaves.get("keys"), leaves["enc"], leaves["q"], leaves["prev"],
                                 torch.from_numpy(mask), leaves["conv"], leaves["w_loc"],
                                 leaves["v"], 1.5, b=leaves["b"], group=group)
    assert type(ctx.grad_fn).__name__ == "LocationAttendBackward"
    got = dict(zip(names, torch.autograd.grad(
        (ctx, align), list(leaves.values()),
        (torch.from_numpy(g_ctx), torch.from_numpy(g_align)))))

    def fused(keys, enc, q, prev, conv, w_loc, v, b):
        keys_in = (b if keys is None else keys + b) * jnp.ones((u, t, 1), jnp.float32)
        rep = lambda x: jnp.repeat(x, group, axis=0)  # noqa: E731
        return location_attend_fused(rep(keys_in), rep(enc), q, prev, rep(jnp.asarray(mask)),
                                     conv, w_loc, v, 1.5, True)

    args = [None if k == "keys" and not with_keys else jnp.asarray(arrays[k])
            for k in ["keys", "enc", "q", "prev", "conv", "w_loc", "v", "b"]]
    if with_keys:
        out, vjp = jax.vjp(fused, *args)
    else:
        out, vjp = jax.vjp(lambda *r: fused(None, *r), *args[1:])
    np.testing.assert_allclose(ctx.detach().numpy(), np.asarray(out[0]), atol=1e-4, rtol=0)
    want = dict(zip(names, vjp((jnp.asarray(g_ctx), jnp.asarray(g_align)))))
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=1e-5,
                                   err_msg=k)


# ---- config, fit and bin/train ---------------------------------------------------


@pytest.mark.parametrize("name", ["ls960_joint", "timit_attention"])
def test_attention_configs_match_jax_and_train(name):
    import yaml

    raw = yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())
    exp, jexp = experiment_from_dict(raw), JExperimentConfig.from_dict(raw)
    for f in dataclasses.fields(exp):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    exp.check_trainable()  # attention and joint models train now
    task = exp.att_task(28)
    assert task.model.is_joint == (name == "ls960_joint")
    assert task.label_smoothing == 0.05 and task.scheduled_sampling_ramp_max_step > 0
    bgru = experiment_from_dict(dict(raw, encoder_type="bgru")).att_task(28)  # the scan path
    assert bgru.model.encoder.cell == "gru" and bgru.model.encoder.bidirectional


def _tiny_joint(**kw):
    import yaml

    raw = yaml.safe_load((REPO / "configs" / "ls960_joint.yml").read_text())
    raw.update(num_units=8, num_layers=3, attention_dim=8, attention_conv_num_channels=4,
               attention_conv_width=5, decoder_num_units=8, embedding_dim=4, toy_num_utts=32,
               batch_size=8, num_epoch=2, max_decode_length=20, **kw)
    return raw


def test_bin_train_joint_end_to_end_and_resume(tmp_path):
    """A tiny copy of configs/ls960_joint.yml, one epoch, then a resumed second
    one that ends where an uninterrupted run ends, bit for bit."""
    raw = _tiny_joint()
    cfg = tmp_path / "tiny_joint.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    summary = train_cli.main([str(cfg), str(straight), "--device", "cpu"])
    assert summary["epochs"] == 2 and summary["steps"] == 8  # 26 train utterances, batch 8
    assert summary["nonfinite_steps"] == 0 and np.isfinite(summary["train_loss"])
    assert np.isfinite(summary["dev_loss"]) and summary["dev_error_rate"] >= 0
    for f in ("metrics.csv", "train.log", "summary.json", "config.yml",
              "checkpoints/epoch_1.pt"):
        assert (straight / f).exists(), f
    assert len((straight / "metrics.csv").read_text().splitlines()) == 3

    train_cli.main([str(cfg), str(resumed), "--device", "cpu", "--epochs", "1"])
    assert CheckpointManager(resumed / "checkpoints").latest_epoch == 0
    summary2 = train_cli.main([str(cfg), str(resumed), "--device", "cpu"])
    assert "resuming from checkpoint epoch 0" in (resumed / "train.log").read_text()
    assert summary2["epochs"] == 2 and summary2["steps"] == 8
    _, a = CheckpointManager(straight / "checkpoints").restore({"params": 0, "extra": 0}, 1)
    _, b = CheckpointManager(resumed / "checkpoints").restore({"params": 0, "extra": 0}, 1)
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    assert a["extra"]["step"] == b["extra"]["step"] == 8
