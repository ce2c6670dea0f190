"""The port's gradient accumulation (``train/accum.py``, ``grad_accum`` of the
three tasks' train steps) against the JAX package's, on the CPU.

Both sides start from the same JAX-initialised weights (bridged with
``utils/bridge.py``) and take the same seeded numpy batch of B = 4 ragged
rows of precomputed features with per-speaker CMVN rows through an SGD step
(clip 5.0, lr 0.1) over strided microbatches: the CTC model (BLSTM-8) at
A = 2 and A = 4, the joint CTC-attention model (BLSTM-8, hybrid attention,
every training term on) at A = 2 and the transducer (LSTM-8) at A = 4 (each
JAX step compiles for seconds). At A = 2 the last row is a filler of weight
0; at A = 4 every row is real, because a microbatch of fill rows only
counts 0 in the port and 1 in the JAX step (see ``train/accum.py``).
Dropout stays at keep 1.0 and scheduled sampling at 0 (jax.random cannot be
replayed in torch). Tolerances, float32, as ``tests/test_torch_train_step.py``:

- the loss and each aux term: atol 1e-4, rtol 1e-5;
- SGD's weights after the step: atol 2e-5, rtol 1e-4.

For each of the three models the port's own A = 2 and A = 4 steps equal its
A = 1 step on weighted and fill rows, all-fill microbatches included (loss
rtol 2e-5, weights atol 2e-5, as the JAX package's accumulation tests); one impossible row rejects
the whole accumulated update (weights and optimizer state bit for bit); a
batch whose rows do not divide by A raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.transducer import (
    TransducerConfig as JTransducerConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import Seq2SeqConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.train.accum import accum_value_and_grad
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

C = 6
D = 10  # precomputed feature width
T = 27  # frames: T' = 9 after 3/3 stacking
H = 8
LR = 0.1
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _labels(rng, label_len, width):
    labels = np.full((len(label_len), width), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, C, n)
    return labels


def _batch(seed, weight=(1, 1, 1, 0)):
    """4 ragged [T, D] feature rows with speaker CMVN rows."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(4, T, D).astype(np.float32) * 2.0 + 1.0
    input_len = np.asarray([T, 22, 14, T], np.int32)
    for i, n in enumerate(input_len):
        feats[i, n:] = 0.0
    label_len = np.asarray([3, 1, 2, 3], np.int32)
    return {"inputs": feats, "input_len": input_len, "labels": _labels(rng, label_len, 4),
            "label_len": label_len, "weight": np.asarray(weight, np.float32),
            "cmvn_mean": rng.randn(4, D).astype(np.float32),
            "cmvn_inv_std": (0.5 + rng.rand(4, D)).astype(np.float32)}


FEATURES = dict(frontend=None, feature_dim=D, num_stack=3, num_skip=3)


def _ctc():
    enc = dict(encoder_type="blstm", num_units=H, num_layers=1)
    kw = dict(FEATURES, weight_decay=1e-2)
    return (jctc.CTCTaskConfig(model=JCTCConfig(encoder=jencoders.EncoderConfig(**enc),
                                                num_classes=C), **kw),
            ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                   **kw))


def _joint():
    enc = dict(encoder_type="blstm", num_units=H, num_layers=1)
    att = dict(attention_type="hybrid", attention_dim=H, conv_num_channels=4, conv_width=5)
    common = dict(num_classes=C, decoder_num_units=H, embedding_dim=4, max_decode_length=6,
                  scheduled_sampling_prob=0.0, ctc_loss_weight=0.3)
    kw = dict(FEATURES, weight_decay=1e-2, label_smoothing=0.05, guided_attention_weight=5.0,
              guided_attention_sigma=0.2, guided_attention_decay_steps=20,
              ctc_weight_init=0.6, ctc_weight_anneal_steps=60)
    jcfg = jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**enc),
                                  attention=JAttentionConfig(**att), **common)
    cfg = Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att), **common)
    return jatt.AttTaskConfig(model=jcfg, **kw), att_task.AttTaskConfig(model=cfg, **kw)


def _transducer():
    enc = dict(encoder_type="lstm", num_units=H, num_layers=1)
    model = dict(num_classes=C, pred_num_units=H, embedding_dim=4, joint_dim=H)
    return (jtt.TransducerTaskConfig(
                model=JTransducerConfig(encoder=jencoders.EncoderConfig(**enc), **model),
                **FEATURES),
            tt.TransducerTaskConfig(
                model=TransducerConfig(encoder=EncoderConfig(**enc), **model), **FEATURES))


# family -> (tasks, JAX module, port module, extra step arguments)
FAMILIES = {
    "ctc": (_ctc, jctc, ctc_task, {}),
    "joint": (_joint, jatt, att_task, {"step": 7}),
    "transducer": (_transducer, jtt, tt, {}),
}


@functools.lru_cache(maxsize=None)
def _setup(family):
    make_tasks, jmod, mod, _ = FAMILIES[family]
    jtask, task = make_tasks()
    jparams = jmod.init_params(jax.random.PRNGKey(0), jtask)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), mod.init_model(task))
    return jtask, task, jparams, params


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_step(task, mod, params, batch, accum, extra):
    opt = build_optimizer("sgd", 5.0)
    step = mod.make_train_step(task, opt, grad_accum=accum)
    return step(params, opt.init(params), _tb(batch), LR, **extra)


@pytest.mark.parametrize("family,accum", [("ctc", 2), ("ctc", 4), ("joint", 2),
                                          ("transducer", 4)])
def test_accumulated_step_matches_jax(family, accum):
    jtask, task, jparams, params = _setup(family)
    _, jmod, mod, extra = FAMILIES[family]
    batch = _batch(3, weight=(1, 1, 1, 0) if accum == 2 else (1, 1, 1, 1))
    jopt = jbuild_optimizer("sgd", 5.0)
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  (the JAX step donates)
    jstep = jmod.make_train_step(jtask, jopt, grad_accum=accum)
    jp = copy(jparams)
    want_params, _, want_aux = jstep(jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in
                                                          batch.items()},
                                     LR, jax.random.PRNGKey(1), *extra.values())
    new, _, aux = _port_step(task, mod, params, batch, accum, extra)
    assert not bool(aux["nonfinite"]) and not bool(want_aux["nonfinite"])
    assert set(aux) == set(want_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), **LOSS_TOL, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, want_params), mod.init_model(task))
    for k in want:
        np.testing.assert_allclose(new[k].numpy(), want[k].numpy(), **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("weight", [(1, 1, 1, 1), (1, 1, 1, 0), (1, 0, 1, 0)])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_microbatches_equal_the_full_batch(family, weight, accum):
    """Strided microbatches hold rows a, a+A: at A = 4 with (1, 1, 1, 0)
    microbatch 3 is all fill, with (1, 0, 1, 0) microbatches 1 and 3 (and at
    A = 2 microbatch 1); each must count 0."""
    _, task, _, params = _setup(family)
    _, _, mod, extra = FAMILIES[family]
    batch = _batch(5, weight)
    p1, _, a1 = _port_step(task, mod, params, batch, 1, extra)
    pa, _, aa = _port_step(task, mod, params, batch, accum, extra)
    assert set(aa) == set(a1)
    for k in a1:
        np.testing.assert_allclose(float(aa[k]), float(a1[k]), rtol=2e-5, err_msg=k)
    for k in p1:
        np.testing.assert_allclose(pa[k].numpy(), p1[k].numpy(), atol=2e-5, err_msg=k)


def test_accumulation_without_weights_averages_microbatches():
    _, task, _, params = _setup("ctc")
    batch = {k: v for k, v in _batch(4).items() if k != "weight"}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    fn = lambda p, mb, g: ctc_task.forward_loss(p, task, mb, True, g)  # noqa: E731
    (loss4, _), g4 = accum_value_and_grad(fn, leaves, _tb(batch), None, 4)
    (loss1, _), g1 = accum_value_and_grad(fn, leaves, _tb(batch), None, 1)
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=2e-5)
    for k in g1:
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), atol=2e-6, err_msg=k)


def test_one_impossible_row_rejects_the_accumulated_update():
    _, task, _, params = _setup("ctc")
    batch = _batch(6)
    batch["labels"] = np.tile(np.asarray([[1, 1, 2, 2]], np.int32), (4, 1))
    batch["label_len"] = np.asarray([1, 4, 1, 1], np.int32)
    batch["input_len"] = np.asarray([T, 9, T, T], np.int32)  # 3 frames for 4 labels, 2 repeats
    opt = build_optimizer("adam", 5.0)
    state = opt.init(params)
    new, new_state, aux = ctc_task.make_train_step(task, opt, grad_accum=2)(
        params, state, _tb(batch), LR)
    assert bool(aux["nonfinite"])
    for k in params:
        assert torch.equal(new[k], params[k]), k
    for a, b in zip(jax.tree.leaves(new_state), jax.tree.leaves(state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_indivisible_rows_raise(family):
    _, task, _, params = _setup(family)
    _, _, mod, extra = FAMILIES[family]
    with pytest.raises(ValueError, match="not divisible by grad_accum 3"):
        _port_step(task, mod, params, _batch(7), 3, extra)
