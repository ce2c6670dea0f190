"""The port's transducer (loss, model, greedy decode, train and eval steps) vs JAX.

Both sides start from the same JAX-initialised weights (bridged). Dropout
stays at keep 1.0 (jax.random cannot be replayed in torch). Tolerances,
float32:

- the lattice loss on given inputs: rtol 1e-5, atol 1e-4 (a sum of T + U
  log terms; the port scans u with Hillis-Steele, JAX with
  ``associative_scan``, so the partial sums differ in order); its
  gradients atol 1e-5, rtol 1e-4;
- prediction-net outputs and states: atol 1e-5;
- the train step, as the CTC step's tests: loss atol 1e-4 (the frontend's
  log-mel and the recurrences sum in different orders), gradients and SGD's
  parameters atol 2e-5, rtol 1e-4, Adam's parameters 0.1 * lr;
- greedy ids and lengths exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.decoding.transducer_greedy import (
    transducer_greedy_decode as jgreedy,
)
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.ops import transducer as jrnnt
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_greedy import (
    transducer_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.augment import SpecAugmentConfig
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import (
    TransducerConfig,
    pred_initial_states,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.transducer import (
    rnnt_loss,
    rnnt_loss_from_logprobs,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)

NUM = 4000  # samples: 24 frames -> T' = 8 after 3/3 stacking
C = 4  # real classes; blank = 4
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
FRONTEND = dict(num_mels=40, use_energy=False, add_deltas=False, cmvn="none")


def _tasks(weight_decay=1e-2):
    enc = dict(encoder_type="lstm", num_units=16, num_layers=2)
    model = dict(num_classes=C, pred_num_units=8, embedding_dim=4, joint_dim=12)
    jtask = jtt.TransducerTaskConfig(
        model=jtransducer.TransducerConfig(encoder=JEncoderConfig(**enc), **model),
        frontend=JFrontendConfig(**FRONTEND), num_stack=3, num_skip=3,
        weight_decay=weight_decay)
    task = tt.TransducerTaskConfig(
        model=TransducerConfig(encoder=EncoderConfig(**enc), **model),
        frontend=FrontendConfig(**FRONTEND), num_stack=3, num_skip=3,
        weight_decay=weight_decay)
    return jtask, task


def _setup(seed=0):
    jtask, task = _tasks()
    jparams = jtt.init_params(jax.random.PRNGKey(seed), jtask)
    model = tt.init_model(task)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    model.load_state_dict(params)
    return jtask, task, jparams, params, model


def _batch(seed):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, NUM) * 0.3).astype(np.float32)
    input_len = np.asarray([NUM, 3000, 1700, NUM], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    labels = np.asarray([[0, 1, 1, 3], [2, -1, -1, -1], [-1, -1, -1, -1], [3, 0, 2, -1]],
                        np.int32)
    label_len = np.asarray([4, 1, 0, 3], np.int32)  # a row with no labels
    weight = np.asarray([1, 1, 1, 0], np.float32)  # the last row is a batch filler
    return {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len,
            "weight": weight}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _lattice(seed, b=5, t=7, u=4, j=6, v=5):
    rng = np.random.RandomState(seed)
    f = rng.randn(b, t, j).astype(np.float32)
    g = rng.randn(b, u + 1, j).astype(np.float32)
    w = (rng.randn(j, v) * 0.5).astype(np.float32)
    bias = (rng.randn(v) * 0.1).astype(np.float32)
    u_len = np.asarray([u, 0, 2, u, 1][:b], np.int32)  # includes 0 and U
    t_len = np.asarray([t, 3, 1, 2, t][:b], np.int32)  # includes 1, 2 < U and T
    labels = np.full((b, u), -1, np.int32)
    for i, n in enumerate(u_len):
        labels[i, :n] = rng.randint(0, v - 1, n)
    return f, g, w, bias, labels, t_len, u_len


@pytest.mark.parametrize("seed", [0, 1])
def test_rnnt_loss_and_grads_match_jax(seed):
    f, g, w, bias, labels, t_len, u_len = _lattice(seed)
    blank = w.shape[1] - 1
    weights = np.arange(1, f.shape[0] + 1, dtype=np.float32)  # a distinct cotangent per row

    def jloss(f, g, w, bias):
        nll = jrnnt.rnnt_loss(f, g, w, bias, jnp.asarray(labels), jnp.asarray(t_len),
                              jnp.asarray(u_len), blank)
        return jnp.sum(nll * weights), nll

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (f, g, w, bias)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (f, g, w, bias)]
    nll = rnnt_loss(*leaves, torch.from_numpy(labels), torch.from_numpy(t_len),
                    torch.from_numpy(u_len), blank)
    (nll * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert bool(torch.isfinite(nll).all()) and bool((nll > 0).all())
    for name, leaf, jg in zip(("f", "g", "w_out", "b_out"), leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), err_msg=name,
                                   atol=1e-5, rtol=1e-4)


def test_rnnt_loss_from_logprobs_matches_jax_on_a_long_lattice():
    """U + 1 = 13 lattice rows: four Hillis-Steele rounds, not a power of two."""
    rng = np.random.RandomState(4)
    b, t, u1 = 3, 9, 13
    lp = np.log(rng.dirichlet(np.ones(3), size=(b, t, u1)).astype(np.float32))
    lp_blank, lp_label = lp[..., 0], lp[..., 1]
    t_len, u_len = np.asarray([9, 4, 1], np.int32), np.asarray([12, 7, 0], np.int32)
    want = jrnnt.rnnt_loss_from_logprobs(*map(jnp.asarray, (lp_blank, lp_label, t_len, u_len)))
    got = rnnt_loss_from_logprobs(*map(torch.from_numpy, (lp_blank, lp_label, t_len, u_len)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    # t_len = 1, u_len = 0: only the terminal blank
    np.testing.assert_allclose(float(got[2]), -float(lp_blank[2, 0, 0]), rtol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_predict_matches_jax(with_state):
    jtask, task, jparams, _, model = _setup(seed=1)
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, C + 1, (3, 5)).astype(np.int32)
    states = [tuple(rng.randn(3, 8).astype(np.float32) * 0.5 for _ in range(2))]
    jstates = [tuple(map(jnp.asarray, s)) for s in states] if with_state else None
    want_g, want_states = jtransducer.predict(jparams, jtask.model, jnp.asarray(tokens),
                                              initial_states=jstates)
    with torch.no_grad():
        got_g, got_states = model.predict(
            torch.from_numpy(tokens),
            [tuple(map(torch.from_numpy, s)) for s in states] if with_state else None)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5, rtol=0)
    for (h, c), (jh, jc) in zip(got_states, want_states):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    zeros = pred_initial_states(task.model, 3)
    assert len(zeros) == 1 and all(not bool(x.any()) for x in zeros[0])


@pytest.mark.parametrize("seed,max_symbols", [(3, None), (4, 2)])
def test_greedy_decode_matches_jax(seed, max_symbols):
    jtask, task, jparams, _, model = _setup(seed=seed)
    rng = np.random.RandomState(seed)
    f_proj = (rng.randn(3, 9, 12) * 2.0).astype(np.float32)
    enc_len = np.asarray([9, 4, 0], np.int32)
    want_ids, want_len = (np.asarray(x) for x in jgreedy(
        jparams, jtask.model, jnp.asarray(f_proj), jnp.asarray(enc_len), max_symbols))
    with torch.no_grad():
        ids, n = transducer_greedy_decode(model, torch.from_numpy(f_proj),
                                          torch.from_numpy(enc_len), max_symbols)
    assert ids.dtype == torch.int32 and n.dtype == torch.int32
    np.testing.assert_array_equal(n.numpy(), want_len)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    s = max_symbols or task.model.max_symbols_per_frame
    assert ids.shape == (3, 9 * s) and int(n[2]) == 0  # no frame, no symbol
    assert 0 < int(n[0]) < 9 * s  # some frames emit, and blank stops some


def test_forward_loss_and_every_gradient_match_jax():
    jtask, task, jparams, params, model = _setup(seed=5)
    batch = _batch(seed=1)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtt.forward_loss(p, jtask, _jb(batch), train=True), has_aux=True))(jparams)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, aux = tt.forward_loss(leaves, task, _tb(batch), True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(aux["rnnt_nll"].detach()), float(jaux["rnnt_nll"]),
                               **LOSS_TOL)
    assert float(aux["rnnt_nll"].detach()) < float(loss.detach())  # the L2 term is in the loss
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
        assert float(g.abs().sum()) > 0, k


_JAX_STEPS = {}


def _jax_step(jtask, jparams, jstate, name, batch, lr):
    # one jitted step per optimizer for the whole file: each compile takes seconds
    if name not in _JAX_STEPS:
        _JAX_STEPS[name] = jtt.make_train_step(jtask, jbuild_optimizer(name, 5.0))
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731  the step donates its inputs
    return _JAX_STEPS[name](copy(jparams), copy(jstate), _jb(batch), lr,
                            jax.random.PRNGKey(1))


@pytest.mark.parametrize("name,lr", [("sgd", 0.1), ("adam", 1e-3)])
def test_one_train_step_matches_jax(name, lr):
    jtask, task, jparams, params, model = _setup(seed=6)
    jopt, opt = jbuild_optimizer(name, 5.0), build_optimizer(name, 5.0)
    jstate, state = jopt.init(jparams), opt.init(params)
    batch = _batch(seed=7)
    jparams, jstate, jaux = _jax_step(jtask, jparams, jstate, name, batch, lr)
    params, state, aux = tt.make_train_step(task, opt)(params, state, _tb(batch), lr)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), **LOSS_TOL)
    assert not bool(aux["nonfinite"]) and not bool(jaux["nonfinite"])
    want = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    tol = GRAD_TOL if name == "sgd" else dict(atol=0.1 * lr, rtol=0)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **tol)
    if name == "adam":
        jadam = adam_state_from_jax(jax.tree.map(np.asarray, jstate), model)
        assert int(state["count"]) == int(jadam["count"]) == 1


def test_eval_step_matches_jax():
    jtask, task, jparams, params, _ = _setup(seed=8)
    batch = _batch(seed=9)
    want = [np.asarray(x) for x in jtt.make_eval_step(jtask)(jparams, _jb(batch))]
    decoded, dec_len, nll = tt.make_eval_step(task)(params, _tb(batch))
    np.testing.assert_array_equal(dec_len.numpy(), want[1])
    np.testing.assert_array_equal(decoded.numpy(), want[0])
    np.testing.assert_allclose(nll.numpy(), want[2], **LOSS_TOL)
    assert int(dec_len.sum()) > 0


def test_unported_transducer_options_raise():
    _, task, _, params, _ = _setup()
    # gradient accumulation is ported (tests/test_torch_grad_accum.py): rows must divide by A
    opt = build_optimizer("sgd")
    three_rows = {k: v[:3] for k, v in _tb(_batch(seed=9)).items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        tt.make_train_step(task, opt, grad_accum=2)(params, opt.init(params), three_rows, 0.1)
    # the beam eval step is ported (tests/test_torch_transducer_beam.py)
    assert callable(tt.make_beam_eval_step(task, 4))
    # SpecAugment is ported: the step builds with it (tests/test_torch_conformer_train.py)
    tt.make_train_step(task._replace(spec_augment=SpecAugmentConfig()), build_optimizer("sgd"))
