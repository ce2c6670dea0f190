"""The port's CTC train step vs ``make_train_step`` of the JAX package, on the CPU.

Both sides start from the same JAX-initialised weights (bridged) and take the
same batch of waveforms through frontend, stacking, a 2-layer BLSTM, the head,
CTC loss, L2 decay, clip and update. Dropout stays at keep 1.0 (jax.random
cannot be replayed in torch). Tolerances, float32:

- loss: atol 1e-4 on a loss of about 10 (the frontend's log-mel and the
  recurrences sum in different orders on the two sides);
- gradients, and SGD's parameters after the step: atol 2e-5, rtol 1e-4;
- Adam's parameters: atol 0.1 * lr per step taken, and Adam's moments
  rtol 1e-3: its first update is close to ``lr * sign(g)``, so an element
  whose gradient is near zero turns a summation-order difference into a
  larger one of the update (seen: 2 of 23040 weights off by 5.6e-5 at
  lr 1e-3 after one step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.augment import SpecAugmentConfig
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import dropout
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import (
    CTCTaskConfig,
    forward_loss,
    make_train_step,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)

NUM = 4000  # samples: 24 frames -> T' = 8 after 3/3 stacking
C = 6
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _tasks(weight_decay=1e-2):
    enc = dict(encoder_type="blstm", num_units=16, num_layers=2)
    jtask = jctc_task.CTCTaskConfig(
        model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=C),
        frontend=JFrontendConfig(use_energy=False), num_stack=3, num_skip=3,
        weight_decay=weight_decay,
    )
    task = CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
        frontend=FrontendConfig(use_energy=False), num_stack=3, num_skip=3,
        weight_decay=weight_decay,
    )
    return jtask, task


def _batch(seed, impossible=False):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, NUM) * 0.1).astype(np.float32)
    input_len = np.asarray([NUM, 3000, 1700, NUM], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    labels = np.asarray([[0, 1, 1], [2, -1, -1], [3, 4, -1], [5, 0, 2]], np.int32)
    label_len = np.asarray([3, 1, 2, 3], np.int32)
    if impossible:  # 10 frames: 9 labels with 4 repeats need 13
        labels = np.tile(np.asarray([[1, 1, 2, 2, 3, 3, 4, 4, 5]], np.int32), (4, 1))
        label_len = np.full((4,), 9, np.int32)
        input_len[:] = 1700
    weight = np.asarray([1, 1, 1, 0], np.float32)  # the last row is a batch filler
    return {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len,
            "weight": weight}


def _setup(seed=0):
    jtask, task = _tasks()
    jparams = jctc_task.init_params(jax.random.PRNGKey(seed), jtask)
    tree = jax.tree.map(np.asarray, jparams)
    model = CTCModel(task.model, task.input_dim)
    params = params_from_jax(tree, model)
    return jtask, task, jparams, params, model


_JAX_STEPS = {}


def _jax_step(jtask, jparams, jstate, name, batch, lr):
    # one jitted step per optimizer for the whole file: each compile takes seconds
    if (jtask, name) not in _JAX_STEPS:
        _JAX_STEPS[jtask, name] = jctc_task.make_train_step(jtask, jbuild_optimizer(name, 5.0))
    step = _JAX_STEPS[jtask, name]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # the jitted step donates its inputs: hand it copies
    copy = lambda t: jax.tree.map(jnp.array, t)  # noqa: E731
    return step(copy(jparams), copy(jstate), jb, lr, jax.random.PRNGKey(1))


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_and_every_gradient_match_jax():
    jtask, task, jparams, params, model = _setup()
    batch = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jctc_task.forward_loss(p, jtask, jb, train=True), has_aux=True)(jparams)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), model)

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, aux = forward_loss(leaves, task, _tb(batch), True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    assert float(aux["ctc_nll"].detach()) < float(loss.detach())  # the L2 term is in the loss
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
        assert float(g.abs().sum()) > 0, k


@pytest.mark.parametrize("steps", [1, 3])
def test_sgd_steps_match_jax(steps):
    name = "sgd"
    jtask, task, jparams, params, model = _setup(seed=2)
    jopt, opt = jbuild_optimizer("sgd", 5.0), build_optimizer("sgd", 5.0)
    jstate, state = jopt.init(jparams), opt.init(params)
    train_step = make_train_step(task, opt)
    for i in range(steps):
        batch = _batch(seed=10 + i)
        jparams, jstate, jaux = _jax_step(jtask, jparams, jstate, name, batch, 0.1)
        params, state, aux = train_step(params, state, _tb(batch), 0.1)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), **LOSS_TOL)
        assert not bool(aux["nonfinite"]) and not bool(jaux["nonfinite"])
    want = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


def _assert_adam_close(params, state, jparams, jstate, model, lr, steps):
    want = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=0.1 * lr * steps, rtol=0,
                                   err_msg=k)
    jadam = adam_state_from_jax(jax.tree.map(np.asarray, jstate), model)
    assert int(state["count"]) == int(jadam["count"])
    for m in ("mu", "nu"):
        for k, v in state[m].items():
            w = jadam[m][k].numpy()
            np.testing.assert_allclose(v.numpy(), w, atol=1e-3 * float(np.abs(w).max()) + 1e-12,
                                       rtol=1e-3, err_msg=f"{m}.{k}")


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_steps_match_jax(steps):
    lr, name = 1e-3, "adam"
    jtask, task, jparams, params, model = _setup(seed=3)
    jopt, opt = jbuild_optimizer("adam", 5.0), build_optimizer("adam", 5.0)
    jstate, state = jopt.init(jparams), opt.init(params)
    train_step = make_train_step(task, opt)
    for i in range(steps):
        batch = _batch(seed=20 + i)
        jparams, jstate, jaux = _jax_step(jtask, jparams, jstate, name, batch, lr)
        params, state, aux = train_step(params, state, _tb(batch), lr)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), **LOSS_TOL)
    _assert_adam_close(params, state, jparams, jstate, model, lr, steps)


def test_adam_step_from_a_bridged_mid_training_state():
    """Two JAX steps, then the state crosses the bridge and both take a third."""
    lr, name = 1e-3, "adam"
    jtask, task, jparams, _, model = _setup(seed=4)
    jopt, opt = jbuild_optimizer("adam", 5.0), build_optimizer("adam", 5.0)
    jstate = jopt.init(jparams)
    for i in range(2):
        jparams, jstate, _ = _jax_step(jtask, jparams, jstate, name, _batch(seed=30 + i), lr)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), model)
    state = adam_state_from_jax(jax.tree.map(np.asarray, jstate), model)
    assert int(state["count"]) == 2
    batch = _batch(seed=32)
    jparams, jstate, _ = _jax_step(jtask, jparams, jstate, name, batch, lr)
    params, state, _ = make_train_step(task, opt)(params, state, _tb(batch), lr)
    _assert_adam_close(params, state, jparams, jstate, model, lr, 1)


def _leaves(state):
    if torch.is_tensor(state):
        return [state]
    return [x for v in state.values() for x in _leaves(v)]


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_impossible_alignment_rolls_back_params_and_state(name):
    jtask, task, jparams, params, model = _setup(seed=5)
    jopt, opt = jbuild_optimizer(name, 5.0), build_optimizer(name, 5.0)
    jstate, state = jopt.init(jparams), opt.init(params)
    train_step = make_train_step(task, opt)
    # one real step first, so the rolled-back state is not all zeros
    params, state, _ = train_step(params, state, _tb(_batch(seed=40)), 1e-3)
    jparams, jstate, _ = _jax_step(jtask, jparams, jstate, name, _batch(seed=40), 1e-3)
    batch = _batch(seed=41, impossible=True)
    new_params, new_state, aux = train_step(params, state, _tb(batch), 1e-3)
    jnew, jnew_state, jaux = _jax_step(jtask, jparams, jstate, name, batch, 1e-3)
    assert bool(aux["nonfinite"]) and bool(jaux["nonfinite"])
    assert float(aux["loss"]) >= 1e20 and np.isfinite(float(aux["loss"]))
    for k in params:
        assert torch.equal(new_params[k], params[k]), k
    for a, b in zip(_leaves(new_state), _leaves(state)):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(jnew), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(jnew_state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dropout_generator_determinism_and_keep_ratio():
    x = torch.ones(200, 500)
    a = dropout(x, 0.8, True, torch.Generator().manual_seed(7))
    b = dropout(x, 0.8, True, torch.Generator().manual_seed(7))
    c = dropout(x, 0.8, True, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.8) < 0.01  # 1e5 draws: the std of the ratio is 0.0013
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1.0 / 0.8))
    assert torch.equal(dropout(x, 0.8, False, torch.Generator()), x)
    assert torch.equal(dropout(x, 1.0, True, torch.Generator()), x)


def test_train_step_with_dropout_is_reproducible():
    _, task, _, params, _ = _setup(seed=6)
    task = task._replace(model=task.model._replace(
        encoder=task.model.encoder._replace(dropout_keep_prob=0.5)))
    opt = build_optimizer("sgd", 5.0)
    step = make_train_step(task, opt)
    batch = _tb(_batch(seed=50))
    outs = [step(params, opt.init(params), batch, 0.1, torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    assert float(outs[0][2]["loss"]) != float(outs[2][2]["loss"])
    no_drop = step(params, opt.init(params), batch, 0.1)[2]["loss"]  # no generator: no dropout
    assert float(no_drop) != float(outs[0][2]["loss"])


def test_unported_step_options_raise():
    _, task, _, params, _ = _setup()
    opt = build_optimizer("sgd", 5.0)
    # gradient accumulation is ported (tests/test_torch_grad_accum.py): rows must divide by A
    three_rows = {k: v[:3] for k, v in _tb(_batch(seed=9)).items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        make_train_step(task, opt, grad_accum=2)(params, opt.init(params), three_rows, 0.1)
    # SpecAugment is ported: the step builds with it (tests/test_torch_conformer_train.py)
    make_train_step(task._replace(spec_augment=SpecAugmentConfig()), opt)
