"""The port's CTC models and train steps at ``compute_dtype: bfloat16`` against the JAX package.

The BLSTM (the headline step's encoder, behind the frontend and 3/3
stacking), pyramidal, multitask (the tap after layer 1 and the sub head,
the heads' losses mixed at 0.5) and VGG encoders, their logits, every term
of the loss and every gradient. The fixtures, the JAX side's path and the
tolerances are those of ``tests/test_torch_bf16_models.py``: the module
fixture ``pallas`` patches ``EncoderConfig.spec`` to ``impl="pallas"`` (the
TPU path, in interpret mode); values rtol = atol = 2e-2, gradients rtol
5e-2 and atol 3e-2 of each tensor's largest entry, losses 2e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import ctc as jctc
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import lstm_bidi
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

VALUE_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_RTOL, GRAD_ATOL = 5e-2, 3e-2  # atol of each gradient tensor's largest entry
LOSS_RTOL = 2e-3  # a CTC / RNN-T loss of about 10: float32 sums of bf16-rounded logits
H, NUM, C = 8, 4000, 6  # 4000 samples: 24 frames -> T' = 8 after 3/3 stacking
BF16 = "bfloat16"


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


def _grads_close(got: dict, want: dict):
    for k, g in got.items():
        assert g.dtype == torch.float32, k  # the master weights' gradients
        _grad_close(g, want[k].numpy(), k)
        assert float(g.abs().sum()) > 0, k


def _batch(seed, rows=4):
    """Waveforms of 4000 samples and shorter, labels, and the same labels for a
    multitask sub head."""
    rng = np.random.RandomState(seed)
    wav = (rng.randn(rows, NUM) * 0.1).astype(np.float32)
    input_len = np.asarray([NUM, 3000, 1700, NUM][:rows], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    labels = np.asarray([[0, 1, 1], [2, -1, -1], [3, 4, -1], [5, 0, 2]][:rows], np.int32) % C
    label_len = np.asarray([3, 1, 2, 3][:rows], np.int32)
    return {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len,
            "labels_sub": labels % 4, "label_len_sub": label_len,
            "weight": np.ones((rows,), np.float32)}


# ---- CTC models and their train steps ------------------------------------------------


CTC_CASES = {
    "blstm": dict(encoder_type="blstm", num_layers=2),
    "pyramidal": dict(encoder_type="pyramidal_blstm", num_layers=2),
    "multitask": dict(encoder_type="multitask_blstm", num_layers=2, num_layers_sub=1),
    "vgg": dict(encoder_type="vgg_blstm", num_layers=1),
}


def _ctc_tasks(case):
    enc = dict(CTC_CASES[case], num_units=H, compute_dtype=BF16)
    sub = dict(num_classes_sub=4) if case == "multitask" else {}
    # the multitask loss mixes the heads' terms, so that the sub head has a gradient
    mix = dict(main_task_weight=0.5) if case == "multitask" else {}
    jtask = jctc_task.CTCTaskConfig(
        model=jctc.CTCConfig(encoder=jencoders.EncoderConfig(**enc), num_classes=C, **sub),
        frontend=JFrontendConfig(use_energy=False), num_stack=3, num_skip=3, **mix)
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C, **sub),
        frontend=FrontendConfig(use_energy=False), num_stack=3, num_skip=3, **mix)
    if case == "vgg":  # VGG reads [static | delta | delta-delta] planes, no stacking
        jtask = jtask._replace(num_stack=1, num_skip=1)
        task = task._replace(num_stack=1, num_skip=1)
    return jtask, task


@pytest.fixture(scope="module")
def ctc_cases(pallas):
    """Per case: the tasks, the JAX weights, the bridged weights, and the JAX
    loss's terms and gradients on one batch (one JAX compile per case)."""
    out = {}
    batch = _batch(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i, case in enumerate(CTC_CASES):
        jtask, task = _ctc_tasks(case)
        jparams = jctc_task.init_params(jax.random.PRNGKey(i), jtask)
        model = CTCModel(task.model, task.input_dim)
        (_, jaux), jgrads = jax.jit(jax.value_and_grad(
            lambda p, jtask=jtask: jctc_task.forward_loss(p, jtask, jb, train=True),
            has_aux=True))(jparams)
        out[case] = dict(jtask=jtask, task=task, jparams=jparams,
                         params=_bridge(jparams, model), model=model,
                         jaux={k: float(v) for k, v in jaux.items()},
                         jgrads=_bridge(jgrads, model), batch=batch)
    return out


def test_ctc_logits_match_apply_ctc_bf16(ctc_cases):
    """The headline's model (frontend, stacking, BLSTM, head): its logits;
    the other cases' forward is held through their losses below."""
    c = ctc_cases["blstm"]
    jb = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    jout = jax.jit(lambda p: jctc.apply_ctc(p, c["jtask"].model,
                                            *jctc_task.device_pipeline(c["jtask"], jb)))(
        c["jparams"])
    tb = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    with torch.no_grad():
        feats, feat_len = ctc_task.device_pipeline(c["task"], tb)
        out = ctc_task.apply_model(c["params"], c["task"], feats, feat_len)
    assert out.logits.dtype == torch.float32  # the head upcasts the bf16 encoder output
    np.testing.assert_array_equal(out.logit_len.numpy(), np.asarray(jout.logit_len))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits), **VALUE_TOL)


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_forward_loss_and_gradients_match_jax_bf16(ctc_cases, case):
    c = ctc_cases[case]
    tb = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in c["params"].items()}
    before = lstm_bidi.launches_bf16
    loss, aux = ctc_task.forward_loss(leaves, c["task"], tb, True)
    assert lstm_bidi.launches_bf16 == before  # the CPU takes the plain versions
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert loss.dtype == torch.float32
    for k, v in aux.items():
        np.testing.assert_allclose(float(v.detach()), c["jaux"][k], rtol=LOSS_RTOL, err_msg=k)
    _grads_close(grads, c["jgrads"])


def test_ctc_train_step_keeps_float32_weights_bf16(ctc_cases):
    """The guard, the clip and Adam stay float32; one step moves every weight."""
    c = ctc_cases["blstm"]
    opt = build_optimizer("adam", 5.0)
    params = {k: v.clone() for k, v in c["params"].items()}
    step = ctc_task.make_train_step(c["task"], opt)
    new, state, aux = step(params, opt.init(params), {k: torch.from_numpy(v) for k, v in
                                                       c["batch"].items()}, 1e-3)
    assert not bool(aux["nonfinite"]) and aux["loss"].dtype == torch.float32
    for k, v in new.items():
        assert v.dtype == torch.float32 and not torch.equal(v, params[k]), k
    assert all(x.dtype == torch.float32 for x in state["mu"].values())


