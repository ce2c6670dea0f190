"""The port's layers, transducer and conformer at ``compute_dtype: bfloat16`` against JAX.

(The CTC models and their train steps: ``tests/test_torch_bf16_ctc.py``.)
The config field's path to the tasks and serving, what still raises at bf16
(a carried state with bf16 streams), and ``ops/bf16.matmul``'s gradient
against JAX's transpose are held here too. (The attention families:
``tests/test_torch_bf16_attention.py``; streaming at bf16:
``tests/test_torch_stream_bf16.py``.)

On the CPU the JAX encoder takes its scan (``impl="auto"``), whose bf16 rounds
``h @ Wh`` and not the streams; the TPU takes the Pallas kernels. The module
fixture ``pallas`` patches ``EncoderConfig.spec`` to ``impl="pallas"`` so
that the JAX side runs the TPU path, its kernels in interpret mode (no JAX
file changes). Both sides start from the same JAX-initialised weights
(bridged) and take the same seeded numpy inputs, at B <= 4, T' <= 16, H = 8
and two layers. Tolerances are those of the JAX package's own bf16 tests
(``tests/test_lstm_pallas.py``: values rtol = atol = 2e-2; gradients rtol
5e-2, atol 3e-2), the gradients' atol taken of each tensor's largest entry:
the two sides run the same rounding recipes and differ in float32
summation order. The conformer, whose every product is a bf16 product
(``ops/bf16.matmul``), is held closer: its gradients within 2e-4 of each
tensor's largest entry and 1e-3 relative, as ``ops/bf16.matmul`` forms a
bf16 product's gradient from the float32 cotangent, as JAX's transpose
does (its gradients match ``jax.grad``'s within one bf16 rounding of the
result, below). Losses are held within 2e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import conformer as jc
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.models.rnn import (
    RNNSpec,
    bidirectional_scan,
    init_bidirectional,
    init_rnn_params,
    rnn_scan,
)
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu_torch import streaming
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models import conformer as tc
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import LSTM, BiLSTM, dropout
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.ops import bf16
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import lstm_bidi, lstm_layer
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

VALUE_TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_RTOL, GRAD_ATOL = 5e-2, 3e-2  # atol of each gradient tensor's largest entry
# the conformer's gradients (5.2e-5 of the largest entry at most, the rotary case)
CONFORMER_GRAD_RTOL, CONFORMER_GRAD_ATOL = 1e-3, 2e-4
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


def _grad_close(got: torch.Tensor, want, what: str, rtol: float = GRAD_RTOL,
                atol: float = GRAD_ATOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol * float(np.abs(want).max()), err_msg=what)


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


# ---- one layer ---------------------------------------------------------------------


def _layer_case(seed, t=12, d=5):
    rng = np.random.RandomState(seed)
    xs = rng.randn(3, t, d).astype(np.float32)
    lengths = np.asarray([t, 7, 1])
    w = rng.randn(3, t, 2 * H).astype(np.float32)
    return xs, lengths, w


def test_bilstm_matches_bidirectional_scan_bf16():
    xs, lengths, w = _layer_case(0)
    spec = RNNSpec(cell="lstm", num_units=H, impl="pallas", compute_dtype=BF16)
    params = init_bidirectional(jax.random.PRNGKey(1), spec, xs.shape[-1])

    def loss(p, x):
        ys = bidirectional_scan(p, spec, x, jnp.asarray(lengths))
        return jnp.sum(ys.astype(jnp.float32) * w), ys

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(xs))
    layer = BiLSTM(xs.shape[-1], H, compute_dtype=BF16)
    layer.load_state_dict(_bridge(params, layer))
    x_t = torch.from_numpy(xs).requires_grad_(True)
    before = lstm_bidi.launches, lstm_bidi.launches_bf16
    ys = layer(x_t, torch.from_numpy(lengths))
    assert (lstm_bidi.launches, lstm_bidi.launches_bf16) == before  # the CPU's plain path
    assert ys.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the same bf16 values up to a few roundings: two bf16 ulps
    np.testing.assert_allclose(ys.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-5)
    grads = torch.autograd.grad((ys.float() * torch.from_numpy(w)).sum(),
                                [x_t] + list(layer.parameters()))
    want_p = _bridge(gp, layer)
    _grad_close(grads[0], gx, "xs")
    _grads_close(dict(zip(dict(layer.named_parameters()), grads[1:])), want_p)


def test_lstm_matches_rnn_scan_bf16():
    xs, lengths, w = _layer_case(2)
    w = w[..., :H]
    spec = RNNSpec(cell="lstm", num_units=H, impl="pallas", compute_dtype=BF16)
    params = init_rnn_params(jax.random.PRNGKey(3), spec, xs.shape[-1])
    # a bf16 input, as a layer after the first gets it: promoted to a float32 product
    xs16 = jnp.asarray(xs).astype(jnp.bfloat16)

    def loss(p, x):
        ys, (h_fin, _) = rnn_scan(p, spec, x, jnp.asarray(lengths))
        return jnp.sum(ys.astype(jnp.float32) * w), (ys, h_fin)

    (_, (want, h_fin)), (gp, gx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, xs16)
    assert h_fin.dtype == jnp.float32  # the final h is upcast; the layer does not return it
    layer = LSTM(xs.shape[-1], H, compute_dtype=BF16)
    layer.load_state_dict(_bridge(params, layer))
    x_t = torch.from_numpy(xs).bfloat16().requires_grad_(True)
    before = lstm_layer.launches, lstm_layer.launches_bf16
    ys = layer(x_t, torch.from_numpy(lengths))
    assert (lstm_layer.launches, lstm_layer.launches_bf16) == before
    assert ys.dtype == torch.bfloat16
    np.testing.assert_allclose(ys.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=8e-3, atol=1e-5)
    grads = torch.autograd.grad((ys.float() * torch.from_numpy(w)).sum(),
                                [x_t] + list(layer.parameters()))
    assert grads[0].dtype == torch.bfloat16
    _grad_close(grads[0], gx, "xs")
    _grads_close(dict(zip(dict(layer.named_parameters()), grads[1:])), _bridge(gp, layer))
    # with a carried state (a streaming chunk) the layer takes rnn_scan's scan branch:
    # a float32 xproj, bf16 operands of h @ Wh with float32 sums, float32 ys
    h0 = np.random.RandomState(4).randn(3, H).astype(np.float32)
    want_ys, (want_h, want_c) = rnn_scan(params, spec, xs16, jnp.asarray(lengths),
                                         initial_state=(jnp.asarray(h0), jnp.asarray(h0)))
    with torch.no_grad():
        ys, (h_t, c_t) = layer(x_t, torch.from_numpy(lengths),
                               (torch.from_numpy(h0), torch.from_numpy(h0)))
    assert ys.dtype == torch.float32 and want_ys.dtype == jnp.float32
    for got, want in ((ys, want_ys), (h_t, want_h), (c_t, want_c)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_dropout_keeps_bf16():
    x = torch.ones(4, 6, dtype=torch.bfloat16)
    out = dropout(x, 0.8, True, torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16
    assert set(out.float().unique().tolist()) <= {0.0, float(torch.tensor(1 / 0.8).bfloat16())}


# ---- the transducer ----------------------------------------------------------------


def test_transducer_forward_loss_and_gradients_match_jax_bf16(pallas):
    enc = dict(encoder_type="lstm", num_units=H, num_layers=1, compute_dtype=BF16)
    model_kw = dict(num_classes=4, pred_num_units=8, embedding_dim=4, joint_dim=12)
    fe = dict(num_mels=40, use_energy=False, add_deltas=False, cmvn="none")
    jtask = jtt.TransducerTaskConfig(
        model=jtransducer.TransducerConfig(encoder=jencoders.EncoderConfig(**enc), **model_kw),
        frontend=JFrontendConfig(**fe), num_stack=3, num_skip=3)
    task = tt.TransducerTaskConfig(
        model=TransducerConfig(encoder=EncoderConfig(**enc), **model_kw),
        frontend=FrontendConfig(**fe), num_stack=3, num_skip=3)
    jparams = jtt.init_params(jax.random.PRNGKey(5), jtask)
    model = tt.init_model(task)
    batch = _batch(seed=2)
    batch["labels"] = batch["labels"] % 4
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtt.forward_loss(p, jtask, jb, train=True), has_aux=True))(jparams)
    leaves = {k: v.clone().requires_grad_(True) for k, v in _bridge(jparams, model).items()}
    loss, _ = tt.forward_loss(leaves, task, {k: torch.from_numpy(v) for k, v in batch.items()},
                              True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    _grads_close(grads, _bridge(jgrads, model))
    # the eval step's greedy decode runs on the bf16 encoder too
    ids, n, nll = tt.make_eval_step(task)(leaves, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert nll.dtype == torch.float32 and bool(torch.isfinite(nll).all())


# ---- the conformer -----------------------------------------------------------------


CONFORMER_CASES = [  # ls960_conformer_ctc's stack; rope with the window; rel_shift with MoE
    dict(block="conformer", pos_encoding="absolute"),
    dict(block="conformer", pos_encoding="rotary", left_context=3),
    dict(block="transformer", moe_experts=3, moe_top_k=2, pos_encoding="relative"),
]


@pytest.mark.parametrize("kw", CONFORMER_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_conformer_stack_and_gradients_match_jax_bf16(kw):
    base = dict(dim=16, num_layers=2, num_heads=2, conv_kernel_size=3, ff_expansion=2,
                compute_dtype=BF16, **kw)
    jspec, spec = jc.ConformerSpec(**base), tc.ConformerSpec(**base)
    d_in, t, lengths = 7, 11, [11, 5, 1, 0]
    p = jc.init_conformer(jax.random.PRNGKey(6), jspec, d_in)
    model = tc.Conformer(spec, d_in)
    model.load_state_dict(_bridge(p, model))
    rng = np.random.RandomState(7)
    x = rng.randn(len(lengths), t, d_in).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    cot = rng.randn(len(lengths), t, 16).astype(np.float32)

    def jloss(p, x):
        out, aux = jc.apply_conformer(p, jspec, x, jnp.asarray(lens), return_aux=True)
        return jnp.sum(out * cot) + aux, out

    (_, want), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = model(xt, torch.from_numpy(lens))
    assert out.dtype == torch.float32  # LayerNorm and the residuals stay float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VALUE_TOL)
    loss = (out * torch.from_numpy(cot)).sum() + (aux if aux is not None else 0.0)
    names = list(dict(model.named_parameters()))
    grads = torch.autograd.grad(loss, [xt] + list(model.parameters()))
    tol = dict(rtol=CONFORMER_GRAD_RTOL, atol=CONFORMER_GRAD_ATOL)
    _grad_close(grads[0], jgx, "inputs", **tol)
    want_p = _bridge(jgp, model)
    for name, g in zip(names, grads[1:]):
        # the key bias's gradient is zero in exact arithmetic unless keys are
        # rotated (it shifts a row of scores by one constant): both sides hold
        # only rounding noise there, within the inputs' gradient atol
        w = want_p[name].numpy()
        if name.endswith("mhsa.k.b") and spec.pos_encoding != "rotary":
            bound = GRAD_ATOL * float(np.abs(np.asarray(jgx)).max())
            assert max(float(g.abs().max()), float(np.abs(w).max())) < bound, name
            continue
        _grad_close(g, w, name, **tol)


# ---- the bf16 product's gradient --------------------------------------------------


@pytest.mark.parametrize("a_shape,b_shape", [((5, 7), (7, 3)), ((2, 5, 7), (7, 3)),
                                             ((2, 5, 7), (2, 7, 3)), ((2, 5, 7), (1, 7, 3))],
                         ids=["2d", "rows-by-matrix", "batched", "broadcast"])
def test_bf16_matmul_gradients_match_jax_transpose(a_shape, b_shape):
    """``ops/bf16.matmul``'s operand gradients against ``jax.grad`` of the
    reference's product: the float32 cotangent times the other bf16 operand,
    float32 sums, the result rounded to bf16 and then widened to the float32
    operand's type. Both sides form the same exact products; float32 sums in
    other orders may differ in the last bit before the bf16 rounding."""
    rng = np.random.RandomState(8)
    a = rng.randn(*a_shape).astype(np.float32)
    b = rng.randn(*b_shape).astype(np.float32)
    out_shape = np.broadcast_shapes(a_shape[:-2], b_shape[:-2]) + (a_shape[-2], b_shape[-1])
    cot = rng.randn(*out_shape).astype(np.float32)

    def jloss(x, w):
        y = jnp.matmul(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    at = torch.from_numpy(a).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = bf16.matmul(at, bt)
    assert y.dtype == torch.float32
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [at, bt])
    for g, w, what in zip(got, want, ("da", "db")):
        assert g.dtype == torch.float32, what
        w = np.asarray(w, np.float32)
        # one bf16 ulp of the result (2**-7 relative at most) where a float32
        # sum lands on a rounding boundary
        np.testing.assert_allclose(g.numpy(), w, rtol=2 ** -7, atol=1e-6, err_msg=what)
        # the gradient is the rounded float32 product: every entry a bf16 value
        assert torch.equal(g, g.bfloat16().float()), what


def test_bf16_matmul_gradient_keeps_the_cotangent_float32():
    """A cotangent's bits below bf16's resolution still count: against b = [1,
    1] the cotangent [1 + 2**-9, -1] gives da = 2**-9, which the cotangent
    rounded to bf16 first ([1, -1]) would turn into 0."""
    a = torch.ones(1, 1, requires_grad=True)
    (g,) = torch.autograd.grad(bf16.matmul(a, torch.ones(1, 2)), [a],
                               torch.tensor([[1.0 + 2.0 ** -9, -1.0]]))
    assert float(g) == 2.0 ** -9


# ---- the config field and what still raises -----------------------------------------


def _raw(**kw):
    base = {"model_type": "ctc", "corpus": "toy", "label_type": "character",
            "input_size": 40, "use_energy": False, "use_delta": False, "cmvn": "none",
            "num_stack": 3, "num_skip": 3, "encoder_type": "blstm", "num_units": 8,
            "num_layers": 2, "compute_dtype": BF16}
    base.update(kw)
    return base


def test_yaml_compute_dtype_reaches_the_tasks_and_serving():
    exp = experiment_from_dict(_raw())
    task = exp.task(28)
    assert task.model.encoder.compute_dtype == BF16
    model = ctc_task.init_model(task, torch.Generator().manual_seed(0)).eval()
    assert model.encoder.layers[0].bf16
    wav = (np.random.RandomState(3).randn(2, NUM) * 0.1).astype(np.float32)
    lens = np.asarray([NUM, 2500], np.int32)
    ids, n = build_inference_fn(task, model)(wav, lens)
    with torch.no_grad():
        feats, fl = ctc_task.device_pipeline(task, {"inputs": torch.from_numpy(wav),
                                                    "input_len": torch.from_numpy(lens)})
        logits = model(feats, fl).logits
    assert logits.dtype == torch.float32
    best = logits.argmax(-1)
    for row in range(2):  # greedy CTC: collapse repeats, drop blanks
        want = [int(c) for i, c in enumerate(best[row, :int(model(feats, fl).logit_len[row])])
                if (i == 0 or c != best[row, i - 1]) and c != task.model.blank_id]
        assert ids[row, :int(n[row])].tolist() == want
    tr = experiment_from_dict(_raw(model_type="transducer", encoder_type="lstm",
                                   pred_num_units=8, embedding_dim=4, joint_dim=8)).task(28)
    assert tr.model.encoder.compute_dtype == BF16


def test_streaming_at_bf16_raises():
    """Streaming runs at bf16 (``tests/test_torch_stream_bf16.py`` holds it to
    JAX's chunk step); a carried state with bf16 streams still raises: the
    reference's chunk takes the scan, which has no bf16 streams."""
    task = experiment_from_dict(_raw(encoder_type="lstm")).task(28)
    model = ctc_task.init_model(task)
    init_fn, step_fn = streaming.build_streaming_fn(task, model, chunk_samples=1600)
    state, _, n = step_fn(init_fn(2), np.zeros((2, 1600), np.float32),
                          np.full((2,), 1600, np.int32))
    assert state.rnn_states[0][0].dtype == torch.float32 and n.shape == (2,)
    h0 = torch.zeros(2, H)
    with pytest.raises(NotImplementedError, match="no bf16 streams"):
        lstm_layer(torch.zeros(2, 3, 4 * H, dtype=torch.bfloat16), torch.zeros(H, 4 * H),
                   torch.ones(2, 3), initial_state=(h0, h0))
