"""The port's BLSTM backward (``LSTMBidi``, ``lstm_bidi_bwd_plain``) vs JAX.

The JAX side runs as its own tests run it on the CPU: the VJP of
``lstm_bidi_pallas`` in Pallas interpret mode, and ``jax.grad`` through
``bidirectional_scan``. Tolerance atol/rtol 1e-5 in float32 for the kernel's
outputs (a dozen steps of H <= 32: the two sides differ only in summation
order), 1e-4 for the layer's weight gradients, which sum over T * B.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models.rnn import (
    RNNSpec,
    bidirectional_scan,
    init_bidirectional,
)
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.lstm_kernel import lstm_bidi_pallas
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import BiLSTM
from tensorflow_end2end_speech_recognition_tpu_torch.ops.ctc import ctc_loss
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    LSTMBidi,
    lstm_bidi,
    lstm_bidi_bwd,
    lstm_bidi_bwd_plain,
    lstm_bidi_fwd_plain,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(b=4, t=11, h=8, seed=0):
    rng = np.random.RandomState(seed)
    xf = rng.randn(b, t, 4 * h).astype(np.float32)
    xb = rng.randn(b, t, 4 * h).astype(np.float32)
    whf = ((rng.rand(h, 4 * h) - 0.5) * 0.6).astype(np.float32)
    whb = ((rng.rand(h, 4 * h) - 0.5) * 0.6).astype(np.float32)
    lengths = np.asarray([t, 1, 6, t - 1][:b])  # ragged, including 1 and T
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    gys = [rng.randn(b, t, h).astype(np.float32) for _ in range(2)]
    return (xf, xb, whf, whb, mask), gys


def _jax_vjp(arrays, gys, forget_bias):
    xf, xb, whf, whb, mask = map(jnp.asarray, arrays)
    _, vjp = jax.vjp(lambda a, b, c, d: lstm_bidi_pallas(a, b, c, d, mask, forget_bias),
                     xf, xb, whf, whb)
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, gys)))]


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_bwd_plain_and_function_match_pallas_vjp(forget_bias):
    arrays, gys = _inputs(seed=int(forget_bias) + 1)
    want = _jax_vjp(arrays, gys, forget_bias)  # dxf, dxb, dwhf, dwhb

    xf, xb, whf, whb, mask = map(torch.from_numpy, arrays)
    gf, gb = map(torch.from_numpy, gys)
    ys_f, ys_b, cs_f, cs_b = lstm_bidi_fwd_plain(xf, xb, whf, whb, mask, forget_bias)
    before = lstm_bidi_bwd.launches
    dx = lstm_bidi_bwd(xf, xb, whf, whb, mask, ys_f, ys_b, cs_f, cs_b, gf, gb, forget_bias)
    assert lstm_bidi_bwd.launches == before  # CPU tensors take the plain version
    for got, w in zip(dx, want[:2]):
        np.testing.assert_allclose(got.numpy(), w, **TOL)

    leaves = [x.clone().requires_grad_(True) for x in (xf, xb, whf, whb)]
    out_f, out_b = LSTMBidi.apply(*leaves, mask, forget_bias)
    ((out_f * gf).sum() + (out_b * gb).sum()).backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, **TOL)


def test_bwd_plain_equals_autograd_through_fwd_plain():
    arrays, gys = _inputs(b=3, t=9, h=16, seed=5)
    xf, xb, whf, whb, mask = map(torch.from_numpy, arrays)
    gf, gb = map(torch.from_numpy, gys)
    xs = [xf.clone().requires_grad_(True), xb.clone().requires_grad_(True)]
    ys_f, ys_b, _, _ = lstm_bidi_fwd_plain(*xs, whf, whb, mask)
    want = torch.autograd.grad((ys_f * gf).sum() + (ys_b * gb).sum(), xs)
    with torch.no_grad():
        ys_f, ys_b, cs_f, cs_b = lstm_bidi_fwd_plain(xf, xb, whf, whb, mask)
        got = lstm_bidi_bwd_plain(xf, xb, whf, whb, mask, ys_f, ys_b, cs_f, cs_b, gf, gb)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_forward_takes_the_function_only_when_grad_is_needed():
    arrays, _ = _inputs(b=2, t=5, seed=6)
    xf, xb, whf, whb, mask = map(torch.from_numpy, arrays)
    ys = lstm_bidi(xf, xb, whf, whb, mask)
    assert all(y.grad_fn is None for y in ys)
    ys = lstm_bidi(xf, xb, whf.requires_grad_(True), whb, mask)
    assert all(type(y.grad_fn).__name__ == "LSTMBidiBackward" for y in ys)
    want = lstm_bidi_fwd_plain(xf, xb, whf, whb, mask)
    for g, w in zip(ys, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_bilstm_grads_match_bidirectional_scan(impl):
    b, t, d, h = 3, 10, 6, 16
    rng = np.random.RandomState(7)
    xs = rng.randn(b, t, d).astype(np.float32)
    lengths = np.asarray([t, 1, 4])
    spec = RNNSpec(cell="lstm", num_units=h, impl=impl)
    params = init_bidirectional(jax.random.PRNGKey(8), spec, d)
    w = rng.randn(b, t, 2 * h).astype(np.float32)  # a distinct cotangent per output

    def loss(p, x):
        return jnp.sum(bidirectional_scan(p, spec, x, jnp.asarray(lengths)) * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(xs))
    want = params_from_jax(jax.tree.map(np.asarray, g_params), BiLSTM(d, h))

    layer = BiLSTM(d, h)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), layer))
    x = torch.from_numpy(xs).requires_grad_(True)
    (layer(x, torch.from_numpy(lengths)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), atol=1e-5, rtol=1e-4)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_every_encoder_parameter_gets_a_gradient():
    """A CTC loss reaches every wx, wh and b of every layer (not only the head)."""
    cfg = CTCConfig(encoder=EncoderConfig(num_units=8, num_layers=3), num_classes=5)
    model = CTCModel(cfg, 6, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(9)
    feats = torch.from_numpy(rng.randn(2, 9, 6).astype(np.float32))
    lens = torch.tensor([9, 5])
    out = model(feats, lens)
    labels = torch.tensor([[0, 1, 2], [3, -1, -1]], dtype=torch.int32)
    ctc_loss(out.logits, out.logit_len, labels, torch.tensor([3, 1]),
             cfg.blank_id).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
