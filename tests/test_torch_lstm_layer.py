"""The port's unidirectional LSTM layer (kernels #3/#4's plain versions,
``LSTMLayer``, ``models.rnn.LSTM``, the ``lstm`` encoder) vs the JAX package.

The JAX side runs as its own tests run it on the CPU: ``lstm_layer_pallas``
and its VJP in Pallas interpret mode, ``rnn_scan`` with ``impl="scan"``, and
``apply_encoder`` / ``apply_ctc`` (the scan branch on the CPU). Tolerances in
float32: ys and cs within atol 1e-5 (a dozen steps of H <= 32, the two sides
differ only in summation order); gradients rtol 1e-4, atol 1e-5; encoder
outputs and logits atol 1e-4 after two or four layers.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models import ctc as jctc
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    apply_encoder,
    init_encoder,
)
from tensorflow_end2end_speech_recognition_tpu.models.rnn import (
    RNNSpec,
    init_rnn_params,
    rnn_scan,
)
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.lstm_kernel import (
    _fwd_call,
    lstm_layer_pallas,
)
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import LSTM, lstm_scan
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    LSTMLayer,
    lstm_layer,
    lstm_layer_bwd,
    lstm_layer_bwd_plain,
    lstm_layer_fwd,
    lstm_layer_fwd_plain,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import ExperimentConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(b=4, t=11, h=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, 4 * h).astype(np.float32)
    wh = ((rng.rand(h, 4 * h) - 0.5) * 0.6).astype(np.float32)
    lengths = np.asarray([t, 1, 6, t - 1][:b])  # ragged, including 1 and T
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    gys = rng.randn(b, t, h).astype(np.float32)
    return (x, wh, mask), gys


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_fwd_plain_matches_pallas_forward(forget_bias):
    (x, wh, mask), _ = _inputs(seed=int(forget_bias))
    want = np.asarray(lstm_layer_pallas(jnp.asarray(x), jnp.asarray(wh), jnp.asarray(mask),
                                        forget_bias))
    ys_tm, cs_tm = _fwd_call(jnp.swapaxes(jnp.asarray(x), 0, 1), jnp.asarray(wh),
                             jnp.swapaxes(jnp.asarray(mask), 0, 1)[..., None], forget_bias)
    before = lstm_layer.launches
    ys, cs = lstm_layer_fwd(*map(torch.from_numpy, (x, wh, mask)), forget_bias, with_cs=True)
    assert lstm_layer.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(ys.numpy(), want, **TOL)
    np.testing.assert_allclose(ys.numpy(), np.swapaxes(np.asarray(ys_tm), 0, 1), **TOL)
    np.testing.assert_allclose(cs.numpy(), np.swapaxes(np.asarray(cs_tm), 0, 1), **TOL)
    assert (ys.numpy()[1, 1:] == 0).all()  # a masked step emits 0


@pytest.mark.parametrize("forget_bias", [1.0, 0.5])
def test_layer_function_grads_match_pallas_vjp(forget_bias):
    (x, wh, mask), gys = _inputs(seed=3)
    _, vjp = jax.vjp(lambda a, w: lstm_layer_pallas(a, w, jnp.asarray(mask), forget_bias),
                     jnp.asarray(x), jnp.asarray(wh))
    want_dx, want_dwh = (np.asarray(g) for g in vjp(jnp.asarray(gys)))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, wh)]
    before = lstm_layer_bwd.launches
    ys = LSTMLayer.apply(*leaves, torch.from_numpy(mask), forget_bias)
    (ys * torch.from_numpy(gys)).sum().backward()
    assert lstm_layer_bwd.launches == before
    np.testing.assert_allclose(leaves[0].grad.numpy(), want_dx, **GRAD_TOL)
    np.testing.assert_allclose(leaves[1].grad.numpy(), want_dwh, **GRAD_TOL)
    assert (leaves[0].grad.numpy()[1, 1:] == 0).all()  # dgates is 0 on a masked step


def test_bwd_plain_equals_autograd_through_fwd_plain():
    (x, wh, mask), gys = _inputs(b=3, t=9, h=16, seed=5)
    x, wh, mask, gys = map(torch.from_numpy, (x, wh, mask, gys))
    xg = x.clone().requires_grad_(True)
    ys, _ = lstm_layer_fwd_plain(xg, wh, mask)
    (want,) = torch.autograd.grad((ys * gys).sum(), [xg])
    with torch.no_grad():
        ys, cs = lstm_layer_fwd_plain(x, wh, mask)
        got = lstm_layer_bwd(x, wh, mask, ys, cs, gys)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(lstm_layer_bwd_plain(x, wh, mask, ys, cs, gys), got, atol=0,
                               rtol=0)


def test_layer_takes_the_function_only_when_grad_is_needed():
    (x, wh, mask), _ = _inputs(b=2, t=5, seed=6)
    x, wh, mask = map(torch.from_numpy, (x, wh, mask))
    ys = lstm_layer(x, wh, mask)
    assert ys.grad_fn is None
    with torch.no_grad():
        assert lstm_layer(x, wh.requires_grad_(True), mask).grad_fn is None
    ys_g = lstm_layer(x, wh, mask)
    assert type(ys_g.grad_fn).__name__ == "LSTMLayerBackward"
    torch.testing.assert_close(ys_g, ys, atol=0, rtol=0)


def test_layer_rejects_bad_inputs():
    (x, wh, mask), _ = _inputs(b=2, t=5, seed=7)
    x, wh, mask = map(torch.from_numpy, (x, wh, mask))
    with pytest.raises(ValueError, match="wh has shape"):
        lstm_layer(x, wh[:, :8].contiguous(), mask)
    with pytest.raises(ValueError, match="float32"):
        lstm_layer(x, wh.double(), mask)
    # bf16 streams run (test_torch_lstm_bf16.py), but not from a carried state
    h0 = torch.zeros(x.shape[0], wh.shape[0])
    with pytest.raises(NotImplementedError, match="bf16"):
        lstm_layer(x.bfloat16(), wh, mask, initial_state=(h0, h0))


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_lstm_layer_grads_match_rnn_scan(impl):
    b, t, d, h = 3, 10, 6, 16
    rng = np.random.RandomState(7)
    xs = rng.randn(b, t, d).astype(np.float32)
    lengths = np.asarray([t, 1, 4])
    spec = RNNSpec(cell="lstm", num_units=h, impl=impl)
    params = init_rnn_params(jax.random.PRNGKey(8), spec, d)
    w = rng.randn(b, t, h).astype(np.float32)

    def loss(p, x):
        return jnp.sum(rnn_scan(p, spec, x, jnp.asarray(lengths))[0] * w)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(xs))
    want = params_from_jax(jax.tree.map(np.asarray, g_params), LSTM(d, h))
    layer = LSTM(d, h)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), layer))
    x = torch.from_numpy(xs).requires_grad_(True)
    (layer(x, torch.from_numpy(lengths)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), **GRAD_TOL)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_scan_matches_rnn_scan_with_carried_state(with_state):
    b, u, d, h = 3, 6, 5, 8
    rng = np.random.RandomState(9)
    xs = rng.randn(b, u, d).astype(np.float32)
    spec = RNNSpec(cell="lstm", num_units=h, impl="scan")
    params = init_rnn_params(jax.random.PRNGKey(10), spec, d)
    init = tuple(rng.randn(b, h).astype(np.float32) * 0.5 for _ in range(2))
    want_ys, (want_h, want_c) = rnn_scan(
        params, spec, jnp.asarray(xs), jnp.full((b,), u, jnp.int32),
        initial_state=tuple(map(jnp.asarray, init)) if with_state else None)
    layer = LSTM(d, h)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), layer))
    with torch.no_grad():
        ys, (hh, cc) = lstm_scan(layer, torch.from_numpy(xs),
                                 tuple(map(torch.from_numpy, init)) if with_state else None)
    for got, want in ((ys, want_ys), (hh, want_h), (cc, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [False, True])
def test_lstm_encoder_matches_apply_encoder(train):
    kw = dict(encoder_type="lstm", num_units=16, num_layers=2)
    jcfg, cfg = JEncoderConfig(**kw), EncoderConfig(**kw)
    assert cfg.output_dim == jcfg.output_dim == 16 and not cfg.bidirectional
    params = init_encoder(jax.random.PRNGKey(11), jcfg, 7)
    rng = np.random.RandomState(12)
    feats = rng.randn(3, 13, 7).astype(np.float32)
    lens = np.asarray([13, 6, 1], np.int32)
    # dropout stays at keep 1.0: train only checks that the train flag changes nothing else
    want = apply_encoder(params, jcfg, jnp.asarray(feats), jnp.asarray(lens), train=train)
    enc = Encoder(cfg, 7)
    enc.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), enc))
    assert isinstance(enc.layers[0], LSTM)
    with torch.no_grad():
        out, out_len, aux, *_ = enc(torch.from_numpy(feats), torch.from_numpy(lens), train,
                                    torch.Generator().manual_seed(0))
    assert aux is None and want.aux_loss is None
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(want.outputs), atol=1e-4, rtol=0)


def test_unported_unidirectional_types_raise():
    gru = EncoderConfig(encoder_type="gru", num_units=4, num_layers=1)  # ported: the scan path
    assert not gru.bidirectional and gru.cell == "gru" and gru.output_dim == 4
    assert type(Encoder(gru, 3).layers[0]).__name__ == "ScanRNN"
    with pytest.raises(ValueError, match="unknown encoder_type"):
        Encoder(EncoderConfig(encoder_type="lstmx", num_units=4, num_layers=1), 3)
    for t in ("vgg_lstm", "multitask_lstm"):  # ported: one direction of H units
        cfg = EncoderConfig(encoder_type=t, num_units=4, num_layers=1)
        assert not cfg.bidirectional and cfg.output_dim == 4
        Encoder(cfg, 3)


def test_streaming_ctc_config_and_model_match_jax():
    """configs/ls_streaming_ctc.yml (narrowed): the causal CTC model's logits."""
    import yaml

    raw = yaml.safe_load((REPO / "configs" / "ls_streaming_ctc.yml").read_text())
    exp, jexp = ExperimentConfig.from_dict(raw), JExperimentConfig.from_dict(raw)
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    assert exp.encoder_config().encoder_type == "lstm"
    narrow = dict(encoder_type="lstm", num_units=24, num_layers=4, dropout_keep_prob=0.8)
    jcfg = jctc.CTCConfig(encoder=JEncoderConfig(**narrow), num_classes=28)
    cfg = CTCConfig(encoder=EncoderConfig(**narrow), num_classes=28)
    params = jctc.init_ctc(jax.random.PRNGKey(13), jcfg, 40)
    rng = np.random.RandomState(14)
    feats = rng.randn(2, 17, 40).astype(np.float32)
    lens = np.asarray([17, 8], np.int32)
    want = jctc.apply_ctc(params, jcfg, jnp.asarray(feats), jnp.asarray(lens))
    model = CTCModel(cfg, 40)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=1e-4, rtol=0)
