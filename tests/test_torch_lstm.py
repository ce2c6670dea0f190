"""Port ``lstm_bidi`` and ``BiLSTM`` vs the JAX Pallas kernel and scan path.

The JAX side runs as its own tests run it on the CPU: ``lstm_bidi_pallas``
in Pallas interpret mode, and ``bidirectional_scan`` with
``RNNSpec(impl="pallas")`` and ``impl="scan"``. Tolerance atol/rtol 1e-5 in
float32, as ``tests/test_lstm_pallas.py`` holds the kernel to the scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models.rnn import (
    RNNSpec,
    _flip_valid,
    bidirectional_scan,
    init_bidirectional,
)
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.lstm_kernel import lstm_bidi_pallas
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import BiLSTM, flip_valid
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import lstm_bidi
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _kernel_inputs(b=3, t=9, h=8, seed=0):
    rng = np.random.RandomState(seed)
    xf = rng.randn(b, t, 4 * h).astype(np.float32)
    xb = rng.randn(b, t, 4 * h).astype(np.float32)
    whf = (rng.rand(h, 4 * h).astype(np.float32) - 0.5) * 0.4
    whb = (rng.rand(h, 4 * h).astype(np.float32) - 0.5) * 0.4
    lengths = np.asarray([t, 5, 1][:b])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return xf, xb, whf, whb, mask


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_plain_lstm_bidi_matches_pallas_kernel(forget_bias):
    arrays = _kernel_inputs(seed=int(forget_bias))
    want = lstm_bidi_pallas(*map(jnp.asarray, arrays), forget_bias)
    before = lstm_bidi.launches
    got = lstm_bidi(*map(torch.from_numpy, arrays), forget_bias)
    assert lstm_bidi.launches == before  # CPU tensors take the plain path
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_flip_valid_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 6, 2).astype(np.float32)
    lengths = np.asarray([6, 4, 0])
    want = _flip_valid(jnp.asarray(x), jnp.asarray(lengths))
    got = flip_valid(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_bilstm_layer_matches_bidirectional_scan(impl):
    b, t, d, h = 4, 16, 6, 32
    rng = np.random.RandomState(3)
    xs = rng.randn(b, t, d).astype(np.float32)
    lengths = np.asarray([t, 11, 3, 1])
    spec = RNNSpec(cell="lstm", num_units=h, impl=impl)
    params = init_bidirectional(jax.random.PRNGKey(4), spec, d)
    want = bidirectional_scan(params, spec, jnp.asarray(xs), jnp.asarray(lengths))

    layer = BiLSTM(d, h)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), layer))
    before = lstm_bidi.launches
    with torch.inference_mode():
        got = layer(torch.from_numpy(xs), torch.from_numpy(lengths))
    assert lstm_bidi.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_input_checks_raise():
    xf, xb, whf, whb, mask = map(torch.from_numpy, _kernel_inputs())
    # the streams share one dtype (float32 or bf16); wh and mask stay float32
    with pytest.raises(ValueError, match="xproj_b must be torch.bfloat16"):
        lstm_bidi(xf.bfloat16(), xb, whf, whb, mask)
    with pytest.raises(ValueError, match="wh_f must be torch.float32"):
        lstm_bidi(xf.bfloat16(), xb.bfloat16(), whf.bfloat16(), whb, mask)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_bidi(xf.transpose(0, 1).contiguous().transpose(0, 1), xb, whf, whb, mask)
    with pytest.raises(ValueError, match="meta"):
        lstm_bidi(xf, xb, whf.to("meta"), whb, mask)
    with pytest.raises(ValueError, match="shape"):
        lstm_bidi(xf, xb, whf[:, :-4].contiguous(), whb, mask)
    with pytest.raises(ValueError, match="empty"):
        lstm_bidi(xf[:, :0], xb[:, :0], whf, whb, mask[:, :0])


@pytest.mark.parametrize("field,value", [
    ("use_peephole", True), ("num_proj", 4), ("clip_activation", 5.0),
    ("encoder_type", "bgru"), ("compute_dtype", "float16"),
])
def test_unported_encoder_options_raise(field, value):
    """Every cell option and GRU is ported (the scan-path layers); only a
    compute dtype that does not exist raises."""
    cfg = EncoderConfig(**{field: value})
    if field == "compute_dtype":
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            Encoder(cfg, input_dim=4)
        return
    enc = Encoder(cfg, input_dim=4)
    assert not cfg.spec().on_kernels
    assert type(enc.layers[0]).__name__ == "ScanBiRNN"
    assert cfg.output_dim == 2 * (value if field == "num_proj" else cfg.num_units)
