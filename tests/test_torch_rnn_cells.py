"""The scan-path recurrent layers against the JAX package's scan, on the CPU.

``models/rnn.py``'s option LSTM cell (peephole, projection, cell clip) and
GRU cell, one direction (``rnn_scan``, forward and reversed, with and
without a carried ``initial_state``) and both (``ScanBiRNN`` against
``bidirectional_scan``), from the same JAX-initialised weights (bridged) and
seeded numpy inputs with ragged lengths that include 1 and T. Each case
checks the outputs, the final state and, through ``jax.grad`` and autograd
of one weighted sum of both, the gradients of every weight, the inputs and
the initial state. Tolerances:

- float32: outputs and states within 1e-5; each gradient within 1e-4 of
  its largest entry;
- bfloat16 (``h @ Wh`` on bf16 operands, float32 sums; the gradients of
  ``h_prev`` and ``Wh`` rounded to bf16 on both sides): outputs, states and
  each gradient within 1e-4 of their largest entry;
- GRU casts nothing at bfloat16: its outputs equal its float32 ones.

``num_proj: 0`` and ``clip_activation: 0`` read as "off", as the reference
reads them by truth: the encoder then keeps the kernels' ``BiLSTM``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import rnn as jrnn
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import (
    BiLSTM,
    CellParams,
    RNNSpec,
    ScanBiRNN,
    rnn_scan,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

B, T, D, H = 3, 6, 5, 8
LENS = np.asarray([T, 1, 4], np.int32)
F32_ATOL, F32_GRAD, BF16_REL = 1e-5, 1e-4, 1e-4
OPTIONS = {
    "peephole": dict(use_peephole=True),
    "proj": dict(num_proj=6),
    "clip": dict(clip_activation=0.3),
    "all": dict(use_peephole=True, num_proj=6, clip_activation=0.3),
    "gru": dict(cell="gru"),
}
# (options, compute dtype, carried initial state, reversed)
CASES = {
    "peephole f32": ("peephole", "float32", False, False),
    "proj f32 carried reversed": ("proj", "float32", True, True),
    "clip f32 carried": ("clip", "float32", True, False),
    "all f32 reversed": ("all", "float32", False, True),
    "all f32 carried": ("all", "float32", True, False),
    "all bf16 carried": ("all", "bfloat16", True, False),
    "peephole bf16 reversed": ("peephole", "bfloat16", False, True),
    "gru f32 carried": ("gru", "float32", True, False),
    "gru f32 reversed": ("gru", "float32", False, True),
    "gru bf16": ("gru", "bfloat16", False, False),
}


def _specs(option: str, dtype: str):
    kw = dict(num_units=H, compute_dtype=dtype, **OPTIONS[option])
    return jrnn.RNNSpec(**kw), RNNSpec(**kw)


def _inputs(spec, seed: int):
    rng = np.random.RandomState(seed)
    xs = rng.randn(B, T, D).astype(np.float32)
    xs[1, 1:] = 0.0
    state = [rng.randn(B, spec.out_dim).astype(np.float32) * 0.5]
    if spec.cell == "lstm":
        state.append(rng.randn(B, spec.num_units).astype(np.float32) * 0.5)
    g_ys = rng.randn(B, T, spec.out_dim).astype(np.float32)
    g_state = [rng.randn(*s.shape).astype(np.float32) for s in state]
    return xs, tuple(state), g_ys, tuple(g_state)


def _grad_close(name, got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rnn_scan_matches_jax(case):
    option, dtype, carried, reverse = CASES[case]
    jspec, spec = _specs(option, dtype)
    assert not spec.on_kernels and not jspec.pallas_eligible
    params = jrnn.init_rnn_params(jax.random.PRNGKey(1), jspec, D, 0.3)
    xs, state, g_ys, g_state = _inputs(spec, 2)
    if option == "clip":  # a clip that binds: the cell state grows past 0.3
        params = dict(params, b=params["b"] + 0.5)

    def jloss(p, x, s0):
        ys, fin = jrnn.rnn_scan(p, jspec, x, jnp.asarray(LENS), reverse,
                                initial_state=s0 if carried else None)
        total = jnp.sum(ys * g_ys) + sum(jnp.sum(f * g) for f, g in zip(fin, g_state))
        return total, (ys, fin)

    jstate = tuple(jnp.asarray(s) for s in state)
    (_, (jys, jfin)), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(
        params, jnp.asarray(xs), jstate)

    p = CellParams(spec, D)
    p.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), p))
    x = torch.from_numpy(xs).requires_grad_(True)
    s0 = tuple(torch.from_numpy(s).requires_grad_(True) for s in state)
    ys, fin = rnn_scan(p, x, torch.from_numpy(LENS), reverse,
                       initial_state=s0 if carried else None)
    assert ys.dtype == torch.float32 and len(fin) == len(state)
    total = (ys * torch.from_numpy(g_ys)).sum() + sum(
        (f * torch.from_numpy(g)).sum() for f, g in zip(fin, g_state))
    leaves = [x, *s0] if carried else [x]
    grads = torch.autograd.grad(total, [*p.parameters(), *leaves])
    names = [n for n, _ in p.named_parameters()]

    bf16 = dtype == "bfloat16" and option != "gru"
    for got, want, what in ((ys, jys, "ys"), *((f, w, f"state {i}") for i, (f, w) in
                                               enumerate(zip(fin, jfin)))):
        got, want = got.detach().numpy(), np.asarray(want)
        atol = BF16_REL * float(np.abs(want).max()) if bf16 else F32_ATOL
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)
    np.testing.assert_array_equal(ys.detach().numpy()[1, 1:], 0.0)  # masked steps emit 0
    want_grads = dict(jgrads[0])
    want_grads["xs"] = jgrads[1]
    for i, g in enumerate(jgrads[2]):
        want_grads[f"s{i}"] = g
    got_names = names + ["xs"] + ([f"s{i}" for i in range(len(state))] if carried else [])
    for name, g in zip(got_names, grads):
        _grad_close(name, g.numpy(), np.asarray(want_grads[name]),
                    F32_GRAD)
    if option == "gru" and dtype == "bfloat16":  # GRU ignores compute_dtype
        f32 = CellParams(spec._replace(compute_dtype="float32"), D)
        f32.load_state_dict(p.state_dict())
        ys32, _ = rnn_scan(f32, x, torch.from_numpy(LENS), reverse)
        assert torch.equal(ys32, ys)


@pytest.mark.parametrize("option,dtype", [("all", "bfloat16"), ("gru", "float32")])
def test_scan_birnn_matches_bidirectional_scan(option, dtype):
    jspec, spec = _specs(option, dtype)
    params = jrnn.init_bidirectional(jax.random.PRNGKey(3), jspec, D, 0.3)
    xs, _, _, _ = _inputs(spec, 4)
    g = np.random.RandomState(5).randn(B, T, 2 * spec.out_dim).astype(np.float32)

    def jloss(p, x):
        ys = jrnn.bidirectional_scan(p, jspec, x, jnp.asarray(LENS))
        return jnp.sum(ys * g), ys

    (_, jys), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(xs))
    layer = ScanBiRNN(spec, D)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), layer))
    x = torch.from_numpy(xs).requires_grad_(True)
    ys = layer(x, torch.from_numpy(LENS))
    grads = torch.autograd.grad((ys * torch.from_numpy(g)).sum(), [*layer.parameters(), x])
    bf16 = dtype == "bfloat16"
    atol = BF16_REL * float(np.abs(np.asarray(jys)).max()) if bf16 else F32_ATOL
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), atol=atol, rtol=0)
    flat = {f"{d}.{k}": v for d in ("fwd", "bwd") for k, v in jgrads[0][d].items()}
    flat["xs"] = jgrads[1]
    for (name, _), got in zip([*layer.named_parameters(), ("xs", None)], grads):
        _grad_close(name, got.numpy(), np.asarray(flat[name]), F32_GRAD)


@pytest.mark.parametrize("encoder_type", ["blstm", "lstm"])
def test_zero_proj_and_clip_mean_off(encoder_type):
    """``num_proj: 0`` / ``clip_activation: 0``: the plain cell on the kernels'
    layers, equal to JAX (which reads both by truth) and to the unset config."""
    kw = dict(encoder_type=encoder_type, num_units=H, num_layers=2, num_proj=0,
              clip_activation=0.0)
    jcfg, cfg = jencoders.EncoderConfig(**kw), EncoderConfig(**kw)
    assert cfg.spec().on_kernels and jcfg.spec().pallas_eligible
    assert cfg.output_dim == jcfg.output_dim == H * (2 if encoder_type == "blstm" else 1)
    params = jencoders.init_encoder(jax.random.PRNGKey(6), jcfg, D)
    enc = Encoder(cfg, D)
    assert type(enc.layers[0]).__name__ == ("BiLSTM" if encoder_type == "blstm" else "LSTM")
    assert isinstance(enc.layers[0], BiLSTM) == (encoder_type == "blstm")
    enc.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), enc))
    xs, _, _, _ = _inputs(RNNSpec(num_units=H), 7)
    want = jencoders.apply_encoder(params, jcfg, jnp.asarray(xs), jnp.asarray(LENS))
    with torch.no_grad():
        got = enc(torch.from_numpy(xs), torch.from_numpy(LENS))
        unset = Encoder(cfg._replace(num_proj=None, clip_activation=None), D)
        unset.load_state_dict(enc.state_dict())
        plain = unset(torch.from_numpy(xs), torch.from_numpy(LENS))
    np.testing.assert_allclose(got.outputs.numpy(), np.asarray(want.outputs), atol=F32_ATOL,
                               rtol=0)
    assert torch.equal(got.outputs, plain.outputs)
