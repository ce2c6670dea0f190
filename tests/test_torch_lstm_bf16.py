"""The port's LSTM kernels' plain versions with bf16 streams vs the JAX Pallas kernels.

``compute_dtype: bfloat16`` streams ``xproj``, ``ys``, ``cs``, the cotangent
and ``dxproj`` in bf16 and keeps ``Wh``, the carried state and the gate
math in float32. The JAX side runs as its own tests run it on the CPU:
``lstm_bidi_pallas`` and ``lstm_layer_pallas`` (and their ``_fwd_call`` for
``cs``) in Pallas interpret mode on the same bf16 ``xproj``, values and
``jax.vjp``. Tolerance: two bf16 ulps (rtol 8e-3, atol 1e-5) on ``ys``,
``cs`` and ``dxproj``, which both sides round from float32 walks that
differ only in summation order; 1e-3 of the largest entry on ``dWh``, a
float32 sum over T * B of bf16 products. ``ops/bf16.matmul`` is held to
``jnp.matmul(..., preferred_element_type=float32)`` on bf16 operands:
exact products summed in float32 (1e-6 relative), and gradients within
1e-2 of each one's largest entry (the port rounds the cotangent to bf16
before its products, the reference does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.ops.pallas.lstm_kernel import (
    _bidi_fwd_call,
    _fwd_call,
    lstm_bidi_pallas,
    lstm_layer_pallas,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops import bf16
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    lstm_bidi,
    lstm_bidi_bwd,
    lstm_bidi_fwd_plain,
    lstm_layer,
    lstm_layer_bwd,
    lstm_layer_fwd_plain,
)

torch.set_num_threads(1)

ULPS2 = dict(atol=1e-5, rtol=8e-3)  # two bf16 ulps
DWH_RTOL = 1e-3  # of the largest entry


def _arrays(b=4, t=12, h=8, seed=0, dirs=2):
    """float32 projections (rounded to bf16 by each side), weights, a ragged
    length mask including 1 and T, and float32 cotangents."""
    rng = np.random.RandomState(seed)
    xs = [rng.randn(b, t, 4 * h).astype(np.float32) for _ in range(dirs)]
    whs = [((rng.rand(h, 4 * h) - 0.5) * 0.6).astype(np.float32) for _ in range(dirs)]
    lengths = np.asarray([t, 1, t - 3, 5][:b])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    gys = [rng.randn(b, t, h).astype(np.float32) for _ in range(dirs)]
    return xs, whs, mask, gys


def _jbf(x):
    return jnp.asarray(x).astype(jnp.bfloat16)


def _tbf(x):
    return torch.from_numpy(x).bfloat16()


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got: torch.Tensor, want, what: str, **tol):
    assert got.dtype == torch.bfloat16, (what, got.dtype)
    np.testing.assert_allclose(got.float().numpy(), _np(want), err_msg=what, **(tol or ULPS2))


def _dwh_close(got: torch.Tensor, want, what: str):
    assert got.dtype == torch.float32, (what, got.dtype)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= DWH_RTOL, (what, err)


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_bidi_forward_plain_matches_pallas_bf16(forget_bias):
    xs, whs, mask, _ = _arrays(seed=int(forget_bias))
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    want = _bidi_fwd_call(*(tm(_jbf(x)) for x in xs), *map(jnp.asarray, whs),
                          tm(jnp.asarray(mask))[..., None], forget_bias)
    got = lstm_bidi_fwd_plain(*map(_tbf, xs), *map(torch.from_numpy, whs),
                              torch.from_numpy(mask), forget_bias)
    for name, g, w in zip(("ys_f", "ys_b", "cs_f", "cs_b"), got, want):
        _close(g, tm(w), name)
    before = lstm_bidi.launches, lstm_bidi.launches_bf16
    ys = lstm_bidi(*map(_tbf, xs), *map(torch.from_numpy, whs), torch.from_numpy(mask),
                   forget_bias)
    assert (lstm_bidi.launches, lstm_bidi.launches_bf16) == before  # CPU: the plain path
    for g, w in zip(ys, got[:2]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_bidi_vjp_matches_pallas_bf16(forget_bias):
    xs, whs, mask, gys = _arrays(seed=2 + int(forget_bias))
    jm = jnp.asarray(mask)
    ys, vjp = jax.vjp(lambda a, b, c, d: lstm_bidi_pallas(a, b, c, d, jm, forget_bias),
                      *map(_jbf, xs), *map(jnp.asarray, whs))
    want = vjp(tuple(_jbf(g) for g in gys))
    x_t = [_tbf(x).requires_grad_(True) for x in xs]
    w_t = [torch.from_numpy(w).requires_grad_(True) for w in whs]
    out = lstm_bidi(*x_t, *w_t, torch.from_numpy(mask), forget_bias)
    assert type(out[0].grad_fn).__name__ == "LSTMBidiBackward"
    for name, g, w in zip(("ys_f", "ys_b"), out, ys):
        _close(g.detach(), w, name)
    got = torch.autograd.grad(out, x_t + w_t, [_tbf(g) for g in gys])
    _close(got[0], want[0], "dxproj_f")
    _close(got[1], want[1], "dxproj_b")
    _dwh_close(got[2], want[2], "dwh_f")
    _dwh_close(got[3], want[3], "dwh_b")


def test_bidi_backward_plain_reads_bf16_residuals():
    """``lstm_bidi_bwd`` (the plain version on the CPU) on the JAX forward's
    own bf16 residuals: the reverse walk alone against ``_bidi_bwd_call``'s."""
    from tensorflow_end2end_speech_recognition_tpu.ops.pallas.lstm_kernel import (
        _bidi_bwd_call,
    )

    xs, whs, mask, gys = _arrays(b=3, t=10, h=16, seed=5)
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    mask_tm = tm(jnp.asarray(mask))[..., None]
    jx = [tm(_jbf(x)) for x in xs]
    res = _bidi_fwd_call(*jx, *map(jnp.asarray, whs), mask_tm, 1.0)
    want = _bidi_bwd_call(*jx, *map(jnp.asarray, whs), mask_tm, *res,
                          *(tm(_jbf(g)) for g in gys), 1.0)
    t2 = lambda x: torch.from_numpy(np.array(_np(tm(x)))).bfloat16()  # noqa: E731
    before = lstm_bidi_bwd.launches_bf16
    got = lstm_bidi_bwd(*map(_tbf, xs), *map(torch.from_numpy, whs), torch.from_numpy(mask),
                        *map(t2, res), *map(_tbf, gys), 1.0)
    assert lstm_bidi_bwd.launches_bf16 == before
    _close(got[0], tm(want[0]), "dxproj_f")
    _close(got[1], tm(want[1]), "dxproj_b")


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_layer_forward_plain_matches_pallas_bf16(forget_bias):
    xs, whs, mask, _ = _arrays(seed=7 + int(forget_bias), dirs=1)
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    want = _fwd_call(tm(_jbf(xs[0])), jnp.asarray(whs[0]), tm(jnp.asarray(mask))[..., None],
                     forget_bias)
    got = lstm_layer_fwd_plain(_tbf(xs[0]), torch.from_numpy(whs[0]), torch.from_numpy(mask),
                               forget_bias)
    _close(got[0], tm(want[0]), "ys")
    _close(got[1], tm(want[1]), "cs")


@pytest.mark.parametrize("forget_bias", [1.0, 0.0])
def test_layer_vjp_matches_pallas_bf16(forget_bias):
    xs, whs, mask, gys = _arrays(seed=11 + int(forget_bias), dirs=1)
    jm = jnp.asarray(mask)
    ys, vjp = jax.vjp(lambda a, w: lstm_layer_pallas(a, w, jm, forget_bias), _jbf(xs[0]),
                      jnp.asarray(whs[0]))
    want = vjp(_jbf(gys[0]))
    x_t = _tbf(xs[0]).requires_grad_(True)
    w_t = torch.from_numpy(whs[0]).requires_grad_(True)
    before = lstm_layer_bwd.launches, lstm_layer_bwd.launches_bf16
    out = lstm_layer(x_t, w_t, torch.from_numpy(mask), forget_bias)
    assert type(out.grad_fn).__name__ == "LSTMLayerBackward"
    _close(out.detach(), ys, "ys")
    dx, dwh = torch.autograd.grad(out, (x_t, w_t), _tbf(gys[0]))
    assert (lstm_layer_bwd.launches, lstm_layer_bwd.launches_bf16) == before
    _close(dx, want[0], "dxproj")
    _dwh_close(dwh, want[1], "dwh")


def test_function_takes_a_float32_cotangent_at_the_stream_dtype():
    """A float32 cotangent of bf16 ``ys`` is rounded to bf16 first, as
    ``_bwd_call`` casts ``gys`` to the stream dtype."""
    xs, whs, mask, gys = _arrays(seed=13, dirs=1)
    x_t = _tbf(xs[0]).requires_grad_(True)
    w_t = torch.from_numpy(whs[0]).requires_grad_(True)
    out = lstm_layer(x_t, w_t, torch.from_numpy(mask)).float()
    g32 = torch.autograd.grad(out, (x_t, w_t), torch.from_numpy(gys[0]))
    out = lstm_layer(x_t, w_t, torch.from_numpy(mask))
    g16 = torch.autograd.grad(out, (x_t, w_t), _tbf(gys[0]))
    assert g32[0].dtype == torch.bfloat16 and g32[1].dtype == torch.float32
    for a, b in zip(g32, g16):
        assert torch.equal(a, b)


@pytest.mark.parametrize("xshape,wshape", [
    ((5, 12), (12, 7)),  # a dense layer
    ((2, 3, 12), (12, 7)),  # rows of a batch
    ((2, 3, 6, 4), (2, 3, 4, 6)),  # attention scores
    ((1, 2, 6, 4), (3, 1, 4, 5)),  # the MoE bank: every expert on every row
])
def test_bf16_matmul_matches_jax_preferred_float32(xshape, wshape):
    rng = np.random.RandomState(17)
    x, w = rng.randn(*xshape).astype(np.float32), rng.randn(*wshape).astype(np.float32)
    g = rng.randn(*np.broadcast_shapes(xshape[:-2], wshape[:-2]), xshape[-2],
                  wshape[-1]).astype(np.float32)

    def f(a, b):
        return jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    x_t, w_t = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    got = bf16.matmul(x_t, w_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    dx, dw = torch.autograd.grad(got, (x_t, w_t), torch.from_numpy(g))
    for name, a, b in (("dx", dx, want_dx), ("dw", dw, want_dw)):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert np.abs(a.numpy() - b).max() <= 1e-2 * np.abs(b).max(), name
    # the operands' gradients are bf16 values, as JAX's transpose converts them
    assert torch.equal(dx, dx.bfloat16().float()) and torch.equal(dw, dw.bfloat16().float())


def test_bf16_mm_f32_refuses_float32_operands():
    with pytest.raises(ValueError, match="bf16 operands"):
        bf16.mm_f32(torch.ones(2, 2), torch.ones(2, 2).bfloat16())
