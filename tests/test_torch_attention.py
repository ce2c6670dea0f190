"""The port's attention scorers and kernel #7's plain version, against the JAX package.

Same seeded numpy inputs through both packages, weights carried by
``utils/bridge.params_from_jax``. Tolerance: atol 1e-5 in float32 (sums of
at most a few hundred terms, taken in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models import attention as jattention
from tensorflow_end2end_speech_recognition_tpu.ops.pallas.attention_kernel import (
    _reference_math,
    location_attend_pallas,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import (
    ATTENTION_TYPES,
    Attention,
    AttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.attention import (
    location_attend,
    location_attend_plain,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-5
B, T, ENC, DEC = 4, 23, 12, 10


def _bridged(cfg_kw, enc_dim=ENC, dec_dim=DEC, seed=0):
    jcfg = jattention.AttentionConfig(**cfg_kw)
    params = jattention.init_attention(jax.random.PRNGKey(seed), jcfg, enc_dim, dec_dim)
    att = Attention(AttentionConfig(**cfg_kw), enc_dim, dec_dim)
    att.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), att))
    return jcfg, params, att


def _inputs(lengths, enc_dim=ENC, dec_dim=DEC, seed=1):
    rng = np.random.RandomState(seed)
    b = len(lengths)
    enc_out = rng.randn(b, T, enc_dim).astype(np.float32)
    dec_state = rng.randn(b, dec_dim).astype(np.float32)
    logits = rng.randn(b, T).astype(np.float32)
    prev = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return enc_out, dec_state, prev.astype(np.float32), mask


def _jax_attend(jcfg, params, enc_out, dec_state, prev, mask):
    keys = jattention.precompute_keys(params, jcfg, jnp.asarray(enc_out))
    ctx, align = jattention.attend(params, jcfg, jnp.asarray(enc_out), keys, jnp.asarray(mask),
                                   jnp.asarray(dec_state), jnp.asarray(prev))
    return np.asarray(ctx), np.asarray(align)


def _port_attend(att, enc_out, dec_state, prev, mask, fused=False):
    enc = torch.from_numpy(enc_out)
    with torch.no_grad():
        ctx, align = att.attend(enc, att.precompute_keys(enc), torch.from_numpy(mask),
                                torch.from_numpy(dec_state), torch.from_numpy(prev), fused=fused)
    return ctx.numpy(), align.numpy()


@pytest.mark.parametrize("att_type", ATTENTION_TYPES)
def test_attend_matches_jax(att_type):
    cfg_kw = dict(attention_type=att_type, attention_dim=16, conv_num_channels=4, conv_width=11,
                  sharpening_factor=1.5)
    jcfg, params, att = _bridged(cfg_kw)
    args = _inputs([T, 17, 1, 0])  # a filler row of length 0 too
    want = _jax_attend(jcfg, params, *args)
    got = _port_attend(att, *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1][3], np.full(T, 1.0 / T), atol=1e-7)  # 1/T on length 0


@pytest.mark.parametrize("att_type", ["hybrid", "content"])
def test_attend_sigmoid_smoothing_matches_jax(att_type):
    cfg_kw = dict(attention_type=att_type, attention_dim=8, conv_num_channels=3, conv_width=5,
                  sigmoid_smoothing=True)
    jcfg, params, att = _bridged(cfg_kw, seed=3)
    args = _inputs([T, 9, 2, 1], seed=4)
    # sigmoid smoothing never takes the fused read: fused=True must not change it
    for fused in (False, True):
        got = _port_attend(att, *args, fused=fused)
        for g, w in zip(got, _jax_attend(jcfg, params, *args)):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("att_type", ["hybrid", "location"])
@pytest.mark.parametrize("conv_width", [10, 11])
def test_fused_read_matches_unfused_jax_attend(att_type, conv_width):
    """The fused read (additive -1e30 mask, keys + b + loc + q) agrees with the
    JAX unfused attend (replacing mask, b + keys + q + loc) on every row,
    the all-masked one included."""
    cfg_kw = dict(attention_type=att_type, attention_dim=16, conv_num_channels=4,
                  conv_width=conv_width, sharpening_factor=1.5)
    jcfg, params, att = _bridged(cfg_kw, seed=conv_width)
    args = _inputs([T, 5, 1, 0], seed=5)
    before = location_attend.launches
    got = _port_attend(att, *args, fused=True)
    assert location_attend.launches == before  # CPU tensors: the plain version
    for g, w in zip(got, _jax_attend(jcfg, params, *args)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def _kernel_inputs(lengths, conv_width, a=16, he=12, c=4, seed=0):
    rng = np.random.RandomState(seed)
    n = len(lengths)
    logits = rng.randn(n, T).astype(np.float32)
    prev = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return (
        rng.randn(n, T, a).astype(np.float32) * 0.5,  # keys_in
        rng.randn(n, T, he).astype(np.float32),  # enc_out
        rng.randn(n, a).astype(np.float32) * 0.5,  # q
        prev.astype(np.float32),
        np.arange(T)[None, :] < np.asarray(lengths)[:, None],  # enc_mask
        ((rng.rand(conv_width, 1, c) - 0.5) * 0.2).astype(np.float32),  # conv_w
        ((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32),  # w_loc
        ((rng.rand(a) - 0.5) * 0.2).astype(np.float32),  # v
    )


def _plain(args, sharpening):
    return [x.numpy() for x in location_attend(*map(torch.from_numpy, args), sharpening)]


@pytest.mark.parametrize("conv_width", [10, 11])
def test_plain_matches_pallas_interpret(conv_width):
    args = _kernel_inputs([T, 7, 1, 16], conv_width, seed=conv_width)
    want = location_attend_pallas(*map(jnp.asarray, args), sharpening=1.5, interpret=True)
    got = _plain(args, 1.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("conv_width", [1, 4, 11, 60])  # 60 > T: taps reach past both ends
def test_plain_matches_reference_math_with_empty_row(conv_width):
    args = _kernel_inputs([T, 0, 3, 1], conv_width, a=8, he=6, c=3, seed=7)
    want = _reference_math(*map(jnp.asarray, args), 0.7)
    got = _plain(args, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1][1], np.full(T, 1.0 / T), atol=1e-7)


def test_location_attend_rejects_bad_inputs():
    args = list(map(torch.from_numpy, _kernel_inputs([T, 4], 5)))
    location_attend_plain(*args)  # well-formed
    bad = {
        0: args[0].double(),  # float64 keys
        1: args[1].transpose(1, 2).contiguous().transpose(1, 2),  # non-contiguous enc_out
        2: args[2][:, :-1].contiguous(),  # q of the wrong width
        4: args[4].float(),  # float mask
        5: args[5][:, 0].contiguous(),  # conv_w without its middle axis
        6: args[6].t().contiguous(),  # w_loc [A, C]
    }
    for i, x in bad.items():
        with pytest.raises(ValueError):
            location_attend(*(x if j == i else a for j, a in enumerate(args)))
