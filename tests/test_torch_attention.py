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


def _grouped_inputs(lengths, group, with_keys, conv_width=9, a=16, he=12, c=4, seed=11):
    """Per-utterance keys, b, enc_out and mask, per-row q and prev: U =
    len(lengths) utterances of ``group`` rows each."""
    rng = np.random.RandomState(seed)
    u, n = len(lengths), len(lengths) * group
    logits = rng.randn(n, T).astype(np.float32)
    prev = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    keys = rng.randn(u, T, a).astype(np.float32) * 0.5
    return dict(
        keys=keys if with_keys else None,
        enc_out=rng.randn(u, T, he).astype(np.float32),
        q=rng.randn(n, a).astype(np.float32) * 0.5,
        prev_align=prev.astype(np.float32),
        enc_mask=np.arange(T)[None, :] < np.asarray(lengths)[:, None],
        conv_w=((rng.rand(conv_width, 1, c) - 0.5) * 0.2).astype(np.float32),
        w_loc=((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32),
        v=((rng.rand(a) - 0.5) * 0.2).astype(np.float32),
        b=(rng.randn(a) * 0.3).astype(np.float32),
    )


@pytest.mark.parametrize("with_keys", [True, False], ids=["hybrid", "location"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_grouped_read_matches_pallas_interpret_on_tiled_inputs(group, with_keys):
    """Row n of the grouped call reads utterance n // group, with b added in
    the call: the same as the Pallas kernel and _reference_math on inputs
    repeated ``group`` times with keys_in = keys + b (b broadcast without keys)."""
    lengths = [T, 0, 9]  # an utterance of length 0: its rows get 1/T
    x = _grouped_inputs(lengths, group, with_keys, seed=group)
    names = ("keys", "enc_out", "q", "prev_align", "enc_mask", "conv_w", "w_loc", "v")
    before = location_attend.launches
    got = location_attend(*(None if x[k] is None else torch.from_numpy(x[k]) for k in names),
                          1.5, b=torch.from_numpy(x["b"]), group=group)
    assert location_attend.launches == before  # CPU tensors: the plain version
    keys_in = x["keys"] + x["b"] if with_keys else np.broadcast_to(
        x["b"], x["enc_out"].shape[:2] + x["b"].shape)
    tile = lambda y: jnp.repeat(jnp.asarray(y), group, axis=0)  # noqa: E731
    tiled = (tile(keys_in), tile(x["enc_out"]), jnp.asarray(x["q"]),
             jnp.asarray(x["prev_align"]), tile(x["enc_mask"]), jnp.asarray(x["conv_w"]),
             jnp.asarray(x["w_loc"]), jnp.asarray(x["v"]))
    n = len(lengths) * group
    assert got[0].shape == (n, 12) and got[1].shape == (n, T)
    for g, w in zip(got, _reference_math(*tiled, 1.5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)
    # the Pallas kernel gives an empty row 1/t_pad, not 1/T: hold the others
    rows = np.repeat(np.asarray(lengths) > 0, group)
    for g, w in zip(got, location_attend_pallas(*tiled, sharpening=1.5, interpret=True)):
        np.testing.assert_allclose(g.numpy()[rows], np.asarray(w)[rows], atol=ATOL, rtol=0)
    for row in range(group, 2 * group):  # the length-0 utterance's rows
        np.testing.assert_allclose(got[1][row].numpy(), np.full(T, 1.0 / T), atol=1e-7)


def test_grouped_read_rejects_rows_that_do_not_match_the_groups():
    x = {k: None if v is None else torch.from_numpy(v)
         for k, v in _grouped_inputs([T, 4], 2, True).items()}
    names = ("keys", "enc_out", "q", "prev_align", "enc_mask", "conv_w", "w_loc", "v")
    call = lambda **kw: location_attend(  # noqa: E731
        *(kw.get(k, x[k]) for k in names), b=kw.get("b", x["b"]), group=kw.get("group", 2))
    call()  # well-formed: 4 rows in 2 groups of 2
    bad = [
        dict(group=3),  # 4 rows do not split into groups of 3
        dict(group=4),  # 1 group of 4 rows for 2 utterances
        dict(keys=x["keys"].repeat_interleave(2, dim=0)),  # keys with a row per decoder row
        dict(enc_mask=x["enc_mask"].repeat_interleave(2, dim=0)),  # a mask row per decoder row
        dict(prev_align=x["prev_align"][:3].contiguous()),  # 3 alignment rows for 4
        dict(keys=None, b=None),  # no keys at all
        dict(b=x["b"][:-1].contiguous()),  # b of the wrong width
        dict(group=0),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)


def test_unfused_read_refuses_a_group():
    """Only the fused read serves grouped rows; the others need one encoder row per row."""
    _, _, att = _bridged(dict(attention_type="content", attention_dim=8))
    assert not att.fused_read
    enc_out, dec_state, prev, mask = (torch.from_numpy(x) for x in _inputs([T, 5]))
    with pytest.raises(ValueError, match="group"):
        att.attend(enc_out[:1], att.precompute_keys(enc_out[:1]), mask[:1], dec_state, prev,
                   fused=True, group=2)
