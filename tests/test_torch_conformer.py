"""The port's conformer / transformer encoder against the JAX package, on the CPU.

Weights come from the JAX initialisers, perturbed by seeded noise so that
the LayerNorm gains, the biases and the relative-position ``pos_u`` /
``pos_v`` (zeros at init) all matter, and cross with ``utils/bridge.py``.
Inputs come from numpy seeds, at dim 16, 2 or 4 heads, 2 layers, kernel 3
and 4, T <= 13, B = 4 with lengths T, 5, 1 and 0 (a filler row with no
valid frame). Tolerances, float32:

- outputs of a module or of the stack, and the MoE aux loss: atol 1e-5
  (sums of a few dozen terms in other orders);
- gradients of the stack: 1e-4 of each tensor's largest entry. The key
  bias's gradient is zero in exact arithmetic unless keys are rotated (a
  bias added to every key shifts a row's scores by one constant, which the
  softmax ignores); both sides' cancellation noise, about 1e-6, must stay
  below 1e-5;
- ``rel_shift`` against a gather oracle, and the gates' tie rule: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models import conformer as jc
from tensorflow_end2end_speech_recognition_tpu.models import ctc as jctc
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu_torch.models import conformer as tc
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

ATOL = 1e-5
GRAD_RTOL = 1e-4  # of each gradient tensor's largest entry
CANCELLED = 1e-5  # a gradient that is zero in exact arithmetic (the key bias)
D_IN, DIM, T = 7, 16, 13
LENGTHS = [T, 5, 1, 0]


def _spec(**kw):
    base = dict(dim=DIM, num_layers=2, num_heads=4, conv_kernel_size=3, ff_expansion=2)
    base.update(kw)
    return jc.ConformerSpec(**base), tc.ConformerSpec(**base)


def _perturb(tree, seed, scale=0.1):
    """Every leaf plus seeded noise (numpy float32)."""
    leaves, treedef = jax.tree.flatten(jax.tree.map(np.asarray, tree))
    rng = np.random.RandomState(seed)
    return treedef.unflatten([(x + scale * rng.randn(*x.shape)).astype(np.float32)
                              for x in leaves])


def _load(module, tree):
    module.load_state_dict(params_from_jax(tree, module))
    return module


def _inputs(seed, d=DIM, lengths=LENGTHS, t=T):
    rng = np.random.RandomState(seed)
    x = rng.randn(len(lengths), t, d).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    mask = np.arange(t)[None, :] < lens[:, None]
    return x, lens, mask


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


# ---- LayerNorm, feed-forward, positions ---------------------------------------------


def test_layer_norm_and_feed_forward_match_jax():
    jspec, spec = _spec()
    x, _, _ = _inputs(0)
    x[1] *= 30.0  # a row of large values: the variance is biased, eps inside the rsqrt
    p_ln = _perturb(jc._ln_init(DIM), 1)
    _close(_load(tc.LayerNorm(DIM), p_ln)(torch.from_numpy(x)), jc._ln(p_ln, jnp.asarray(x)))
    p_ff = _perturb(jc._ff_init(jax.random.PRNGKey(2), jspec), 3)
    ff = _load(tc.FeedForward(spec), p_ff)
    assert sorted(ff.state_dict()) == ["in.b", "in.w", "ln.b", "ln.g", "out.b", "out.w"]
    _close(ff(torch.from_numpy(x)), jc._ff(p_ff, jnp.asarray(x), jnp.float32))


@pytest.mark.parametrize("t", [1, 6])
def test_sinusoids_match_jax(t):
    _close(tc.posenc(t, DIM), jc._posenc(t, DIM))
    _close(tc.rel_posemb(t, DIM), jc._rel_posemb(t, DIM))
    pos = np.random.RandomState(t).randint(0, 5000, (2, t)).astype(np.float32)
    _close(tc.sinusoids(torch.from_numpy(pos), DIM), jc._posenc_at(jnp.asarray(pos), DIM),
           atol=1e-4)  # sin/cos of angles up to 5000


def test_rope_matches_jax_and_pairs_interleaved_channels():
    x = np.random.RandomState(4).randn(2, 3, 9, 6).astype(np.float32)
    _close(tc.rope(torch.from_numpy(x)), jc._rope(jnp.asarray(x)))
    pos = np.random.RandomState(5).randint(0, 300, (2, 9)).astype(np.float32)
    _close(tc.rope_at(torch.from_numpy(x), torch.from_numpy(pos)),
           jc._rope_at(jnp.asarray(x), jnp.asarray(pos)), atol=1e-4)
    # channel pair (0, 1) rotates at frequency 1: position 1 turns (1, 0) by 1 rad
    e = torch.zeros(1, 1, 2, 6)
    e[..., 0] = 1.0
    r = tc.rope(e)[0, 0, 1]
    torch.testing.assert_close(r[:2], torch.tensor([np.cos(1.0), np.sin(1.0)],
                                                    dtype=torch.float32))


@pytest.mark.parametrize("t", [1, 2, 7])
def test_rel_shift_matches_a_gather_oracle_and_jax(t):
    x = np.random.RandomState(t).randn(2, 3, t, 2 * t - 1).astype(np.float32)
    got = tc.rel_shift(torch.from_numpy(x))
    i = np.arange(t)[:, None]
    j = np.arange(t)[None, :]
    oracle = x[..., i, t - 1 - i + j]  # out[..., i, j] = x[..., i, T-1-i+j]
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc._rel_shift(jnp.asarray(x))))


# ---- MHSA, conv module, MoE --------------------------------------------------------


@pytest.mark.parametrize("left_context", [-1, 3])
@pytest.mark.parametrize("pos", ["absolute", "rotary", "relative"])
def test_mhsa_matches_jax(pos, left_context):
    """Each scheme with full attention and a window of 3; the rows of length 1
    and 0 (every key masked: a uniform softmax over all T, as -1e30 gives)."""
    jspec, spec = _spec(pos_encoding=pos, left_context=left_context, num_heads=2)
    p = _perturb(jc._mhsa_init(jax.random.PRNGKey(6), jspec), 7)
    mhsa = _load(tc.MHSA(spec), p)
    assert ("pos.w" in mhsa.state_dict()) == (pos == "relative")
    x, _, mask = _inputs(8)
    got = mhsa(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, jc._mhsa(p, jnp.asarray(x), jnp.asarray(mask), jspec))
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("left_context", [-1, 4])
@pytest.mark.parametrize("k", [3, 4])
def test_conv_module_matches_jax(k, left_context):
    """SAME (odd and even kernels: the extra tap pads on the right) and causal."""
    jspec, spec = _spec(conv_kernel_size=k, left_context=left_context)
    p = _perturb(jc._conv_init(jax.random.PRNGKey(9), jspec), 10)
    conv = _load(tc.ConvModule(spec), p)
    assert conv.dw.shape == (k, 1, DIM)
    x, _, mask = _inputs(11)
    _close(conv(torch.from_numpy(x), torch.from_numpy(mask)),
           jc._conv_module(p, jnp.asarray(x), jnp.asarray(mask), jspec))
    _close(tc.depthwise_conv(torch.from_numpy(x), torch.from_numpy(p["dw"]), left_context >= 0),
           jc._depthwise_shifts(jnp.asarray(p["dw"]), jnp.asarray(x), left_context >= 0))


@pytest.mark.parametrize("router", ["random", "ties"])
@pytest.mark.parametrize("experts,top_k", [(4, 2), (3, 1), (2, 2)])
def test_moe_ff_matches_jax(experts, top_k, router):
    """Outputs and the aux loss. With a zero router every expert ties: the
    reference keeps every expert at or above the k-th probability, so all
    of them, and the argmax takes the first."""
    jspec, spec = _spec(moe_experts=experts, moe_top_k=top_k)
    p = _perturb(jc._moe_init(jax.random.PRNGKey(12), jspec), 13)
    if router == "ties":
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    moe = _load(tc.MoEFeedForward(spec), p)
    assert moe.state_dict()["in.w"].shape == (experts, DIM, 2 * DIM)
    assert "router.b" not in moe.state_dict()
    x, _, mask = _inputs(14)
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x), torch.from_numpy(mask))
    want, jaux = jc._moe_ff(p, jnp.asarray(x), jnp.asarray(mask), jspec)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(jaux), atol=ATOL, rtol=0)
    if router == "ties":
        # uniform gates over every expert, and every argmax at expert 0: aux = 1
        dense = sum(np.asarray(jc._ff({"ln": p["ln"], "in": {"w": p["in"]["w"][e],
                                                              "b": p["in"]["b"][e]},
                                       "out": {"w": p["out"]["w"][e], "b": p["out"]["b"][e]}},
                                      jnp.asarray(x), jnp.float32))
                    for e in range(experts)) / experts
        _close(got, dense)
        assert float(aux) == pytest.approx(1.0, abs=1e-6)


# ---- the stack -----------------------------------------------------------------------

STACKS = [
    dict(block="conformer"),
    dict(block="transformer"),
    dict(block="conformer", moe_experts=4),
    dict(block="transformer", moe_experts=3, moe_top_k=1, pos_encoding="relative"),
    dict(block="conformer", pos_encoding="rotary", left_context=3, conv_kernel_size=4),
    dict(block="conformer", pos_encoding="relative", left_context=0),
]


def _stack(seed, **kw):
    jspec, spec = _spec(**kw)
    p = _perturb(jc.init_conformer(jax.random.PRNGKey(seed), jspec, D_IN), seed + 1)
    return jspec, p, _load(tc.Conformer(spec, D_IN), p)


@pytest.mark.parametrize("kw", STACKS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_stack_matches_apply_conformer(kw):
    jspec, p, model = _stack(15, **kw)
    keys = set(model.state_dict())
    assert "proj.w" in keys and ("ln_out.g" in keys) == (kw["block"] == "transformer")
    x, lens, _ = _inputs(16, d=D_IN)
    want, jaux = jc.apply_conformer(p, jspec, jnp.asarray(x), jnp.asarray(lens), return_aux=True)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x), torch.from_numpy(lens))
    _close(got, want)
    assert not got[3].any() and not got[1, 5:].any()  # pad frames zeroed
    if jspec.moe_experts > 1:
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-7, rtol=1e-5)
    else:
        assert aux is None


@pytest.mark.parametrize("kw", [
    STACKS[0], STACKS[4],
    dict(block="transformer", moe_experts=3, moe_top_k=2, pos_encoding="relative"),
], ids=["conformer", "conformer-rotary-causal", "transformer-moe-relative"])
def test_stack_gradients_match_jax(kw):
    """d(sum(out * cot) + aux) / d(weights, inputs) against ``jax.grad``. The
    MoE case gates top-2 of 3: at top-1 a gate is p / p, whose gradient is
    cancellation and leaves the router only the aux term's."""
    jspec, p, model = _stack(17, **kw)
    x, lens, _ = _inputs(18, d=D_IN)
    cot = np.random.RandomState(19).randn(len(LENGTHS), T, DIM).astype(np.float32)

    def jloss(p, x):
        out, aux = jc.apply_conformer(p, jspec, x, jnp.asarray(lens), return_aux=True)
        return jnp.sum(out * cot) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    want = params_from_jax(jax.tree.map(np.asarray, jgp), model)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = model(xt, torch.from_numpy(lens))
    loss = (out * torch.from_numpy(cot)).sum() + (aux if aux is not None else 0.0)
    names = list(dict(model.named_parameters()))
    grads = torch.autograd.grad(loss, [xt] + list(model.parameters()))
    for name, g, w in zip(["inputs"] + names, grads, [np.asarray(jgx)] +
                          [want[n].numpy() for n in names]):
        if name.endswith("mhsa.k.b") and jspec.pos_encoding != "rotary":
            assert max(float(g.abs().max()), float(np.abs(w).max())) < CANCELLED, name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * scale, rtol=0, err_msg=name)


def test_dropout_draws_from_the_generator():
    """Four sites per layer, drawn from the generator: the same seed gives the
    same output, another seed another; without a generator (or train) none."""
    _, _, model = _stack(20)
    x, lens, _ = _inputs(21, d=D_IN)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    with torch.no_grad():
        plain = model(xt, lt)[0]
        outs = [model(xt, lt, True, torch.Generator().manual_seed(s), keep_prob=0.5)[0]
                for s in (1, 1, 2)]
        assert torch.equal(model(xt, lt, True, None, keep_prob=0.5)[0], plain)
        assert torch.equal(model(xt, lt, False, torch.Generator(), keep_prob=0.5)[0], plain)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert not torch.equal(outs[0], plain)


# ---- encoder config, encoder and CTC model -------------------------------------------


@pytest.mark.parametrize("encoder_type", ["conformer", "transformer"])
def test_encoder_and_ctc_model_match_jax(encoder_type):
    kw = dict(encoder_type=encoder_type, num_units=DIM, num_layers=2, num_heads=2,
              conv_kernel_size=4, ff_expansion=2, moe_experts=2, moe_top_k=1,
              moe_aux_weight=0.5, pos_encoding="rotary", left_context=5)
    jcfg, cfg = jencoders.EncoderConfig(**kw), EncoderConfig(**kw)
    assert cfg.output_dim == jcfg.output_dim == DIM
    assert cfg.conformer_spec()._asdict() == jcfg.conformer_spec()._asdict()
    jmodel_cfg = jctc.CTCConfig(encoder=jcfg, num_classes=5)
    p = _perturb(jctc.init_ctc(jax.random.PRNGKey(22), jmodel_cfg, D_IN), 23)
    model = _load(CTCModel(CTCConfig(encoder=cfg, num_classes=5), D_IN), p)
    assert "encoder.conformer.layers.1.moe.router.w" in model.state_dict()
    x, lens, _ = _inputs(24, d=D_IN)
    want = jctc.apply_ctc(p, jmodel_cfg, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(lens))
        enc = model.encoder(torch.from_numpy(x), torch.from_numpy(lens))
    _close(out.logits, want.logits)
    np.testing.assert_array_equal(out.logit_len.numpy(), np.asarray(want.logit_len))
    np.testing.assert_allclose(float(out.aux_loss), float(want.aux_loss), atol=1e-7, rtol=1e-5)
    assert torch.equal(enc.aux_loss, out.aux_loss) and enc.outputs.shape == (4, T, DIM)


def test_invalid_and_unported_specs_raise():
    with pytest.raises(ValueError, match="divisible"):
        Encoder(EncoderConfig(encoder_type="conformer", num_units=10, num_heads=4), D_IN)
    with pytest.raises(ValueError, match="even head dim"):
        Encoder(EncoderConfig(encoder_type="conformer", num_units=12, num_heads=4,
                              pos_encoding="rotary"), D_IN)
    with pytest.raises(ValueError, match="pos_encoding"):
        Encoder(EncoderConfig(encoder_type="transformer", num_units=8, pos_encoding="alibi"), 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):  # no such mode
        Encoder(EncoderConfig(encoder_type="conformer", num_units=8, num_heads=2,
                              compute_dtype="float16"), D_IN)
    # bf16 (test_torch_bf16_models.py) builds, and its outputs stay float32
    bf = Encoder(EncoderConfig(encoder_type="conformer", num_units=8, num_heads=2,
                               conv_kernel_size=3, compute_dtype="bfloat16"), D_IN)
    x, lens, _ = _inputs(25, d=D_IN)
    with torch.no_grad():
        out = bf(torch.from_numpy(x), torch.from_numpy(lens)).outputs
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    # "shifts" computes the same function as the grouped conv: one implementation
    a = Encoder(EncoderConfig(encoder_type="conformer", num_units=8, num_heads=2,
                              conv_kernel_size=3), D_IN, torch.Generator().manual_seed(0))
    b = Encoder(EncoderConfig(encoder_type="conformer", num_units=8, num_heads=2,
                              conv_kernel_size=3, depthwise_impl="shifts"), D_IN)
    b.load_state_dict(a.state_dict())
    x, lens, _ = _inputs(25, d=D_IN)
    with torch.no_grad():
        assert torch.equal(a(torch.from_numpy(x), torch.from_numpy(lens)).outputs,
                           b(torch.from_numpy(x), torch.from_numpy(lens)).outputs)
