"""Conformer training, SpecAugment and the six conformer / transformer configs
in the port, against the JAX package, on the CPU.

Both sides start from the same JAX-initialised weights (bridged) and take the
same seeded numpy batch of waveforms: frontend, 3/3 stacking, a 2-layer
conformer of width 16 (2 heads, kernel 3), then the CTC head, the transducer
joint or the attention decoder. Dropout stays at keep 1.0 (jax.random cannot
be replayed in torch), so a step's only draws are SpecAugment's, which the
tests feed from the JAX draws where they compare. Tolerances, float32, as
``tests/test_torch_train_step.py``:

- losses and each term (the MoE term included): atol 1e-4, rtol 1e-5;
- gradients, and SGD's weights after the step: atol 2e-5, rtol 1e-4;
- Adam's weights: atol 0.1 · lr per step, its moments 1e-3 of each tensor's
  largest entry. The key bias's gradient is zero in exact arithmetic under
  absolute positions (the softmax ignores a bias added to every key), so
  Adam's first update, about lr · sign(g), follows each side's rounding:
  there both updates stay within lr and the moments within 1e-6 of 0;
- the SpecAugment mask from the JAX draws of a key: exact.
"""

import dataclasses
import http.client
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.frontend import augment as jaugment
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.seq2seq import (
    Seq2SeqConfig as JSeq2SeqConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu.train.loop import _specaug
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin.serve import make_server
from tensorflow_end2end_speech_recognition_tpu_torch.frontend import augment
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import Seq2SeqConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.ops.ctc import ctc_loss
from tensorflow_end2end_speech_recognition_tpu_torch.ops.losses import batch_mean, l2_weight_decay
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    params_from_jax,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NUM = 4000  # samples: 24 frames -> T' = 8 after 3/3 stacking
C = 5
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
ENC = dict(encoder_type="conformer", num_units=16, num_layers=2, num_heads=2,
           conv_kernel_size=3, ff_expansion=2)
MOE = dict(moe_experts=3, moe_top_k=2, moe_aux_weight=0.5)
FRONTEND = dict(use_energy=False)
CONFIGS = ["ls960_conformer_ctc", "ls960_transformer_ctc", "ls960_moe_conformer",
           "ls_conformer_transducer", "ls_streaming_conformer", "ls960_conformer_ctc_sa"]


def _bridge(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model)


def _copy(tree):  # the jitted JAX steps donate their inputs
    return jax.tree.map(jnp.array, tree)


def _batch(seed, label_width=3):
    """4 waveforms, ragged; the last row a filler (weight 0)."""
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, NUM) * 0.1).astype(np.float32)
    input_len = np.asarray([NUM, 3000, 1700, NUM], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    label_len = np.asarray([3, 1, 2, 0][:4], np.int32).clip(max=label_width)
    labels = np.full((4, label_width), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, C, n)
    return {"inputs": wav, "input_len": input_len, "labels": labels, "label_len": label_len,
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _check_terms(aux, jaux):
    assert set(aux) - {"nonfinite"} == set(jaux) - {"nonfinite"}
    for k in set(aux) - {"nonfinite"}:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), err_msg=k, **LOSS_TOL)


def _check_grads(jgrads, grads, model):
    want = _bridge(jgrads, model)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


def _grads(forward_loss, params, task, batch, **kw):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, aux = forward_loss(leaves, task, _tb(batch), True, **kw)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return {k: v.detach() for k, v in aux.items()}, grads


# ---- CTC: a MoE conformer, its loss terms, gradients and an Adam step ----------------


def _ctc_tasks():
    enc = dict(ENC, **MOE)
    common = dict(num_stack=3, num_skip=3, weight_decay=1e-2)
    jtask = jctc.CTCTaskConfig(model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=C),
                               frontend=JFrontendConfig(**FRONTEND), **common)
    task = ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                  frontend=FrontendConfig(**FRONTEND), **common)
    return jtask, task


@pytest.fixture(scope="module")
def ctc_setup():
    jtask, task = _ctc_tasks()
    jparams = jctc.init_params(jax.random.PRNGKey(0), jtask)
    model = ctc_task.init_model(task)
    return dict(jtask=jtask, task=task, jparams=jparams, params=_bridge(jparams, model),
                model=model)


def test_ctc_moe_loss_terms_and_gradients_match_jax(ctc_setup):
    """The MoE term joins the loss in training (after the CTC mean, before
    weight decay) and stays out of the eval loss, as in the JAX task."""
    jtask, task = ctc_setup["jtask"], ctc_setup["task"]
    batch = _batch(1)
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jctc.forward_loss(p, jtask, b, train=True), has_aux=True))(
        ctc_setup["jparams"], _jb(batch))
    aux, grads = _grads(ctc_task.forward_loss, ctc_setup["params"], task, batch)
    assert set(aux) == {"ctc_nll", "moe_aux", "loss"}
    _check_terms(aux, jaux)
    assert float(aux["loss"]) > float(aux["ctc_nll"]) + float(aux["moe_aux"])  # + the L2 term
    _check_grads(jgrads, grads, ctc_setup["model"])
    assert float(grads["encoder.conformer.layers.0.moe.router.w"].abs().sum()) > 0
    with torch.no_grad():
        _, eval_aux = ctc_task.forward_loss(ctc_setup["params"], task, _tb(batch), False)
    assert "moe_aux" not in eval_aux


def test_ctc_moe_adam_step_matches_jax(ctc_setup):
    lr = 1e-3
    jtask, task, model = ctc_setup["jtask"], ctc_setup["task"], ctc_setup["model"]
    params, jparams = ctc_setup["params"], ctc_setup["jparams"]
    opt, jopt = build_optimizer("adam", 5.0), jbuild_optimizer("adam", 5.0)
    batch = _batch(2)
    jnew, jstate, jaux = jctc.make_train_step(jtask, jopt)(
        _copy(jparams), jopt.init(_copy(jparams)), _jb(batch), lr, jax.random.PRNGKey(1))
    new, state, aux = ctc_task.make_train_step(task, opt)(params, opt.init(params), _tb(batch),
                                                           lr, torch.Generator().manual_seed(0))
    assert not bool(aux["nonfinite"]) and not bool(jaux["nonfinite"])
    _check_terms(aux, jaux)
    want = _bridge(jnew, model)
    jadam = adam_state_from_jax(jax.tree.map(np.asarray, jstate), model)
    for k, v in new.items():
        if k.endswith("mhsa.k.b"):  # cancellation: see the module docstring
            for step in (v - params[k], want[k] - params[k]):
                assert float(step.abs().max()) <= 1.001 * lr, k
            for m in ("mu", "nu"):
                assert max(float(state[m][k].abs().max()),
                           float(jadam[m][k].abs().max())) < 1e-6, k
            continue
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=0.1 * lr, rtol=0, err_msg=k)
    for m in ("mu", "nu"):
        for k, v in state[m].items():
            if k.endswith("mhsa.k.b"):
                continue
            w = jadam[m][k].numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-3, err_msg=f"{m}.{k}",
                                       atol=1e-3 * float(np.abs(w).max()) + 1e-12)


def test_ctc_eval_and_beam_eval_steps_run_the_conformer(ctc_setup):
    jtask, task = ctc_setup["jtask"], ctc_setup["task"]
    batch = _batch(3)
    want = [np.asarray(x) for x in jctc.make_eval_step(jtask)(ctc_setup["jparams"], _jb(batch))]
    got = ctc_task.make_eval_step(task)(ctc_setup["params"], _tb(batch))
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[2].numpy(), want[2], **LOSS_TOL)
    ids, lens, nll = ctc_task.make_beam_eval_step(task, 4)(ctc_setup["params"], _tb(batch))
    assert ids.shape == got[0].shape and torch.equal(nll, got[2])


# ---- transducer: a chunk-causal rotary MoE conformer, one SGD step ---------------------


def test_transducer_conformer_sgd_step_matches_jax():
    enc = dict(ENC, pos_encoding="rotary", left_context=2, **MOE)
    model_kw = dict(num_classes=C, pred_num_units=8, embedding_dim=4, joint_dim=12)
    fe = dict(num_mels=40, use_energy=False, add_deltas=False, cmvn="none")
    common = dict(num_stack=3, num_skip=3, weight_decay=1e-2)
    jtask = jtt.TransducerTaskConfig(
        model=jtransducer.TransducerConfig(encoder=JEncoderConfig(**enc), **model_kw),
        frontend=JFrontendConfig(**fe), **common)
    task = tt.TransducerTaskConfig(model=TransducerConfig(encoder=EncoderConfig(**enc),
                                                          **model_kw),
                                   frontend=FrontendConfig(**fe), **common)
    jparams = jtt.init_params(jax.random.PRNGKey(4), jtask)
    model = tt.init_model(task)
    params = _bridge(jparams, model)
    batch = _batch(5)
    jopt, opt = jbuild_optimizer("sgd", 5.0), build_optimizer("sgd", 5.0)
    jnew, _, jaux = jtt.make_train_step(jtask, jopt)(
        _copy(jparams), jopt.init(jparams), _jb(batch), 0.1, jax.random.PRNGKey(1))
    new, _, aux = tt.make_train_step(task, opt)(params, opt.init(params), _tb(batch), 0.1)
    assert "moe_aux" in aux and not bool(aux["nonfinite"])
    _check_terms(aux, jaux)
    want = _bridge(jnew, model)
    for k, v in new.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)
        assert not torch.equal(v, params[k]), k
    want_eval = [np.asarray(x) for x in jtt.make_eval_step(jtask)(jnew, _jb(batch))]
    decoded, dec_len, nll = tt.make_eval_step(task)(new, _tb(batch))
    np.testing.assert_array_equal(dec_len.numpy(), want_eval[1])
    np.testing.assert_array_equal(decoded.numpy(), want_eval[0])
    np.testing.assert_allclose(nll.numpy(), want_eval[2], **LOSS_TOL)


# ---- joint CTC-attention on a conformer encoder ---------------------------------------


def test_joint_ctc_attention_conformer_matches_jax():
    """No config sets it, but the JAX package runs it: the encoder's MoE term
    after the joint mix, then weight decay; the greedy eval step's ids."""
    enc = dict(ENC, encoder_type="transformer", pos_encoding="relative", **MOE)
    att = dict(attention_type="hybrid", attention_dim=8, conv_num_channels=4, conv_width=5)
    common = dict(num_classes=C, decoder_num_units=16, embedding_dim=8, max_decode_length=10,
                  ctc_loss_weight=0.3)
    task_kw = dict(num_stack=3, num_skip=3, weight_decay=1e-2, label_smoothing=0.05)
    jtask = jatt.AttTaskConfig(
        model=JSeq2SeqConfig(encoder=JEncoderConfig(**enc), attention=JAttentionConfig(**att),
                             **common),
        frontend=JFrontendConfig(**FRONTEND), **task_kw)
    task = att_task.AttTaskConfig(
        model=Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att),
                            **common),
        frontend=FrontendConfig(**FRONTEND), **task_kw)
    jparams = jatt.init_params(jax.random.PRNGKey(6), jtask)
    model = att_task.init_model(task)
    params = _bridge(jparams, model)
    batch = _batch(7)
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jatt.forward_loss(p, jtask, b, True, jax.random.PRNGKey(1), 0),
        has_aux=True))(jparams, _jb(batch))
    aux, grads = _grads(att_task.forward_loss, params, task, batch, step=0)
    assert set(aux) == {"att_nll", "ctc_nll", "moe_aux", "loss"}
    _check_terms(aux, jaux)
    _check_grads(jgrads, grads, model)
    want = jatt.make_eval_step(jtask)(jparams, _jb(batch))
    got = att_task.make_eval_step(task)(params, _tb(batch))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **LOSS_TOL)


# ---- SpecAugment ---------------------------------------------------------------------


def _jax_draws(key, feat_len, d, cfg):
    """``spec_augment``'s draws for ``key``, recomputed from ``frontend/augment.py``."""
    b = feat_len.shape[0]
    keys = jax.random.split(key, cfg.num_freq_masks + cfg.num_time_masks)
    fw, fs, tw, ts = [], [], [], []
    for i in range(cfg.num_freq_masks):
        k0, k1 = jax.random.split(keys[i])
        fw.append(jax.random.randint(k0, (b, 1, 1), 0, cfg.freq_mask_width + 1))
        fs.append(jax.random.randint(k1, (b, 1, 1), 0, max(d - cfg.freq_mask_width, 0) + 1))
    for i in range(cfg.num_time_masks):
        k0, k1 = jax.random.split(keys[cfg.num_freq_masks + i])
        max_w = jnp.maximum((feat_len.astype(jnp.float32) * cfg.time_mask_frac)
                            .astype(jnp.int32), 1)[:, None, None]
        width = jnp.floor(jax.random.uniform(k0, (b, 1, 1))
                          * (max_w + 1).astype(jnp.float32)).astype(jnp.int32)
        lo = jnp.maximum(feat_len[:, None, None] - width + 1, 1).astype(jnp.float32)
        tw.append(width)
        ts.append(jnp.floor(jax.random.uniform(k1, (b, 1, 1)) * lo).astype(jnp.int32))

    def stack(xs):
        return torch.from_numpy(np.stack([np.asarray(x).reshape(b) for x in xs]).astype(np.int64))

    return augment.MaskDraws(stack(fw), stack(fs), stack(tw), stack(ts))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", [jaugment.SpecAugmentConfig(),
                                 jaugment.SpecAugmentConfig(freq_mask_width=30, num_freq_masks=1,
                                                            time_mask_frac=0.3,
                                                            num_time_masks=3)])
def test_spec_augment_mask_matches_jax_draws(cfg, seed):
    """The mask builder on the draws ``jax.random`` makes for a key equals
    ``spec_augment``'s output bit for bit (a width-24 axis: D - F reaches 0
    for the wide band)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(5, 40, 24).astype(np.float32)
    feat_len = np.asarray([40, 23, 7, 1, 0], np.int32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaugment.spec_augment(key, jnp.asarray(feats), jnp.asarray(feat_len), cfg))
    draws = _jax_draws(key, jnp.asarray(feat_len), 24, cfg)
    keep = augment.keep_mask(draws, 40, 24)
    np.testing.assert_array_equal((torch.from_numpy(feats) * keep).numpy(), want)
    assert (want == 0).any()


def test_spec_augment_draws_keep_the_reference_bounds():
    cfg = augment.SpecAugmentConfig(freq_mask_width=5, num_freq_masks=2, time_mask_frac=0.2,
                                    num_time_masks=2)
    feat_len = torch.tensor([50, 11, 3, 1, 0] * 200)
    draws = augment.draw_masks(feat_len, 12, cfg, torch.Generator().manual_seed(0))
    assert draws.freq_width.shape == (2, 1000) and draws.time_start.shape == (2, 1000)
    assert draws.freq_width.min() == 0 and draws.freq_width.max() == 5
    assert draws.freq_start.min() == 0 and draws.freq_start.max() == 12 - 5  # inclusive
    max_w = (feat_len.float() * 0.2).int().clamp_min(1)
    assert bool((draws.time_width <= max_w).all()) and bool((draws.time_width == max_w).any())
    # a span lies on valid frames (a row of length 0 may still draw width 1 at 0)
    end = draws.time_start + draws.time_width
    assert bool((end <= torch.maximum(feat_len, draws.time_width)).all())
    assert bool((draws.time_start[:, feat_len == 0] == 0).all())
    again = augment.draw_masks(feat_len, 12, cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(draws, again))


def test_spec_augment_in_the_train_step(ctc_setup):
    """Training with a generator masks the stacked features with its draws;
    without a generator, or in eval, nothing is masked."""
    task = ctc_setup["task"]._replace(spec_augment=augment.SpecAugmentConfig())
    params, batch = ctc_setup["params"], _tb(_batch(8))
    with torch.no_grad():
        plain = ctc_task.forward_loss(params, ctc_setup["task"], batch, True)[0]
        aug = [ctc_task.forward_loss(params, task, batch, True, torch.Generator().manual_seed(s))[0]
               for s in (1, 1, 2)]
        assert torch.equal(ctc_task.forward_loss(params, task, batch, True)[0], plain)
        assert torch.equal(ctc_task.forward_loss(params, task, batch, False,
                                                 torch.Generator().manual_seed(1))[0],
                           ctc_task.forward_loss(params, ctc_setup["task"], batch, False)[0])
        feats, feat_len = ctc_task.device_pipeline(task, batch)
        masked = augment.spec_augment(feats, feat_len, torch.Generator().manual_seed(1),
                                      task.spec_augment)
        out = ctc_task.apply_model(params, task, masked, feat_len, True)
    assert torch.equal(aug[0], aug[1]) and not torch.equal(aug[0], aug[2])
    assert not torch.equal(aug[0], plain)
    # the step's loss is the same arithmetic on the features masked by hand
    nll = ctc_loss(out.logits, out.logit_len, batch["labels"], batch["label_len"],
                   blank_id=task.model.blank_id)
    manual = (batch_mean(nll, batch["weight"]) + out.aux_loss
              + l2_weight_decay(params, task.weight_decay))
    torch.testing.assert_close(aug[0], manual, rtol=0, atol=0)


# ---- the six configs: load, bin/train with a resume, bin/serve -----------------------


def _raw(name):
    import yaml

    return yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_load_and_match_jax(name):
    raw = _raw(name)
    exp, jexp = experiment_from_dict(raw), JExperimentConfig.from_dict(raw)
    for f in dataclasses.fields(exp):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    exp.check_trainable()
    enc, jenc = exp.encoder_config(), jexp.encoder_config()
    assert enc.conformer_spec()._asdict() == jenc.conformer_spec()._asdict()
    assert enc.output_dim == jenc.output_dim == 144
    task = exp.task(28)
    jspec = _specaug(jexp)
    assert (task.spec_augment is None) == (jspec is None) == (name != "ls960_conformer_ctc_sa")
    if jspec is not None:
        assert task.spec_augment._asdict() == jspec._asdict()
    model = (tt if exp.model_type == "transducer" else ctc_task).init_model(task)
    n_params = sum(v.numel() for v in model.state_dict().values())
    assert n_params > 1e6 and "encoder.conformer.proj.w" in model.state_dict()


def test_chip_smoke_builds_the_six_configs_as_their_files():
    """``chip_smoke.py`` builds each config from a dict (the card machine may
    have no yaml): each dict is its file."""
    import chip_smoke

    for name in CONFIGS:
        raw = getattr(chip_smoke, name.upper())
        assert experiment_from_dict(raw) == experiment_from_dict(_raw(name)), name
    wide = experiment_from_dict(chip_smoke.CONFORMER_WIDE)
    assert (wide.num_units, wide.num_layers, wide.num_heads) == (512, 8, 8)


def _tiny(name, **kw):
    raw = dict(_raw(name), num_units=8, num_layers=2, num_heads=2, conv_kernel_size=3,
               ff_expansion=2, toy_num_utts=16, batch_size=8, num_epoch=2, warmup_steps=2)
    if raw["model_type"] == "transducer":
        raw.update(pred_num_units=8, embedding_dim=4, joint_dim=8)
    raw.update(kw)
    return raw


@pytest.mark.parametrize("name", CONFIGS)
def test_bin_train_tiny_configs_end_to_end_and_resume(name, tmp_path):
    """A tiny copy of each config (width 8, 2 layers, 16 utterances), one
    epoch, then a resumed second; then bin/eval and bin/decode on it."""
    cfg = tmp_path / f"tiny_{name}.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in _tiny(name).items()))
    model_dir = tmp_path / "m"
    first = train_cli.main([str(cfg), str(model_dir), "--device", "cpu", "--epochs", "1"])
    assert first["epochs"] == 1 and CheckpointManager(model_dir / "checkpoints").latest_epoch == 0
    summary = train_cli.main([str(cfg), str(model_dir), "--device", "cpu"])
    log = (model_dir / "train.log").read_text()
    assert "resuming from checkpoint epoch 0" in log
    assert summary["epochs"] == 2 and summary["steps"] == 2 * first["steps"]
    assert summary["nonfinite_steps"] == 0 and np.isfinite(summary["train_loss"])
    assert np.isfinite(summary["dev_loss"]) and summary["dev_error_rate"] >= 0
    # bin/eval at the config's beam (CTC: the prefix beam at 20 or greedy; the
    # transducer: greedy) and bin/decode on the model dir bin/train wrote
    res = eval_cli.main([str(model_dir), "--device", "cpu"])
    assert all(np.isfinite(res[s]["loss"]) and res[s]["num_utts"] > 0 for s in ("dev", "test"))
    lines = decode_cli.main([str(model_dir), "--device", "cpu"])
    hyps = sum(s.startswith("  HYP") for s in lines)
    assert hyps == sum(s.startswith("[") for s in lines) >= 1  # one per test utterance


def test_fit_logs_the_moe_term(tmp_path):
    """Each logged step of a MoE model prints and records its load-balance term."""
    lines = []
    summary = fit(experiment_from_dict(_tiny("ls960_moe_conformer", num_epoch=1)), tmp_path,
                  log_every=1, print_fn=lines.append, device="cpu")
    steps = [s for s in lines if " step " in s]
    assert len(steps) == summary["steps"] == 2
    assert all(0.0 < float(s.split(" moe_aux ")[1]) < 1.0 for s in steps)  # weight 1e-2
    events = list((tmp_path / "events").iterdir())
    assert events and b"train/moe_aux" in events[0].read_bytes()


def test_make_server_answers_with_a_conformer_ctc_model():
    exp = experiment_from_dict(_tiny("ls960_conformer_ctc"))
    task = exp.ctc_task(28)
    model = ctc_task.init_model(task, torch.Generator().manual_seed(0)).eval()
    units = [chr(ord("a") + i) for i in range(26)] + ["_", "'"]
    server = make_server(task, model, 2, NUM, port=0, max_wait_ms=5.0, units=units,
                         label_type="character")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        wav = (np.random.RandomState(9).randn(3000) * 0.3).astype(np.float32)
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("POST", "/recognize", wav.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    want_ids, want_len = build_inference_fn(task, model)(
        np.tile(np.pad(wav, (0, NUM - 3000)), (2, 1)), np.full((2,), 3000, np.int32))
    assert r["num_ids"] == int(want_len[0])
    assert r["ids"] == want_ids[0, : int(want_len[0])].tolist()
