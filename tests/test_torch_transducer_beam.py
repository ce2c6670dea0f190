"""The port's RNN-T beam search against the JAX package, on the CPU.

``decoding/transducer_beam.transducer_beam_search`` on bridged weights and
the same encoder activations must give JAX's hypotheses (tokens and lengths
equal, scores within 1e-4), with and without RNN-LM shallow fusion; its top
score is at least the greedy path's (JAX's own check); and the three
entry points that now take the beam (``serving.build_inference_fn``, the
transducer task's beam eval step, and ``bin/decode`` / ``bin/eval`` at
``--beam-width`` above 1, with and without ``--lm-dir``) must run it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.decoding import transducer_beam as jbeam
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import lm as jlm
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train_lm
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import transducer_beam as beam
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_greedy import (
    transducer_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models import lm
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

SCORE_TOL = dict(rtol=1e-4, atol=1e-4)  # float32 joint and log-softmax, other sum orders
C = 5
MODEL = dict(num_classes=C, pred_num_units=8, embedding_dim=4, joint_dim=8,
             max_symbols_per_frame=3, parameter_init=0.5)
ENC = dict(encoder_type="lstm", num_units=8, num_layers=1, parameter_init=0.5)
FRONTEND = dict(use_energy=False, add_deltas=False, cmvn="none")


def _tasks(**model_kw):
    model = dict(MODEL, **model_kw)
    jtask = jtt.TransducerTaskConfig(
        model=jtransducer.TransducerConfig(encoder=JEncoderConfig(**ENC), **model),
        frontend=JFrontendConfig(**FRONTEND), num_stack=3, num_skip=3)
    task = tt.TransducerTaskConfig(
        model=TransducerConfig(encoder=EncoderConfig(**ENC), **model),
        frontend=FrontendConfig(**FRONTEND), num_stack=3, num_skip=3)
    return jtask, task


def _bridged(seed, **model_kw):
    jtask, task = _tasks(**model_kw)
    params = jtt.init_params(jax.random.PRNGKey(seed), jtask)
    model = tt.init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return jtask, task, params, model.eval()


def _lms(seed=7):
    cfg = jlm.LMConfig(vocab=C + 2, num_units=8, embedding_dim=4)
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), cfg)
    model = lm.RNNLM(lm.LMConfig(vocab=C + 2, num_units=8, embedding_dim=4))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return (jparams, cfg), model.eval()


def _jfusion(jlm_pair, jtask):
    return jlm.make_fusion_lm(jlm_pair[0], jlm_pair[1], sos_id=jlm_pair[1].vocab - 2,
                              num_ctc_classes=jtask.model.vocab_with_blank)


def _f_proj(seed, b=3, t=7):
    rng = np.random.RandomState(seed)
    f = rng.randn(b, t, MODEL["joint_dim"]).astype(np.float32) * 1.5
    return f, np.asarray([t, t - 2, 2][:b], np.int32)


def _assert_same_beams(got, want):
    tok, ln, sc = (x.numpy() for x in got)
    wtok, wln, wsc = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ln, wln)
    np.testing.assert_array_equal(tok, wtok)
    np.testing.assert_allclose(sc, wsc, **SCORE_TOL)


@pytest.mark.parametrize("width", [2, 4])
def test_beam_search_matches_jax(width):
    jtask, _, params, model = _bridged(seed=1)
    f, n = _f_proj(2)
    want = jbeam.transducer_beam_search(params, jtask.model, jnp.asarray(f), jnp.asarray(n),
                                        beam_width=width)
    with torch.no_grad():
        got = beam.transducer_beam_search(model, torch.from_numpy(f), torch.from_numpy(n),
                                          beam_width=width)
    _assert_same_beams(got, want)
    # every frame pays one blank, so on random weights the best path is the
    # empty one; the hypotheses behind it emit labels
    assert got.lengths.sum() > 0
    assert got.tokens.dtype == torch.int32 and got.lengths.dtype == torch.int32


@pytest.mark.parametrize("lm_weight", [0.5, -2.0])
def test_beam_search_with_lm_fusion_matches_jax(lm_weight):
    jtask, task, params, model = _bridged(seed=3)
    jlm_pair, port_lm = _lms()
    f, n = _f_proj(4)
    want = jbeam.transducer_beam_search(params, jtask.model, jnp.asarray(f), jnp.asarray(n),
                                        beam_width=4, fusion_lm=_jfusion(jlm_pair, jtask),
                                        lm_weight=lm_weight)
    fusion = lm.make_fusion_lm(port_lm, task.model.vocab_with_blank)
    with torch.no_grad():
        got = beam.transducer_beam_search(model, torch.from_numpy(f), torch.from_numpy(n),
                                          beam_width=4, fusion_lm=fusion, lm_weight=lm_weight)
        plain = beam.transducer_beam_search(model, torch.from_numpy(f), torch.from_numpy(n),
                                            beam_width=4)
    _assert_same_beams(got, want)
    assert not torch.allclose(got.scores, plain.scores)  # the LM took part


def test_beam_split_over_calls_equals_one_call():
    """beam_advance chunk by chunk (as a stream drives it) gives the one-call
    beam; rows past their count keep the beam bit for bit."""
    _, _, _, model = _bridged(seed=5)
    f, n = _f_proj(6, t=8)
    f, n = torch.from_numpy(f), torch.from_numpy(n)
    with torch.no_grad():
        want = beam.transducer_beam_search(model, f, n, beam_width=3, max_len=24)
        state = beam.beam_init(model, 3, 3, 24)
        for lo in (0, 3, 6):
            chunk_n = (n - lo).clamp(0, 3)
            before = {k: v for k, v in state.items() if k != "states"}
            state = beam.beam_advance(model, state, f[:, lo: lo + 3], chunk_n)
            for row in torch.nonzero(chunk_n == 0).flatten():
                for k, v in before.items():
                    assert torch.equal(state[k][row], v[row]), k
        got = beam.beam_finalize(state)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_beam_top_score_at_least_greedy_path():
    """JAX's check: the top hypothesis's path score is at least the greedy
    path's, replayed with the same per-frame scoring."""
    _, task, _, model = _bridged(seed=8)
    cfg = task.model
    f, n = _f_proj(9, t=6)
    f, n = torch.from_numpy(f), torch.from_numpy(n)
    with torch.no_grad():
        res = beam.transducer_beam_search(model, f, n, beam_width=8)
        assert (res.scores[:, 1:] <= res.scores[:, :-1] + 1e-6).all()  # best first
        dec, dec_len = transducer_greedy_decode(model, f, n)
        from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_greedy import (
            decode_frame,
            decoder_init,
        )

        for i in range(3):
            carry, score = decoder_init(model, 1), 0.0
            g, states = carry
            for t in range(int(n[i])):
                _, em = decode_frame(model, (g, states), f[i, t][None], torch.tensor([True]))
                for k in [int(x) for x in em[0] if x >= 0]:
                    score += float(torch.log_softmax(model.joint_logits(f[i, t][None], g),
                                                     -1)[0, k])
                    g, states = model.predict(torch.tensor([[k]]), initial_states=states)
                    g = g[:, 0]
                score += float(torch.log_softmax(model.joint_logits(f[i, t][None], g),
                                                 -1)[0, cfg.blank_id])
            assert float(res.scores[i, 0]) >= score - 1e-5, (i, float(res.scores[i, 0]), score)
            assert int(res.lengths[i, 0]) <= int(n[i]) * cfg.max_symbols_per_frame
        assert dec_len.sum() > 0


def _wave_batch(seed, b=3, num=4000):
    rng = np.random.RandomState(seed)
    waves = (rng.randn(b, num) * 0.3).astype(np.float32)
    return waves, np.asarray([num, 2500, 0][:b], np.int32)


@pytest.mark.parametrize("with_lm", [False, True])
def test_inference_fn_beam_matches_jax_serving(with_lm):
    jtask, task, params, model = _bridged(seed=11)
    jlm_pair, port_lm = _lms(seed=12)
    waves, lens = _wave_batch(13)
    kw = dict(lm=jlm_pair, lm_weight=0.5) if with_lm else {}
    jinfer = jserving.build_inference_fn(jtask, jtt, params, beam_width=4, **kw)
    want_ids, want_len = (np.asarray(x) for x in jinfer(jnp.asarray(waves), jnp.asarray(lens)))
    kw = dict(lm=port_lm, lm_weight=0.5) if with_lm else {}
    ids, n = build_inference_fn(task, model, beam_width=4, **kw)(waves, lens)
    np.testing.assert_array_equal(n.numpy(), want_len)
    np.testing.assert_array_equal(ids.numpy(), want_ids)


def test_beam_eval_step_matches_jax():
    jtask, task, params, model = _bridged(seed=14)
    jlm_pair, port_lm = _lms(seed=15)
    waves, lens = _wave_batch(16)
    rng = np.random.RandomState(17)
    labels = rng.randint(0, C, (3, 4)).astype(np.int32)
    label_len = np.asarray([4, 3, 1], np.int32)
    batch = dict(inputs=waves, input_len=lens, labels=labels, label_len=label_len)
    jstep = jtt.make_beam_eval_step(jtask, 3, lm=jlm_pair, lm_weight=0.5)
    want = [np.asarray(x) for x in jstep(params, {k: jnp.asarray(v) for k, v in batch.items()})]
    step = tt.make_beam_eval_step(task, 3, lm=port_lm, lm_weight=0.5)
    got = [x.numpy() for x in step(dict(model.state_dict()),
                                   {k: torch.from_numpy(v) for k, v in batch.items()})]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)  # the teacher-forced nll


def test_decode_and_eval_clis_run_the_beam(tmp_path, capsys):
    cfg = tmp_path / "rnnt.yml"
    cfg.write_text("model_type: transducer\nlabel_type: character\ninput_size: 40\n"
                   "use_energy: false\nuse_delta: false\ncmvn: none\nnum_stack: 3\n"
                   "num_skip: 3\nencoder_type: lstm\nnum_units: 8\nnum_layers: 1\n"
                   "pred_num_units: 8\nembedding_dim: 4\njoint_dim: 8\nbatch_size: 4\n"
                   "num_epoch: 1\ntoy_num_utts: 16\ntoy_max_units: 4\nbeam_width: 3\n")
    train_cli.main([str(cfg), str(tmp_path / "m"), "--device", "cpu"])
    train_lm.main([str(cfg), str(tmp_path / "lm"), "--epochs", "1", "--num-units", "8",
                   "--embedding-dim", "4", "--batch-size", "8", "--device", "cpu"])
    capsys.readouterr()
    res = eval_cli.main([str(tmp_path / "m"), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[0] == "decoding with beam width 3"
    assert np.isfinite(res["dev"]["error_rate"]) and np.isfinite(res["test"]["loss"])
    res = eval_cli.main([str(tmp_path / "m"), "--device", "cpu", "--lm-dir",
                         str(tmp_path / "lm"), "--lm-weight", "0.5"])
    assert capsys.readouterr().out.splitlines()[0] == (
        "decoding with beam width 3 + LM fusion w=0.5")
    assert np.isfinite(res["test"]["error_rate"])
    for extra in ([], ["--lm-dir", str(tmp_path / "lm")]):
        lines = decode_cli.main([str(tmp_path / "m"), "--device", "cpu", "--beam-width", "3",
                                 "--nbest", "2", "--num-utts", "2", *extra])
        assert lines[0].startswith("# model transducer/lstm") and lines[0].endswith("beam 3")
        names = sum(line.startswith("[") for line in lines)
        assert names >= 1
        assert sum(line.strip().startswith("HYP2 (score") for line in lines) == names
    assert Path(tmp_path / "m" / "config.yml").exists()
