"""The port's streaming recognition against the JAX package, on the CPU.

Kernel #3's plain version resuming from a carried ``(h, c)`` against the
scan branch of ``rnn_scan(..., initial_state=...)``; the frontend's
preemphasis context; ``streaming.build_streaming_fn`` chunk by chunk
against JAX's ``step_fn`` (CTC greedy and the prefix beam, unstacked and
stacked, the transducer greedy and beam, RNN-LM fusion in both beams:
tokens and lengths equal every chunk, the finalized beams equal, scores
within 1e-4); the chunked tokens against the port's own offline decode;
pause, resume and slot reuse (a paused row's state equal bit for bit); the
``chunk_len = -1`` flush; ``_validate``'s errors; and the session API
(``serving.StreamingEngine`` and ``bin/serve --stream`` on the CPU).
Toy sizes: B <= 3, H <= 16, 2 layers, chunks of 4 hops.
"""

import http.client
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import streaming as jstreaming
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.frontend import features as jfeatures
from tensorflow_end2end_speech_recognition_tpu.models import lm as jlm
from tensorflow_end2end_speech_recognition_tpu.models import rnn as jrnn
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu_torch import streaming
from tensorflow_end2end_speech_recognition_tpu_torch.bin import serve as serve_cli
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.ctc_greedy import (
    ctc_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.ctc_prefix_beam import (
    ctc_prefix_beam_search,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_beam import (
    transducer_beam_search,
)
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_greedy import (
    transducer_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend import features
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models import lm
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import LSTM
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm
from tensorflow_end2end_speech_recognition_tpu_torch.serving import StreamingEngine
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import device_pipeline
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import load_task

torch.set_num_threads(1)

CARRY_ATOL = 1e-5  # float32 gate products summed in other orders than XLA's
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)  # beam scores: sums of float32 log-probs
C = 6
CHUNK = 640  # 4 hops of 10 ms at 16 kHz
N = 4000  # samples: 6.25 chunks
WAV_LEN = np.asarray([N, 4 * CHUNK, 1000], np.int32)  # mid-chunk, on a boundary, short
W, K, L = 4, 5, 50  # beam width, top-K classes, prefix cap
FRONTEND = dict(use_energy=False, add_deltas=False, cmvn="none")
ENC = dict(encoder_type="lstm", num_units=16, num_layers=2)
TR_MODEL = dict(num_classes=C, pred_num_units=16, embedding_dim=8, joint_dim=16,
                max_symbols_per_frame=3)


def bridge(jtask, task, jmod, mod, seed):
    """JAX params of ``jtask`` and the port's model of ``task`` on the same weights."""
    params = jmod.init_params(jax.random.PRNGKey(seed), jtask)
    model = mod.init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return params, model.eval()


def ctc_pair(stack=1, skip=1, seed=0, enc=None):
    enc = enc or ENC
    jtask = jctc.CTCTaskConfig(model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=C),
                               frontend=JFrontendConfig(**FRONTEND), num_stack=stack,
                               num_skip=skip)
    task = ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                  frontend=FrontendConfig(**FRONTEND), num_stack=stack,
                                  num_skip=skip)
    return (jtask, task, *bridge(jtask, task, jctc, ctc_task, seed))


def transducer_pair(stack=3, skip=3, seed=0, enc=None):
    enc = enc or ENC
    jtask = jtt.TransducerTaskConfig(
        model=jtransducer.TransducerConfig(encoder=JEncoderConfig(**enc), **TR_MODEL),
        frontend=JFrontendConfig(**FRONTEND), num_stack=stack, num_skip=skip)
    task = tt.TransducerTaskConfig(
        model=TransducerConfig(encoder=EncoderConfig(**enc), **TR_MODEL),
        frontend=FrontendConfig(**FRONTEND), num_stack=stack, num_skip=skip)
    return (jtask, task, *bridge(jtask, task, jtt, tt, seed))


def lm_pair(seed=11):
    cfg = jlm.LMConfig(vocab=C + 2, num_units=8, embedding_dim=4)
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), cfg)
    model = lm.RNNLM(lm.LMConfig(vocab=C + 2, num_units=8, embedding_dim=4))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), model))
    return (jparams, cfg), model.eval()


def waves(seed, b=3, n=N):
    return (np.random.RandomState(seed).randn(b, n) * 0.3).astype(np.float32)


def chunk_lens(wav_len, k, stacked):
    """Every chunk's lengths, then (stacked streams) the -1 flush of rows that
    ended on a chunk boundary."""
    n_chunks = -(-int(wav_len.max()) // CHUNK)
    lens = [np.clip(wav_len - i * CHUNK, 0, CHUNK).astype(np.int32) for i in range(n_chunks)]
    if stacked:
        lens.append(np.where(wav_len % CHUNK == 0, -1, 0).astype(np.int32))
    return lens


def drive(step_fn, state, wav, wav_len, stacked, to_np=np.asarray):
    """Step a stream over ``wav``: (final state, per-chunk (tokens, tok_len), per-row tokens)."""
    wav = np.pad(wav, ((0, 0), (0, -wav.shape[1] % CHUNK + CHUNK)))
    outs, rows = [], [[] for _ in range(wav.shape[0])]
    for i, cl in enumerate(chunk_lens(wav_len, CHUNK, stacked)):
        lo = i * CHUNK if cl.max() > 0 else 0
        piece = wav[:, lo: lo + CHUNK] if cl.max() > 0 else np.zeros_like(wav[:, :CHUNK])
        state, tok, n = step_fn(state, piece, cl)
        tok, n = to_np(tok), to_np(n)
        outs.append((tok, n))
        for r in range(len(rows)):
            rows[r].extend(tok[r, : n[r]].tolist())
    return state, outs, rows


def jax_drive(jtask, params, wav, wav_len, **kw):
    fns = jstreaming.build_streaming_fn(jtask, params, CHUNK, **kw)
    step = jax.jit(fns[1])
    state, outs, rows = drive(lambda s, c, n: step(s, jnp.asarray(c), jnp.asarray(n)),
                              fns[0](wav.shape[0]), wav, wav_len, jtask.num_stack > 1)
    final = [np.asarray(x) for x in fns[2](state)] if len(fns) > 2 else None
    return outs, rows, final


def port_drive(task, model, wav, wav_len, **kw):
    fns = streaming.build_streaming_fn(task, model, CHUNK, **kw)
    state, outs, rows = drive(fns[1], fns[0](wav.shape[0]), wav, wav_len, task.num_stack > 1,
                              lambda x: x.numpy())
    final = [x.numpy() for x in fns[2](state)] if len(fns) > 2 else None
    return outs, rows, final


def assert_same_chunks(got, want):
    assert len(got) == len(want)
    for i, ((tok, n), (wtok, wn)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(n, wn, err_msg=f"chunk {i}")
        np.testing.assert_array_equal(tok, wtok, err_msg=f"chunk {i}")


def assert_same_beams(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], **SCORE_TOL)


# ---- kernel #3 with a carried state ------------------------------------------


def test_lstm_carry_plain_matches_jax_scan():
    rng = np.random.RandomState(0)
    b, t, d, h = 4, 6, 5, 8
    spec = jrnn.RNNSpec(cell="lstm", num_units=h, impl="scan")
    jparams = jrnn.init_rnn_params(jax.random.PRNGKey(1), spec, d)
    xs = rng.randn(b, t, d).astype(np.float32)
    lengths = np.asarray([t, 3, 0, 1], np.int32)
    h0, c0 = (rng.randn(b, h).astype(np.float32) for _ in range(2))
    want_ys, (want_h, want_c) = jrnn.rnn_scan(jparams, spec, jnp.asarray(xs),
                                              jnp.asarray(lengths),
                                              initial_state=(jnp.asarray(h0), jnp.asarray(c0)))
    layer = LSTM(d, h)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), layer))
    state = (torch.from_numpy(h0), torch.from_numpy(c0))
    with torch.no_grad():
        ys, (h_t, c_t) = layer(torch.from_numpy(xs), torch.from_numpy(lengths), state)
        xproj = torch.from_numpy(xs) @ layer.wx + layer.b
        mask = (torch.arange(t)[None] < torch.from_numpy(lengths)[:, None]).float()
        p_ys, p_cs, (p_h, p_c) = lstm.lstm_layer_fwd_plain(xproj, layer.wh, mask, 1.0, state)
    for got, want in ((ys, want_ys), (h_t, want_h), (c_t, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CARRY_ATOL, rtol=0)
    assert torch.equal(ys, p_ys) and torch.equal(h_t, p_h) and torch.equal(c_t, p_c)
    assert torch.equal(p_cs[:, -1], p_c)  # cs holds the carried c
    # the row with no valid step hands its state back bit for bit, and emits 0
    assert torch.equal(h_t[2], state[0][2]) and torch.equal(c_t[2], state[1][2])
    assert not ys[2].any()
    # no state: the zero-state forward of before, two outputs
    assert torch.equal(lstm.lstm_layer_fwd(xproj, layer.wh, mask, 1.0),
                       lstm.lstm_layer_fwd_plain(xproj, layer.wh, mask, 1.0)[0])


def test_lstm_carry_takes_no_gradient_and_checks_its_state():
    layer = LSTM(3, 4)
    xs, lengths = torch.randn(2, 3, 3), torch.tensor([3, 1])
    state = (torch.zeros(2, 4), torch.zeros(2, 4))
    with pytest.raises(NotImplementedError, match="no gradient"):
        layer(xs, lengths, state)
    with torch.no_grad():
        with pytest.raises(ValueError, match="h0 has shape"):
            layer(xs, lengths, (torch.zeros(3, 4), torch.zeros(2, 4)))
        with pytest.raises(ValueError, match="initial_state must be"):
            layer(xs, lengths, (torch.zeros(2, 4),))


def test_extract_features_with_preemph_context_matches_jax():
    rng = np.random.RandomState(2)
    wav = rng.randn(3, 960).astype(np.float32) * 0.3
    ctx = rng.randn(3, 1).astype(np.float32)
    lens = np.asarray([960, 700, 400], np.int32)
    for kw in (dict(FRONTEND), dict(FRONTEND, use_energy=True)):
        want, wlen = jfeatures.extract_features(jnp.asarray(wav), jnp.asarray(lens),
                                                JFrontendConfig(**kw),
                                                preemph_context=jnp.asarray(ctx))
        got, glen = features.extract_features(torch.from_numpy(wav), torch.from_numpy(lens),
                                              FrontendConfig(**kw),
                                              preemph_context=torch.from_numpy(ctx))
        np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5)
    # the context changes only the first frame
    plain, _ = features.extract_features(torch.from_numpy(wav), torch.from_numpy(lens),
                                         FrontendConfig(**kw))
    assert torch.equal(got[:, 1:], plain[:, 1:]) and not torch.equal(got[:, :1], plain[:, :1])


# ---- build_streaming_fn against JAX, chunk by chunk ---------------------------


CTC_CASES = {
    "greedy": dict(stack=1, skip=1, kw={}),
    "greedy_stacked": dict(stack=3, skip=3, kw={}),
    "greedy_stacked_3_1": dict(stack=3, skip=1, kw={}),
    "beam": dict(stack=1, skip=1, kw=dict(beam_width=W, top_k_classes=K, max_prefix_len=L)),
    "beam_lm": dict(stack=1, skip=1, kw=dict(beam_width=W, top_k_classes=K, max_prefix_len=L,
                                             lm_weight=0.5)),
}


@pytest.fixture(scope="module")
def ctc_runs():
    """Each CTC case streamed through JAX and the port on the same audio."""
    runs = {}
    (jlm_params, port_lm) = lm_pair()
    for name, case in CTC_CASES.items():
        jtask, task, params, model = ctc_pair(case["stack"], case["skip"], seed=3)
        wav = waves(4)
        jkw, kw = dict(case["kw"]), dict(case["kw"])
        if "lm_weight" in kw:
            jkw["lm"], kw["lm"] = jlm_params, port_lm
        runs[name] = dict(task=task, model=model, wav=wav, kw=kw,
                          jax=jax_drive(jtask, params, wav, WAV_LEN, **jkw),
                          port=port_drive(task, model, wav, WAV_LEN, **kw))
    return runs


@pytest.mark.parametrize("name", list(CTC_CASES))
def test_ctc_stream_matches_jax_chunk_by_chunk(ctc_runs, name):
    run = ctc_runs[name]
    (j_outs, j_rows, j_final), (outs, rows, final) = run["jax"], run["port"]
    assert_same_chunks(outs, j_outs)
    assert rows == j_rows and sum(map(len, rows)) > 0
    if j_final is not None:
        assert_same_beams(final, j_final)


@pytest.mark.parametrize("name", list(CTC_CASES))
def test_ctc_stream_equals_port_offline(ctc_runs, name):
    run = ctc_runs[name]
    task, model, kw = run["task"], run["model"], run["kw"]
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(run["wav"]),
                                           "input_len": torch.from_numpy(WAV_LEN)})
        out = model(feats, fl)
        ids, n = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
        assert run["port"][1] == [ids[i, : n[i]].tolist() for i in range(3)]
        if "beam_width" in kw:
            fusion = (lm.make_fusion_lm(kw["lm"], task.model.vocab_with_blank)
                      if "lm" in kw else None)
            want = ctc_prefix_beam_search(out.logits, out.logit_len, task.model.blank_id,
                                          beam_width=W, top_k_classes=K, max_prefix_len=L,
                                          fusion_lm=fusion, lm_weight=kw.get("lm_weight", 0.0))
            assert_same_beams(run["port"][2], [x.numpy() for x in want])


TR_CASES = {
    "greedy": {},
    "beam": dict(beam_width=3, max_prefix_len=40),
    "beam_lm": dict(beam_width=3, max_prefix_len=40, lm_weight=-1.0),
}


@pytest.fixture(scope="module")
def transducer_runs():
    runs = {}
    jlm_params, port_lm = lm_pair(seed=12)
    jtask, task, params, model = transducer_pair(seed=5)
    for name, kw in TR_CASES.items():
        wav = waves(6)
        jkw, kw = dict(kw), dict(kw)
        if "lm_weight" in kw:
            jkw["lm"], kw["lm"] = jlm_params, port_lm
        runs[name] = dict(task=task, model=model, wav=wav, kw=kw,
                          jax=jax_drive(jtask, params, wav, WAV_LEN, **jkw),
                          port=port_drive(task, model, wav, WAV_LEN, **kw))
    return runs


@pytest.mark.parametrize("name", list(TR_CASES))
def test_transducer_stream_matches_jax_chunk_by_chunk(transducer_runs, name):
    run = transducer_runs[name]
    (j_outs, j_rows, j_final), (outs, rows, final) = run["jax"], run["port"]
    assert_same_chunks(outs, j_outs)
    assert rows == j_rows and sum(map(len, rows)) > 0
    if j_final is not None:
        assert_same_beams(final, j_final)
        assert final[1].sum() > 0  # the hypotheses emit labels


@pytest.mark.parametrize("name", list(TR_CASES))
def test_transducer_stream_equals_port_offline(transducer_runs, name):
    run = transducer_runs[name]
    task, model, kw = run["task"], run["model"], run["kw"]
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(run["wav"]),
                                           "input_len": torch.from_numpy(WAV_LEN)})
        f_proj, enc_len = model.encode(feats, fl)
        ids, n = transducer_greedy_decode(model, f_proj, enc_len)
        assert run["port"][1] == [ids[i, : n[i]].tolist() for i in range(3)]
        if "beam_width" in kw:
            fusion = (lm.make_fusion_lm(kw["lm"], task.model.vocab_with_blank)
                      if "lm" in kw else None)
            want = transducer_beam_search(model, f_proj, enc_len, beam_width=3, max_len=40,
                                          fusion_lm=fusion, lm_weight=kw.get("lm_weight", 0.0))
            assert_same_beams(run["port"][2], [x.numpy() for x in want])


# ---- pause, resume, slot reuse, flush -----------------------------------------


def leaves(state, row):
    out = []
    streaming.tree_map(lambda x: out.append(x[row].clone()), state)
    return out


@pytest.mark.parametrize("family", ["ctc_beam", "transducer_beam"])
def test_pause_resume_and_slot_reuse(family):
    if family == "ctc_beam":
        _, task, _, model = ctc_pair(stack=3, skip=3, seed=7)
        kw = dict(beam_width=W, top_k_classes=K, max_prefix_len=L)
    else:
        _, task, _, model = transducer_pair(seed=7)
        kw = dict(beam_width=3, max_prefix_len=40)
    wav = waves(8, b=2, n=4 * CHUNK)
    wav_len = np.asarray([4 * CHUNK, 4 * CHUNK], np.int32)
    init_fn, step_fn, finalize_fn = streaming.build_streaming_fn(task, model, CHUNK, **kw)
    want_state, _, want = drive(step_fn, init_fn(2), wav, wav_len, True, lambda x: x.numpy())
    want_final = [x.numpy() for x in finalize_fn(want_state)]

    state, got = init_fn(2), [[], []]

    def feed(k0, k1):
        nonlocal state
        chunk, cl = np.zeros((2, CHUNK), np.float32), np.zeros((2,), np.int32)
        for row, k in ((0, k0), (1, k1)):
            if k == "flush":
                cl[row] = -1
            elif k is not None:
                chunk[row], cl[row] = wav[row, k * CHUNK: (k + 1) * CHUNK], CHUNK
        paused = [row for row, k in ((0, k0), (1, k1)) if k is None]
        before = {row: leaves(state, row) for row in paused}
        state, tok, n = step_fn(state, chunk, cl)
        for row in paused:  # a paused row's whole state is kept bit for bit
            assert n[row] == 0
            assert all(torch.equal(a, b) for a, b in zip(leaves(state, row), before[row]))
        for row in (0, 1):
            got[row].extend(tok[row, : n[row]].tolist())

    # out of lockstep: row 1 pauses twice mid-stream, row 0 once
    feed(0, 0)
    feed(1, None)
    feed(None, 1)
    feed(2, 2)
    feed(3, None)
    feed("flush", 3)
    feed(None, "flush")
    assert got == want
    for x, y in zip((x.numpy() for x in finalize_fn(state)), want_final):
        np.testing.assert_array_equal(x, y)

    # slot reuse: row 0 restarts with row 1's audio while row 1 stays ended
    state = streaming.reset_rows(state, init_fn(2), np.asarray([True, False]))
    fresh = init_fn(2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(state, 0), leaves(fresh, 0)))
    got0 = []
    for k in list(range(4)) + ["flush"]:
        chunk = np.zeros((2, CHUNK), np.float32)
        if k != "flush":
            chunk[0] = wav[1, k * CHUNK: (k + 1) * CHUNK]
        state, tok, n = step_fn(state, chunk, np.asarray([CHUNK if k != "flush" else -1, 0],
                                                         np.int32))
        got0.extend(tok[0, : n[0]].tolist())
        assert n[1] == 0
    assert got0 == want[1]


def test_stacked_stream_on_a_chunk_boundary_needs_the_flush():
    _, task, _, model = ctc_pair(stack=3, skip=3, seed=9)
    wav = waves(10, b=1, n=4 * CHUNK)
    init_fn, step_fn = streaming.build_streaming_fn(task, model, CHUNK)
    state, rows = init_fn(1), []
    for k in range(4):
        state, tok, n = step_fn(state, wav[:, k * CHUNK: (k + 1) * CHUNK], [CHUNK])
        rows.extend(tok[0, : n[0]].tolist())
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav),
                                           "input_len": torch.tensor([4 * CHUNK])})
        out = model(feats, fl)
        ids, n_ids = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
    want = ids[0, : n_ids[0]].tolist()
    assert rows == want[: len(rows)]  # the held-back tail window is missing
    held = state.carry_len.clone()
    assert held[0] > 0  # base frames wait for the window they start
    state, tok, n = step_fn(state, np.zeros((1, CHUNK), np.float32), [-1])
    assert rows + tok[0, : n[0]].tolist() == want
    assert state.carry_len[0] == 0
    # a partial final chunk flushes by itself
    state, rows = init_fn(1), []
    for k, cl in enumerate((CHUNK, CHUNK, CHUNK, CHUNK - 160)):
        state, tok, n = step_fn(state, wav[:, k * CHUNK: (k + 1) * CHUNK], [cl])
        rows.extend(tok[0, : n[0]].tolist())
    feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav),
                                       "input_len": torch.tensor([4 * CHUNK - 160])})
    with torch.no_grad():
        out = model(feats, fl)
        ids, n_ids = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
    assert rows == ids[0, : n_ids[0]].tolist() and state.carry_len[0] == 0


# ---- validation ----------------------------------------------------------------


def _replace_encoder(task, **kw):
    return task._replace(model=task.model._replace(encoder=task.model.encoder._replace(**kw)))


@pytest.mark.parametrize("case,match", [
    ("deltas", "causal"), ("cmvn", "CMVN"), ("blstm", "causal encoder"),
    ("splice", "splice"), ("skip", "num_skip"), ("hop", "multiple of the hop"),
    ("short", "chunk too short"), ("conformer", "left_context"), ("relative", "relative"),
    ("no_frontend", "waveform frontend"), ("multitask", "main task"),
])
def test_validate_errors_match_jax(case, match):
    jtask, task = (t._replace(frontend=f(**FRONTEND)) for t, f in (
        (jctc.CTCTaskConfig(model=JCTCConfig(encoder=JEncoderConfig(**ENC), num_classes=C)),
         JFrontendConfig),
        (ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**ENC), num_classes=C)),
         FrontendConfig)))
    chunk = CHUNK
    conformer = dict(encoder_type="conformer", num_heads=2, conv_kernel_size=3)
    if case == "deltas":
        edit = lambda t, f: t._replace(frontend=f(**dict(FRONTEND, add_deltas=True)))  # noqa
    elif case == "cmvn":
        edit = lambda t, f: t._replace(frontend=f(**dict(FRONTEND, cmvn="utterance")))  # noqa
    elif case == "blstm":
        edit = lambda t, f: _replace_encoder(t, encoder_type="blstm")  # noqa
    elif case == "splice":
        edit = lambda t, f: t._replace(splice=2)  # noqa
    elif case == "skip":
        edit = lambda t, f: t._replace(num_stack=2, num_skip=3)  # noqa
    elif case == "conformer":
        edit = lambda t, f: _replace_encoder(t, **conformer)  # noqa
    elif case == "relative":
        edit = lambda t, f: _replace_encoder(t, left_context=4, pos_encoding="relative",  # noqa
                                             **conformer)
    elif case == "no_frontend":
        edit = lambda t, f: t._replace(frontend=None)  # noqa
    elif case == "multitask":
        edit = lambda t, f: t._replace(model=t.model._replace(num_classes_sub=3))  # noqa
    else:
        edit = lambda t, f: t  # noqa
        chunk = 1000 if case == "hop" else 0
    jtask, task = edit(jtask, JFrontendConfig), edit(task, FrontendConfig)
    with pytest.raises(ValueError, match=match):
        jstreaming.build_streaming_fn(jtask, {}, chunk)
    model = torch.nn.Linear(1, 1)  # _validate and the chunk checks come first
    with pytest.raises(ValueError, match=match):
        streaming.build_streaming_fn(task, model, chunk)


def test_gru_streaming_waits_for_the_gru_port():
    """GRU streams now (tests/test_torch_encoder_zoo.py holds it against JAX):
    its layers carry (h,)."""
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**dict(ENC, encoder_type="gru")), num_classes=C),
        frontend=FrontendConfig(**FRONTEND))
    model = CTCModel(task.model, task.input_dim)
    init_fn, _ = streaming.build_streaming_fn(task, model, CHUNK)
    assert [tuple(x.shape for x in c) for c in init_fn(2).rnn_states] == [
        ((2, ENC["num_units"]),)] * ENC["num_layers"]
    assert streaming.carry_samples(FrontendConfig()) == jstreaming.carry_samples(
        JFrontendConfig()) == 320


# ---- the session API ---------------------------------------------------------------


def _engine(beam=False, batch=2, **kw):
    _, task, _, model = transducer_pair(seed=13)
    fns = streaming.build_streaming_fn(task, model, CHUNK,
                                       **(dict(beam_width=3, max_prefix_len=40) if beam else {}))
    engine = StreamingEngine(fns[0](batch), fns[1], batch, CHUNK, tick_ms=1.0,
                             finalize=fns[2] if beam else None, final_flush=True, **kw)
    return task, model, fns, engine


def _offline_transducer(task, model, wav, beam=False):
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav[None]),
                                           "input_len": torch.tensor([wav.shape[0]])})
        f_proj, enc_len = model.encode(feats, fl)
        if beam:
            res = transducer_beam_search(model, f_proj, enc_len, beam_width=3, max_len=40)
            return res.tokens[0, 0, : res.lengths[0, 0]].tolist()
        ids, n = transducer_greedy_decode(model, f_proj, enc_len)
    return ids[0, : n[0]].tolist()


@pytest.mark.parametrize("beam", [False, True])
def test_streaming_engine_sessions(beam):
    task, model, _, engine = _engine(beam)
    try:
        a, b = engine.start(), engine.start()
        assert a and b and engine.start() is None  # every slot busy
        wav_a, wav_b = waves(14, b=2, n=3 * CHUNK)
        wav_b = wav_b[: 2 * CHUNK + 300]
        got = {a: [], b: []}
        for lo in range(0, 3 * CHUNK, 500):  # posts that do not align with chunks
            got[a] += engine.feed(a, wav_a[lo: lo + 500])
            got[b] += engine.feed(b, wav_b[lo: lo + 500])
        for sid in (a, b):
            end = engine.end(sid)
            got[sid] = end if beam else got[sid] + end
        assert got[a] == _offline_transducer(task, model, wav_a, beam)
        assert got[b] == _offline_transducer(task, model, wav_b, beam)
        c = engine.start()  # a freed slot, reset for a new stream
        got_c = engine.feed(c, wav_b)
        end = engine.end(c)
        assert (end if beam else got_c + end) == got[b] and engine.steps_run > 0
        with pytest.raises(KeyError):
            engine.feed(a, wav_a[:10])
    finally:
        engine.stop()


def test_streaming_engine_reclaims_an_abandoned_session():
    _, _, _, engine = _engine(batch=1, session_timeout_s=0.2)
    try:
        sid = engine.start()
        engine.feed(sid, np.zeros(100, np.float32))
        assert engine.start() is None
        deadline = time.monotonic() + 10.0
        while engine.start() is None:
            assert time.monotonic() < deadline, "the abandoned slot was never reclaimed"
            time.sleep(0.05)
        with pytest.raises(KeyError):
            engine.feed(sid, np.zeros(10, np.float32))
    finally:
        engine.stop()


def _post(port, path, body=b"", ctype="application/octet-stream"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=body, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_serve_stream_over_http(tmp_path):
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import save_weights

    cfg = tmp_path / "rnnt.yml"
    cfg.write_text("model_type: transducer\nlabel_type: character\ninput_size: 40\n"
                   "use_energy: false\nuse_delta: false\ncmvn: none\nnum_stack: 3\n"
                   "num_skip: 3\nencoder_type: lstm\nnum_units: 8\nnum_layers: 2\n"
                   "pred_num_units: 8\nembedding_dim: 4\njoint_dim: 8\n")
    save_weights(tmp_path / "w.npz",
                 tt.init_model(load_task(cfg)[0], torch.Generator().manual_seed(0)).state_dict())
    task, model, units, label_type = serve_cli.load_model(cfg, tmp_path / "w.npz",
                                                          torch.device("cpu"))
    server = serve_cli.make_stream_server(task, model, batch_size=2, chunk_ms=40.0,
                                          beam_width=2, max_wait_ms=1.0, units=units,
                                          label_type=label_type)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        meta = json.loads(conn.getresponse().read())
        assert meta["streaming"] and meta["chunk_samples"] == CHUNK and meta["batch_size"] == 2
        assert meta["decode"] == "transducer_beam" and meta["final_flush"]
        sids = [_post(port, "/stream/start")[1]["session"] for _ in range(2)]
        status, body = _post(port, "/stream/start")
        assert status == 503 and "busy" in body["error"]
        wav = waves(15, b=1, n=2 * CHUNK + 500)[0]
        for lo in range(0, wav.shape[0], 400):
            status, body = _post(port, f"/stream/audio?session={sids[0]}",
                                 wav[lo: lo + 400].tobytes())
            assert status == 200 and isinstance(body["ids"], list) and "text" in body
        status, body = _post(port, f"/stream/end?session={sids[0]}")
        assert status == 200 and body["final"] is True
        with torch.no_grad():
            feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav[None]),
                                               "input_len": torch.tensor([wav.shape[0]])})
            f_proj, enc_len = model.encode(feats, fl)
            res = transducer_beam_search(model, f_proj, enc_len, beam_width=2, max_len=200)
        assert body["ids"] == res.tokens[0, 0, : res.lengths[0, 0]].tolist()
        assert body["text"] == "".join(units[i] for i in body["ids"])
        status, body = _post(port, f"/stream/audio?session={sids[1]}",
                             json.dumps({"audio": [0.0] * 300}).encode(), "application/json")
        assert status == 200
        assert _post(port, "/stream/audio")[0] == 400  # no session
        assert _post(port, "/stream/audio?session=nope", b"\0\0\0\0")[0] == 400
        assert _post(port, "/stream/start")[0] == 200  # the ended session's slot is free
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
