"""The port's CTC prefix beam search against the JAX package and a host oracle.

Same seeded numpy logits through ``ctc_prefix_beam_search`` of both
packages over a grid of batch, frames, classes, beam widths and top-K,
with valid lengths 0, 1 and T, underfull (blank-dominated) beams and
``max_prefix_len < T``: prefixes and lengths must be equal in every live
slot (score above -1e29) and the scores within 1e-5 + 1e-5 · |score|
(float32 log-probabilities summed over up to 64 frames in other orders).
The rolling hashes must equal JAX's uint32 ones bit for bit, two chunks of
``beam_advance`` must equal one call, and the CTC-beam ``build_inference_fn``
must give JAX's ids on bridged weights.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.decoding import ctc_prefix_beam as jbeam
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import ctc_prefix_beam as beam
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import (
    CTCTaskConfig,
    init_model,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)


def host_prefix_beam(log_probs, blank, beam_width):
    """Textbook Hannun prefix beam search with dicts (the JAX tests' host oracle)."""
    t_len, c_len = log_probs.shape
    neg = -float("inf")

    def lse(*xs):
        xs = [x for x in xs if x != neg]
        if not xs:
            return neg
        m = max(xs)
        return m + math.log(sum(math.exp(x - m) for x in xs))

    beams = {(): (0.0, neg)}  # prefix -> (pb, pnb)
    for t in range(t_len):
        new = {}
        for prefix, (pb, pnb) in beams.items():
            total = lse(pb, pnb)
            npb, npnb = new.get(prefix, (neg, neg))
            new[prefix] = (lse(npb, total + log_probs[t, blank]), npnb)
            if prefix:  # repeat last: the same prefix
                c = prefix[-1]
                npb, npnb = new[prefix]
                new[prefix] = (npb, lse(npnb, pnb + log_probs[t, c]))
            for c in range(c_len):
                if c == blank:
                    continue
                ext = prefix + (c,)
                base = pb if (prefix and c == prefix[-1]) else total
                npb, npnb = new.get(ext, (neg, neg))
                new[ext] = (npb, lse(npnb, base + log_probs[t, c]))
        beams = dict(sorted(new.items(), key=lambda kv: -lse(*kv[1]))[:beam_width])
    return [(p, lse(*v)) for p, v in sorted(beams.items(), key=lambda kv: -lse(*kv[1]))]


def _search(logits, lens, blank, **kw):
    out = beam.ctc_prefix_beam_search(torch.from_numpy(logits), torch.from_numpy(lens),
                                      blank, **kw)
    return [x.numpy() for x in out]


def _prefix(prefixes, lengths, i, j):
    return tuple(int(x) for x in prefixes[i, j][: int(lengths[i, j])])


def test_matches_host_reference():
    rng = np.random.RandomState(0)
    b, t, c, w = 3, 12, 6, 8
    logits = rng.randn(b, t, c).astype(np.float32) * 2
    lens = np.array([12, 9, 5], np.int32)
    prefixes, lengths, scores = _search(logits, lens, c - 1, beam_width=w, top_k_classes=c - 1)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    for i in range(b):
        ref = host_prefix_beam(log_probs[i, : lens[i]], c - 1, w)
        assert _prefix(prefixes, lengths, i, 0) == ref[0][0]
        np.testing.assert_allclose(scores[i, 0], ref[0][1], rtol=1e-3, atol=1e-3)
        got3 = {_prefix(prefixes, lengths, i, j) for j in range(3)}
        assert len(got3 & {p for p, _ in ref[:3]}) >= 2  # near-ties may reorder


def test_blank_dominated_underfull_beam_matches_host():
    """Live candidates < W: every reported live score is the oracle's for its
    prefix (a duplicate keeping its mass would inflate them by about log 4)."""
    rng = np.random.RandomState(7)
    t, c, w = 10, 6, 20
    logits = rng.randn(1, t, c).astype(np.float32)
    logits[..., c - 1] += 4.0
    prefixes, lengths, scores = _search(logits, np.array([t], np.int32), c - 1, beam_width=w,
                                        top_k_classes=c - 1)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    ref = dict(host_prefix_beam(log_probs[0], c - 1, w))
    assert _prefix(prefixes, lengths, 0, 0) == max(ref, key=ref.get)
    live = 0
    for j in range(w):
        if scores[0, j] < -1e20:  # a dead slot
            continue
        live += 1
        np.testing.assert_allclose(scores[0, j], ref[_prefix(prefixes, lengths, 0, j)],
                                   rtol=1e-3, atol=1e-3)
    assert live >= 5


GRID = [  # (B, T, C, W, K, valid lengths, max_prefix_len, blank boost)
    (3, 20, 5, 4, 3, [20, 1, 0], None, 0.0),
    (4, 64, 29, 20, 16, [64, 33, 1, 0], None, 0.0),
    (2, 40, 29, 4, 16, [40, 17], 5, 0.0),  # full prefixes: max_prefix_len < T
    (3, 30, 5, 1, 3, [30, 12, 1], None, 0.0),
    (2, 48, 29, 20, 3, [48, 20], None, 4.0),  # blank-dominated: an underfull beam
    (1, 12, 5, 20, 16, [12], None, 0.0),  # K = min(16, C - 1) = 4; underfull
    (4, 32, 29, 4, 3, [32, 0, 5, 31], 3, 1.0),
]


@pytest.mark.parametrize("b,t,c,w,k,lens,max_len,boost", GRID)
def test_prefix_beam_matches_jax(b, t, c, w, k, lens, max_len, boost):
    rng = np.random.RandomState(b * 100 + t + c + w)
    logits = (rng.randn(b, t, c) * 2).astype(np.float32)
    logits[..., c - 1] += boost
    lens = np.asarray(lens, np.int32)
    kw = dict(beam_width=w, top_k_classes=k, max_prefix_len=max_len)
    want = [np.asarray(x) for x in jbeam.ctc_prefix_beam_search(
        jnp.asarray(logits), jnp.asarray(lens), c - 1, **kw)]
    got = _search(logits, lens, c - 1, **kw)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert got[0].shape == want[0].shape == (b, w, max_len or t)
    live = want[2] > -1e29
    np.testing.assert_array_equal(got[2] > -1e29, live)
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_array_equal(got[0][live], want[0][live])
    np.testing.assert_allclose(got[2][live], want[2][live], **SCORE_TOL)
    assert (lens > 0).sum() == 0 or int(got[1][:, 0].max()) > 0  # something was decoded
    if max_len is not None:
        assert int(got[1].max()) == max_len  # some prefix filled up


def _state_np(state):
    return {f: np.asarray(getattr(state, f)) for f in ("prefixes", "lengths", "last", "h1",
                                                        "h2", "pb", "pnb", "lm_score")}


def test_hashes_equal_jax_uint32_bits():
    """After 64 frames of random prefixes the int64 hashes hold JAX's uint32
    values, past 2^31 included."""
    rng = np.random.RandomState(3)
    b, t, c, w = 2, 64, 29, 4
    logits = (rng.randn(b, t, c) * 3).astype(np.float32)
    logits[..., c - 1] -= 3.0  # few blanks: long prefixes
    lens = np.asarray([t, 50], np.int32)
    jstate = jbeam.beam_advance(jbeam.beam_init(b, w, t), jnp.asarray(logits),
                                jnp.asarray(lens), c - 1, 16)
    state = beam.beam_advance(beam.beam_init(b, w, t), torch.from_numpy(logits),
                              torch.from_numpy(lens), c - 1, 16)
    for f in ("h1", "h2"):
        want = np.asarray(getattr(jstate, f))
        assert want.dtype == np.uint32
        got = getattr(state, f)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64), err_msg=f)
    assert (np.asarray(jstate.h1) >= 2**31).any() and int(state.lengths.min()) > 20


def test_hash_step_is_the_uint32_recurrence():
    rng = np.random.RandomState(4)
    h = np.concatenate([rng.randint(0, 2**32, 1000, dtype=np.uint64),
                        np.asarray([0, 2**31, 2**32 - 1], np.uint64)])
    cls = rng.randint(0, 64, h.shape[0]).astype(np.uint64)
    for mult in (2654435761, 40503):
        want = (h * np.uint64(mult) + cls + np.uint64(1)) % np.uint64(2**32)
        got = beam.hash_step(torch.from_numpy(h.astype(np.int64)),
                             torch.from_numpy(cls.astype(np.int64)), mult)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_two_chunks_equal_one_call():
    """Streaming drives ``beam_advance`` chunk by chunk: rows freeze past their
    valid frames, so the chunked state equals the one-call state bit for bit."""
    rng = np.random.RandomState(5)
    b, t, c, w, cut = 3, 30, 5, 4, 11
    logits = torch.from_numpy((rng.randn(b, t, c) * 2).astype(np.float32))
    lens = torch.tensor([30, 7, 0])
    once = beam.beam_advance(beam.beam_init(b, w, t), logits, lens, c - 1, 3)
    state = beam.beam_init(b, w, t)
    state = beam.beam_advance(state, logits[:, :cut], lens.clamp(max=cut), c - 1, 3)
    state = beam.beam_advance(state, logits[:, cut:], (lens - cut).clamp(min=0), c - 1, 3)
    for f, v in _state_np(once).items():
        np.testing.assert_array_equal(_state_np(state)[f], v, err_msg=f)


def test_ctc_beam_inference_fn_matches_jax_serving():
    """``build_inference_fn(beam_width=4)`` on a CTC model: JAX's ids and lengths
    on bridged weights, a zero-length filler row included."""
    enc = dict(encoder_type="blstm", num_units=16, num_layers=2)
    jtask = jctc_task.CTCTaskConfig(
        model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=28),
        frontend=JFrontendConfig(use_energy=False), num_stack=3, num_skip=3)
    task = CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=28),
                         frontend=FrontendConfig(use_energy=False), num_stack=3, num_skip=3)
    params = jctc_task.init_params(jax.random.PRNGKey(1), jtask)
    model = init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    rng = np.random.RandomState(2)
    num = 6400  # 39 frames -> 13 after 3/3 stacking
    waves = (rng.randn(4, num) * 0.1).astype(np.float32)
    lens = np.asarray([num, 3000, 900, 0], np.int32)
    for i, n in enumerate(lens):
        waves[i, n:] = 0.0
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jctc_task, params, beam_width=4)(jnp.asarray(waves), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model, beam_width=4)(waves, lens)
    assert got_ids.dtype == torch.int32 and got_ids.shape == want_ids.shape == (4, 13)
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert int(got_len.sum()) > 0 and int(got_len[3]) == 0
