"""Port frontend vs the JAX frontend on the same seeded waveforms.

Tolerance: atol 1e-4 on CMVN-normalized features (unit variance), float32
throughout; the two sides sum the DFT products in different orders.
Stacking and splicing are pure gathers and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.data.frame_ops import (
    splice_frames as jax_splice,
    stack_frames as jax_stack,
)
from tensorflow_end2end_speech_recognition_tpu.frontend import features as jf
from tensorflow_end2end_speech_recognition_tpu_torch.data.frame_ops import (
    splice_frames,
    stack_frames,
)
from tensorflow_end2end_speech_recognition_tpu_torch.frontend import features as tf_

torch.set_num_threads(1)


def _batch(seed=0, n=4000):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(4, n) * 0.1).astype(np.float32)
    wav[2] = 0.0  # all-zero row: log floor, zero variance
    lens = np.asarray([n, 2500, n, 300], np.int32)  # 300 < frame_length
    for i, n_i in enumerate(lens):
        wav[i, n_i:] = 0.0
    return wav, lens


@pytest.mark.parametrize("use_energy", [True, False])
def test_extract_features_matches_jax(use_energy):
    wav, lens = _batch()
    kw = dict(use_energy=use_energy)
    want, want_len = jf.extract_features(jnp.asarray(wav), jnp.asarray(lens),
                                         jf.FrontendConfig(**kw))
    got, got_len = tf_.extract_features(torch.from_numpy(wav), torch.from_numpy(lens),
                                        tf_.FrontendConfig(**kw))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == want.shape
    assert got_len.tolist()[3] == 0 and bool(torch.all(got[3] == 0))
    assert bool(torch.all(torch.isfinite(got)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_unnormalized_features_match_jax():
    wav, lens = _batch(seed=1)
    kw = dict(cmvn="none", add_deltas=False)
    want, _ = jf.extract_features(jnp.asarray(wav), jnp.asarray(lens), jf.FrontendConfig(**kw))
    got, _ = tf_.extract_features(torch.from_numpy(wav), torch.from_numpy(lens),
                                  tf_.FrontendConfig(**kw))
    # raw log-mel values down to log(1e-10) = -23: relative tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-5)
    # MFCC is ported (tests/test_torch_disk_corpus.py): base_dim counts cepstra
    for kw in (dict(feature_type="mfcc"), dict(feature_type="mfcc", num_ceps=20,
                                               use_energy=False)):
        cfg = tf_.FrontendConfig(**kw)
        assert cfg.base_dim == jf.FrontendConfig(**kw).base_dim == cfg.num_ceps + cfg.use_energy
        feats, _ = tf_.extract_features(torch.from_numpy(wav), torch.from_numpy(lens), cfg)
        assert feats.shape[-1] == cfg.feature_dim


def test_frontend_config_fields_match_jax():
    assert tf_.FrontendConfig._fields == jf.FrontendConfig._fields
    assert tuple(tf_.FrontendConfig()) == tuple(jf.FrontendConfig())
    cfg = tf_.FrontendConfig(use_energy=False)
    assert cfg.feature_dim == jf.FrontendConfig(use_energy=False).feature_dim == 120


@pytest.mark.parametrize("num_stack,num_skip", [(3, 3), (2, 1), (1, 1), (3, 2)])
def test_stack_frames_matches_jax_exactly(num_stack, num_skip):
    rng = np.random.RandomState(2)
    feats = rng.randn(3, 11, 5).astype(np.float32)
    lens = np.asarray([11, 7, 1], np.int32)
    want, want_len = jax_stack(jnp.asarray(feats), jnp.asarray(lens), num_stack, num_skip)
    got, got_len = stack_frames(torch.from_numpy(feats), torch.from_numpy(lens),
                                num_stack, num_skip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


@pytest.mark.parametrize("splice", [0, 1, 2])
def test_splice_frames_matches_jax_exactly(splice):
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 6, 4).astype(np.float32)
    want = jax_splice(jnp.asarray(feats), splice)
    got = splice_frames(torch.from_numpy(feats), splice)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
