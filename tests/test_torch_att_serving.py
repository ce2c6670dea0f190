"""The port's attention serving path end to end, against the JAX package.

Waveform -> ids through both ``build_inference_fn``s (attention branch,
greedy and beam) on bridged weights must give identical ids and lengths,
with a zero-length filler row in the batch as the micro-batcher makes
them; the HTTP server must answer as the direct inference does, and with a
CTC model at a beam width above 1 as JAX's prefix beam does; and
``bin/serve.load_model`` must build an attention model from a YAML config.
"""

import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.seq2seq import (
    Seq2SeqConfig as JSeq2SeqConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt_task
from tensorflow_end2end_speech_recognition_tpu_torch.bin.serve import load_model, make_server
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import Seq2SeqConfig
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train.att_task import (
    AttTaskConfig,
    init_model,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    params_from_jax,
    save_weights,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import load_task

torch.set_num_threads(1)

NUM = 4000  # padded samples: 24 frames -> 12 encoder frames after one 2x reduction
NUM_CLASSES = 6


def _tasks():
    enc = dict(encoder_type="pyramidal_blstm", num_units=8, num_layers=2)
    att = dict(attention_type="hybrid", attention_dim=8, conv_num_channels=3, conv_width=7)
    common = dict(num_classes=NUM_CLASSES, decoder_num_units=8, embedding_dim=4,
                  max_decode_length=10, ctc_loss_weight=0.3)
    jtask = jatt_task.AttTaskConfig(
        model=JSeq2SeqConfig(encoder=JEncoderConfig(**enc), attention=JAttentionConfig(**att),
                             **common),
        frontend=JFrontendConfig(use_energy=False))
    task = AttTaskConfig(
        model=Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att),
                            **common),
        frontend=FrontendConfig(use_energy=False))
    return jtask, task


def _bridged(seed=0):
    jtask, task = _tasks()
    params = jatt_task.init_params(jax.random.PRNGKey(seed), jtask)
    model = init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return jtask, task, params, model


def _waves(n_rows, seed):
    rng = np.random.RandomState(seed)
    waves = (rng.randn(n_rows, NUM) * 0.1).astype(np.float32)
    lens = rng.randint(500, NUM + 1, n_rows).astype(np.int32)
    lens[0] = NUM
    lens[-1] = 0  # a micro-batcher filler row
    for i, n in enumerate(lens):
        waves[i, n:] = 0.0
    return waves, lens


@pytest.mark.parametrize("beam_width", [1, 4])
def test_inference_ids_match_jax_serving(beam_width):
    jtask, task, params, model = _bridged(seed=2)  # rows that end by eos and rows that do not
    waves, lens = _waves(4, seed=1)
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jatt_task, params, beam_width=beam_width)(jnp.asarray(waves), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model, beam_width)(waves, lens)
    assert got_ids.dtype == torch.int32 and got_len.dtype == torch.int32
    assert got_ids.shape == want_ids.shape
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert int(got_len.sum()) > 0  # the comparison decoded something
    assert int(got_len.min()) < task.model.max_decode_length  # and some row ended by eos
    for ids, n in zip(got_ids.numpy(), got_len.numpy()):  # a random model may emit sos
        assert (ids[n:] == -1).all() and (ids[:n] >= 0).all()
        assert (ids[:n] < task.model.vocab).all() and (ids[:n] != task.model.eos_id).all()


def test_ctc_beam_serves_as_jax(tmp_path):
    """A CTC model from a YAML config at ``--beam-width 4``: the server's ids are
    those of JAX's ``build_inference_fn`` prefix beam on bridged weights."""
    from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
    from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task

    cfg = tmp_path / "ctc.yml"
    cfg.write_text("model_type: ctc\nlabel_type: character\nnum_units: 8\nnum_layers: 1\n"
                   "num_stack: 3\nnum_skip: 3\nuse_energy: false\nbeam_width: 4\n")
    task, units, label_type = load_task(cfg)
    jtask = jctc_task.CTCTaskConfig(
        model=JCTCConfig(encoder=JEncoderConfig(encoder_type="blstm", num_units=8,
                                                num_layers=1), num_classes=len(units)),
        frontend=JFrontendConfig(use_energy=False), num_stack=3, num_skip=3)
    params = jctc_task.init_params(jax.random.PRNGKey(4), jtask)
    model = ctc_task.init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    server = make_server(task, model, 2, NUM, port=0, max_wait_ms=5.0, units=units,
                         label_type=label_type, beam_width=4)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["beam_width"] == 4 and health["decode"] == "ctc_prefix_beam"
        assert health["blank_id"] == len(units)
        wav = (np.random.RandomState(6).randn(NUM) * 0.3).astype(np.float32)
        conn.request("POST", "/recognize", wav.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r = json.loads(conn.getresponse().read())
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jctc_task, params, beam_width=4)(
        jnp.asarray(np.stack([wav, np.zeros(NUM, np.float32)])), jnp.asarray([NUM, 0])))
    assert r["num_ids"] == int(want_len[0]) > 0
    assert r["ids"] == want_ids[0, : int(want_len[0])].tolist()
    assert r["text"] == "".join(units[i] for i in r["ids"])


def test_http_server_beam_end_to_end():
    _, task, _, model = _bridged(seed=0)
    units = ["aa", "bb", "cc", "dd", "ee", "ff"]
    server = make_server(task, model, 2, NUM, port=0, max_wait_ms=5.0, units=units,
                         label_type="phone61", beam_width=3)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["beam_width"] == 3
        assert health["blank_id"] is None and health["num_samples"] == NUM

        wav = (np.random.RandomState(5).randn(3000) * 0.3).astype(np.float32)
        conn.request("POST", "/recognize", wav.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r = json.loads(conn.getresponse().read())
        want_ids, want_len = build_inference_fn(task, model, 3)(
            np.stack([np.pad(wav, (0, NUM - 3000)), np.zeros(NUM, np.float32)]),
            np.asarray([3000, 0], np.int32))
        assert r["num_ids"] == int(want_len[0])
        assert r["ids"] == want_ids[0, : int(want_len[0])].tolist()
        assert r["text"] == " ".join(units[i] for i in r["ids"])
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()


def test_serve_loads_attention_yaml_and_bridged_weights(tmp_path):
    cfg = tmp_path / "tiny_att.yml"
    cfg.write_text("model_type: joint_ctc_attention\nlabel_type: character\ninput_size: 40\n"
                   "use_energy: false\nencoder_type: pyramidal_blstm\nnum_units: 8\n"
                   "num_layers: 2\nattention_dim: 8\nattention_conv_width: 5\n"
                   "decoder_num_units: 8\nembedding_dim: 4\nctc_loss_weight: 0.3\n"
                   "max_decode_length: 6\nbeam_width: 8\nattention_weights_tempareture: 2.0\n")
    task, units, _ = load_task(cfg)
    assert isinstance(task, AttTaskConfig) and task.model.is_joint
    assert task.model.attention.sharpening_factor == 2.0 and task.model.vocab == 30
    src = init_model(task, torch.Generator().manual_seed(0))
    save_weights(tmp_path / "w.npz", src.state_dict())
    task2, model, units2, _ = load_model(cfg, tmp_path / "w.npz", torch.device("cpu"))
    assert task2 == task and units2 == units and "ctc_head.w" in model.state_dict()
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, atol=0, rtol=0)
    ids, n = build_inference_fn(task2, model, 2)(np.zeros((2, NUM), np.float32),
                                                 np.asarray([NUM, 0], np.int32))
    assert ids.shape == (2, 6) and n.shape == (2,)
