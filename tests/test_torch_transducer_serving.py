"""The port's transducer serving and training path end to end, against the JAX package.

Waveform -> ids through both ``build_inference_fn``s (transducer greedy) on
bridged weights must give identical ids and lengths, with a zero-length
filler row as the micro-batcher makes them; the HTTP server must answer as
the direct inference does; ``configs/ls_transducer.yml`` must build the task
the JAX ``build_transducer_task`` builds; ``bin/serve.load_model`` must load
a transducer; and ``bin/train`` must train one for a toy epoch on the CPU.
"""

import dataclasses
import http.client
import json
import threading
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu.train.loop import build_transducer_task
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin.serve import load_model, make_server
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.serving import build_inference_fn
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    params_from_jax,
    save_weights,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    ExperimentConfig,
    load_task,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NUM = 4000  # padded samples: 24 frames -> T' = 8 after 3/3 stacking
C = 5
FRONTEND = dict(num_mels=40, use_energy=False, add_deltas=False, cmvn="none")


def _bridged(seed=0):
    enc = dict(encoder_type="lstm", num_units=12, num_layers=2)
    model = dict(num_classes=C, pred_num_units=8, embedding_dim=4, joint_dim=10,
                 max_symbols_per_frame=3)
    jtask = jtt.TransducerTaskConfig(
        model=jtransducer.TransducerConfig(encoder=JEncoderConfig(**enc), **model),
        frontend=JFrontendConfig(**FRONTEND), num_stack=3, num_skip=3)
    task = tt.TransducerTaskConfig(
        model=TransducerConfig(encoder=EncoderConfig(**enc), **model),
        frontend=FrontendConfig(**FRONTEND), num_stack=3, num_skip=3)
    params = jtt.init_params(jax.random.PRNGKey(seed), jtask)
    model = tt.init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return jtask, task, params, model


def test_inference_ids_match_jax_serving():
    jtask, task, params, model = _bridged(seed=1)
    rng = np.random.RandomState(2)
    waves = (rng.randn(4, NUM) * 0.3).astype(np.float32)
    lens = np.asarray([NUM, 2500, 900, 0], np.int32)  # the last row is a filler
    for i, n in enumerate(lens):
        waves[i, n:] = 0.0
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jtt, params)(jnp.asarray(waves), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model)(waves, lens)
    assert got_ids.dtype == torch.int32 and got_len.dtype == torch.int32
    assert got_ids.shape == want_ids.shape == (4, 8 * 3)
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert int(got_len.sum()) > 0 and int(got_len[3]) == 0
    # the beam branch: the JAX inference function's transducer beam
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jtt, params, beam_width=4)(jnp.asarray(waves), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model, beam_width=4)(waves, lens)
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)


def test_http_server_transducer_end_to_end():
    _, task, _, model = _bridged(seed=0)
    units = ["a", "b", "c", "d", "e"]
    server = make_server(task, model, 2, NUM, port=0, max_wait_ms=5.0, units=units,
                         label_type="character")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["blank_id"] == C
        wav = (np.random.RandomState(5).randn(3000) * 0.3).astype(np.float32)
        conn.request("POST", "/recognize", json.dumps({"audio": wav.tolist()}),
                     {"Content-Type": "application/json"})
        r = json.loads(conn.getresponse().read())
        want_ids, want_len = build_inference_fn(task, model)(
            np.stack([np.pad(wav, (0, NUM - 3000)), np.zeros(NUM, np.float32)]),
            np.asarray([3000, 0], np.int32))
        assert r["num_ids"] == int(want_len[0]) > 0
        assert r["ids"] == want_ids[0, : int(want_len[0])].tolist()
        assert r["text"] == "".join(units[i] for i in r["ids"])
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()


def test_ls_transducer_config_builds_the_jax_task():
    exp = ExperimentConfig.from_yaml(REPO / "configs" / "ls_transducer.yml")
    jexp = JExperimentConfig.from_yaml(str(REPO / "configs" / "ls_transducer.yml"))
    for f in dataclasses.fields(ExperimentConfig):
        assert getattr(exp, f.name) == getattr(jexp, f.name), f.name
    task = exp.task(28)
    jtask = build_transducer_task(jexp, SimpleNamespace(num_units=28))
    assert isinstance(task, tt.TransducerTaskConfig)
    for f in ("num_stack", "num_skip", "splice", "weight_decay", "feature_dim", "input_dim"):
        assert getattr(task, f) == getattr(jtask, f), f
    assert task.frontend._asdict() == jtask.frontend._asdict()
    assert jtask.spec_augment is None and task.spec_augment is None
    for f in TransducerConfig._fields:
        if f != "encoder":
            assert getattr(task.model, f) == getattr(jtask.model, f), f
    for f in EncoderConfig._fields:
        assert getattr(task.model.encoder, f) == getattr(jtask.model.encoder, f), f
    m = task.model
    assert (m.encoder.encoder_type, m.encoder.num_units, m.encoder.num_layers) == ("lstm", 512, 4)
    assert (task.input_dim, m.pred_num_units, m.embedding_dim, m.joint_dim,
            m.vocab_with_blank, m.max_symbols_per_frame) == (120, 128, 32, 256, 29, 4)


def test_serve_loads_transducer_yaml_and_bridged_weights(tmp_path):
    cfg = tmp_path / "tiny_rnnt.yml"
    cfg.write_text("model_type: transducer\nlabel_type: character\ninput_size: 40\n"
                   "use_energy: false\nuse_delta: false\ncmvn: none\nnum_stack: 3\n"
                   "num_skip: 3\nencoder_type: lstm\nnum_units: 8\nnum_layers: 2\n"
                   "pred_num_units: 6\nembedding_dim: 4\njoint_dim: 8\n")
    task, units, _ = load_task(cfg)
    assert isinstance(task, tt.TransducerTaskConfig) and task.model.vocab_with_blank == 29
    src = tt.init_model(task, torch.Generator().manual_seed(0))
    save_weights(tmp_path / "w.npz", src.state_dict())
    task2, model, units2, _ = load_model(cfg, tmp_path / "w.npz", torch.device("cpu"))
    assert task2 == task and units2 == units and "pred.0.wh" in model.state_dict()
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, atol=0, rtol=0)
    ids, n = build_inference_fn(task2, model)(np.zeros((2, NUM), np.float32),
                                              np.asarray([NUM, 0], np.int32))
    assert ids.shape == (2, 8 * 4) and n.shape == (2,)


def test_bin_train_transducer_one_toy_epoch(tmp_path):
    raw = dict(model_type="transducer", corpus="toy", label_type="character", input_size=40,
               use_energy=False, use_delta=False, cmvn="none", num_stack=3, num_skip=3,
               encoder_type="lstm", num_units=8, num_layers=2, pred_num_units=8,
               embedding_dim=4, joint_dim=8, dropout=0.9, batch_size=4, num_epoch=1,
               optimizer="adam", learning_rate=1e-3, weight_decay=1e-8, toy_num_utts=12,
               toy_max_units=4)
    cfg = tmp_path / "tiny.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    summary = train_cli.main([str(cfg), str(tmp_path / "m"), "--device", "cpu"])
    assert summary["epochs"] == 1 and summary["steps"] == 3  # 10 train utterances, batch 4
    assert summary["nonfinite_steps"] == 0 and np.isfinite(summary["train_loss"])
    assert np.isfinite(summary["dev_loss"]) and 0 <= summary["dev_error_rate"]
    assert "model: transducer/lstm" in (tmp_path / "m" / "train.log").read_text()
    assert CheckpointManager(tmp_path / "m" / "checkpoints").latest_epoch == 0
