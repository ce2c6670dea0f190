"""The port's CTC serving slice end to end, against the JAX package.

Waveform -> ids through both ``build_inference_fn``s on bridged weights must
give identical ids; the micro-batcher and the HTTP server must answer as the
direct inference does; the YAML subset must build the JAX package's
configs; and no port module may import jax.
"""

import http.client
import json
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.encoders import (
    EncoderConfig as JEncoderConfig,
)
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.bin.serve import load_model, make_server
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.serving import (
    MicroBatcher,
    build_inference_fn,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import (
    CTCTaskConfig,
    init_model,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    params_from_jax,
    save_weights,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import load_task

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NUM = 4000  # padded samples: 24 frames -> T = 8 after 3/3 stacking


def _tasks(num_classes=28, units=32, layers=2):
    enc = dict(encoder_type="blstm", num_units=units, num_layers=layers)
    jtask = jctc_task.CTCTaskConfig(
        model=JCTCConfig(encoder=JEncoderConfig(**enc), num_classes=num_classes),
        frontend=JFrontendConfig(use_energy=False), num_stack=3, num_skip=3,
    )
    task = CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=num_classes),
        frontend=FrontendConfig(use_energy=False), num_stack=3, num_skip=3,
    )
    return jtask, task


def _bridged(seed=0, **kw):
    jtask, task = _tasks(**kw)
    params = jctc_task.init_params(jax.random.PRNGKey(seed), jtask)
    model = init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return jtask, task, params, model


def _waves(n_rows, seed):
    rng = np.random.RandomState(seed)
    waves = (rng.randn(n_rows, NUM) * 0.1).astype(np.float32)
    lens = rng.randint(500, NUM + 1, n_rows).astype(np.int32)
    lens[0] = NUM
    for i, n in enumerate(lens):
        waves[i, n:] = 0.0
    return waves, lens


def test_inference_ids_match_jax_serving():
    jtask, task, params, model = _bridged(seed=0)
    waves, lens = _waves(4, seed=1)
    want_ids, want_len = (np.asarray(x) for x in jserving.build_inference_fn(
        jtask, jctc_task, params, beam_width=1)(jnp.asarray(waves), jnp.asarray(lens)))
    got_ids, got_len = build_inference_fn(task, model)(waves, lens)
    assert got_ids.dtype == torch.int32 and got_ids.shape == want_ids.shape
    np.testing.assert_array_equal(got_len.numpy(), want_len)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert int(got_len.sum()) > 0  # the comparison decoded something


def test_micro_batcher_concurrent_submits():
    _, task, _, model = _bridged(seed=2, units=16, layers=1)
    infer = build_inference_fn(task, model)
    waves, lens = _waves(7, seed=3)
    batcher = MicroBatcher(infer, 3, (NUM,), max_wait_ms=50.0)
    results = [None] * 7
    try:
        def worker(i):
            results[i] = batcher.submit(waves[i], int(lens[i]))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        with pytest.raises(ValueError, match="row shape"):
            batcher.submit(waves[0][:-1], NUM)
    finally:
        batcher.stop()
    assert 3 <= batcher.batches_run <= 7  # 7 requests in batches of <= 3
    want_ids, want_len = infer(waves, lens)
    for i, (ids, n) in enumerate(results):
        assert n == int(want_len[i])
        np.testing.assert_array_equal(ids, want_ids[i].numpy())


def test_http_server_end_to_end():
    _, task, _, model = _bridged(seed=4, num_classes=6, units=16, layers=1)
    units = ["aa", "bb", "cc", "dd", "ee", "ff"]
    server = make_server(task, model, 2, NUM, port=0, max_wait_ms=5.0,
                         units=units, label_type="phone61")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok" and health["batch_size"] == 2
        assert health["num_samples"] == NUM and health["blank_id"] == 6

        wav = (np.random.RandomState(5).randn(3000) * 0.3).astype(np.float32)
        conn.request("POST", "/recognize", json.dumps({"audio": wav.tolist()}),
                     {"Content-Type": "application/json"})
        r1 = json.loads(conn.getresponse().read())
        conn.request("POST", "/recognize", wav.tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r2 = json.loads(conn.getresponse().read())
        assert r1 == r2
        want_ids, want_len = build_inference_fn(task, model)(
            np.tile(np.pad(wav, (0, NUM - 3000)), (2, 1)), np.full((2,), 3000, np.int32))
        assert r1["num_ids"] == int(want_len[0])
        assert r1["ids"] == want_ids[0, : int(want_len[0])].tolist()
        assert r1["text"] == " ".join(units[i] for i in r1["ids"])

        conn.request("POST", "/recognize", np.zeros(NUM + 10, np.float32).tobytes(),
                     {"Content-Type": "application/octet-stream"})
        r3 = json.loads(conn.getresponse().read())
        assert r3["truncated"] is True and r3["consumed"] == NUM

        conn.request("POST", "/recognize", json.dumps({"audio": [[1.0], [2.0]]}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400 and "error" in json.loads(resp.read())
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()


@pytest.mark.parametrize("name", ["ls100_ctc", "timit_ctc_blstm"])
def test_yaml_configs_match_jax(name):
    from tensorflow_end2end_speech_recognition_tpu.data.tokenizers import build_tokenizer
    from tensorflow_end2end_speech_recognition_tpu.train.loop import build_ctc_task
    from tensorflow_end2end_speech_recognition_tpu.utils.config import ExperimentConfig

    path = REPO / "configs" / f"{name}.yml"
    exp = ExperimentConfig.from_yaml(str(path))
    tok = build_tokenizer(exp.label_type)
    want = build_ctc_task(exp, tok)
    task, units, label_type = load_task(path)
    assert units == list(tok.units) and label_type == exp.label_type
    assert tuple(task.frontend) == tuple(want.frontend)
    for f in ("num_stack", "num_skip", "splice", "input_dim"):
        assert getattr(task, f) == getattr(want, f), f
    for f in ("num_classes", "bottleneck_dim", "blank_id"):
        assert getattr(task.model, f) == getattr(want.model, f), f
    for f in EncoderConfig._fields + ("output_dim",):
        assert getattr(task.model.encoder, f) == getattr(want.model.encoder, f), f


def test_serve_loads_yaml_and_bridged_weights(tmp_path):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text("model_type: ctc\nlabel_type: character\ninput_size: 40\n"
                   "use_energy: false\nnum_stack: 3\nnum_skip: 3\nencoder_type: blstm\n"
                   "num_units: 16\nnum_layers: 1\nbatch_size: 32\nbeam_width: 20\n")
    task, units, label_type = load_task(cfg)
    src = init_model(task, torch.Generator().manual_seed(0))
    save_weights(tmp_path / "w.npz", src.state_dict())
    task2, model, units2, _ = load_model(cfg, tmp_path / "w.npz", torch.device("cpu"))
    assert task2 == task and units2 == units and len(units) == 28
    for k, v in src.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, atol=0, rtol=0)
    cfg.write_text(cfg.read_text() + "no_such_key: 1\n")
    with pytest.raises(KeyError, match="no_such_key"):
        load_task(cfg)


def test_port_imports_no_jax():
    """Every port module and chip_smoke.py import with jax made unimportable."""
    code = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "tensorflow_end2end_speech_recognition_tpu"):
            raise ImportError(f"port imported {name}")
        return None

sys.meta_path.insert(0, Block())
import tensorflow_end2end_speech_recognition_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
# the card machine has none of these either
assert not any(m.split(".")[0] in ("optax", "orbax", "Levenshtein") for m in sys.modules)
for want in ("bin.train", "train.loop", "train.checkpoint", "train.optimizer", "ops.ctc",
             "data.dataset", "utils.metrics"):
    assert pkg.__name__ + "." + want in names, want
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 30
