"""The port's exported artifacts (``serving.export_model`` / ``load_exported``,
``export_streaming_model`` / ``load_streaming``, ``bin/export`` and
``bin/serve ARTIFACT``) against the port's in-process serving and the JAX
package, on the CPU.

- A loaded artifact's ids and lengths equal the in-process
  ``build_inference_fn``'s bit for bit, and the JAX ``build_inference_fn``'s
  on the same weights (``utils/bridge.py``): CTC greedy, the CTC prefix beam
  with an RNN-LM, the transducer, the attention beam, and a features-mode
  (``feature_dim``) CTC model; the transducer and attention branches in
  features mode against in-process serving.
- The contract: one JAX ``export_model`` round trip whose contract keys
  and values equal the port's, apart from ``platforms`` and the port's own
  keys; JAX ``export_streaming_model``'s ``frames_per_chunk`` and
  ``final_flush`` for a stacked CTC model and a transducer.
- A streaming artifact's steps and ``finalize`` equal ``build_streaming_fn``'s
  bit for bit, and it serves over the session API.
- ``bin/prepare`` -> ``bin/train`` -> ``bin/export --selfcheck`` ->
  ``bin/serve ARTIFACT`` over HTTP for a ``data_root`` word model, with the
  corpus and the model dir removed before serving: ``/healthz``, features
  requests (JSON and raw float32), the truncation flag.
- What raises: a device type the artifact was not exported for, a streaming
  artifact given to ``load_exported`` (and a batch one to
  ``load_streaming``), ``--streaming`` on a features model (in the CLI
  test).

Toy sizes: B <= 4, H = 8, at most 2 layers.
"""

import http.client
import json
import shutil
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import serving as jserving
from tensorflow_end2end_speech_recognition_tpu.models import lm as jlm
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.utils import jax_setup
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch import serving, streaming
from tensorflow_end2end_speech_recognition_tpu_torch.bin import export as export_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import prepare
from tensorflow_end2end_speech_recognition_tpu_torch.bin import serve as serve_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin.eval import restore_model
from tensorflow_end2end_speech_recognition_tpu_torch.data.toy_corpus import ToyCorpus
from tensorflow_end2end_speech_recognition_tpu_torch.models.lm import RNNLM, LMConfig
from tensorflow_end2end_speech_recognition_tpu_torch.train import loop
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_to_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    ExperimentConfig,
    experiment_from_dict,
)

torch.set_num_threads(1)

SR = 16000
NUM = 4000  # padded samples: 24 frames
C = 6
UNITS = [f"u{i}" for i in range(C)]
FRAMES, FEAT_DIM = 20, 6  # features mode: [B, 20, 6]
LM_WEIGHT = 0.3
BASE = dict(corpus="toy", label_type="word", input_size=8, use_energy=False, use_delta=False,
            cmvn="none", num_units=8, num_layers=2, dropout=1.0, batch_size=4)
CONFIGS = {  # name -> (raw config, beam width, with an LM, features mode)
    "ctc_greedy": (dict(BASE, model_type="ctc", encoder_type="blstm"), 1, False, False),
    "ctc_beam_lm": (dict(BASE, model_type="ctc", encoder_type="blstm"), 3, True, False),
    "transducer": (dict(BASE, model_type="transducer", encoder_type="lstm", num_stack=3,
                        num_skip=3, pred_num_units=8, embedding_dim=4, joint_dim=8,
                        max_symbols_per_frame=2), 1, False, False),
    "attention_beam": (dict(BASE, model_type="attention", encoder_type="blstm", num_layers=1,
                            attention_type="location", attention_dim=8, decoder_num_units=8,
                            embedding_dim=4, max_decode_length=6), 3, False, False),
    "features_ctc": (dict(BASE, model_type="ctc", encoder_type="blstm", num_stack=2,
                          num_skip=2), 1, False, True),
}
# contract keys the port writes beyond the JAX contract's
PORT_KEYS = {"format", "experiment", "num_classes", "lm_config", "top_k_classes",
             "max_prefix_len"}


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    # JAX's entry points turn on a persistent compile cache under HOME
    monkeypatch.setattr(jax_setup, "setup", lambda *a, **k: None)


def _tasks(raw: dict, features: bool):
    """(port task, task module, experiment), (JAX task, task module) of ``raw``."""
    feature_dim = FEAT_DIM if features else None
    exp = experiment_from_dict(raw)
    task, mod = loop.build_task(exp, SimpleNamespace(num_units=C), feature_dim)
    jtask, jmod = jloop.build_task(JExperimentConfig.from_dict(raw),
                                   SimpleNamespace(num_units=C), feature_dim)
    return (task, mod, exp), (jtask, jmod)


def _lm(seed: int = 5):
    return RNNLM(LMConfig(vocab=C + 2, num_units=8, embedding_dim=4),
                 torch.Generator().manual_seed(seed)).eval()


def _inputs(features: bool, seed: int = 0):
    rng = np.random.RandomState(seed)
    if features:
        x = rng.randn(3, FRAMES, FEAT_DIM).astype(np.float32)
        lens = np.asarray([FRAMES, 13, 0], np.int32)
    else:
        x = (rng.randn(3, NUM) * 0.3).astype(np.float32)
        lens = np.asarray([NUM, 2500, 0], np.int32)
    for r, n in enumerate(lens):
        x[r, n:] = 0.0
    return x, lens


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (port task, model, lm, in-process (ids, lens), artifact path, inputs)."""
    root = tmp_path_factory.mktemp("art")
    out = {}
    for name, (raw, beam, with_lm, features) in CONFIGS.items():
        (task, mod, exp), _ = _tasks(raw, features)
        model = mod.init_model(task, torch.Generator().manual_seed(1)).eval()
        lm = _lm() if with_lm else None
        x, lens = _inputs(features)
        want = serving.build_inference_fn(task, model, beam, lm, LM_WEIGHT if lm else 0.0)(
            x, lens)
        path = serving.export_model(
            task, model, root / f"{name}.art", 4, FRAMES if features else NUM,
            beam_width=beam, units=UNITS, label_type="word", experiment=exp,
            platforms=("cpu",), lm=lm, lm_weight=LM_WEIGHT if lm else 0.0)
        out[name] = (task, model, lm, want, path, (x, lens))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_equals_in_process_serving(exported, name):
    _, _, _, (want_ids, want_len), path, (x, lens) = exported[name]
    ids, n = serving.load_exported(path, device="cpu")(x, lens)
    assert torch.equal(ids, want_ids) and torch.equal(n, want_len)
    assert ids.dtype == want_ids.dtype and int(n[2]) == 0
    if name != "attention_beam":  # a zero-length row decodes nothing; attention stops at eos
        assert int(n[0]) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifact_ids_equal_jax_serving(exported, name):
    raw, beam, with_lm, features = CONFIGS[name]
    task, model, lm, (ids, n), _, (x, lens) = exported[name]
    _, (jtask, jmod) = _tasks(raw, features)
    params = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))
    jlm_pair = None
    if lm is not None:
        jlm_pair = (jax.tree.map(jnp.asarray, params_to_jax(lm.state_dict())),
                    jlm.LMConfig(vocab=C + 2, num_units=8, embedding_dim=4))
    want_ids, want_len = (np.asarray(v) for v in jserving.build_inference_fn(
        jtask, jmod, params, beam, jlm_pair, LM_WEIGHT if lm else 0.0)(
            jnp.asarray(x), jnp.asarray(lens)))
    np.testing.assert_array_equal(n.numpy(), want_len)
    for r in range(len(lens)):
        np.testing.assert_array_equal(ids[r, : int(n[r])].numpy(), want_ids[r, : want_len[r]])


@pytest.mark.parametrize("name", ["transducer", "attention_beam"])
def test_features_mode_artifacts_of_the_other_branches(name, tmp_path):
    """The transducer and attention branches on [B, T, feature_dim] frames: a
    features-mode artifact (``input_rank`` 3) serves as in process."""
    raw, beam, _, _ = CONFIGS[name]
    (task, mod, exp), _ = _tasks(raw, True)
    assert task.frontend is None and task.feature_dim == FEAT_DIM
    model = mod.init_model(task, torch.Generator().manual_seed(6)).eval()
    x, lens = _inputs(True, seed=6)
    want_ids, want_n = serving.build_inference_fn(task, model, beam)(x, lens)
    path = serving.export_model(task, model, tmp_path / "f.art", 4, FRAMES, beam_width=beam,
                                units=UNITS, experiment=exp, platforms=("cpu",))
    assert json.loads(path.with_suffix(".art.json").read_text())["input_rank"] == 3
    ids, n = serving.load_exported(path, "cpu")(x, lens)
    assert torch.equal(ids, want_ids) and torch.equal(n, want_n)


def test_contract_equals_the_jax_export(exported, tmp_path):
    """One JAX ``export_model`` round trip (CTC greedy): every key both
    contracts have holds the same value, ``platforms`` apart."""
    raw, beam, _, _ = CONFIGS["ctc_greedy"]
    _, model, _, _, path, (x, lens) = exported["ctc_greedy"]
    _, (jtask, jmod) = _tasks(raw, False)
    params = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))
    extra = {"label_type": "word", "model_type": "ctc", "sample_rate": SR}
    jpath = jserving.export_model(jtask, jmod, params, tmp_path / "m.shlo", 4, NUM,
                                  beam_width=beam, tokenizer=SimpleNamespace(units=UNITS),
                                  platforms=("cpu",), extra_meta=extra)
    want = json.loads(jpath.with_suffix(".shlo.json").read_text())
    ids, n = jserving.load_exported(jpath)(np.pad(x, ((0, 1), (0, 0))), np.pad(lens, (0, 1)))
    port = serving.export_model(exported["ctc_greedy"][0], model, tmp_path / "m.art", 4, NUM,
                                beam_width=beam, units=UNITS, label_type="word",
                                experiment=experiment_from_dict(raw), platforms=("cpu",),
                                extra_meta=extra)
    got = json.loads(port.with_suffix(".art.json").read_text())
    assert set(want) - set(got) == set()
    assert set(got) - set(want) <= PORT_KEYS
    for k in set(want) - {"platforms"}:
        assert got[k] == want[k], k
    assert got["platforms"] == ["cpu"] and want["platforms"] == ["cpu"]
    # the JAX artifact decodes as the port's does on the same weights
    got_ids, got_n = serving.load_exported(port, "cpu")(x, lens)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n)[:3])


STREAM_RAW = {
    "stacked_ctc": dict(BASE, model_type="ctc", encoder_type="lstm", num_stack=3, num_skip=3),
    "transducer": CONFIGS["transducer"][0],
}


@pytest.mark.parametrize("name", list(STREAM_RAW))
def test_streaming_contract_equals_the_jax_export(name, tmp_path):
    raw = STREAM_RAW[name]
    (task, mod, exp), (jtask, jmod) = _tasks(raw, False)
    model = mod.init_model(task, torch.Generator().manual_seed(2)).eval()
    params = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))
    jpath = jserving.export_streaming_model(jtask, params, tmp_path / "s.shlo", 2, 1600,
                                            platforms=("cpu",))
    want = json.loads(jpath.with_suffix(".shlo.json").read_text())
    path = serving.export_streaming_model(task, model, tmp_path / "s.art", 2, 1600,
                                          experiment=exp, platforms=("cpu",))
    got = json.loads(path.with_suffix(".art.json").read_text())
    for k in ("streaming", "batch_size", "chunk_samples", "frames_per_chunk", "beam_width",
              "final_flush", "blank_id", "units"):
        assert got[k] == want[k], k
    assert got["final_flush"] is True
    # the JAX loader's state and sidecar exist only because it has no model code
    assert "state_leaves" not in got and not path.with_suffix(".art.final").exists()


def _drive(state, step, wav, lens, chunk):
    toks = []
    for i in range(-(-int(max(lens)) // chunk) + 1):
        cl = np.clip(lens - i * chunk, 0, chunk).astype(np.int32)
        if i * chunk >= max(lens):
            cl = np.where(lens % chunk == 0, -1, 0).astype(np.int32)
        piece = np.zeros((len(lens), chunk), np.float32)
        seg = wav[:, i * chunk: (i + 1) * chunk]
        piece[:, : seg.shape[1]] = seg
        state, tok, n = step(state, piece, cl)
        toks.append((tok.clone(), n.clone()))
    return state, toks


def test_streaming_artifact_equals_build_streaming_fn(tmp_path):
    """A stacked LSTM CTC stream at beam 3 with an RNN-LM: every chunk's tokens
    and the finalized beam equal the in-process step's, bit for bit."""
    raw = STREAM_RAW["stacked_ctc"]
    (task, mod, exp), _ = _tasks(raw, False)
    model = mod.init_model(task, torch.Generator().manual_seed(3)).eval()
    lm = _lm(6)
    chunk = 640
    path = serving.export_streaming_model(task, model, tmp_path / "s.art", 3, chunk,
                                          units=UNITS, label_type="word", experiment=exp,
                                          platforms=("cpu",), beam_width=3, lm=lm,
                                          lm_weight=LM_WEIGHT)
    meta = json.loads(path.with_suffix(".art.json").read_text())
    assert meta["lm_config"] == lm.cfg._asdict() and meta["lm_weight"] == LM_WEIGHT
    fns = streaming.build_streaming_fn(task, model, chunk, beam_width=3, lm=lm,
                                       lm_weight=LM_WEIGHT)
    state0, step, finalize = serving.load_streaming(path, device="cpu")
    wav = (np.random.RandomState(7).randn(3, 4000) * 0.3).astype(np.float32)
    lens = np.asarray([4000, 4 * chunk, 900])
    got_state, got = _drive(state0, step, wav, lens, chunk)
    want_state, want = _drive(fns[0](3), fns[1], wav, lens, chunk)
    for (t, n), (wt, wn) in zip(got, want):
        assert torch.equal(t, wt) and torch.equal(n, wn)
    for a, b in zip(finalize(got_state), fns[2](want_state)):
        assert torch.equal(a, b)


def test_streaming_artifact_serves_sessions(tmp_path):
    """``bin/serve ARTIFACT`` of a greedy streaming artifact: the session API
    gives the tokens the step gives."""
    raw = dict(BASE, model_type="ctc", encoder_type="lstm")
    (task, mod, exp), _ = _tasks(raw, False)
    model = mod.init_model(task, torch.Generator().manual_seed(4)).eval()
    path = serving.export_streaming_model(task, model, tmp_path / "g.art", 2, 640,
                                          units=UNITS, label_type="word", experiment=exp,
                                          platforms=("cpu",))
    wav = (np.random.RandomState(8).randn(1, 2560) * 0.3).astype(np.float32)
    fns = streaming.build_streaming_fn(task, model, 640)
    want = []
    for t, n in _drive(fns[0](1), fns[1], wav, np.asarray([2560]), 640)[1]:
        want += t[0, : int(n[0])].tolist()
    server = serve_cli.make_artifact_server(path, "cpu", max_wait_ms=1.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def post(p, body=b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", p, body, {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    try:
        status, start = post("/stream/start")
        assert status == 200 and start["chunk_samples"] == 640
        sid, got = start["session"], []
        for k in range(4):
            status, body = post(f"/stream/audio?session={sid}",
                                wav[0, k * 640: (k + 1) * 640].tobytes())
            assert status == 200
            got += body["ids"]
        status, body = post(f"/stream/end?session={sid}")
        assert status == 200 and "final" not in body
        got += body["ids"]
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    assert got == want


# ---- bin/prepare -> bin/train -> bin/export -> bin/serve ARTIFACT ------------------


@pytest.fixture(scope="module")
def data_root_model(tmp_path_factory):
    """A tiny word-unit CTC model trained by bin/train from a prepared corpus."""
    import wave

    root = tmp_path_factory.mktemp("corpus")
    utts = ToyCorpus(label_type="character", num_utts=16, max_units=3, seed=9).utterances
    for split, us in (("train", utts[:10]), ("dev_clean", utts[10:13]),
                      ("test_clean", utts[13:])):
        lines = []
        for u in us:
            wav = root / f"{u.name}.wav"
            with wave.open(str(wav), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes((np.clip(u.wav * 0.5, -1, 1) * 32767).astype(np.int16).tobytes())
            lines.append(f"{u.name}\t{wav}\t{u.text}")
        (root / f"{split}.scp").write_text("\n".join(lines) + "\n")
        prepare.main([str(root / "data"), split, "--wav-scp", str(root / f"{split}.scp"),
                      "--input-size", "8", "--no-energy", "--device", "cpu"])
    raw = dict(BASE, model_type="ctc", encoder_type="blstm", num_layers=1, num_epoch=1,
               data_root=str(root / "data"), cmvn="utterance", num_stack=2, num_skip=2)
    cfg = root / "tiny.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in raw.items()))
    train_cli.main([str(cfg), str(root / "m"), "--device", "cpu"])
    return root, raw


def test_cli_export_then_serve_a_data_root_model(data_root_model, tmp_path, capsys):
    root, raw = data_root_model
    model_dir, out = root / "m", tmp_path / "w.art"
    export_cli.main([str(model_dir), str(out), "--batch", "4", "--frames", "60",
                     "--selfcheck", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert any(s.startswith("exported epoch-0 ctc/blstm beam 1 -> ") for s in lines), lines
    assert "selfcheck ok: decoded (4, 30), lengths" in lines[-1], lines
    meta = json.loads(out.with_suffix(".art.json").read_text())
    assert meta["input_rank"] == 3 and meta["num_samples"] == 60 and meta["platforms"] == ["cpu"]
    units = meta["units"]
    assert units == loop.build_corpus_splits(ExperimentConfig.from_dict(raw), need=())[3].units
    # the requests: dev features as prepared, one longer than the artifact's 60 frames
    feats_dir = root / "data" / "dev_clean" / "feats"
    feats = [np.load(f) for f in sorted(feats_dir.glob("*.npy"))]
    feats.append(np.concatenate([feats[0]] * (61 // len(feats[0]) + 1))[:75])
    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    task, mod = loop.build_task(exp, SimpleNamespace(num_units=len(units)), feats[0].shape[1])
    _, model = restore_model(model_dir, task, mod, None, torch.device("cpu"))
    infer = serving.build_inference_fn(task, model)
    want = []
    for f in feats:
        row = np.zeros((1, 60, f.shape[1]), np.float32)
        n = min(len(f), 60)
        row[0, :n] = f[:n]
        ids, k = infer(row, np.asarray([n]))
        want.append(ids[0, : int(k[0])].tolist())
    with pytest.raises(SystemExit, match="needs the waveform frontend"):
        export_cli.main([str(model_dir), str(tmp_path / "s.art"), "--streaming",
                         "--device", "cpu"])
    shutil.rmtree(root / "data")  # the corpus, and the model dir, are gone
    shutil.rmtree(model_dir)
    server = serve_cli.make_artifact_server(out, "cpu", max_wait_ms=20.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def request(method, path, body=None, ctype="application/json"):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request(method, path, body, {"Content-Type": ctype})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    try:
        status, health = request("GET", "/healthz")
        assert status == 200 and health["input_rank"] == 3 and health["device"] == "cpu"
        got = [request("POST", "/recognize", json.dumps({"features": f.tolist()}))
               for f in feats]
        raw_bytes = request("POST", "/recognize", feats[1].astype(np.float32).tobytes(),
                            "application/octet-stream")
        bad = request("POST", "/recognize", json.dumps({"features": feats[0][0].tolist()}))
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()
    for (status, body), w in zip(got, want):
        assert status == 200 and body["ids"] == w and body["num_ids"] == len(w)
        assert body["text"] == " ".join(units[i] for i in w)
    assert got[-1][1]["truncated"] is True and got[-1][1]["consumed"] == 60
    assert not any("truncated" in body for _, body in got[:-1])
    assert raw_bytes[0] == 200 and raw_bytes[1]["ids"] == want[1]
    assert bad[0] == 400 and "rank" in bad[1]["error"]


# ---- what raises ----------------------------------------------------------------


def test_what_raises(exported, tmp_path):
    task, model, _, _, path, _ = exported["ctc_greedy"]
    exp = experiment_from_dict(CONFIGS["ctc_greedy"][0])
    cuda_only = serving.export_model(task, model, tmp_path / "c.art", 2, NUM, units=UNITS,
                                     experiment=exp)
    assert json.loads(cuda_only.with_suffix(".art.json").read_text())["platforms"] == ["cuda"]
    with pytest.raises(ValueError, match=r"exported for \['cuda'\], not cpu"):
        serving.load_exported(cuda_only, device="cpu")
    (stask, smod, sexp), _ = _tasks(STREAM_RAW["stacked_ctc"], False)
    stream_path = serving.export_streaming_model(
        stask, smod.init_model(stask), tmp_path / "s.art", 2, 640, experiment=sexp,
        platforms=("cpu",))
    with pytest.raises(ValueError, match="is a streaming artifact"):
        serving.load_exported(stream_path, device="cpu")
    with pytest.raises(ValueError, match="is not a streaming artifact"):
        serving.load_streaming(path, device="cpu")
    with pytest.raises(ValueError, match="experiment config"):
        serving.export_model(task, model, tmp_path / "x.art", 2, NUM)
