"""The port's tools on the CPU: the C++ host runtime, profiling, plotting, and
the CLIs on a scan-path (BGRU) model.

- ``data/native.py`` builds ``csrc/asr_native.cpp`` with the host compiler
  into the package's ``_build/`` and runs it: ``batch_assemble`` and
  ``levenshtein_batch`` give exactly the bits of the JAX package's numpy /
  Python fallbacks and of the port's own fallbacks;
- ``fit(profile_steps=(1, 2))`` writes a Chrome trace, and ``fit`` writes the
  loss and error-rate curves;
- ``bin/train --profile`` -> ``bin/plot`` -> ``bin/eval`` -> ``bin/decode``
  -> ``bin/export`` on a tiny BGRU config, the artifact's ids equal to the
  restored model's in-process serving.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.data import native as jnative
from tensorflow_end2end_speech_recognition_tpu_torch import serving
from tensorflow_end2end_speech_recognition_tpu_torch.bin import decode as decode_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import export as export_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import plot as plot_cli
from tensorflow_end2end_speech_recognition_tpu_torch.bin import train as train_cli
from tensorflow_end2end_speech_recognition_tpu_torch.data import native
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit
from tensorflow_end2end_speech_recognition_tpu_torch.utils import edit_distance
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict
from tensorflow_end2end_speech_recognition_tpu_torch.utils.plot import (
    plot_attention_weights,
    plot_ctc_posteriors,
)

torch.set_num_threads(1)

TINY_BGRU = dict(model_type="ctc", corpus="toy", label_type="character", input_size=12,
                 use_energy=False, use_delta=True, num_stack=3, num_skip=3,
                 encoder_type="bgru", num_units=8, num_layers=2, dropout=1.0, batch_size=4,
                 num_epoch=1, optimizer="adam", learning_rate=1e-3, clip_grad_norm=5.0,
                 sort_utt=True, toy_num_utts=16, toy_max_units=4)


@pytest.fixture
def jax_fallback(monkeypatch):
    """The JAX package's module with its library refused: its numpy / Python paths."""
    monkeypatch.setattr(jnative, "_LIB", False)
    return jnative


def _port_fallback(monkeypatch):
    monkeypatch.setattr(native, "_lib", lambda: None)


def _utterances(features: bool, seed: int) -> list:
    rng = np.random.RandomState(seed)
    lens = [37, 1, 20, 37, 5]
    return [rng.randn(n, 6).astype(np.float32) if features else rng.randn(n).astype(np.float32)
            for n in lens]


@pytest.mark.parametrize("features", [False, True], ids=["waveforms", "features"])
def test_batch_assemble_bits_equal_the_numpy_paths(features, jax_fallback, monkeypatch):
    assert native.have_native()
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR and lib.parent.name == "_build"
    utts = _utterances(features, 0)
    got, got_len = native.batch_assemble(utts, 48, n_threads=3)
    want, want_len = jax_fallback.batch_assemble(utts, 48)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(got_len, want_len)
    _port_fallback(monkeypatch)
    fallback, _ = native.batch_assemble(utts, 48)
    assert fallback.tobytes() == got.tobytes() and not native.have_native()
    with pytest.raises(ValueError, match="exceeds t_pad"):
        native.batch_assemble(utts, 36)


def test_levenshtein_batch_equals_the_python_paths(jax_fallback, monkeypatch):
    rng = np.random.RandomState(1)
    refs = [list(rng.randint(0, 5, n)) for n in (0, 3, 9, 14, 1, 7, 0)]
    hyps = [list(rng.randint(0, 5, n)) for n in (0, 0, 11, 6, 4, 7, 2)]
    got = native.levenshtein_batch(refs, hyps, n_threads=4)
    assert got.dtype == np.int32 and got.shape == (len(refs), 4)
    np.testing.assert_array_equal(got, jax_fallback.levenshtein_batch(refs, hyps))
    np.testing.assert_array_equal(got, edit_distance.levenshtein_batch(refs, hyps))
    np.testing.assert_array_equal(got[:, 0], got[:, 1:].sum(axis=1))  # S + I + D
    _port_fallback(monkeypatch)
    np.testing.assert_array_equal(native.levenshtein_batch(refs, hyps), got)


def test_fit_profiles_steps_and_plots_curves(tmp_path):
    lines = []
    fit(experiment_from_dict(TINY_BGRU), tmp_path, log_every=1, print_fn=lines.append,
        profile_steps=(1, 2), device="cpu")
    trace = tmp_path / "trace" / "train_steps_1-2.json"
    assert f"profiler trace written to {trace}" in lines
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    for png in ("loss.png", "ler.png"):
        assert (tmp_path / png).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert not any(s.startswith("plotting failed") for s in lines)


def test_plot_functions_write_pngs(tmp_path):
    post = np.random.RandomState(2).dirichlet(np.ones(5), size=30)
    assert plot_ctc_posteriors(post, tmp_path / "p.png", unit_names=list("abcd")).exists()
    w = np.random.RandomState(3).rand(6, 20)
    assert plot_attention_weights(w, tmp_path / "a.png", hyp_tokens=list("hello!")).exists()


def test_cli_train_profile_plot_eval_decode_export(tmp_path, capsys):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in TINY_BGRU.items()))
    model_dir = tmp_path / "m"
    summary = train_cli.main([str(cfg), str(model_dir), "--device", "cpu", "--profile"])
    assert summary["epochs"] == 1 and np.isfinite(summary["dev_loss"])
    assert (model_dir / "trace" / "train_steps_2-5.json").exists()
    made = plot_cli.main([str(model_dir), "--device", "cpu", "--utt-index", "0"])
    assert {Path(p).name for p in made} == {"loss.png", "ler.png", "ctc_probs_utt0.png"}
    with pytest.raises(SystemExit, match="out of range"):
        plot_cli.main([str(model_dir), "--device", "cpu", "--utt-index", "99"])
    results = eval_cli.main([str(model_dir), "--device", "cpu"])
    assert set(results) == {"dev", "test"} and results["dev"]["num_utts"] > 0
    decode_cli.main([str(model_dir), "--device", "cpu", "--num-utts", "2"])
    art = tmp_path / "m.art"
    export_cli.main([str(model_dir), str(art), "--batch", "2", "--seconds", "1.5",
                     "--device", "cpu", "--selfcheck"])
    meta = json.loads(Path(f"{art}.json").read_text())
    assert meta["experiment"]["encoder_type"] == "bgru" and meta["platforms"] == ["cpu"]
    rng = np.random.RandomState(4)
    wav = (rng.randn(2, 24000) * 0.1).astype(np.float32)
    lens = np.asarray([24000, 9000], np.int32)
    ids, n = serving.load_exported(art, device="cpu")(wav, lens)
    _, model = eval_cli.restore_model(model_dir, *_task_of(model_dir), None, "cpu")
    want_ids, want_n = serving.build_inference_fn(_task_of(model_dir)[0], model)(wav, lens)
    assert torch.equal(ids, want_ids) and torch.equal(n, want_n)
    capsys.readouterr()


def _task_of(model_dir: Path):
    from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import (
        build_corpus_splits,
        build_task,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import ExperimentConfig

    exp = ExperimentConfig.from_yaml(model_dir / "config.yml")
    _, _, _, tokenizer = build_corpus_splits(exp, need=())
    return build_task(exp, tokenizer)
