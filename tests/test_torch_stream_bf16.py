"""Streaming at ``compute_dtype: bfloat16`` in the port, against the JAX package, on the CPU.

A streaming chunk at bf16 takes the reference's scan branch of ``rnn_scan``
(``models/rnn.py`` ``_lstm_step``): a float32 ``xproj``, each step's
``h @ Wh`` on bf16 operands with float32 sums, float32 streams and carries.
The port runs it as kernel #3's carried walk with bf16 products
(``lstm_layer(..., bf16_product=True)``; on the CPU its plain version). The
chunk-causal conformer takes the JAX chunk step's ``dt`` casts.

- The plain bf16-product carried walk against ``rnn_scan`` at bf16 from a
  non-zero state, with lengths 0..T: ``ys``, ``hT`` and ``cT`` within 1e-5
  of each tensor's largest entry (bf16 x bf16 products are exact in float32,
  so the two differ only in the order of their float32 sums).
- ``build_streaming_fn`` at bf16 on shrunk copies of
  ``configs/ls_streaming_ctc.yml``, ``ls_transducer.yml``,
  ``ls_streaming_conformer.yml`` and ``ls_conformer_transducer.yml``
  against the JAX ``build_streaming_fn`` chunk by chunk: the encoder's
  chunk outputs within ``ENC_ATOL`` of their largest entry, and where the
  head's top-two margin exceeds ``ENC_ATOL`` the frames' argmax ids equal;
  the streamed tokens equal (no frame of these seeds is that close). The
  streaming is not compared with offline bf16 decoding: the offline path
  rounds its streams to bf16, the chunk does not.
- A bf16 streaming artifact (``serving.export_streaming_model`` /
  ``load_streaming``) round trip, bit for bit.

Toy sizes: B = 3, H = 16, 2 layers, chunks of 4 hops.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tensorflow_end2end_speech_recognition_tpu import streaming as jstreaming
from tensorflow_end2end_speech_recognition_tpu.models import ctc as jctc_model
from tensorflow_end2end_speech_recognition_tpu.models import rnn as jrnn
from tensorflow_end2end_speech_recognition_tpu.models import transducer as jtransducer
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch import serving, streaming
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import LSTM
from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm
from tensorflow_end2end_speech_recognition_tpu_torch.train import loop
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict
from test_torch_streaming import CHUNK, WAV_LEN, assert_same_chunks, drive, waves

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CARRY_RTOL = 1e-5  # of each tensor's largest entry: float32 sums in other orders
# the encoder's chunk outputs, of their largest entry (seen: 2.9e-7 to 4.1e-7; the
# float32 walk in the LSTM configs moves them 2.7e-4 to 4.8e-4 and float32 score
# and context products in the conformers 9.9e-3)
ENC_ATOL = 1e-5
C = 6
# the YAMLs' widths cut to toy size (the keys each YAML has)
SHRINK = {"num_units": 16, "num_layers": 2, "num_heads": 2, "conv_kernel_size": 5,
          "left_context": 4, "pred_num_units": 8, "embedding_dim": 4, "joint_dim": 16}
STREAM_CONFIGS = ("ls_streaming_ctc", "ls_transducer", "ls_streaming_conformer",
                  "ls_conformer_transducer")


def _raw(name: str) -> dict:
    raw = yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text())
    return dict(raw, **{k: v for k, v in SHRINK.items() if k in raw},
                compute_dtype="bfloat16")


def _pair(name: str, seed: int = 0):
    """JAX (task, params) and the port's (task, model) of a shrunk bf16 config,
    on the same (bridged) weights."""
    raw = _raw(name)
    jtask, jmod = jloop.build_task(JExperimentConfig.from_dict(raw), SimpleNamespace(num_units=C))
    task, mod = loop.build_task(experiment_from_dict(raw), SimpleNamespace(num_units=C))
    assert task.model.encoder.compute_dtype == "bfloat16"
    params = jmod.init_params(jax.random.PRNGKey(seed), jtask)
    model = mod.init_model(task)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return raw, (jtask, params), (task, model.eval())


# ---- the carried walk with bf16 products ---------------------------------------


@pytest.mark.parametrize("t,h", [(6, 8), (10, 32)])
def test_bf16_product_walk_matches_jax_scan(t, h):
    """The plain version, and ``LSTM`` with a carried state at bf16, from a
    non-zero (h0, c0), with every row length 0..T."""
    rng = np.random.RandomState(t)
    b, d = t + 1, 5
    spec = jrnn.RNNSpec(cell="lstm", num_units=h, impl="scan", compute_dtype="bfloat16")
    jparams = jrnn.init_rnn_params(jax.random.PRNGKey(h), spec, d)
    xs = rng.randn(b, t, d).astype(np.float32)
    lengths = np.arange(b, dtype=np.int32)  # 0 .. T
    h0, c0 = (rng.randn(b, h).astype(np.float32) * 0.5 for _ in range(2))
    want = jrnn.rnn_scan(jparams, spec, jnp.asarray(xs), jnp.asarray(lengths),
                         initial_state=(jnp.asarray(h0), jnp.asarray(c0)))
    want = [np.asarray(x) for x in (want[0], *want[1])]
    layer = LSTM(d, h, compute_dtype="bfloat16")
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), layer))
    state = (torch.from_numpy(h0), torch.from_numpy(c0))
    mask = (torch.arange(t)[None] < torch.from_numpy(lengths)[:, None]).float()
    with torch.no_grad():
        ys, (h_t, c_t) = layer(torch.from_numpy(xs), torch.from_numpy(lengths), state)
        xproj = torch.from_numpy(xs) @ layer.wx + layer.b
        p_ys, _, (p_h, p_c) = lstm.lstm_layer_fwd_plain(xproj, layer.wh, mask,
                                                         initial_state=state, bf16_product=True)
        f_ys, _, (f_h, f_c) = lstm.lstm_layer_fwd_plain(xproj, layer.wh, mask,
                                                         initial_state=state)
    for got in ((ys, h_t, c_t), (p_ys, p_h, p_c)):
        for g, w, what in zip(got, want, ("ys", "hT", "cT")):
            assert g.dtype == torch.float32, what
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=CARRY_RTOL * np.abs(w).max(), err_msg=what)
    # a row with no valid step gives back its state bit for bit
    assert torch.equal(h_t[0], state[0][0]) and torch.equal(c_t[0], state[1][0])
    # the mode is not the float32 walk: its bf16 products move ys past ten tolerances
    assert float((f_ys - p_ys).abs().max()) > 10 * CARRY_RTOL * np.abs(want[0]).max()


def test_bf16_product_needs_a_carried_state():
    xproj, wh, mask = torch.zeros(2, 3, 32), torch.zeros(8, 32), torch.ones(2, 3)
    with pytest.raises(ValueError, match="initial_state"):
        lstm.lstm_layer(xproj, wh, mask, bf16_product=True)
    with pytest.raises(ValueError, match="initial_state"):
        lstm.lstm_layer_fwd(xproj, wh, mask, bf16_product=True)


# ---- the four causal configs' chunk steps at bf16 --------------------------------


def _record_port(model, is_ctc):
    """Wrap the module that reads the encoder's chunk output: its inputs, in order."""
    seen = []
    target = model.head if is_ctc else model.enc_proj
    forward = target.forward

    def record(x):
        seen.append(x.clone())
        return forward(x)

    target.forward = record
    return seen


@pytest.fixture
def jax_recorder(monkeypatch):
    """Record the encoder's chunk outputs on the JAX side: the ``_affine`` calls
    on ``params["head"]`` (CTC) or ``params["enc_proj"]`` (transducer)."""
    seen = []

    def install(target):
        for mod in (jctc_model, jtransducer):
            orig = mod._affine

            def rec(p, x, orig=orig):
                if p is target:
                    seen.append(np.asarray(x))
                return orig(p, x)

            monkeypatch.setattr(mod, "_affine", rec)
        return seen

    return install


@pytest.mark.parametrize("name", STREAM_CONFIGS)
def test_bf16_chunk_step_matches_jax(name, jax_recorder):
    raw, (jtask, params), (task, model) = _pair(name)
    is_ctc = raw["model_type"] == "ctc"
    stacked = task.num_stack > 1
    jseen = jax_recorder(params["head"] if is_ctc else params["enc_proj"])
    pseen = _record_port(model, is_ctc)
    wav = waves(21)
    jfns = jstreaming.build_streaming_fn(jtask, params, CHUNK)  # eager: its encoder recorded
    _, want, want_rows = drive(lambda s, c, n: jfns[1](s, jnp.asarray(c), jnp.asarray(n)),
                               jfns[0](3), wav, WAV_LEN, stacked)
    fns = streaming.build_streaming_fn(task, model, CHUNK)
    before = lstm.lstm_layer.launches_bf16_product
    _, got, rows = drive(fns[1], fns[0](3), wav, WAV_LEN, stacked, lambda x: x.numpy())
    assert lstm.lstm_layer.launches_bf16_product == before  # the CPU takes the plain walk
    assert len(jseen) == len(pseen) == len(want)
    head = model.head if is_ctc else None
    for i, (j, p) in enumerate(zip(jseen, pseen)):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=ENC_ATOL * np.abs(j).max(),
                                   err_msg=f"chunk {i}")
        if head is not None:  # the frames' argmax where the top-two margin exceeds ENC_ATOL
            with torch.no_grad():
                logits = head(p).numpy()
                jlogits = head(torch.from_numpy(j.copy())).numpy()
            top2 = np.sort(jlogits, axis=-1)[..., -2:]
            clear = (top2[..., 1] - top2[..., 0]) > ENC_ATOL * np.abs(jlogits).max()
            np.testing.assert_array_equal(logits.argmax(-1)[clear], jlogits.argmax(-1)[clear])
    assert_same_chunks(got, want)
    assert rows == want_rows and any(rows)


def test_bf16_streaming_artifact_round_trip(tmp_path):
    raw, _, (task, model) = _pair("ls_transducer", seed=3)
    path = serving.export_streaming_model(task, model, tmp_path / "s.art", 3, CHUNK,
                                          experiment=experiment_from_dict(raw),
                                          platforms=("cpu",), beam_width=2)
    state0, step, finalize = serving.load_streaming(path, device="cpu")
    fns = streaming.build_streaming_fn(task, model, CHUNK, beam_width=2)
    wav = waves(22)
    got_state, got, _ = drive(step, state0, wav, WAV_LEN, True, lambda x: x.numpy())
    want_state, want, _ = drive(fns[1], fns[0](3), wav, WAV_LEN, True, lambda x: x.numpy())
    assert_same_chunks(got, want)
    for a, b in zip(finalize(got_state), fns[2](want_state)):
        assert torch.equal(a, b)
