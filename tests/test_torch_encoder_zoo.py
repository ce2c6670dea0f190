"""The encoder zoo's scan-path types and ``cnn_zhang`` against the JAX package,
on the CPU, through the encoder, the CTC task, the attention decoder,
streaming and export.

Both sides start from the same JAX-initialised weights (bridged) and take the
same seeded numpy inputs with ragged lengths. Dropout stays off (jax.random
cannot be replayed in torch). Tolerances, float32:

- encoder outputs, logits, streamed states: atol 1e-5 (a few recurrent
  layers, or 5x3 convolutions over up to 256 channels, summed in other
  orders than XLA's);
- CTC losses within 1e-5 relative, gradients within 1e-4 of each tensor's
  largest entry;
- the attention decoder's logits and alignments: atol 1e-4, as
  ``tests/test_torch_seq2seq.py``; decoded ids, streamed tokens and an
  exported model's ids exactly.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu import streaming as jstreaming
from tensorflow_end2end_speech_recognition_tpu.frontend import FrontendConfig as JFrontendConfig
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc_task
from tensorflow_end2end_speech_recognition_tpu_torch import serving, streaming
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.ctc_greedy import ctc_greedy_decode
from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import (
    Encoder,
    EncoderConfig,
    zhang_output_dim,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import ScanBiRNN, ScanRNN
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    Seq2SeqModel,
    greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops import attention, lstm
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import device_pipeline
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import build_task
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

ATOL, LOSS_RTOL, GRAD_REL, DEC_ATOL = 1e-5, 1e-5, 1e-4, 1e-4
H = 8
OPTS = dict(use_peephole=True, num_proj=6, clip_activation=0.5)
C = 6  # classes
CHUNK = 640  # 4 hops of 10 ms at 16 kHz


def _bridge(tree, model):
    return params_from_jax(jax.tree.map(np.asarray, tree), model)


# ---- each encoder type against apply_encoder --------------------------------------


ENCODER_CASES = {  # name -> (EncoderConfig fields, channels, frequency width)
    "bgru": (dict(encoder_type="bgru", num_layers=1), 1, 7),
    "gru": (dict(encoder_type="gru", num_layers=1), 1, 7),
    "blstm options": (dict(encoder_type="blstm", num_layers=1, **OPTS), 1, 7),
    "lstm peephole clip": (dict(encoder_type="lstm", num_layers=1, use_peephole=True,
                                clip_activation=0.5), 1, 7),
    "pyramidal_blstm options": (dict(encoder_type="pyramidal_blstm", num_layers=2, **OPTS),
                                1, 7),
    "vgg_blstm options": (dict(encoder_type="vgg_blstm", num_layers=1, **OPTS), 3, 7),
    "multitask_blstm options": (dict(encoder_type="multitask_blstm", num_layers=2,
                                     num_layers_sub=1, **OPTS), 1, 7),
    "cnn_zhang F=13": (dict(encoder_type="cnn_zhang", fc_units=(12, 10)), 3, 13),
    "cnn_zhang one channel F=7": (dict(encoder_type="cnn_zhang", fc_units=(9,),
                                       input_channels=1), 1, 7),
}


@pytest.mark.parametrize("case", sorted(ENCODER_CASES))
def test_encoder_matches_apply_encoder(case):
    kw, channels, freq = ENCODER_CASES[case]
    kw = dict(kw, num_units=H)
    if "input_channels" not in kw:
        kw["input_channels"] = channels
    jcfg, cfg = jencoders.EncoderConfig(**kw), EncoderConfig(**kw)
    d = channels * freq
    params = jencoders.init_encoder(jax.random.PRNGKey(3), jcfg, d)
    enc = Encoder(cfg, d)
    enc.load_state_dict(_bridge(params, enc))
    rng = np.random.RandomState(4)
    t = 13
    feats = rng.randn(3, t, d).astype(np.float32)
    lens = np.asarray([t, 1, 8], np.int32)
    feats[1, 1:] = 0.0
    want = jax.jit(lambda p, x, n: jencoders.apply_encoder(p, jcfg, x, n))(
        params, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got = enc(torch.from_numpy(feats), torch.from_numpy(lens))
    assert got.outputs.shape == want.outputs.shape
    assert got.outputs.shape[-1] == cfg.output_dim == jcfg.output_dim
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_allclose(got.outputs.numpy(), np.asarray(want.outputs), atol=ATOL, rtol=0)
    if cfg.is_multitask:
        np.testing.assert_allclose(got.sub_outputs.numpy(), np.asarray(want.sub_outputs),
                                   atol=ATOL, rtol=0)
    if cfg.is_cnn:
        assert params["fcs"][0]["w"].shape[0] == zhang_output_dim(d, cfg.input_channels)
        assert not hasattr(enc, "layers")
    else:
        layer = ScanBiRNN if cfg.bidirectional else ScanRNN
        assert all(isinstance(x, layer) for x in enc.layers)


# ---- the CTC task: loss and every gradient ----------------------------------------


FRONT = dict(num_mels=9, use_energy=False)  # 27 features with deltas


def _ctc_tasks(enc: dict, stack: int = 1):
    jtask = jctc_task.CTCTaskConfig(
        model=JCTCConfig(encoder=jencoders.EncoderConfig(**enc), num_classes=C),
        frontend=JFrontendConfig(**FRONT), num_stack=stack, num_skip=stack, weight_decay=1e-2)
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
        frontend=FrontendConfig(**FRONT), num_stack=stack, num_skip=stack, weight_decay=1e-2)
    return jtask, task


def _batch(seed: int, num: int = 3200):
    rng = np.random.RandomState(seed)
    wav = (rng.randn(3, num) * 0.1).astype(np.float32)
    input_len = np.asarray([num, 2400, 1200], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    labels = np.asarray([[0, 1, 1], [2, -1, -1], [3, 4, -1]], np.int32)
    return {"inputs": wav, "input_len": input_len, "labels": labels,
            "label_len": np.asarray([3, 1, 2], np.int32),
            "weight": np.asarray([1, 1, 0], np.float32)}


@pytest.mark.parametrize("enc,stack", [
    (dict(encoder_type="bgru", num_units=H, num_layers=1), 2),
    (dict(encoder_type="cnn_zhang", fc_units=(8,)), 1),
], ids=["bgru", "cnn_zhang"])
def test_ctc_loss_and_gradients_match_jax(enc, stack):
    jtask, task = _ctc_tasks(enc, stack)
    jparams = jctc_task.init_params(jax.random.PRNGKey(5), jtask)
    model = ctc_task.init_model(task)
    params = _bridge(jparams, model)
    batch = _batch(6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jctc_task.forward_loss(p, jtask, b, train=True), has_aux=True))(
            jparams, jb)
    want = _bridge(jgrads, model)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    before = (lstm.lstm_bidi.launches, lstm.lstm_layer.launches)
    loss, _ = ctc_task.forward_loss(leaves, task, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()}, True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert (lstm.lstm_bidi.launches, lstm.lstm_layer.launches) == before  # no walk
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for k, g in grads.items():
        w = want[k].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_REL * scale, rtol=0, err_msg=k)


# ---- attention: a pyramidal encoder with the options under the joint model ----------


def test_joint_attention_with_option_encoder_matches_jax():
    """ls960_joint's shape, narrowed: a pyramidal BLSTM with peephole, clip and
    projection under hybrid attention and the joint CTC head; greedy decode."""
    enc = dict(encoder_type="pyramidal_blstm", num_units=H, num_layers=2, **OPTS)
    att = dict(attention_type="hybrid", attention_dim=6, conv_num_channels=3, conv_width=5)
    common = dict(num_classes=5, decoder_num_units=8, embedding_dim=4, max_decode_length=12,
                  ctc_loss_weight=0.3)
    jcfg = jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**enc),
                                  attention=JAttentionConfig(**att), **common)
    cfg = Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att), **common)
    d = 7
    params = jseq2seq.init_seq2seq(jax.random.PRNGKey(8), jcfg, d)
    model = Seq2SeqModel(cfg, d)
    model.load_state_dict(_bridge(params, model))
    model.eval()
    rng = np.random.RandomState(9)
    feats = rng.randn(3, 18, d).astype(np.float32)
    lens = np.asarray([18, 11, 3], np.int32)
    want = jax.jit(lambda p, x, n: jseq2seq.greedy_decode(p, jcfg, x, n))(
        params, jnp.asarray(feats), jnp.asarray(lens))
    before = attention.location_attend.launches
    with torch.no_grad():
        got = greedy_decode(model, torch.from_numpy(feats), torch.from_numpy(lens))
    assert attention.location_attend.launches == before  # the CPU takes #7's plain version
    assert got.enc_out.shape[-1] == 2 * OPTS["num_proj"]
    np.testing.assert_array_equal(got.predicted_ids.numpy(), np.asarray(want.predicted_ids))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=DEC_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.attention_weights.numpy(),
                               np.asarray(want.attention_weights), atol=DEC_ATOL, rtol=0)
    np.testing.assert_allclose(got.ctc_logits.numpy(), np.asarray(want.ctc_logits), atol=ATOL,
                               rtol=0)


# ---- streaming: GRU and the option LSTM ---------------------------------------------


STREAM_FRONT = dict(use_energy=False, add_deltas=False, cmvn="none")
STREAM_ENCODERS = {
    "gru": dict(encoder_type="gru", num_units=16, num_layers=2),
    "lstm options": dict(encoder_type="lstm", num_units=16, num_layers=2,
                         use_peephole=True, num_proj=12, clip_activation=0.5),
}
WAV_LEN = np.asarray([4000, 4 * CHUNK, 1000], np.int32)  # mid-chunk, on a boundary, short


@pytest.fixture(scope="module", params=sorted(STREAM_ENCODERS))
def stream_run(request):
    enc = STREAM_ENCODERS[request.param]
    jtask = jctc_task.CTCTaskConfig(
        model=JCTCConfig(encoder=jencoders.EncoderConfig(**enc), num_classes=C),
        frontend=JFrontendConfig(**STREAM_FRONT))
    task = ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                  frontend=FrontendConfig(**STREAM_FRONT))
    params = jctc_task.init_params(jax.random.PRNGKey(10), jtask)
    model = ctc_task.init_model(task)
    model.load_state_dict(_bridge(params, model))
    model.eval()
    wav = (np.random.RandomState(11).randn(3, 4000) * 0.3).astype(np.float32)
    jinit, jstep = jstreaming.build_streaming_fn(jtask, params, CHUNK)
    jstep = jax.jit(jstep)
    init_fn, step_fn = streaming.build_streaming_fn(task, model, CHUNK)
    jstate, state = jinit(3), init_fn(3)
    padded = np.pad(wav, ((0, 0), (0, CHUNK)))
    chunks, rows = [], [[] for _ in range(3)]
    for i in range(-(-int(WAV_LEN.max()) // CHUNK)):
        cl = np.clip(WAV_LEN - i * CHUNK, 0, CHUNK).astype(np.int32)
        piece = padded[:, i * CHUNK: (i + 1) * CHUNK]
        jstate, jtok, jn = jstep(jstate, jnp.asarray(piece), jnp.asarray(cl))
        state, tok, n = step_fn(state, piece, cl)
        chunks.append(((tok.numpy(), n.numpy()), (np.asarray(jtok), np.asarray(jn)),
                       [[x.numpy() for x in layer] for layer in state.rnn_states],
                       [[np.asarray(x) for x in layer] for layer in jstate.rnn_states]))
        for r in range(3):
            rows[r].extend(tok[r, : n[r]].tolist())
    return dict(name=request.param, task=task, model=model, wav=wav, chunks=chunks, rows=rows)


def test_stream_matches_jax_chunk_by_chunk(stream_run):
    """Tokens per chunk equal, and every layer's carried state after each
    chunk (the chunk's encoder output at each row's last frame) within 1e-5."""
    for i, ((tok, n), (jtok, jn), states, jstates) in enumerate(stream_run["chunks"]):
        np.testing.assert_array_equal(n, jn, err_msg=f"chunk {i}")
        np.testing.assert_array_equal(tok, jtok, err_msg=f"chunk {i}")
        assert [len(s) for s in states] == [len(s) for s in jstates]
        assert len(states[0]) == (1 if stream_run["name"] == "gru" else 2)
        for layer, (s, js) in enumerate(zip(states, jstates)):
            for part, (x, jx) in enumerate(zip(s, js)):
                assert x.shape == jx.shape
                np.testing.assert_allclose(x, jx, atol=ATOL, rtol=0,
                                           err_msg=f"chunk {i} layer {layer} part {part}")
    assert sum(map(len, stream_run["rows"])) > 0


def test_stream_equals_port_offline(stream_run):
    task, model = stream_run["task"], stream_run["model"]
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(stream_run["wav"]),
                                           "input_len": torch.from_numpy(WAV_LEN)})
        out = model(feats, fl)
        ids, n = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
    assert stream_run["rows"] == [ids[i, : n[i]].tolist() for i in range(3)]


# ---- export ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoder_type", ["bgru", "cnn_zhang"])
def test_exported_model_gives_in_process_ids(encoder_type, tmp_path):
    """``export_model`` -> ``load_exported`` rebuilds the model from the stored
    config (``cnn_zhang`` at the config's default ``fc_units``, (1024,))."""
    exp = experiment_from_dict(dict(
        model_type="ctc", label_type="character", input_size=9, use_energy=False,
        use_delta=True, num_stack=2, num_skip=2, encoder_type=encoder_type, num_units=H,
        num_layers=2))
    task, _ = build_task(exp, SimpleNamespace(num_units=C))
    model = ctc_task.init_model(task, torch.Generator().manual_seed(12)).eval()
    batch = _batch(13)
    want = serving.build_inference_fn(task, model)(batch["inputs"], batch["input_len"])
    path = serving.export_model(task, model, tmp_path / "m.art", 4, batch["inputs"].shape[1],
                                units=[str(i) for i in range(C)], label_type="character",
                                experiment=exp, platforms=("cpu",))
    assert Path(path).exists()
    got = serving.load_exported(path, device="cpu")(batch["inputs"], batch["input_len"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][0]) > 0
