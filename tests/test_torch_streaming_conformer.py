"""Chunk-causal conformer / transformer streaming in the port, against the JAX package.

``models/conformer_stream.conformer_stream_step`` chunk by chunk against
JAX's on bridged weights and against the port's own offline stack (outputs
within 1e-5, the KV and conv caches too); a paused row's caches kept bit for
bit; ``build_streaming_fn`` for the conformer CTC (greedy, stacked, the
prefix beam) and the conformer transducer (greedy and beam) against JAX's
step chunk by chunk and against the port's offline decode; and the
relative scheme refused. Toy sizes: d = 16, 2 layers, 2 heads, kernel 5,
left context 6-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.models import conformer as jconformer
from tensorflow_end2end_speech_recognition_tpu.models import conformer_stream as jstream
from tensorflow_end2end_speech_recognition_tpu_torch import streaming
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
from tensorflow_end2end_speech_recognition_tpu_torch.models import conformer_stream
from tensorflow_end2end_speech_recognition_tpu_torch.models.conformer import (
    Conformer,
    ConformerSpec,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import device_pipeline
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from test_torch_streaming import (
    WAV_LEN,
    assert_same_beams,
    assert_same_chunks,
    ctc_pair,
    jax_drive,
    port_drive,
    transducer_pair,
    waves,
)

torch.set_num_threads(1)

OUT_ATOL = 1e-5  # float32 products and softmax sums in other orders
CONFORMER = dict(encoder_type="conformer", num_units=16, num_layers=2, num_heads=2,
                 conv_kernel_size=5, pos_encoding="rotary", left_context=8)


def _stacks(block, pos, moe=0):
    spec = dict(dim=16, num_layers=2, num_heads=2, conv_kernel_size=5, block=block,
                pos_encoding=pos, left_context=6, moe_experts=moe)
    jspec = jconformer.ConformerSpec(**spec)
    params = jconformer.init_conformer(jax.random.PRNGKey(0), jspec, 12)
    model = Conformer(ConformerSpec(**spec), 12)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model))
    return jspec, params, model.eval()


def _flat(cache):
    out = []
    streaming.tree_map(out.append, cache)
    return out


@pytest.mark.parametrize("block,pos,moe", [
    ("conformer", "rotary", 0), ("conformer", "absolute", 0), ("transformer", "rotary", 0),
    ("transformer", "absolute", 0), ("conformer", "rotary", 3),
])
def test_stream_step_matches_jax_and_the_offline_stack(block, pos, moe):
    jspec, params, model = _stacks(block, pos, moe)
    rng = np.random.RandomState(1)
    b, t, f = 3, 20, 5
    xs = rng.randn(b, t, 12).astype(np.float32)
    lens = np.asarray([20, 13, 7])
    with torch.no_grad():
        off = model(torch.from_numpy(xs), torch.from_numpy(lens))[0].numpy()
    jcache = jstream.conformer_cache_init(jspec, b)
    cache = conformer_stream.conformer_cache_init(model.spec, b)
    fed = np.zeros(b, np.int64)
    for c in range(t // f):
        n_new = np.clip(lens - fed, 0, f).astype(np.int32)
        want, jcache = jstream.conformer_stream_step(params, jspec, jcache,
                                                     jnp.asarray(xs[:, c * f: (c + 1) * f]),
                                                     jnp.asarray(n_new))
        with torch.no_grad():
            got, cache = conformer_stream.conformer_stream_step(
                model, cache, torch.from_numpy(xs[:, c * f: (c + 1) * f]),
                torch.from_numpy(n_new).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL, rtol=0)
        for x, y in zip(_flat(cache), jax.tree.leaves(jcache)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=OUT_ATOL, rtol=0)
        for bi in range(b):
            n = int(n_new[bi])
            np.testing.assert_allclose(got[bi, :n].numpy(), off[bi, fed[bi]: fed[bi] + n],
                                       atol=OUT_ATOL, rtol=0, err_msg=f"row {bi} chunk {c}")
            assert not got[bi, n:].any()
        fed += n_new


def test_paused_row_keeps_its_caches_bit_for_bit():
    _, _, model = _stacks("conformer", "rotary")
    xs = torch.randn(2, 5, 12, generator=torch.Generator().manual_seed(3))
    cache = conformer_stream.conformer_cache_init(model.spec, 2)
    with torch.no_grad():
        _, cache = conformer_stream.conformer_stream_step(model, cache, xs, torch.tensor([5, 5]))
        out, after = conformer_stream.conformer_stream_step(model, cache, xs,
                                                            torch.tensor([3, 0]))
    for x, y in zip(_flat(cache), _flat(after)):
        assert torch.equal(x[1], y[1])
    assert not out[1].any() and not torch.equal(_flat(cache)[1][0], _flat(after)[1][0])


CASES = {
    "ctc_greedy": dict(kind="ctc", stack=1, kw={}),
    "ctc_stacked": dict(kind="ctc", stack=3, kw={}),
    "ctc_beam": dict(kind="ctc", stack=1, kw=dict(beam_width=4, top_k_classes=5,
                                                  max_prefix_len=50)),
    "transducer_greedy": dict(kind="transducer", stack=3, kw={}),
    "transducer_beam": dict(kind="transducer", stack=3, kw=dict(beam_width=3,
                                                                max_prefix_len=40)),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, case in CASES.items():
        pair = ctc_pair if case["kind"] == "ctc" else transducer_pair
        jtask, task, params, model = pair(case["stack"], case["stack"], seed=2, enc=CONFORMER)
        wav = waves(5)
        out[name] = dict(task=task, model=model, wav=wav, kw=case["kw"],
                         jax=jax_drive(jtask, params, wav, WAV_LEN, **case["kw"]),
                         port=port_drive(task, model, wav, WAV_LEN, **case["kw"]))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_conformer_stream_matches_jax_chunk_by_chunk(runs, name):
    (j_outs, j_rows, j_final), (outs, rows, final) = runs[name]["jax"], runs[name]["port"]
    assert_same_chunks(outs, j_outs)
    assert rows == j_rows and sum(map(len, rows)) > 0
    if j_final is not None:
        assert_same_beams(final, j_final)


@pytest.mark.parametrize("name", list(CASES))
def test_conformer_stream_equals_port_offline(runs, name):
    run = runs[name]
    task, model, kw = run["task"], run["model"], run["kw"]
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(run["wav"]),
                                           "input_len": torch.from_numpy(WAV_LEN)})
        if CASES[name]["kind"] == "ctc":
            out = model(feats, fl)
            ids, n = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
            if kw:
                want = ctc_prefix_beam_search(out.logits, out.logit_len, task.model.blank_id,
                                              beam_width=4, top_k_classes=5, max_prefix_len=50)
        else:
            f_proj, enc_len = model.encode(feats, fl)
            ids, n = transducer_greedy_decode(model, f_proj, enc_len)
            if kw:
                want = transducer_beam_search(model, f_proj, enc_len, beam_width=3, max_len=40)
    assert run["port"][1] == [ids[i, : n[i]].tolist() for i in range(3)]
    if kw:
        assert_same_beams(run["port"][2], [x.numpy() for x in want])


def test_relative_positions_and_unbounded_windows_are_refused():
    for enc, match in ((dict(CONFORMER, pos_encoding="relative"), "relative"),
                       (dict(CONFORMER, left_context=-1), "left_context")):
        _, task, _, model = ctc_pair(seed=4, enc=enc)
        with pytest.raises(ValueError, match=match):
            streaming.build_streaming_fn(task, model, 640)
    with pytest.raises(ValueError, match="left_context"):
        conformer_stream.conformer_cache_init(ConformerSpec(dim=8, num_heads=2), 1)
