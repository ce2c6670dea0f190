"""The hand-written CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one. This file imports
no jax, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -rs

Tolerances in float32 at these short sequences: atol/rtol 1e-5 for the LSTM
kernels #1-#4 (the kernel and cuBLAS sum each dot product in different orders),
1e-4 absolute on CTC losses (a sum of T log terms) and 1e-5 on CTC gradients;
for the location-attention read 1e-5 on the alignment and 1e-4 on the context
(a sum over T of weights times encoder values of order 1), and 1e-5 on its
gradients (the same plain arithmetic recomputed on the same inputs); 1e-4
where a recurrence runs 1198 steps or a whole model is held against the CPU.
The bf16-stream kernels (``compute_dtype: bfloat16``) are held to their
plain versions within two bf16 ulps (rtol 8e-3, atol 1e-5): both round the
same float32 walk, summed in other orders. #7 on bf16 encoder rows keeps
the float32 tolerances: both widen the rows exactly and sum in float32.
#3's carried walk with bf16 products keeps them for one step and is held
within ``BF16_PRODUCT_TOL`` over a chunk (an h may round to the other bf16
neighbour on each side). The train step built with a world of 1 over nccl
must equal the one-process step bit for bit.
"""

import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu_torch import set_full_fp32
from tensorflow_end2end_speech_recognition_tpu_torch.decoding import attention_beam_search
from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_greedy import (
    transducer_greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig, CTCModel
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.rnn import BiLSTM
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import (
    Seq2SeqConfig,
    Seq2SeqModel,
    greedy_decode,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import (
    TransducerConfig,
    TransducerModel,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.attention import (
    location_attend,
    location_attend_plain,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops.ctc import (
    ctc_loss,
    ctc_loss_fwd_bwd,
    ctc_loss_fwd_only,
    ctc_loss_fwd_only_plain,
    ctc_loss_plain,
    ctc_plan,
)
from tensorflow_end2end_speech_recognition_tpu_torch.ops import bf16 as bf16_ops
from tensorflow_end2end_speech_recognition_tpu_torch.ops import build
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task
from tensorflow_end2end_speech_recognition_tpu_torch.ops import ctc as ctc_ops
from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm as lstm_ops
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    LSTMLayer,
    bwd_plan_for,
    fwd_plan_for,
    lstm_bidi,
    lstm_bidi_bwd,
    lstm_bidi_bwd_plain,
    lstm_bidi_fwd,
    lstm_bidi_fwd_plain,
    lstm_layer,
    lstm_layer_bwd,
    lstm_layer_bwd_plain,
    lstm_layer_fwd,
    lstm_layer_fwd_plain,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

LSTM_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_full_fp32()
    return torch.device("cuda")


def _inputs(dev, b, t, h, lengths, seed):
    rng = np.random.RandomState(seed)
    xf, xb = (torch.from_numpy(rng.randn(b, t, 4 * h).astype(np.float32)).to(dev)
              for _ in range(2))
    whf, whb = (torch.from_numpy(((rng.rand(h, 4 * h) - 0.5) * 0.2).astype(np.float32)).to(dev)
                for _ in range(2))
    lengths = torch.tensor(lengths, device=dev)
    mask = (torch.arange(t, device=dev)[None] < lengths[:, None]).float()
    return xf, xb, whf, whb, mask


SHAPES = [
    (5, 37, 70, [37, 1, 20, 36, 2]),  # neither H nor B a multiple of the 8-wide tiles
    # > 48 KB shared memory, two row tiles; the backward reads its Wh slice from L2
    (9, 5, 1536, [5, 1, 3, 5, 2, 4, 5, 1, 3]),
]


@pytest.mark.parametrize("b,t,h,lengths", SHAPES)
def test_kernel_matches_plain(dev, b, t, h, lengths):
    args = _inputs(dev, b, t, h, lengths, seed=h)
    before = lstm_bidi.launches
    got = lstm_bidi(*args, 1.0)
    torch.cuda.synchronize()
    assert lstm_bidi.launches == before + 1
    want = lstm_bidi_fwd_plain(*args, 1.0)
    for g, w in zip(got, want[:2]):
        torch.testing.assert_close(g, w, **LSTM_TOL)


@pytest.mark.parametrize("b,t,h,lengths", SHAPES)
def test_cell_state_stream_matches_plain(dev, b, t, h, lengths):
    args = _inputs(dev, b, t, h, lengths, seed=h + 1)
    got = lstm_bidi_fwd(*args, 0.5, with_cs=True)
    torch.cuda.synchronize()
    for g, w in zip(got, lstm_bidi_fwd_plain(*args, 0.5)):
        torch.testing.assert_close(g, w, **LSTM_TOL)


@pytest.mark.parametrize("b,t,h,lengths", SHAPES)
def test_backward_kernel_matches_plain(dev, b, t, h, lengths):
    args = _inputs(dev, b, t, h, lengths, seed=h + 2)
    fwd = lstm_bidi_fwd_plain(*args, 1.0)
    rng = np.random.RandomState(h)
    gys = [torch.from_numpy(rng.randn(b, t, h).astype(np.float32)).to(dev) for _ in range(2)]
    before = lstm_bidi_bwd.launches
    got = lstm_bidi_bwd(*args, *fwd, *gys, 1.0)
    torch.cuda.synchronize()
    assert lstm_bidi_bwd.launches == before + 1
    for g, w in zip(got, lstm_bidi_bwd_plain(*args, *fwd, *gys, 1.0)):
        torch.testing.assert_close(g, w, **LSTM_TOL)


def _bwd_case(dev, b, t, h, seed):
    """Inputs of #2 and #4 at [B, T, H], lengths that include T and 1, and
    the plain forwards' streams: (args, fwd_bidi, gys_bidi, fwd_layer)."""
    rng = np.random.RandomState(seed)
    lengths = ([t, 1] + [int(x) for x in rng.randint(1, t + 1, max(b - 2, 0))])[:b]
    args = _inputs(dev, b, t, h, lengths, seed)
    gys = [torch.from_numpy(rng.randn(b, t, h).astype(np.float32)).to(dev) for _ in range(2)]
    return args, lstm_bidi_fwd_plain(*args, 1.0), gys, lstm_layer_fwd_plain(*args[::2], 0.5)


def _check_backward_kernels(dev, b, t, h):
    """#2 and #4 against their plain versions, each called twice: equal bits."""
    args, fwd, gys, fwd1 = _bwd_case(dev, b, t, h, seed=b + h)
    x, _, wh, _, mask = args
    before = (lstm_bidi_bwd.launches, lstm_layer_bwd.launches)
    got = lstm_bidi_bwd(*args, *fwd, *gys, 1.0)
    again = lstm_bidi_bwd(*args, *fwd, *gys, 1.0)
    dx = lstm_layer_bwd(x, wh, mask, *fwd1, gys[0], 0.5)
    dx_again = lstm_layer_bwd(x, wh, mask, *fwd1, gys[0], 0.5)
    torch.cuda.synchronize()
    assert (lstm_bidi_bwd.launches, lstm_layer_bwd.launches) == (before[0] + 2, before[1] + 2)
    for g, w in zip(got, lstm_bidi_bwd_plain(*args, *fwd, *gys, 1.0)):
        torch.testing.assert_close(g, w, **LSTM_TOL)
    torch.testing.assert_close(dx, lstm_layer_bwd_plain(x, wh, mask, *fwd1, gys[0], 0.5),
                               **LSTM_TOL)
    assert all(torch.equal(g, a) for g, a in zip(got, again)) and torch.equal(dx, dx_again)


@pytest.mark.parametrize("b", [1, 33, 64])
@pytest.mark.parametrize("h", [256, 320, 512])
def test_backward_kernels_at_model_widths(dev, b, h):
    """#2 and #4 at the configs' widths (timit, csj, ls) against their plain
    versions: B = 33 and 64 take two row chunks; two calls give equal bits."""
    _check_backward_kernels(dev, b, 24, h)


@pytest.mark.parametrize("b,h", [(5, 270), (33, 270), (9, 1540), (40, 1540)])
def test_backward_kernels_with_unit_tiles_that_leave_a_remainder(dev, b, h):
    """Widths whose unit tile does not divide H for either kernel, so the last
    block of each direction has units past H: resident Wh at H = 270, read
    from L2 at H = 1540, one and two row chunks."""
    for dirs in (1, 2):
        plan = bwd_plan_for(dev, h, dirs, b)
        assert h % plan.units and plan.resident == (h == 270), (dirs, plan)
    _check_backward_kernels(dev, b, 12, h)


@pytest.mark.parametrize("b,ragged", [(128, False), (128, True), (37, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_backward_kernels_at_the_headline_batch(dev, b, ragged, bf16):
    """#2 and #4 at the headline's batch (B = 128, every row full or ragged)
    and at B = 37 (not a multiple of the 16-row tiles), H = 512, in float32
    and bf16 streams: within today's tolerances of their plain versions, one
    launch per call, two calls equal bit for bit; the plan clusters the
    blocks and holds Wh in shared memory."""
    t, h = 24, 512
    rng = np.random.RandomState(b + int(ragged))
    lengths = [t, 1] + [int(x) for x in rng.randint(1, t + 1, b - 2)] if ragged else [t] * b
    xf, xb, whf, whb, mask = _inputs(dev, b, t, h, lengths, seed=b + 5)
    gys = [torch.from_numpy(rng.randn(b, t, h).astype(np.float32)).to(dev) for _ in range(2)]
    fwd = lstm_bidi_fwd_plain(xf, xb, whf, whb, mask, 1.0)
    fwd1 = lstm_layer_fwd_plain(xf, whf, mask, 0.5)
    cast = (lambda v: v.bfloat16()) if bf16 else (lambda v: v)
    xf, xb, gys = cast(xf), cast(xb), [cast(g) for g in gys]
    fwd, fwd1 = [cast(v) for v in fwd], [cast(v) for v in fwd1]
    counter = "launches_bf16" if bf16 else "launches"
    for dirs in (1, 2):
        plan = bwd_plan_for(dev, h, dirs, b, bf16=bf16)
        assert plan.chunks == 1 and plan.resident and plan.cluster > 1, plan
    before = (getattr(lstm_bidi_bwd, counter), getattr(lstm_layer_bwd, counter))
    got = lstm_bidi_bwd(xf, xb, whf, whb, mask, *fwd, *gys, 1.0)
    again = lstm_bidi_bwd(xf, xb, whf, whb, mask, *fwd, *gys, 1.0)
    dx = lstm_layer_bwd(xf, whf, mask, *fwd1, gys[0], 0.5)
    dx_again = lstm_layer_bwd(xf, whf, mask, *fwd1, gys[0], 0.5)
    torch.cuda.synchronize()
    assert (getattr(lstm_bidi_bwd, counter), getattr(lstm_layer_bwd, counter)) == (
        before[0] + 2, before[1] + 2)
    want = (*lstm_bidi_bwd_plain(xf, xb, whf, whb, mask, *fwd, *gys, 1.0),
            lstm_layer_bwd_plain(xf, whf, mask, *fwd1, gys[0], 0.5))
    for g, w in zip((*got, dx), want):
        if bf16:
            _close_bf16(g, w)
        else:
            torch.testing.assert_close(g, w, **LSTM_TOL)
    assert all(torch.equal(g, a) for g, a in zip((*got, dx), (*again, dx_again)))


@pytest.mark.parametrize("entry", ["lstm_bidi_bwd", "lstm_layer_bwd"])
def test_backward_step_trace(dev, entry):
    """The backward's own step trace (``lstm.bwd_trace``, which
    chip_smoke.py and probes/lstm_bwd_time.py read): off by default; on, one
    launch records its first steps' phase marks in order and its clock and
    timer at start and end; off again, results are the same bits."""
    b, t, h = 8, 70, 512
    args, fwd, gys, fwd1 = _bwd_case(dev, b, t, h, seed=13)
    x, _, wh, _, mask = args
    run = ((lambda: lstm_bidi_bwd(*args, *fwd, *gys, 1.0)) if entry == "lstm_bidi_bwd"
           else (lambda: (lstm_layer_bwd(x, wh, mask, *fwd1, gys[0], 0.5),)))
    steps, points = lstm_ops.BWD_TRACE_STEPS, lstm_ops.BWD_TRACE_POINTS
    plain = run()
    out = []
    v = lstm_ops.bwd_trace(entry, lambda: out.append(run()))
    traced = out[0]
    again = run()
    torch.cuda.synchronize()
    assert len(v) == steps * points + 4
    c0, n0, c1, n1 = v[-4:]
    assert c1 > c0 > 0 and n1 > n0 > 0
    marks = [m for s in range(steps) for m in v[s * points:(s + 1) * points]]
    assert all(c0 <= m <= c1 for m in marks)
    assert all(a <= z for a, z in zip(marks, marks[1:]))  # steps and their phases in order
    phases = lstm_ops.bwd_step_phases(v)
    assert list(phases) == list(lstm_ops.BWD_TRACE_PHASES) and all(x >= 0 for x in phases.values())
    assert all(torch.equal(p, q) and torch.equal(p, r) for p, q, r in zip(plain, traced, again))


def test_backward_launch_that_cannot_be_resident_raises(dev, monkeypatch):
    """Plans made as if the card had eight times its SMs: the cooperative
    launch is refused, the wrapper raises and counts nothing, and the next
    call runs."""
    sms = lstm_ops._sm_count(dev.index or 0)
    args, fwd, gys, fwd1 = _bwd_case(dev, 4, 5, 512, seed=7)
    x, _, wh, _, mask = args
    before = (lstm_bidi_bwd.launches, lstm_layer_bwd.launches)
    with monkeypatch.context() as m:
        m.setattr(lstm_ops, "_sm_count", lambda index: 8 * sms)
        assert bwd_plan_for(dev, 512, 2, 4).blocks > sms
        with pytest.raises(RuntimeError, match="lstm_bidi_bwd: CUDA error"):
            lstm_bidi_bwd(*args, *fwd, *gys, 1.0)
        with pytest.raises(RuntimeError, match="lstm_layer_bwd: CUDA error"):
            lstm_layer_bwd(x, wh, mask, *fwd1, gys[0], 0.5)
    assert (lstm_bidi_bwd.launches, lstm_layer_bwd.launches) == before
    got = lstm_bidi_bwd(*args, *fwd, *gys, 1.0)
    torch.cuda.synchronize()
    for g, w in zip(got, lstm_bidi_bwd_plain(*args, *fwd, *gys, 1.0)):
        torch.testing.assert_close(g, w, **LSTM_TOL)


def test_backward_entry_points_refuse_partials_of_another_size(dev):
    """The C entry points hold the dh partials' scratch against what the
    kernel indexes at the call's B and H: a plan made for another batch or
    width is refused (cudaErrorInvalidValue) before anything runs."""
    b, t, h = 40, 5, 512
    args, fwd, gys, fwd1 = _bwd_case(dev, b, t, h, seed=9)
    x, xb, wh, whb, mask = args
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    dx = torch.zeros_like(x)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    invalid_value = 1
    for plan in (bwd_plan_for(dev, h, 1, 8), bwd_plan_for(dev, 256, 1, b)):
        part = torch.empty(plan.part_floats, dtype=torch.float32, device=dev)
        code = lib.lstm_layer_bwd(
            *(a.data_ptr() for a in (x, wh, mask, *fwd1, gys[0])), dx.data_ptr(),
            sync.data_ptr(), part.data_ptr(), plan.part_floats, b, t, h, plan.units,
            int(plan.resident), int(plan.split), plan.cluster, plan.smem_bytes, 0.5, stream)
        assert code == invalid_value, plan
    plan = bwd_plan_for(dev, h, 2, b)
    part = torch.empty(plan.part_floats - 1, dtype=torch.float32, device=dev)
    dx_b = torch.zeros_like(xb)
    code = lib.lstm_bidi_bwd(
        *(a.data_ptr() for a in (*args, *fwd, *gys)), dx.data_ptr(), dx_b.data_ptr(),
        sync.data_ptr(), part.data_ptr(), plan.part_floats - 1, b, t, h, plan.units,
        int(plan.resident), int(plan.split), plan.cluster, plan.smem_bytes, 1.0, stream)
    assert code == invalid_value
    torch.cuda.synchronize()
    assert not dx.any() and not dx_b.any()  # nothing ran


def _check_forward_kernels(dev, b, t, h, mask=None):
    """#1 and #3, with and without ``cs``, against their plain versions (the
    oracle also for a ``mask`` that is not a length mask); each kernel called
    twice with ``cs``: equal bits, and the same ``ys`` bits without it."""
    rng = np.random.RandomState(b + h)
    lengths = ([t, 1] + [int(x) for x in rng.randint(1, t + 1, max(b - 2, 0))])[:b]
    args = _inputs(dev, b, t, h, lengths, seed=b + h + 1)
    if mask is not None:
        args = (*args[:4], mask)
    x, _, wh, _, m = args
    before = (lstm_bidi.launches, lstm_layer.launches)
    got, again, ys = (lstm_bidi_fwd(*args, 0.7, with_cs=cs) for cs in (True, True, False))
    got1, again1 = (lstm_layer_fwd(x, wh, m, 0.5, with_cs=True) for _ in range(2))
    ys1 = lstm_layer_fwd(x, wh, m, 0.5)
    torch.cuda.synchronize()
    assert (lstm_bidi.launches, lstm_layer.launches) == (before[0] + 3, before[1] + 3)
    want, want1 = lstm_bidi_fwd_plain(*args, 0.7), lstm_layer_fwd_plain(x, wh, m, 0.5)
    for g, w in zip((*got, *got1), (*want, *want1)):
        torch.testing.assert_close(g, w, **LSTM_TOL)
    assert all(torch.equal(g, a) for g, a in zip((*got, *got1), (*again, *again1)))
    assert all(torch.equal(y, g) for y, g in zip((*ys, ys1), (*got[:2], got1[0])))


@pytest.mark.parametrize("b", [1, 8, 33, 64])
@pytest.mark.parametrize("h", [256, 270, 320, 512])
def test_forward_kernels_at_model_widths(dev, b, h):
    """#1 and #3 at the configs' widths and H = 270 (a unit tile that leaves a
    remainder): B = 1 and 8 on FFMA, B = 33 and 64 on the tensor cores (#3 at
    64 in clusters of 2 that split k); lengths include 1 and T."""
    for dirs in (1, 2):
        assert fwd_plan_for(dev, h, dirs, b).resident
    _check_forward_kernels(dev, b, 24, h)


@pytest.mark.parametrize("b", [9, 40])
def test_forward_kernels_with_wh_streamed(dev, b):
    """At H = 1540 the Wh slice does not fit shared memory: read from L2."""
    for dirs in (1, 2):
        plan = fwd_plan_for(dev, 1540, dirs, b)
        assert not plan.resident and 1540 % plan.units, plan
    _check_forward_kernels(dev, b, 12, 1540)


@pytest.mark.parametrize("h", [70, 512])
def test_forward_kernels_under_a_mask_with_holes(dev, h):
    """A mask that switches off and on again within a row: a masked step
    carries h and c, the next real step starts from them."""
    b, t = 6, 20
    rng = np.random.RandomState(h)
    mask = (rng.rand(b, t) < 0.6).astype(np.float32)
    mask[0], mask[1, ::2], mask[1, 1::2] = 1.0, 1.0, 0.0
    _check_forward_kernels(dev, b, t, h, torch.from_numpy(mask).to(dev))


def test_forward_launch_that_cannot_be_resident_raises(dev, monkeypatch):
    """Plans made as if the card had eight times its SMs (one unit a block,
    1024 blocks a direction): the cooperative launch is refused, the wrapper
    raises and counts nothing, and the next call runs."""
    sms = lstm_ops._sm_count(dev.index or 0)
    b, t, h = 4, 5, 1024
    args = _inputs(dev, b, t, h, [5, 1, 3, 4], seed=8)
    x, _, wh, _, mask = args
    before = (lstm_bidi.launches, lstm_layer.launches)
    with monkeypatch.context() as m:
        m.setattr(lstm_ops, "_sm_count", lambda index: 8 * sms)
        assert fwd_plan_for(dev, h, 1, b).blocks > 4 * sms
        with pytest.raises(RuntimeError, match="lstm_bidi_fwd: CUDA error"):
            lstm_bidi_fwd(*args, 1.0)
        with pytest.raises(RuntimeError, match="lstm_layer_fwd: CUDA error"):
            lstm_layer_fwd(x, wh, mask, 1.0)
    assert (lstm_bidi.launches, lstm_layer.launches) == before
    got = lstm_layer_fwd(x, wh, mask, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lstm_layer_fwd_plain(x, wh, mask, 1.0)[0], **LSTM_TOL)


def test_forward_entry_points_refuse_an_exchange_buffer_of_another_size(dev):
    """The C entry points hold the h exchange against what the kernel indexes
    at the call's B and H, and take rows of 8 (FFMA), 16 (the tensor cores'
    row tile) or 32 (clusters of 2): a plan made for another batch or width,
    or other rows, is refused (cudaErrorInvalidValue) before anything runs."""
    b, t, h = 40, 5, 512
    xf, xb, whf, whb, mask = _inputs(dev, b, t, h, [t] * b, seed=9)
    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ys, ys_b = torch.zeros((b, t, h), device=dev), torch.zeros((b, t, h), device=dev)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    invalid_value = 1
    good = fwd_plan_for(dev, h, 1, b)
    for plan in (fwd_plan_for(dev, h, 1, 8), fwd_plan_for(dev, 256, 1, b), good._replace(rows=12),
                 good._replace(rows=24)):
        hbuf = torch.empty(plan.hbuf_floats, dtype=torch.float32, device=dev)
        code = lib.lstm_layer_fwd(
            xf.data_ptr(), whf.data_ptr(), mask.data_ptr(), ys.data_ptr(), None,
            sync.data_ptr(), hbuf.data_ptr(), plan.hbuf_floats, b, t, h, plan.units,
            int(plan.resident), plan.rows, plan.smem_bytes, 0.5, stream)
        assert code == invalid_value, plan
    plan = fwd_plan_for(dev, h, 2, b)
    hbuf = torch.empty(plan.hbuf_floats - 1, dtype=torch.float32, device=dev)
    code = lib.lstm_bidi_fwd(
        *(a.data_ptr() for a in (xf, xb, whf, whb, mask, ys, ys_b)), None, None,
        sync.data_ptr(), hbuf.data_ptr(), plan.hbuf_floats - 1, b, t, h, plan.units,
        int(plan.resident), plan.rows, plan.smem_bytes, 1.0, stream)
    assert code == invalid_value
    torch.cuda.synchronize()
    assert not ys.any() and not ys_b.any()  # nothing ran


def test_bidi_kernels_at_the_pyramidal_training_shape(dev):
    """#1 with ``cs`` and #2 at the ls960_joint train step's first layer, B = 32,
    T = 1198, H = 512, lengths that include 1 and T: the plain versions within
    1e-4 (differences carried through 1198 steps), two calls equal bit for bit."""
    b, t, h = 32, 1198, 512
    args, fwd, gys, _ = _bwd_case(dev, b, t, h, seed=11)
    got = [lstm_bidi_fwd(*args, 1.0, with_cs=True) for _ in range(2)]
    dx = [lstm_bidi_bwd(*args, *fwd, *gys, 1.0) for _ in range(2)]
    torch.cuda.synchronize()
    for g, w in zip((*got[0], *dx[0]), (*fwd, *lstm_bidi_bwd_plain(*args, *fwd, *gys, 1.0))):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    assert all(torch.equal(x, y) for x, y in zip((*got[0], *dx[0]), (*got[1], *dx[1])))


@pytest.mark.parametrize("b,t,h", [(300, 8, 512), (600, 4, 512), (80, 4, 1536)])
def test_kernels_past_the_register_carries(dev, b, t, h):
    """A batch past B x units = 2048 for #1/#2 (B = 300 and 600 at H = 512,
    80 at H = 1536) and #3/#4 (B = 600 at H = 512) is split into launches
    over contiguous rows; each wrapper call still counts once and gives the
    plain versions' results."""
    assert fwd_plan_for(dev, h, 2, b).chunks > 1 and bwd_plan_for(dev, h, 2, b).chunks > 1
    assert fwd_plan_for(dev, h, 1, b).chunks == bwd_plan_for(dev, h, 1, b).chunks == (
        2 if b == 600 else 1)
    _check_forward_kernels(dev, b, t, h)
    _check_backward_kernels(dev, b, t, h)


@pytest.mark.parametrize("b", [128, 100])
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_kernels_at_the_headline_batch(dev, b, bf16):
    """#1 and #3 with ``cs`` at the headline's batch (B = 128) and at B = 100
    (not a multiple of the 16-row tiles), H = 512, ragged lengths that include
    1 and T, in float32 and bf16 streams: the plan forms every row's gates in
    one pass on the tensor cores with Wh held in shared memory, one launch a
    call; within today's tolerances of the plain versions, two calls equal bit
    for bit."""
    t, h = 24, 512
    rng = np.random.RandomState(b)
    lengths = [t, 1] + [int(x) for x in rng.randint(1, t + 1, b - 2)]
    xf, xb, whf, whb, mask = _inputs(dev, b, t, h, lengths, seed=b + 3)
    if bf16:
        xf, xb = xf.bfloat16(), xb.bfloat16()
    for dirs in (1, 2):
        plan = fwd_plan_for(dev, h, dirs, b)
        assert plan.chunks == 1 and plan.resident, plan
    counter = "launches_bf16" if bf16 else "launches"
    before = (getattr(lstm_bidi, counter), getattr(lstm_layer, counter))
    got, again = (lstm_bidi_fwd(xf, xb, whf, whb, mask, 1.0, with_cs=True) for _ in range(2))
    got1, again1 = (lstm_layer_fwd(xf, whf, mask, 0.5, with_cs=True) for _ in range(2))
    torch.cuda.synchronize()
    assert (getattr(lstm_bidi, counter), getattr(lstm_layer, counter)) == (
        before[0] + 2, before[1] + 2)
    want = (*lstm_bidi_fwd_plain(xf, xb, whf, whb, mask, 1.0),
            *lstm_layer_fwd_plain(xf, whf, mask, 0.5))
    for g, w in zip((*got, *got1), want):
        if bf16:
            _close_bf16(g, w)
        else:
            torch.testing.assert_close(g, w, **LSTM_TOL)
    assert all(torch.equal(g, a) for g, a in zip((*got, *got1), (*again, *again1)))


@pytest.mark.parametrize("cluster", [0, 1, 2])
@pytest.mark.parametrize("b,h", [(8, 512), (33, 270), (5, 1536)])
def test_forward_product_paths_match_plain(dev, monkeypatch, cluster, b, h):
    """Each gate product ``fwd_plan`` can choose (FFMA, the tensor cores, the
    tensor cores in clusters of 2 that split k), forced at the serving batch,
    past it at a width with a remainder tile and rows that are not 16-byte
    aligned, and with Wh read through L2: #1 and #3
    (``_check_forward_kernels``) and #3's carried walks, float32 and with
    bf16 products, against their plain versions; a row that no step unmasks
    gives back (h0, c0) bit for bit."""
    sms = lstm_ops._sm_count(dev.index or 0)
    monkeypatch.setattr(lstm_ops, "fwd_plan_for", lambda d, h_, dirs, batch: lstm_ops.fwd_plan(
        h_, dirs, batch, sms, cluster))
    assert lstm_ops.fwd_plan_for(dev, h, 2, b).cluster == cluster
    _check_forward_kernels(dev, b, 12, h)
    t = 7
    lengths = ([t, 0, 3, 1, 0] + [t] * b)[:b]
    x, _, wh, _, mask = _inputs(dev, b, t, h, lengths, seed=h + b)
    rng = np.random.RandomState(b)
    h0, c0 = (torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev) for _ in range(2))
    paused = torch.tensor(lengths, device=dev) == 0
    with torch.no_grad():
        for bf16_product in (False, True):
            ys, (h_t, c_t) = lstm_layer(x, wh, mask, 0.5, initial_state=(h0, c0),
                                        bf16_product=bf16_product)
            torch.cuda.synchronize()
            want_ys, _, (want_h, want_c) = lstm_layer_fwd_plain(x, wh, mask, 0.5, (h0, c0),
                                                                bf16_product=bf16_product)
            tol = BF16_PRODUCT_TOL if bf16_product else LSTM_TOL
            for g, w in ((ys, want_ys), (h_t, want_h), (c_t, want_c)):
                torch.testing.assert_close(g, w, **tol)
            assert torch.equal(h_t[paused], h0[paused]) and torch.equal(c_t[paused], c0[paused])


@pytest.mark.parametrize("entry,b", [("lstm_bidi_fwd", 8), ("lstm_layer_fwd", 40)])
def test_forward_step_trace(dev, entry, b):
    """The forward's own step trace (``lstm.fwd_trace``, which chip_smoke.py
    and probes/lstm_fwd_time.py read), on FFMA (B = 8) and on the tensor
    cores (B = 40): off by default; on, one launch records its first steps'
    phase marks in order and its clock and timer at start and end; off again,
    results are the same bits."""
    t, h = 70, 512
    args = _inputs(dev, b, t, h, [t] * b, seed=14)
    x, _, wh, _, mask = args
    run = ((lambda: lstm_bidi_fwd(*args, 1.0, with_cs=True)) if entry == "lstm_bidi_fwd"
           else (lambda: lstm_layer_fwd(x, wh, mask, 0.5, with_cs=True)))
    steps, points = lstm_ops.BWD_TRACE_STEPS, lstm_ops.FWD_TRACE_POINTS
    plain = run()
    out = []
    v = lstm_ops.fwd_trace(entry, lambda: out.append(run()))
    again = run()
    torch.cuda.synchronize()
    assert len(v) == steps * lstm_ops.BWD_TRACE_POINTS + 4
    c0, n0, c1, n1 = v[-4:]
    assert c1 > c0 > 0 and n1 > n0 > 0
    marks = [m for s in range(steps) for m in v[s * points:(s + 1) * points]]
    assert all(c0 <= m <= c1 for m in marks)
    assert all(a <= z for a, z in zip(marks, marks[1:]))  # steps and their phases in order
    phases = lstm_ops.fwd_step_phases(v)
    assert list(phases) == list(lstm_ops.FWD_TRACE_PHASES) and all(x >= 0 for x in phases.values())
    assert all(torch.equal(p, q) and torch.equal(p, r) for p, q, r in zip(plain, out[0], again))


@pytest.mark.parametrize("b,t,h,lengths", SHAPES)
def test_layer_kernels_match_plain(dev, b, t, h, lengths):
    """#3 with and without ``cs``, and #4, against their plain versions."""
    x, _, wh, _, mask = _inputs(dev, b, t, h, lengths, seed=h + 3)
    before = (lstm_layer.launches, lstm_layer_bwd.launches)
    ys = lstm_layer(x, wh, mask, 1.0)
    ys_cs = lstm_layer_fwd(x, wh, mask, 0.5, with_cs=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(ys, lstm_layer_fwd_plain(x, wh, mask, 1.0)[0], **LSTM_TOL)
    want = lstm_layer_fwd_plain(x, wh, mask, 0.5)
    for g, w in zip(ys_cs, want):
        torch.testing.assert_close(g, w, **LSTM_TOL)
    gys = torch.from_numpy(np.random.RandomState(h).randn(b, t, h).astype(np.float32)).to(dev)
    dx = lstm_layer_bwd(x, wh, mask, *want, gys, 0.5)
    torch.cuda.synchronize()
    assert (lstm_layer.launches, lstm_layer_bwd.launches) == (before[0] + 2, before[1] + 1)
    torch.testing.assert_close(dx, lstm_layer_bwd_plain(x, wh, mask, *want, gys, 0.5),
                               **LSTM_TOL)


def test_layer_function_on_card_matches_cpu(dev):
    """``LSTMLayer``'s gradients (#4 and the dWh contraction) against the CPU."""
    x, _, wh, _, mask = _inputs(dev, 3, 17, 40, [17, 1, 9], seed=4)
    gys = torch.from_numpy(np.random.RandomState(5).randn(3, 17, 40).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        leaves = [a.detach().to(d).requires_grad_(True) for a in (x, wh)]
        (LSTMLayer.apply(*leaves, mask.to(d), 1.0) * gys.to(d)).sum().backward()
        grads.append([leaf.grad.cpu() for leaf in leaves])
    for g, w in zip(grads[1], grads[0]):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_transducer_on_card_matches_cpu(dev):
    """A tiny ls_transducer-shaped model: encoder, nll gradients and greedy ids."""
    cfg = TransducerConfig(encoder=EncoderConfig(encoder_type="lstm", num_units=24,
                                                 num_layers=2),
                           num_classes=6, pred_num_units=8, embedding_dim=4, joint_dim=12)
    cpu = TransducerModel(cfg, 10, torch.Generator().manual_seed(0))
    model = TransducerModel(cfg, 10, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.RandomState(6)
    feats = torch.from_numpy(rng.randn(3, 13, 10).astype(np.float32))
    lens = torch.tensor([13, 6, 1])
    with torch.inference_mode():
        want = transducer_greedy_decode(cpu, *cpu.encode(feats, lens))
        before = lstm_layer.launches
        f_proj, enc_len = model.encode(feats.to(dev), lens.to(dev))
        got = transducer_greedy_decode(model, f_proj, enc_len)
        torch.cuda.synchronize()
        assert lstm_layer.launches == before + 2
    torch.testing.assert_close(f_proj.cpu(), cpu.encode(feats, lens)[0], atol=1e-4, rtol=0)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_kernel_rejects_mixed_devices(dev):
    xf, xb, whf, whb, mask = _inputs(dev, 2, 3, 8, [3, 1], seed=0)
    with pytest.raises(ValueError, match="cpu"):
        lstm_bidi(xf, xb, whf.cpu(), whb, mask)


def test_bilstm_layer_on_card_matches_cpu(dev):
    layer = BiLSTM(12, 40, generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    xs = torch.from_numpy(rng.randn(3, 11, 12).astype(np.float32))
    lengths = torch.tensor([11, 6, 1])
    with torch.inference_mode():
        want = layer(xs, lengths)
        got = layer.to(dev)(xs.to(dev), lengths.to(dev))
    torch.testing.assert_close(got.cpu(), want, **LSTM_TOL)


def _ctc_case(dev, b, t, c, u, seed):
    """Ragged logit and label lengths, repeats, an empty and an impossible row."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(b, t, c) * 2).astype(np.float32)).to(dev)
    label_len = rng.randint(0, u + 1, b)
    label_len[0], label_len[1] = u, 0
    labels = np.full((b, u), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, c - 1, n)
    labels[0, 1:3] = labels[0, 0]  # repeated labels
    logit_len = rng.randint(1, t + 1, b)
    logit_len[0] = t
    if b > 2:  # u labels in 2 frames: no alignment, a loss of about 1e30
        label_len[-1], logit_len[-1] = u, 2
        labels[-1] = rng.randint(0, c - 1, u)
    as_t = lambda x: torch.from_numpy(np.asarray(x, np.int32)).to(dev)  # noqa: E731
    return logits, as_t(logit_len), as_t(labels), as_t(label_len)


@pytest.mark.parametrize("b,t,c,u", [
    (7, 23, 29, 5),  # B not a multiple of anything, C = 29 (ls100)
    (3, 30, 11, 600),  # S = 1201 lanes: 16 warps of 3 lanes per thread
    (2, 9, 5, 10000),  # S = 20001: the running rows in global memory
    # each branch of ops/ctc.ctc_plan
    (5, 40, 29, 10),  # S = 21: one lane per thread of one warp
    (6, 60, 29, 16),  # S = 33: two lanes per thread of one warp
    (6, 120, 29, 40),  # S = 81: two warps and a named barrier (the train step's U)
    (8, 400, 29, 180),  # S = 361 at T = 400: six warps
    (3, 80, 29, 300),  # S = 601: ten warps
    (4, 1, 7, 3),  # T = 1: the seeds alone
    (3, 40, 600, 12),  # C = 600: classes past one warp's lanes
])
def test_ctc_kernels_match_plain(dev, b, t, c, u):
    args = _ctc_case(dev, b, t, c, u, seed=u)
    before = (ctc_loss_fwd_bwd.launches, ctc_loss_fwd_only.launches)
    loss, grad = ctc_loss_fwd_bwd(*args, c - 1)
    fwd = ctc_loss_fwd_only(*args, c - 1)
    torch.cuda.synchronize()
    assert (ctc_loss_fwd_bwd.launches, ctc_loss_fwd_only.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    want_loss, want_grad = ctc_loss_plain(*args, c - 1)
    torch.testing.assert_close(loss, want_loss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(fwd, ctc_loss_fwd_only_plain(*args, c - 1), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(grad, want_grad, atol=1e-5, rtol=1e-5)
    assert bool(torch.isfinite(loss).all())


def _ctc_edge_rows(dev, t, c, u, seed):
    """No frames, no labels, one label repeated, no alignment, and a full row."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(5, t, c) * 2).astype(np.float32)).to(dev)
    labels = rng.randint(0, c - 1, (5, u)).astype(np.int32)
    labels[2] = labels[2, 0]  # repeats need a blank between them: 2u - 1 frames
    logit_len = np.array([0, t, t, 2, t], np.int32)
    label_len = np.array([u, 0, u, u, u], np.int32)
    labels[1] = -1
    as_t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return logits, as_t(logit_len), as_t(labels), as_t(label_len)


@pytest.mark.parametrize("t,c,u,route", [
    (12, 29, 3, "one_warp"),
    (120, 29, 40, "warps"),
    (400, 29, 180, "warps"),
    (1300, 11, 600, "warps"),
    (9, 5, 10000, "global"),
])
def test_ctc_kernels_on_edge_rows(dev, t, c, u, route):
    assert ctc_plan(5, t, 2 * u + 1).route == route
    args = _ctc_edge_rows(dev, t, c, u, seed=t)
    loss, grad = ctc_loss_fwd_bwd(*args, c - 1)
    fwd = ctc_loss_fwd_only(*args, c - 1)
    want_loss, want_grad = ctc_loss_plain(*args, c - 1)
    torch.testing.assert_close(loss, want_loss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(fwd, ctc_loss_fwd_only_plain(*args, c - 1), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(grad, want_grad, atol=1e-5, rtol=1e-5)
    assert float(loss[3]) > 1e29  # no alignment: a finite loss of about 1e30
    assert not bool(grad[0].any())  # no frames: no gradient


@pytest.mark.parametrize("u", [40, 180])
def test_ctc_fwd_bwd_is_bitwise_repeatable(dev, u):
    args = _ctc_case(dev, 32, 400, 29, u, seed=7)
    first, second = ctc_loss_fwd_bwd(*args, 28), ctc_loss_fwd_bwd(*args, 28)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    assert torch.equal(ctc_loss_fwd_only(*args, 28), ctc_loss_fwd_only(*args, 28))


def test_ctc_fwd_bwd_is_bitwise_repeatable_at_a_wide_row(dev):
    """S = 4095: 16 warps of 8 lanes and chunks of 2 steps, so a chain's two
    stage slots of new rows turn over every 2 steps while their bulk stores
    read them. Five calls give equal bits, and agree with the plain version."""
    b, t, c, u = 4, 4200, 11, 2047
    assert ctc_plan(b, t, 2 * u + 1).chunk == 2
    args = _ctc_case(dev, b, t, c, u, seed=3)
    calls = [ctc_loss_fwd_bwd(*args, c - 1) for _ in range(5)]
    for loss, grad in calls[1:]:
        assert torch.equal(loss, calls[0][0]) and torch.equal(grad, calls[0][1])
    want_loss, want_grad = ctc_loss_plain(*args, c - 1)
    torch.testing.assert_close(calls[0][0], want_loss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(calls[0][1], want_grad, atol=1e-5, rtol=1e-5)
    assert float(calls[0][0][0]) < 1e29  # row 0 has an alignment


@pytest.mark.parametrize("u,lanes", [(40, 3), (60, 4), (180, 3), (180, 4), (600, 6)])
def test_ctc_kernels_at_other_chain_layouts(dev, u, lanes):
    """The layouts that probes/ctc_chain_step.py times beside the plan's: 3,
    4 and 6 lanes per thread on fewer warps, launched with their plan."""
    b, t, c = 5, 2 * u + 41, 29
    logits, logit_len, labels, label_len = _ctc_case(dev, b, t, c, u, seed=lanes)
    want_loss, want_grad = ctc_loss_plain(logits, logit_len, labels, label_len, c - 1)
    grad = torch.empty_like(logits)
    for fn, g in (("ctc_loss_fwd_bwd", grad), ("ctc_loss_fwd_only", None)):
        plan = ctc_plan(b, t, 2 * u + 1, g is not None, lanes=lanes)
        assert plan.lanes_per_thread == lanes
        loss = ctc_ops._launch(fn, fn, plan, logits, logit_len, labels, label_len, c - 1, g)
        torch.testing.assert_close(loss, want_loss, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(grad, want_grad, atol=1e-5, rtol=1e-5)


def test_ctc_kernels_refuse_a_plan_of_another_shape(dev):
    """The C side reckons the shared memory and grids itself and refuses a
    plan that differs, rather than launch with it."""
    logits, logit_len, labels, label_len = _ctc_case(dev, 3, 50, 29, 12, seed=1)
    plan = ctc_plan(3, 50, 25)
    for bad in (plan._replace(chain_smem_bytes=plan.chain_smem_bytes + 16),
                plan._replace(grad_blocks=plan.grad_blocks - 1),
                plan._replace(lane_stride=25), ctc_plan(3, 50, 27)):
        with pytest.raises(RuntimeError):
            ctc_ops._launch("ctc_loss", "ctc_loss_fwd_bwd", bad, logits, logit_len, labels,
                            label_len, 28, torch.empty_like(logits))


def test_ctc_model_on_card_trains_every_parameter(dev):
    """Autograd reaches every encoder weight through the BLSTM and CTC kernels."""
    cfg = CTCConfig(encoder=EncoderConfig(num_units=24, num_layers=3), num_classes=7)
    cpu = CTCModel(cfg, 10, torch.Generator().manual_seed(0))
    model = CTCModel(cfg, 10, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(rng.randn(3, 13, 10).astype(np.float32))
    lens = torch.tensor([13, 6, 1])
    labels = torch.tensor([[0, 1, 1], [2, 3, -1], [4, -1, -1]], dtype=torch.int32)
    label_len = torch.tensor([3, 2, 1], dtype=torch.int32)
    counts = (lstm_bidi.launches, lstm_bidi_bwd.launches, ctc_loss_fwd_bwd.launches)
    for m, d in ((cpu, "cpu"), (model, dev)):
        out = m(feats.to(d), lens.to(d))
        ctc_loss(out.logits, out.logit_len, labels.to(d), label_len.to(d)).sum().backward()
    torch.cuda.synchronize()
    assert (lstm_bidi.launches, lstm_bidi_bwd.launches, ctc_loss_fwd_bwd.launches) == (
        counts[0] + 3, counts[1] + 3, counts[2] + 1)
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-4, rtol=1e-4, msg=name)


def test_joint_train_step_on_card_matches_cpu(dev):
    """The joint CTC-attention loss with every term on (smoothing, λ anneal,
    guided attention, weight decay) and its gradient, card against CPU, on an
    odd T (the pyramid's zero frame) and ragged lengths: 3 #1 and 3 #2
    launches, 1 #5, and no #7 (training reads attention unfused)."""
    cfg = Seq2SeqConfig(
        encoder=EncoderConfig(encoder_type="pyramidal_blstm", num_units=16, num_layers=3),
        attention=AttentionConfig(attention_dim=12, conv_num_channels=4, conv_width=9),
        num_classes=7, decoder_num_units=16, embedding_dim=8, ctc_loss_weight=0.3)
    task = att_task.AttTaskConfig(model=cfg, frontend=None, feature_dim=10, weight_decay=1e-3,
                                  label_smoothing=0.05, guided_attention_weight=5.0,
                                  guided_attention_decay_steps=20, ctc_weight_init=0.6,
                                  ctc_weight_anneal_steps=60)
    params = att_task.init_params(task, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(4)
    batch = {"inputs": torch.from_numpy(rng.randn(3, 41, 10).astype(np.float32)),
             "input_len": torch.tensor([41, 26, 15]),
             "labels": torch.tensor([[0, 1, 1, 6], [2, 3, -1, -1], [4, -1, -1, -1]],
                                    dtype=torch.int32),
             "label_len": torch.tensor([4, 2, 1], dtype=torch.int32),
             "weight": torch.tensor([1.0, 1.0, 0.0])}
    counts = (lstm_bidi.launches, lstm_bidi_bwd.launches, ctc_loss_fwd_bwd.launches,
              location_attend.launches)
    res = []
    for d in ("cpu", dev):
        leaves = {k: v.to(d).requires_grad_(True) for k, v in params.items()}
        loss, aux = att_task.forward_loss(leaves, task, {k: v.to(d) for k, v in batch.items()},
                                          True, step=10)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        res.append(({k: float(v.detach()) for k, v in aux.items()}, [g.cpu() for g in grads]))
    torch.cuda.synchronize()
    assert (lstm_bidi.launches, lstm_bidi_bwd.launches, ctc_loss_fwd_bwd.launches,
            location_attend.launches) == (counts[0] + 3, counts[1] + 3, counts[2] + 1, counts[3])
    (aux_cpu, g_cpu), (aux_dev, g_dev) = res
    assert set(aux_cpu) == {"att_nll", "ctc_nll", "guided_att", "loss"}
    for k, v in aux_cpu.items():
        assert aux_dev[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
    for name, a, b in zip(params, g_cpu, g_dev):
        assert bool(a.abs().sum() > 0), name
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4, msg=name)


def _attend_case(dev, n, t, a, he, c, w, lengths, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, t).astype(np.float32)
    prev = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    arrays = [
        rng.randn(n, t, a).astype(np.float32) * 0.5,  # keys_in
        rng.randn(n, t, he).astype(np.float32),  # enc_out
        rng.randn(n, a).astype(np.float32) * 0.5,  # q
        prev.astype(np.float32),
        np.arange(t)[None, :] < np.asarray(lengths)[:, None],  # enc_mask
        ((rng.rand(w, 1, c) - 0.5) * 0.2).astype(np.float32),  # conv_w
        ((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32),  # w_loc
        ((rng.rand(a) - 0.5) * 0.2).astype(np.float32),  # v
    ]
    return [torch.from_numpy(x).to(dev) for x in arrays]


@pytest.mark.parametrize("n,t,a,he,c,w,sharpening,lengths", [
    (3, 37, 16, 12, 4, 10, 1.5, [37, 5, 1]),  # even W: (W-1)//2 taps on the left
    (4, 50, 40, 33, 20, 11, 1.0, [50, 0, 1, 49]),  # a row of length 0; C > 16 channels
    (64, 300, 256, 1024, 10, 101, 1.0, [300, 1, 0, 150] * 16),  # beam 8 x 8 at ls960_joint
    (2, 30000, 8, 8, 2, 5, 1.0, [30000, 7]),  # a long row: no T cap
])
def test_location_attend_kernel_matches_plain(dev, n, t, a, he, c, w, sharpening, lengths):
    args = _attend_case(dev, n, t, a, he, c, w, lengths, seed=t + w)
    before = location_attend.launches
    ctx, align = location_attend(*args, sharpening)
    torch.cuda.synchronize()
    assert location_attend.launches == before + 1
    want_ctx, want_align = location_attend_plain(*args, sharpening)
    torch.testing.assert_close(align, want_align, atol=1e-5, rtol=0)
    torch.testing.assert_close(ctx, want_ctx, atol=1e-4, rtol=0)
    for row, length in enumerate(lengths):
        if length == 0:
            torch.testing.assert_close(align[row], torch.full((t,), 1.0 / t, device=dev))
    again = location_attend(*args, sharpening)  # deterministic: no atomics
    assert torch.equal(again[0], ctx) and torch.equal(again[1], align)


def _grouped_attend_case(dev, g, t, a, he, c, w, lengths, seed, with_keys=True):
    """Kernel #7's grouped inputs: keys, enc_out and mask per utterance, q and
    prev per row (``g`` rows per utterance), and the scorer's bias b."""
    rng = np.random.RandomState(seed)
    u = len(lengths)
    n = u * g
    logits = rng.randn(n, t).astype(np.float32)
    prev = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    keys = rng.randn(u, t, a).astype(np.float32) * 0.5
    arrays = [
        keys if with_keys else None,
        rng.randn(u, t, he).astype(np.float32),  # enc_out
        rng.randn(n, a).astype(np.float32) * 0.5,  # q
        prev.astype(np.float32),
        np.arange(t)[None, :] < np.asarray(lengths)[:, None],  # enc_mask
        ((rng.rand(w, 1, c) - 0.5) * 0.2).astype(np.float32),  # conv_w
        ((rng.rand(c, a) - 0.5) * 0.2).astype(np.float32),  # w_loc
        ((rng.rand(a) - 0.5) * 0.2).astype(np.float32),  # v
    ]
    b = torch.from_numpy((rng.randn(a) * 0.3).astype(np.float32)).to(dev)
    return [None if x is None else torch.from_numpy(x).to(dev) for x in arrays], b


@pytest.mark.parametrize("g,t,a,he,c,w,sharpening,lengths,with_keys", [
    # the beam's call at ls960_joint: 8 utterances x 8 beams
    (8, 300, 256, 1024, 10, 101, 1.0, [300, 1, 0, 150, 299, 64, 7, 233], True),
    (2, 30000, 8, 8, 2, 5, 1.0, [30000, 7], True),  # N = 4: a long utterance, no T cap
    (4, 37, 16, 12, 16, 10, 1.5, [37, 0, 5], False),  # a pure location scorer: keys None
    (3, 50, 300, 33, 20, 11, 1.0, [50, 1], True),  # A > 256 units, C > 16, He % 4 != 0
    (16, 40, 16, 40, 6, 7, 1.0, [40, 3], True),  # G = 16: two row chunks of the context
    (4, 20, 16384, 8, 2, 3, 1.0, [20, 11], True),  # A = 16384: energies in row chunks
])
def test_grouped_location_attend_kernel_matches_plain(dev, g, t, a, he, c, w, sharpening,
                                                      lengths, with_keys):
    """C = 10, 2, 16, 20, 6: every channel layout of the energies kernel (C in
    registers as 3, 1, 4 or 2 float4s; C > 16 read as needed)."""
    args, b = _grouped_attend_case(dev, g, t, a, he, c, w, lengths, seed=t + g,
                                   with_keys=with_keys)
    before = location_attend.launches
    ctx, align = location_attend(*args, sharpening, b=b, group=g)
    torch.cuda.synchronize()
    assert location_attend.launches == before + 1
    assert ctx.shape == (len(lengths) * g, he) and align.shape == (len(lengths) * g, t)
    want_ctx, want_align = location_attend_plain(*args, sharpening, b=b, group=g)
    torch.testing.assert_close(align, want_align, atol=1e-5, rtol=0)
    torch.testing.assert_close(ctx, want_ctx, atol=1e-4, rtol=0)
    for utt, length in enumerate(lengths):
        if length == 0:
            torch.testing.assert_close(align[utt * g:(utt + 1) * g],
                                       torch.full((g, t), 1.0 / t, device=dev))
    again = location_attend(*args, sharpening, b=b, group=g)  # deterministic: no atomics
    assert torch.equal(again[0], ctx) and torch.equal(again[1], align)
    assert location_attend.launches == before + 2
    # the tiled layout (keys + b formed outside, each utterance repeated g
    # times, group 1) runs the same sums in the same order: equal bits
    keys, enc, q, prev, mask = args[:5]
    keys_in = b.expand(t, a)[None].expand(len(lengths), t, a) if keys is None else keys + b
    tiled = [x.repeat_interleave(g, dim=0).contiguous() for x in (keys_in, enc)]
    got = location_attend(tiled[0], tiled[1], q, prev, mask.repeat_interleave(g, dim=0),
                          *args[5:], sharpening)
    assert torch.equal(got[0], ctx) and torch.equal(got[1], align)


def test_location_attend_rejects_mixed_devices(dev):
    args = _attend_case(dev, 2, 9, 8, 8, 2, 3, [9, 4], seed=0)
    args[6] = args[6].cpu()
    with pytest.raises(ValueError, match="cpu"):
        location_attend(*args)


@pytest.mark.parametrize("g,t,a,he,c,w,lengths,with_keys", [
    (1, 300, 256, 1024, 10, 101, [300, 1, 0, 150, 299, 64, 7, 233], True),  # greedy, ls960
    (8, 300, 256, 1024, 10, 101, [300, 1, 0, 150, 299, 64, 7, 233], True),  # beam-8, ls960
    (3, 37, 16, 12, 4, 10, [37, 5], False),  # a pure location scorer, even W
])
def test_location_attend_gradient_matches_plain_autograd(dev, g, t, a, he, c, w, lengths,
                                                         with_keys):
    """``LocationAttend`` (the kernel forward, then autograd through the
    recomputed plain read) against autograd through ``location_attend_plain``
    on the card: every float input's gradient; one kernel launch per call,
    none in the backward."""
    args, b = _grouped_attend_case(dev, g, t, a, he, c, w, lengths, seed=t + g + 5,
                                   with_keys=with_keys)
    rng = np.random.RandomState(g)
    n = len(lengths) * g
    cts = [torch.from_numpy(rng.randn(n, x).astype(np.float32)).to(dev) for x in (he, t)]
    names = ["keys", "enc_out", "q", "prev_align", "conv_w", "w_loc", "v", "b"]
    grads = []
    for fn in (location_attend, location_attend_plain):
        leaves = [None if x is None else x.clone().requires_grad_(True)
                  for x in (*args[:4], *args[5:], b)]
        before = location_attend.launches
        outs = fn(*leaves[:4], args[4], *leaves[4:7], 1.5, b=leaves[7], group=g)
        used = [x for x in leaves if x is not None]
        grads.append(torch.autograd.grad(outs, used, cts))
        torch.cuda.synchronize()
        assert location_attend.launches == before + (fn is location_attend)
    assert len(grads[0]) == (8 if with_keys else 7)
    for name, got, want in zip([k for k, x in zip(names, (*args[:4], *args[5:], b))
                                if x is not None], *grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=name)
        assert bool(got.abs().sum() > 0), name
    with torch.no_grad():  # no gradient wanted: the kernel alone, no grad_fn
        ctx, _ = location_attend(*args, 1.5, b=b, group=g)
    assert ctx.grad_fn is None


@pytest.mark.parametrize("g,t,a,he,c,w,lengths,with_keys", [
    # the beam's call at ls960_joint: 8 utterances x 8 beams, 8-byte loads of 4 bf16
    (8, 300, 256, 1024, 10, 101, [300, 1, 0, 150, 299, 64, 7, 233], True),
    (1, 300, 256, 1024, 10, 101, [300, 1, 0, 150, 299, 64, 7, 233], True),  # greedy
    (4, 300, 128, 640, 10, 101, [300, 0, 31], False),  # csj_joint: no keys, He = 640
    (3, 50, 16, 34, 4, 11, [50, 1], True),  # He % 4 != 0: one bf16 per load
    (2, 1500, 8, 24, 2, 5, [1500, 7], True),  # T > 512: rows read in chunks
])
def test_location_attend_bf16_rows_kernel_matches_plain(dev, g, t, a, he, c, w, lengths,
                                                        with_keys):
    """#7 on bf16 encoder rows (``compute_dtype: bfloat16``) against its plain
    version on the same rows, at the float32 tolerances (widening is exact);
    float32 outputs, counted on ``launches_bf16``; two calls bitwise equal,
    and equal to the float32 kernel on the rows widened (the same sums in
    the same order)."""
    args, b = _grouped_attend_case(dev, g, t, a, he, c, w, lengths, seed=t + g + 9,
                                   with_keys=with_keys)
    args[1] = args[1].bfloat16()
    counts = location_attend.launches, location_attend.launches_bf16
    ctx, align = location_attend(*args, 1.0, b=b, group=g)
    torch.cuda.synchronize()
    assert (location_attend.launches, location_attend.launches_bf16) == (counts[0],
                                                                         counts[1] + 1)
    assert ctx.dtype == align.dtype == torch.float32
    want_ctx, want_align = location_attend_plain(*args, 1.0, b=b, group=g)
    torch.testing.assert_close(align, want_align, atol=1e-5, rtol=0)
    torch.testing.assert_close(ctx, want_ctx, atol=1e-4, rtol=0)
    for utt, length in enumerate(lengths):
        if length == 0:
            torch.testing.assert_close(align[utt * g:(utt + 1) * g],
                                       torch.full((g, t), 1.0 / t, device=dev))
    again = location_attend(*args, 1.0, b=b, group=g)
    assert torch.equal(again[0], ctx) and torch.equal(again[1], align)
    wide = location_attend(args[0], args[1].float(), *args[2:], 1.0, b=b, group=g)
    torch.cuda.synchronize()
    assert torch.equal(wide[0], ctx) and torch.equal(wide[1], align)
    assert (location_attend.launches, location_attend.launches_bf16) == (counts[0] + 1,
                                                                         counts[1] + 2)


def test_location_attend_bf16_rows_gradient(dev):
    """``LocationAttend`` on bf16 rows: the kernel forward (one bf16 launch)
    and the plain backward; the rows' gradient is bf16, the float32 one of
    autograd through the plain read rounded."""
    args, b = _grouped_attend_case(dev, 8, 300, 256, 1024, 10, 101,
                                   [300, 1, 0, 150, 299, 64, 7, 233], seed=17)
    enc = args[1].bfloat16()
    cts = [torch.from_numpy(np.random.RandomState(2).randn(64, x).astype(np.float32)).to(dev)
           for x in (1024, 300)]
    leaves = [x.clone().requires_grad_(True) for x in (args[2], enc)]
    before = location_attend.launches_bf16
    outs = location_attend(args[0], leaves[1], leaves[0], *args[3:], 1.0, b=b, group=8)
    dq, denc = torch.autograd.grad(outs, leaves, cts)
    torch.cuda.synchronize()
    assert location_attend.launches_bf16 == before + 1 and denc.dtype == torch.bfloat16
    wide = [x.detach().float().requires_grad_(True) for x in leaves]
    outs = location_attend_plain(args[0], wide[1], wide[0], *args[3:], 1.0, b=b, group=8)
    wq, wenc = torch.autograd.grad(outs, wide, cts)
    torch.testing.assert_close(dq, wq, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(denc.float(), wenc.bfloat16().float(), atol=1e-5, rtol=8e-3)


def test_bf16_attention_model_on_card_matches_cpu(dev):
    """A joint model at ``compute_dtype: bfloat16`` decodes on the card
    through the bf16 walks and #7's bf16 entry, one launch per decoder step
    and no float32 #7 call; ids, tokens and logits as on the CPU (the bf16
    encoder rounds alike on both at this size)."""
    cfg = Seq2SeqConfig(
        encoder=EncoderConfig(encoder_type="pyramidal_blstm", num_units=16, num_layers=3,
                              compute_dtype="bfloat16"),
        attention=AttentionConfig(attention_dim=12, conv_num_channels=4, conv_width=9),
        num_classes=9, decoder_num_units=16, embedding_dim=8, max_decode_length=24,
        ctc_loss_weight=0.3)
    cpu = Seq2SeqModel(cfg, 10, torch.Generator().manual_seed(0)).eval()
    model = Seq2SeqModel(cfg, 10, torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(3, 41, 10).astype(np.float32))
    lens = torch.tensor([41, 17, 0])
    with torch.inference_mode():
        want = greedy_decode(cpu, feats, lens)
        before = location_attend.launches, location_attend.launches_bf16
        got = greedy_decode(model, feats.to(dev), lens.to(dev))
        torch.cuda.synchronize()
        assert got.enc_out.dtype == torch.bfloat16 and got.logits.dtype == torch.float32
        assert location_attend.launches == before[0]
        assert location_attend.launches_bf16 - before[1] == got.steps == want.steps
        torch.testing.assert_close(got.logits.cpu(), want.logits, atol=5e-2, rtol=0)
        assert torch.equal(got.predicted_ids.cpu(), want.predicted_ids)
        want_b = attention_beam_search(cpu, feats, lens, beam_width=4, length_penalty=0.6)
        before = location_attend.launches_bf16
        got_b = attention_beam_search(model, feats.to(dev), lens.to(dev), beam_width=4,
                                      length_penalty=0.6)
        torch.cuda.synchronize()
        assert location_attend.launches_bf16 - before == got_b.steps == want_b.steps
    assert torch.equal(got_b.tokens.cpu(), want_b.tokens)


@pytest.mark.parametrize("a_shape,b_shape,exact", [((300, 512), (512, 2048), False),
                                                   ((4, 100, 64), (4, 64, 100), False),
                                                   ((300, 512), (512, 2048), True)])
def test_bf16_matmul_gradients_on_card_match_cpu(dev, a_shape, b_shape, exact):
    """``ops/bf16.matmul``'s operand gradients on the card, the float32
    cotangent split hi + lo into two bf16 products, against the CPU's exact
    float32 products of the same cotangent: within one bf16 ulp of the
    result (2**-7 relative at most), and 1e-4 of the largest entry where
    the sums cancel (the split drops bits below 2**-17 of each cotangent
    entry; rounding the cotangent to bf16, 2**-9, would exceed it). With
    ``exact`` the cotangent is bf16-exact and ``bf16_cotangent`` skips the
    lo part, as ``BiLSTM`` calls it."""
    rng = np.random.RandomState(4)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in (a_shape, b_shape))
    cot = torch.from_numpy(rng.randn(*torch.broadcast_shapes(a_shape[:-2], b_shape[:-2]),
                                     a_shape[-2], b_shape[-1]).astype(np.float32))
    if exact:
        cot = cot.bfloat16().float()
    grads = []
    for device in (dev, torch.device("cpu")):
        leaves = [x.to(device).requires_grad_(True) for x in (a, b)]
        y = bf16_ops.matmul(*leaves, bf16_cotangent=exact)
        grads.append([g.cpu() for g in torch.autograd.grad(y, leaves, cot.to(device))])
    for got, want, what in zip(*grads, ("da", "db")):
        assert got.dtype == want.dtype == torch.float32, what
        torch.testing.assert_close(got, want, rtol=2 ** -7,
                                   atol=1e-4 * float(want.abs().max()))


def test_attention_model_on_card_matches_cpu(dev):
    """Greedy and beam ids on the card equal the CPU's; one #7 launch per decoder step."""
    cfg = Seq2SeqConfig(
        encoder=EncoderConfig(encoder_type="pyramidal_blstm", num_units=16, num_layers=3),
        attention=AttentionConfig(attention_dim=12, conv_num_channels=4, conv_width=9),
        num_classes=9, decoder_num_units=16, embedding_dim=8, max_decode_length=24,
        ctc_loss_weight=0.3)
    cpu = Seq2SeqModel(cfg, 10, torch.Generator().manual_seed(0)).eval()
    model = Seq2SeqModel(cfg, 10, torch.Generator().manual_seed(0)).to(dev).eval()
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(3, 41, 10).astype(np.float32))
    lens = torch.tensor([41, 17, 0])
    with torch.inference_mode():
        want = greedy_decode(cpu, feats, lens)
        before = location_attend.launches
        got = greedy_decode(model, feats.to(dev), lens.to(dev))
        torch.cuda.synchronize()
        assert location_attend.launches - before == got.steps == want.steps
        assert torch.equal(got.predicted_ids.cpu(), want.predicted_ids)
        torch.testing.assert_close(got.logits.cpu(), want.logits, atol=1e-4, rtol=0)
        want_b = attention_beam_search(cpu, feats, lens, beam_width=4, length_penalty=0.6)
        before = location_attend.launches
        got_b = attention_beam_search(model, feats.to(dev), lens.to(dev), beam_width=4,
                                      length_penalty=0.6)
        torch.cuda.synchronize()
        assert location_attend.launches - before == got_b.steps == want_b.steps
    assert torch.equal(got_b.tokens.cpu(), want_b.tokens)
    assert torch.equal(got_b.lengths.cpu(), want_b.lengths)
    torch.testing.assert_close(got_b.scores.cpu(), want_b.scores, atol=1e-4, rtol=0)


# ---- beams, joint rescoring and fusion (card against CPU) ---------------------------


def _beam_logits(b, t, c, seed):
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(b, t, c) * 2).astype(np.float32))
    lens = torch.tensor(([t, 1, 0] + [int(x) for x in rng.randint(1, t + 1, b)])[:b])
    return logits, lens


def _assert_beams_equal(got, want, score_atol=1e-4):
    live = want[2] > -1e29
    assert torch.equal(got[2].cpu() > -1e29, live)
    assert torch.equal(got[0].cpu()[live], want[0][live])
    assert torch.equal(got[1].cpu()[live], want[1][live])
    torch.testing.assert_close(got[2].cpu()[live], want[2][live], atol=score_atol, rtol=1e-5)


@pytest.mark.parametrize("b,t,c,w,k", [(3, 40, 29, 20, 16), (4, 64, 6, 4, 3)])
def test_ctc_prefix_beam_on_card_matches_cpu_without_host_sync(dev, b, t, c, w, k):
    """The frame loop reads nothing back to the host (sync debug mode raises on
    any synchronising call), and its results equal the CPU's."""
    from tensorflow_end2end_speech_recognition_tpu_torch.decoding import ctc_prefix_beam as beam

    logits, lens = _beam_logits(b, t, c, seed=w + k)
    want = beam.ctc_prefix_beam_search(logits, lens, c - 1, beam_width=w, top_k_classes=k)
    logits_d, lens_d = logits.to(dev), lens.to(dev)
    state = beam.beam_init(b, w, t, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = beam.beam_advance(state, logits_d, lens_d, c - 1, k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _assert_beams_equal(beam.beam_finalize(state), want)


def test_ctc_loss_fwd_only_on_rescoring_labels_matches_plain(dev):
    """#6 on the labels joint rescoring gives it: the blank id (the attention
    decoder's sos) inside a hypothesis, length 0, more labels than frames,
    -1 past each length, a row of no frames, at N = B·W = 12 rows."""
    rng = np.random.RandomState(9)
    n, t, c, u = 12, 20, 29, 15
    logits = torch.from_numpy((rng.randn(n, t, c) * 2).astype(np.float32))
    label_len = torch.tensor([3, 0, 15, 7, 1, 12, 15, 5, 0, 9, 2, 11], dtype=torch.int32)
    labels = torch.from_numpy(rng.randint(0, c, (n, u)).astype(np.int32))  # c - 1 = blank
    labels[0, 1] = c - 1
    labels = torch.where(torch.arange(u)[None] < label_len[:, None], labels, -1)
    logit_len = torch.tensor([20, 20, 6, 20, 20, 20, 20, 0, 3, 20, 20, 20], dtype=torch.int32)
    args = (logits, logit_len, labels, label_len)
    want = ctc_loss_fwd_only_plain(*args, c - 1)
    before = ctc_loss_fwd_only.launches
    got = ctc_loss(*(x.to(dev) for x in args), blank_id=c - 1, need_grad=False)
    torch.cuda.synchronize()
    assert ctc_loss_fwd_only.launches == before + 1
    assert float(want[2]) > 1e29 and bool((labels == c - 1).any())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


def _joint_model(seed=0, max_len=16):
    cfg = Seq2SeqConfig(
        encoder=EncoderConfig(encoder_type="pyramidal_blstm", num_units=16, num_layers=3),
        attention=AttentionConfig(attention_dim=12, conv_num_channels=4, conv_width=9),
        num_classes=9, decoder_num_units=16, embedding_dim=8, max_decode_length=max_len,
        ctc_loss_weight=0.3)
    return cfg, Seq2SeqModel(cfg, 10, torch.Generator().manual_seed(seed)).eval()


def test_joint_rescoring_and_fused_beams_on_card_match_cpu(dev):
    """The attention beam with an RNN-LM fused and joint rescoring (#7 and #6),
    and the CTC prefix beam with carried-state fusion, card against CPU."""
    import copy

    from tensorflow_end2end_speech_recognition_tpu_torch.decoding import (
        ctc_prefix_beam_search,
        joint_rescore,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.models.lm import (
        LMConfig,
        RNNLM,
        make_fusion_lm,
    )

    cfg, cpu = _joint_model()
    model = copy.deepcopy(cpu).to(dev)
    lm_cpu = RNNLM(LMConfig(vocab=cfg.vocab, num_units=16, embedding_dim=8),
                   torch.Generator().manual_seed(1)).eval()
    lm_dev = copy.deepcopy(lm_cpu).to(dev)
    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(3, 41, 10).astype(np.float32))
    lens = torch.tensor([41, 17, 0])
    res = []
    for m, lm, device in ((cpu, lm_cpu, "cpu"), (model, lm_dev, dev)):
        with torch.inference_mode():
            before = (location_attend.launches, ctc_loss_fwd_only.launches)
            out = attention_beam_search(m, feats.to(device), lens.to(device), beam_width=4,
                                        length_penalty=0.6, lm=lm, lm_weight=0.5)
            out = joint_rescore(out, 0.3, cfg.num_classes, 0.6)
            ctc = ctc_prefix_beam_search(
                out.ctc_logits, out.ctc_logit_len, cfg.num_classes, beam_width=4,
                top_k_classes=4, lm_weight=0.5,
                fusion_lm=make_fusion_lm(lm, cfg.num_classes + 1))
            torch.cuda.synchronize()
            launched = (location_attend.launches - before[0],
                        ctc_loss_fwd_only.launches - before[1])
        res.append((out, [x.cpu() for x in ctc], launched))
    (want, want_ctc, cpu_launched), (got, got_ctc, launched) = res
    assert cpu_launched == (0, 0) and launched == (got.steps, 1)
    assert torch.equal(got.tokens.cpu(), want.tokens)
    assert torch.equal(got.lengths.cpu(), want.lengths)
    torch.testing.assert_close(got.scores.cpu(), want.scores, atol=1e-4, rtol=1e-5)
    _assert_beams_equal(got_ctc, want_ctc)


def test_beam_eval_steps_on_card_match_cpu(dev):
    """Both beam eval steps of ``bin/eval``: ids, lengths and NLL, card against CPU."""
    from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import (
        FrontendConfig,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task

    rng = np.random.RandomState(6)
    wav = (rng.randn(3, 8000) * 0.1).astype(np.float32)
    input_len = np.asarray([8000, 5000, 0], np.int32)
    for i, n in enumerate(input_len):
        wav[i, n:] = 0.0
    labels = rng.randint(0, 9, (3, 6)).astype(np.int32)
    label_len = np.asarray([6, 2, 0], np.int32)
    labels[np.arange(6)[None] >= label_len[:, None]] = -1
    batch = dict(inputs=wav, input_len=input_len, labels=labels, label_len=label_len)
    enc = EncoderConfig(encoder_type="blstm", num_units=16, num_layers=2)
    ctc = ctc_task.CTCTaskConfig(model=CTCConfig(encoder=enc, num_classes=9),
                                 frontend=FrontendConfig(use_energy=False), num_stack=3,
                                 num_skip=3)
    cfg, _ = _joint_model(max_len=12)
    att = att_task.AttTaskConfig(model=cfg._replace(encoder=enc._replace(
        encoder_type="pyramidal_blstm")), frontend=FrontendConfig(use_energy=False))
    for mod, task, step in (
            (ctc_task, ctc, ctc_task.make_beam_eval_step(ctc, 5)),
            (att_task, att, att_task.make_beam_eval_step(att, 4, 0.6, joint_rescore_weight=0.3))):
        params = mod.init_params(task, torch.Generator().manual_seed(2),
                                 input_dim=task.input_dim)
        outs = []
        for device in ("cpu", dev):
            tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            outs.append([x.cpu() for x in step({k: v.to(device) for k, v in params.items()},
                                               tb)])
        (ic, lc, nc), (ig, lg, ng) = outs
        assert torch.equal(ic, ig) and torch.equal(lc, lg)
        torch.testing.assert_close(ng, nc, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("enc", [
    dict(encoder_type="conformer", pos_encoding="relative", conv_kernel_size=4),
    dict(encoder_type="transformer", pos_encoding="rotary", left_context=3),
], ids=["conformer-relative", "transformer-rotary-causal"])
def test_conformer_ctc_model_on_card_matches_cpu(dev, enc):
    """A conformer / transformer CTC model at toy width, card against CPU: the
    logits, then the loss on #5 and every gradient; one #5 launch and no
    LSTM walk. Lengths include 1 and 0 (a row with no valid frame)."""
    cfg = CTCConfig(encoder=EncoderConfig(num_units=24, num_layers=2, num_heads=4,
                                          ff_expansion=2, **enc), num_classes=7)
    cpu = CTCModel(cfg, 10, torch.Generator().manual_seed(0))
    model = CTCModel(cfg, 10, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(4, 13, 10).astype(np.float32))
    lens = torch.tensor([13, 6, 1, 0])
    labels = torch.tensor([[0, 1, 1], [2, 3, -1], [4, -1, -1], [-1, -1, -1]], dtype=torch.int32)
    label_len = torch.tensor([3, 2, 1, 0], dtype=torch.int32)
    counts = (lstm_bidi.launches, lstm_layer.launches, ctc_loss_fwd_bwd.launches)
    outs = []
    for m, d in ((cpu, "cpu"), (model, dev)):
        out = m(feats.to(d), lens.to(d))
        ctc_loss(out.logits[:3], out.logit_len[:3], labels[:3].to(d),
                 label_len[:3].to(d)).sum().backward()
        outs.append(out.logits.detach().cpu())
    torch.cuda.synchronize()
    assert (lstm_bidi.launches, lstm_layer.launches, ctc_loss_fwd_bwd.launches) == (
        counts[0], counts[1], counts[2] + 1)
    torch.testing.assert_close(outs[1], outs[0], atol=1e-4, rtol=1e-4)
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-4, rtol=1e-4, msg=name)


def test_moe_aux_loss_on_card_matches_cpu(dev):
    """The MoE encoder's weighted load-balance loss and its gradient, card
    against CPU, with SpecAugment drawn from a generator on the card."""
    from tensorflow_end2end_speech_recognition_tpu_torch.frontend.augment import (
        SpecAugmentConfig,
        spec_augment,
    )

    cfg = CTCConfig(encoder=EncoderConfig(encoder_type="conformer", num_units=16, num_layers=2,
                                          num_heads=2, conv_kernel_size=3, moe_experts=4,
                                          moe_top_k=2, moe_aux_weight=0.5), num_classes=5)
    cpu = CTCModel(cfg, 12, torch.Generator().manual_seed(1))
    model = CTCModel(cfg, 12, torch.Generator().manual_seed(1)).to(dev)
    feats = torch.from_numpy(np.random.RandomState(6).randn(3, 17, 12).astype(np.float32))
    lens = torch.tensor([17, 9, 1])
    aux = []
    for m, d in ((cpu, "cpu"), (model, dev)):
        out = m(feats.to(d), lens.to(d))
        out.aux_loss.backward()
        aux.append(float(out.aux_loss))
    assert aux[1] == pytest.approx(aux[0], rel=1e-5)
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        if q.grad is not None:
            torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-5, rtol=1e-4, msg=name)
    masked = spec_augment(feats.to(dev), lens.to(dev), torch.Generator(device=dev).manual_seed(0),
                          SpecAugmentConfig(freq_mask_width=4, time_mask_frac=0.3))
    assert masked.device.type == "cuda" and bool((masked == 0).any())


@pytest.mark.parametrize("encoder_type", ["vgg_blstm", "vgg_lstm"])
def test_vgg_encoder_on_card_matches_cpu(dev, encoder_type):
    """The VGG encoder at toy size (3 planes of F = 13, odd T, lengths that
    include 1), card against CPU: outputs, lengths and every gradient through
    the cuDNN convolutions and the LSTM kernels (2 walks each way)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import Encoder

    cfg = EncoderConfig(encoder_type=encoder_type, num_units=16, num_layers=2)
    cpu = Encoder(cfg, 39, torch.Generator().manual_seed(0))
    enc = Encoder(cfg, 39, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.RandomState(7)
    feats = torch.from_numpy(rng.randn(3, 37, 39).astype(np.float32))
    lens = torch.tensor([37, 1, 22])
    fwd, bwd = ((lstm_bidi, lstm_bidi_bwd) if encoder_type == "vgg_blstm"
                else (lstm_layer, lstm_layer_bwd))
    counts = (fwd.launches, bwd.launches)
    outs = []
    for m, d in ((cpu, "cpu"), (enc, dev)):
        out = m(feats.to(d), lens.to(d))
        out.outputs.square().sum().backward()
        outs.append((out.outputs.detach().cpu(), out.lengths.cpu()))
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (counts[0] + 2, counts[1] + 2)
    assert outs[1][0].shape == (3, 10, cfg.output_dim)
    assert torch.equal(outs[1][1], outs[0][1])
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-4, rtol=1e-4)
    for (name, p), q in zip(enc.named_parameters(), cpu.parameters()):
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-4, rtol=1e-4, msg=name)


def test_multitask_ctc_model_on_card_matches_cpu(dev):
    """A multitask CTC model at toy size (3 BLSTM layers, the sub head after
    layer 2), card against CPU: both heads' logits, the mixed loss on two #5
    calls and every gradient."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task

    cfg = CTCConfig(encoder=EncoderConfig(encoder_type="multitask_blstm", num_units=16,
                                          num_layers=3, num_layers_sub=2),
                    num_classes=7, num_classes_sub=5)
    task = ctc_task.CTCTaskConfig(model=cfg, frontend=None, feature_dim=10,
                                  main_task_weight=0.8, weight_decay=1e-3)
    params = ctc_task.init_params(task, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(8)
    batch = {"inputs": torch.from_numpy(rng.randn(3, 15, 10).astype(np.float32)),
             "input_len": torch.tensor([15, 9, 1]),
             "labels": torch.tensor([[0, 1, 6], [2, 3, -1], [4, -1, -1]], dtype=torch.int32),
             "label_len": torch.tensor([3, 2, 1], dtype=torch.int32),
             "labels_sub": torch.tensor([[0, 1], [2, -1], [4, -1]], dtype=torch.int32),
             "label_len_sub": torch.tensor([2, 1, 1], dtype=torch.int32),
             "weight": torch.tensor([1.0, 1.0, 0.0])}
    counts = (lstm_bidi.launches, lstm_bidi_bwd.launches, ctc_loss_fwd_bwd.launches)
    res = []
    for d in ("cpu", dev):
        leaves = {k: v.to(d).requires_grad_(True) for k, v in params.items()}
        loss, aux = ctc_task.forward_loss(leaves, task, {k: v.to(d) for k, v in batch.items()},
                                          True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        res.append(({k: float(v.detach()) for k, v in aux.items()}, [g.cpu() for g in grads]))
    torch.cuda.synchronize()
    assert (lstm_bidi.launches, lstm_bidi_bwd.launches, ctc_loss_fwd_bwd.launches) == (
        counts[0] + 3, counts[1] + 3, counts[2] + 2)
    (aux_cpu, g_cpu), (aux_dev, g_dev) = res
    assert set(aux_cpu) == {"ctc_nll", "ctc_nll_sub", "loss"}
    for k, v in aux_cpu.items():
        assert aux_dev[k] == pytest.approx(v, rel=1e-5, abs=1e-5), k
    for name, a, b in zip(params, g_cpu, g_dev):
        assert bool(a.abs().sum() > 0), name
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4, msg=name)


CARRY_SHAPES = [
    (5, 7, 70, [7, 0, 3, 1, 0]),  # ragged, two rows with no valid step (paused streams)
    (8, 10, 512, [10, 0, 10, 9, 5, 10, 1, 10]),  # ls_streaming_ctc's chunk at B = 8
    (600, 3, 512, [3, 0, 2] * 200),  # B x units past 2048: the batch split over launches
]


@pytest.mark.parametrize("b,t,h,lengths", CARRY_SHAPES)
def test_layer_kernel_with_carried_state_matches_plain(dev, b, t, h, lengths):
    x, _, wh, _, mask = _inputs(dev, b, t, h, lengths, seed=h + 7)
    rng = np.random.RandomState(h)
    h0, c0 = (torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev) for _ in range(2))
    before = lstm_layer.launches
    with torch.no_grad():
        ys, (h_t, c_t) = lstm_layer(x, wh, mask, 0.5, initial_state=(h0, c0))
        ys_cs = lstm_layer_fwd(x, wh, mask, 0.5, with_cs=True, initial_state=(h0, c0))
    torch.cuda.synchronize()
    assert lstm_layer.launches == before + 2
    want_ys, want_cs, (want_h, want_c) = lstm_layer_fwd_plain(x, wh, mask, 0.5, (h0, c0))
    for g, w in ((ys, want_ys), (h_t, want_h), (c_t, want_c), (ys_cs[1], want_cs)):
        torch.testing.assert_close(g, w, **LSTM_TOL)
    assert torch.equal(ys_cs[0], ys) and torch.equal(ys_cs[2][0], h_t)
    paused = torch.tensor(lengths, device=dev) == 0
    assert torch.equal(h_t[paused], h0[paused]) and torch.equal(c_t[paused], c0[paused])
    assert not ys[paused].any()
    # zeros in equal the zero-state forward of before
    zeros = torch.zeros_like(h0)
    with torch.no_grad():
        z_ys, _ = lstm_layer(x, wh, mask, 0.5, initial_state=(zeros, zeros))
    torch.testing.assert_close(z_ys, lstm_layer_fwd(x, wh, mask, 0.5), **LSTM_TOL)


# #3 with bf16 products after its first step: a float32 h whose sums ran in
# another order than the plain version's may round to the other bf16 neighbour
# (one bf16 ulp, up to 2^-8 |h|), which moves the next step's gates by that
# times |Wh| (seen: 5.6e-4 at ls_streaming_ctc's chunk, B = 8, T = 10, H = 512);
# step 0's operands are the inputs h0 and Wh, rounded alike on both sides, so a
# one-step walk is held to LSTM_TOL
BF16_PRODUCT_TOL = dict(atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("b,t,h,lengths", CARRY_SHAPES)
def test_layer_kernel_with_bf16_products_matches_plain(dev, b, t, h, lengths):
    """#3's carried walk with bf16 products (``lstm_layer_fwd_carry_bf16``)
    against its plain version: float32 streams and carries, counted on
    ``launches_bf16_product`` alone; a paused row gives back (h0, c0)."""
    x, _, wh, _, mask = _inputs(dev, b, t, h, lengths, seed=h + 9)
    rng = np.random.RandomState(h + 1)
    h0, c0 = (torch.from_numpy(rng.randn(b, h).astype(np.float32)).to(dev) for _ in range(2))
    before = lstm_layer.launches, lstm_layer.launches_bf16, lstm_layer.launches_bf16_product
    with torch.no_grad():
        ys, (h_t, c_t) = lstm_layer(x, wh, mask, 0.5, initial_state=(h0, c0),
                                    bf16_product=True)
        one = lstm_layer(x[:, :1].contiguous(), wh, mask[:, :1].contiguous(), 0.5,
                         initial_state=(h0, c0), bf16_product=True)
        f_one = lstm_layer(x[:, :1].contiguous(), wh, mask[:, :1].contiguous(), 0.5,
                           initial_state=(h0, c0))
    torch.cuda.synchronize()
    assert (lstm_layer.launches, lstm_layer.launches_bf16,
            lstm_layer.launches_bf16_product) == (before[0] + 1, before[1], before[2] + 2)
    want_ys, _, (want_h, want_c) = lstm_layer_fwd_plain(x, wh, mask, 0.5, (h0, c0),
                                                        bf16_product=True)
    for g, w in ((ys, want_ys), (h_t, want_h), (c_t, want_c)):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **BF16_PRODUCT_TOL)
    want_one = lstm_layer_fwd_plain(x[:, :1], wh, mask[:, :1], 0.5, (h0, c0),
                                    bf16_product=True)
    torch.testing.assert_close(one[0], want_one[0], **LSTM_TOL)
    torch.testing.assert_close(one[1][1], want_one[2][1], **LSTM_TOL)
    # not the float32 walk: its first step alone is moved past the tolerance
    assert float((one[0] - f_one[0]).abs().max()) > 10 * LSTM_TOL["atol"]
    paused = torch.tensor(lengths, device=dev) == 0
    assert torch.equal(h_t[paused], h0[paused]) and torch.equal(c_t[paused], c0[paused])


def test_bf16_stream_on_card_matches_cpu(dev):
    """A bf16 LSTM transducer's chunk steps on the card: tokens equal the
    CPU's, one bf16-product carried walk per layer and step, no plain step."""
    from tensorflow_end2end_speech_recognition_tpu_torch import streaming

    task, cpu, model = _stream_model(dev, "lstm", "bfloat16")
    chunk = 1600
    wav = (np.random.RandomState(4).randn(3, 4 * chunk) * 0.3).astype(np.float32)
    lens = [4 * chunk, 3 * chunk, 2 * chunk - 700]
    before = lstm_layer.launches_bf16_product
    plain = lstm_ops.lstm_layer_fwd_plain
    lstm_ops.lstm_layer_fwd_plain = None  # the card must not take the plain walk
    try:
        _, rows = _stream_rows(streaming.build_streaming_fn(task, model, chunk), wav, lens,
                               chunk)
    finally:
        lstm_ops.lstm_layer_fwd_plain = plain
    steps = -(-max(lens) // chunk) + 1
    assert lstm_layer.launches_bf16_product - before == 2 * steps
    assert _stream_rows(streaming.build_streaming_fn(task, cpu, chunk), wav, lens,
                        chunk)[1] == rows


def _stream_model(dev, encoder_type, compute_dtype="float32"):
    enc = (EncoderConfig(encoder_type="lstm", num_units=64, num_layers=2,
                         compute_dtype=compute_dtype)
           if encoder_type == "lstm" else
           EncoderConfig(encoder_type="conformer", num_units=32, num_layers=2, num_heads=2,
                         conv_kernel_size=5, pos_encoding="rotary", left_context=8,
                         compute_dtype=compute_dtype))
    from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
    from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt

    task = tt.TransducerTaskConfig(
        model=TransducerConfig(encoder=enc, num_classes=6, pred_num_units=16, embedding_dim=8,
                               joint_dim=16, max_symbols_per_frame=3),
        frontend=FrontendConfig(use_energy=False, add_deltas=False, cmvn="none"),
        num_stack=3, num_skip=3)
    cpu = tt.init_model(task, torch.Generator().manual_seed(0)).eval()
    import copy

    return task, cpu, copy.deepcopy(cpu).to(dev).eval()


def _stream_rows(fns, wav, lens, chunk, order=None):
    """Drive a stream chunk by chunk (``order``: the rows fed at each step,
    the others paused); returns (state, per-row tokens)."""
    init_fn, step_fn = fns[:2]
    b = wav.shape[0]
    state, rows = init_fn(b), [[] for _ in range(b)]
    n_chunks = -(-int(max(lens)) // chunk)
    nxt = [0] * b
    steps = order or [list(range(b))] * (n_chunks + 1)
    for fed in steps:
        piece, cl = np.zeros((b, chunk), np.float32), np.zeros((b,), np.int32)
        for r in fed:
            k = nxt[r]
            if k < n_chunks:
                piece[r] = wav[r, k * chunk: (k + 1) * chunk]
                cl[r] = np.clip(lens[r] - k * chunk, 0, chunk)
            elif k == n_chunks and lens[r] % chunk == 0:
                cl[r] = -1  # a stacked stream ending on a chunk boundary flushes
            nxt[r] += 1
        state, tok, n = step_fn(state, piece, cl)
        tok, n = tok.cpu().numpy(), n.cpu().numpy()
        for r in range(b):
            rows[r].extend(tok[r, : n[r]].tolist())
    return state, rows


@pytest.mark.parametrize("encoder_type", ["lstm", "conformer"])
def test_streamed_session_on_card_matches_offline_and_cpu(dev, encoder_type):
    from tensorflow_end2end_speech_recognition_tpu_torch import streaming
    from tensorflow_end2end_speech_recognition_tpu_torch.decoding.transducer_beam import (
        transducer_beam_search,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import (
        device_pipeline,
    )

    task, cpu, model = _stream_model(dev, encoder_type)
    chunk = 1600
    rng = np.random.RandomState(3)
    wav = (rng.randn(3, 4 * chunk) * 0.3).astype(np.float32)
    lens = [4 * chunk, 3 * chunk, 2 * chunk - 700]
    fns = streaming.build_streaming_fn(task, model, chunk, beam_width=3, max_prefix_len=60)
    before = lstm_layer.launches
    state, rows = _stream_rows(fns, wav, lens, chunk)
    torch.cuda.synchronize()
    steps = -(-max(lens) // chunk) + 1
    assert lstm_layer.launches - before == (2 * steps if encoder_type == "lstm" else 0)
    final = fns[2](state)
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(dev),
                                           "input_len": torch.tensor(lens, device=dev)})
        f_proj, enc_len = model.encode(feats, fl)
        ids, n = transducer_greedy_decode(model, f_proj, enc_len)
        want = transducer_beam_search(model, f_proj, enc_len, beam_width=3, max_len=60)
    assert rows == [ids[i, : n[i]].tolist() for i in range(3)]
    torch.testing.assert_close(final[1], want.lengths, rtol=0, atol=0)
    torch.testing.assert_close(final[0], want.tokens, rtol=0, atol=0)
    torch.testing.assert_close(final[2], want.scores, rtol=1e-5, atol=1e-3)
    # the same stream on the CPU gives the same tokens
    cpu_fns = streaming.build_streaming_fn(task, cpu, chunk, beam_width=3, max_prefix_len=60)
    assert _stream_rows(cpu_fns, wav, lens, chunk)[1] == rows
    # a row paused mid-stream keeps its state bit for bit and then resumes to
    # the same tokens
    order = [[0, 1, 2], [0, 2], [1], [0, 1, 2], [1, 2], [0], [0, 1, 2], [0, 1, 2]]
    paused_state, paused_rows = _stream_rows(fns, wav, lens, chunk, order)
    assert paused_rows == rows
    for x, y in zip(final, fns[2](paused_state)):
        assert torch.equal(x, y)


# ---- bf16 streams (compute_dtype: bfloat16) -------------------------------------

BF16_TOL = dict(atol=1e-5, rtol=8e-3)  # two bf16 ulps


def _close_bf16(got, want):
    assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("b,t,h,lengths", SHAPES + [(40, 9, 512, [9] * 39 + [1])])
def test_bf16_bidi_kernels_match_plain(dev, b, t, h, lengths):
    """#1 (with ``cs``) and #2 with bf16 streams: the bf16 entries launch, the
    float32 ones do not."""
    xf, xb, whf, whb, mask = _inputs(dev, b, t, h, lengths, seed=h + 7)
    xf, xb = xf.bfloat16(), xb.bfloat16()
    gys = [torch.from_numpy(np.random.RandomState(h).randn(b, t, h).astype(np.float32))
           .to(dev).bfloat16() for _ in range(2)]
    before = (lstm_bidi.launches, lstm_bidi.launches_bf16, lstm_bidi_bwd.launches,
              lstm_bidi_bwd.launches_bf16)
    got = lstm_bidi_fwd(xf, xb, whf, whb, mask, 1.0, with_cs=True)
    want = lstm_bidi_fwd_plain(xf, xb, whf, whb, mask, 1.0)
    dx = lstm_bidi_bwd(xf, xb, whf, whb, mask, *want, *gys, 1.0)
    torch.cuda.synchronize()
    assert (lstm_bidi.launches, lstm_bidi.launches_bf16, lstm_bidi_bwd.launches,
            lstm_bidi_bwd.launches_bf16) == (before[0], before[1] + 1, before[2], before[3] + 1)
    for g, w in zip(got, want):
        _close_bf16(g, w)
    for g, w in zip(dx, lstm_bidi_bwd_plain(xf, xb, whf, whb, mask, *want, *gys, 1.0)):
        _close_bf16(g, w)


@pytest.mark.parametrize("b,t,h,lengths", SHAPES)
def test_bf16_layer_kernels_match_plain(dev, b, t, h, lengths):
    """#3 (with ``cs``) and #4 with bf16 streams."""
    x, _, wh, _, mask = _inputs(dev, b, t, h, lengths, seed=h + 8)
    x = x.bfloat16()
    gys = torch.from_numpy(np.random.RandomState(h + 1).randn(b, t, h).astype(np.float32))
    gys = gys.to(dev).bfloat16()
    before = (lstm_layer.launches, lstm_layer.launches_bf16, lstm_layer_bwd.launches_bf16)
    got = lstm_layer_fwd(x, wh, mask, 0.5, with_cs=True)
    want = lstm_layer_fwd_plain(x, wh, mask, 0.5)
    dx = lstm_layer_bwd(x, wh, mask, *want, gys, 0.5)
    torch.cuda.synchronize()
    assert (lstm_layer.launches, lstm_layer.launches_bf16, lstm_layer_bwd.launches_bf16) == (
        before[0], before[1] + 1, before[2] + 1)
    for g, w in zip(got, want):
        _close_bf16(g, w)
    _close_bf16(dx, lstm_layer_bwd_plain(x, wh, mask, *want, gys, 0.5))


def test_bf16_never_reaches_the_float32_kernels(dev):
    """A bf16 BLSTM-CTC train step and a bf16 transducer encoder launch only
    the bf16 instantiations: the float32 counters do not move."""
    names = ("launches", "launches_bf16")
    fns = (lstm_bidi, lstm_bidi_bwd, lstm_layer, lstm_layer_bwd)
    before = {(f.__name__, n): getattr(f, n) for f in fns for n in names}
    cfg = CTCConfig(encoder=EncoderConfig(encoder_type="blstm", num_units=24, num_layers=2,
                                          compute_dtype="bfloat16"), num_classes=5)
    model = CTCModel(cfg, 10, torch.Generator().manual_seed(0)).to(dev)
    feats = torch.from_numpy(np.random.RandomState(2).randn(3, 13, 10).astype(np.float32))
    lens = torch.tensor([13, 6, 1])
    out = model(feats.to(dev), lens.to(dev))
    labels = torch.tensor([[1, 2], [3, -1], [-1, -1]], device=dev)
    ctc_loss(out.logits, out.logit_len, labels, torch.tensor([2, 1, 0], device=dev)).sum() \
        .backward()
    tr = TransducerModel(TransducerConfig(
        encoder=EncoderConfig(encoder_type="lstm", num_units=24, num_layers=2,
                              compute_dtype="bfloat16"),
        num_classes=6, pred_num_units=8, embedding_dim=4, joint_dim=12), 10).to(dev)
    with torch.inference_mode():
        f_proj, _ = tr.encode(feats.to(dev), lens.to(dev))
    torch.cuda.synchronize()
    moved = {k: getattr(f, n) - before[k] for f in fns for n in names
             for k in [(f.__name__, n)]}
    assert out.logits.dtype == torch.float32 and f_proj.dtype == torch.float32
    assert moved == {("lstm_bidi", "launches"): 0, ("lstm_bidi", "launches_bf16"): 2,
                     ("lstm_bidi_bwd", "launches"): 0, ("lstm_bidi_bwd", "launches_bf16"): 2,
                     ("lstm_layer", "launches"): 0, ("lstm_layer", "launches_bf16"): 2,
                     ("lstm_layer_bwd", "launches"): 0, ("lstm_layer_bwd", "launches_bf16"): 0}
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())


def test_accumulated_step_on_card_equals_one_batch(dev):
    """Four strided microbatches (one all fill, with per-speaker CMVN rows) against
    the one-batch step on the card: the kernels run once per microbatch; the
    loss within 2e-5 relative and every weight within 2e-5, as the JAX
    package's accumulation tests hold them."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer

    d, t, b = 12, 60, 8
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(encoder_type="blstm", num_units=32, num_layers=2),
                        num_classes=6),
        frontend=None, feature_dim=d, num_stack=3, num_skip=3)
    params = {k: v.to(dev) for k, v in
              ctc_task.init_params(task, torch.Generator().manual_seed(0)).items()}
    rng = np.random.RandomState(9)
    lens = np.asarray([60, 51, 33, 60, 12, 45, 60, 27], np.int32)
    label_len = np.asarray([4, 3, 2, 5, 1, 3, 4, 2], np.int32)
    labels = np.full((b, 5), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, 6, n)
    batch = {"inputs": rng.randn(b, t, d).astype(np.float32), "input_len": lens,
             "labels": labels, "label_len": label_len,
             "weight": np.asarray([1, 1, 1, 0, 1, 1, 1, 0], np.float32),
             "cmvn_mean": rng.randn(b, d).astype(np.float32),
             "cmvn_inv_std": (0.5 + rng.rand(b, d)).astype(np.float32)}
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    opt = build_optimizer("sgd", 5.0)
    out = {}
    for accum in (1, 4):
        before = lstm_bidi.launches
        out[accum] = ctc_task.make_train_step(task, opt, grad_accum=accum)(
            params, opt.init(params), tb, 0.1)
        torch.cuda.synchronize()
        assert lstm_bidi.launches - before == 2 * accum
    (p1, _, a1), (p4, _, a4) = out[1], out[4]
    assert not bool(a1["nonfinite"]) and not bool(a4["nonfinite"])
    np.testing.assert_allclose(float(a4["loss"]), float(a1["loss"]), rtol=2e-5)
    for k in p1:
        np.testing.assert_allclose(p4[k].cpu().numpy(), p1[k].cpu().numpy(), atol=2e-5,
                                   err_msg=k)


# ---- the scan-path encoders, cnn_zhang and the tools ------------------------------

ZOO_CASES = {
    "bgru": dict(encoder_type="bgru"),
    "gru": dict(encoder_type="gru"),
    "blstm options": dict(encoder_type="blstm", use_peephole=True, clip_activation=0.5,
                          num_proj=256),
    "cnn_zhang": dict(encoder_type="cnn_zhang"),
}


@pytest.mark.parametrize("case", sorted(ZOO_CASES))
def test_scan_path_and_cnn_models_on_card_match_cpu(dev, case):
    """A CTC model at full width (512 units, depth cut to 2; cnn_zhang's
    full stack) on 2 x 1 s of stacked 120-dim features, card against CPU:
    logits within 1e-3, greedy ids equal, the CTC loss (one #5 call) within
    1e-4 relative and every gradient within 1e-3 of its largest entry; no
    LSTM walk launches."""
    from tensorflow_end2end_speech_recognition_tpu_torch.decoding.ctc_greedy import (
        ctc_greedy_decode,
    )

    cfg = CTCConfig(encoder=EncoderConfig(num_units=512, num_layers=2, **ZOO_CASES[case]),
                    num_classes=28)
    cpu = CTCModel(cfg, 360, torch.Generator().manual_seed(0))
    model = CTCModel(cfg, 360, torch.Generator().manual_seed(0)).to(dev)
    rng = np.random.RandomState(8)
    feats = torch.from_numpy(rng.randn(2, 34, 360).astype(np.float32))
    lens = torch.tensor([34, 20])
    labels = torch.tensor([[1, 2, 3, 4], [5, 6, -1, -1]])
    label_len = torch.tensor([4, 2])
    walks = (lstm_bidi.launches, lstm_bidi_bwd.launches, lstm_layer.launches,
             lstm_layer_bwd.launches)
    before = ctc_loss_fwd_bwd.launches
    outs = []
    for m, d in ((cpu, "cpu"), (model, dev)):
        out = m(feats.to(d), lens.to(d))
        loss = ctc_loss(out.logits, out.logit_len, labels.to(d), label_len.to(d),
                        cfg.blank_id).sum()
        loss.backward()
        ids, n = ctc_greedy_decode(out.logits.detach(), out.logit_len, cfg.blank_id)
        outs.append((out.logits.detach().cpu(), float(loss), ids.cpu(), n.cpu()))
    torch.cuda.synchronize()
    assert ctc_loss_fwd_bwd.launches == before + 1
    assert (lstm_bidi.launches, lstm_bidi_bwd.launches, lstm_layer.launches,
            lstm_layer_bwd.launches) == walks
    (lc, loss_c, ic, nc), (lg, loss_g, ig, ng) = outs
    torch.testing.assert_close(lg, lc, atol=1e-3, rtol=0)
    assert torch.equal(ig, ic) and torch.equal(ng, nc)
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for (name, p), q in zip(model.named_parameters(), cpu.parameters()):
        scale = float(q.grad.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(p.grad.cpu(), q.grad, atol=1e-3 * scale, rtol=0, msg=name)


@pytest.mark.parametrize("case", ["gru", "lstm options"])
def test_scan_path_stream_on_card_matches_offline_and_cpu(dev, case):
    """A causal GRU / option-LSTM CTC stream (2 x 256 units) on the card:
    tokens equal the card's offline greedy decode and the CPU's stream; no
    kernel #3 launch (the scan path)."""
    from tensorflow_end2end_speech_recognition_tpu_torch import streaming
    from tensorflow_end2end_speech_recognition_tpu_torch.decoding.ctc_greedy import (
        ctc_greedy_decode,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.frontend.features import FrontendConfig
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import (
        device_pipeline,
    )

    kw = (dict(encoder_type="gru") if case == "gru" else
          dict(encoder_type="lstm", use_peephole=True, clip_activation=0.5, num_proj=128))
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(num_units=256, num_layers=2, **kw),
                        num_classes=6),
        frontend=FrontendConfig(use_energy=False, add_deltas=False, cmvn="none"))
    cpu = ctc_task.init_model(task, torch.Generator().manual_seed(0)).eval()
    model = ctc_task.init_model(task, torch.Generator().manual_seed(0)).to(dev).eval()
    chunk = 1600
    rng = np.random.RandomState(9)
    wav = (rng.randn(3, 4 * chunk) * 0.3).astype(np.float32)
    lens = [4 * chunk, 3 * chunk, 2 * chunk - 700]
    before = lstm_layer.launches
    _, rows = _stream_rows(streaming.build_streaming_fn(task, model, chunk), wav, lens, chunk)
    torch.cuda.synchronize()
    assert lstm_layer.launches == before
    with torch.no_grad():
        feats, fl = device_pipeline(task, {"inputs": torch.from_numpy(wav).to(dev),
                                           "input_len": torch.tensor(lens, device=dev)})
        out = model(feats, fl)
        ids, n = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
    assert rows == [ids[i, : n[i]].tolist() for i in range(3)] and any(rows)
    assert _stream_rows(streaming.build_streaming_fn(task, cpu, chunk), wav, lens,
                        chunk)[1] == rows


def test_native_runtime_builds_with_the_host_compiler(dev):
    """``data/native.py`` builds and loads on the card's machine (no quiet
    fallback), and its batches and edit counts equal the numpy paths."""
    from tensorflow_end2end_speech_recognition_tpu_torch.data import native
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.edit_distance import (
        levenshtein_batch,
    )

    native.build()
    native.load_library()
    assert native.have_native()
    rng = np.random.RandomState(10)
    utts = [rng.randn(n, 40).astype(np.float32) for n in (50, 1, 31)]
    got, lens = native.batch_assemble(utts, 64)
    want = np.zeros((3, 64, 40), np.float32)
    for i, u in enumerate(utts):
        want[i, : len(u)] = u
    assert got.tobytes() == want.tobytes() and lens.tolist() == [50, 1, 31]
    refs = [list(rng.randint(0, 9, n)) for n in (0, 5, 17)]
    hyps = [list(rng.randint(0, 9, n)) for n in (3, 0, 12)]
    np.testing.assert_array_equal(native.levenshtein_batch(refs, hyps),
                                  levenshtein_batch(refs, hyps))


def test_fit_profile_on_card_traces_cuda_kernels(dev, tmp_path):
    """``fit(profile_steps=(1, 2))`` on the card: the Chrome trace holds the
    card's kernel events."""
    import json

    from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
        experiment_from_dict,
    )

    exp = experiment_from_dict(dict(
        model_type="ctc", label_type="character", input_size=40, use_energy=False,
        use_delta=True, num_stack=3, num_skip=3, encoder_type="bgru", num_units=32,
        num_layers=2, batch_size=4, num_epoch=1, toy_num_utts=16, toy_max_units=4))
    lines = []
    fit(exp, tmp_path, log_every=1, print_fn=lines.append, profile_steps=(1, 2), device="cuda")
    trace = tmp_path / "trace" / "train_steps_1-2.json"
    assert f"profiler trace written to {trace}" in lines
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


def test_world_of_one_over_nccl_equals_the_one_process_step(dev, tmp_path):
    """``chip_smoke.py`` phase 68's world of 1 over nccl at toy width: the
    train step built with the mesh gives the one-process Adam step bit for bit
    (loss, weights, moments) and launches the same kernels."""
    import torch.distributed as dist

    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import make_mesh
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import (
        build_optimizer,
    )

    set_full_fp32()
    task = ctc_task.CTCTaskConfig(
        model=CTCConfig(encoder=EncoderConfig(encoder_type="blstm", num_units=32, num_layers=2),
                        num_classes=6),
        frontend=None, feature_dim=20, num_stack=3, num_skip=3, weight_decay=1e-2)
    rng = np.random.RandomState(0)
    lens = np.asarray([60, 41, 17, 60], np.int32)
    feats = rng.randn(4, 60, 20).astype(np.float32)
    for i, n in enumerate(lens):
        feats[i, n:] = 0.0
    batch = {"inputs": feats, "input_len": lens, "labels": rng.randint(0, 6, (4, 5)).astype(
        np.int32), "label_len": np.asarray([5, 3, 1, 4], np.int32),
        "weight": np.asarray([1, 1, 1, 0], np.float32)}
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    params = {k: v.to(dev) for k, v in ctc_task.init_params(
        task, torch.Generator().manual_seed(0)).items()}
    opt = build_optimizer("adam", 5.0)
    runs = []
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        for mesh in (None, make_mesh(1, device=dev)):
            step = ctc_task.make_train_step(task, opt, mesh=mesh)
            before = (lstm_ops.lstm_bidi.launches, ctc_ops.ctc_loss_fwd_bwd.launches)
            new, state, aux = step(params, opt.init(params), tb, 1e-3)
            torch.cuda.synchronize()
            after = (lstm_ops.lstm_bidi.launches, ctc_ops.ctc_loss_fwd_bwd.launches)
            runs.append((new, state, float(aux["loss"]), [b - a for a, b in zip(before, after)]))
    finally:
        dist.destroy_process_group()
    (p1, s1, l1, n1), (p2, s2, l2, n2) = runs
    assert l1 == l2 and n1 == n2 == [2, 1]
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
        assert torch.equal(s1["mu"][k], s2["mu"][k]) and torch.equal(s1["nu"][k], s2["nu"][k]), k
