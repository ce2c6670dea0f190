"""The CTC kernels' launch plan, on the CPU.

``ops/ctc.ctc_plan`` lays out kernels #5 and #6: a statistics pass (a warp
per frame, and for training a block per utterance that makes its class
lane lists), the alpha chain (and for training the beta chain, in blocks
of their own) with K consecutive lattice lanes per thread, and for
training a gradient pass over frames. A row of up to 64 lanes is one
warp's, a wider one is split over warps that meet at a named barrier, and
past 4096 lanes the running rows live in global memory. Nothing is
compiled and no card is needed.
"""

import pytest

from tensorflow_end2end_speech_recognition_tpu_torch.ops import build
from tensorflow_end2end_speech_recognition_tpu_torch.ops.ctc import (
    CHAIN_K,
    GRAD_FRAMES,
    MAX_CHAIN_WARPS,
    MAX_SMEM,
    FRAME_WARPS,
    CHUNK,
    RING_CHUNKS,
    STAGE_CHUNKS,
    STATIC_SMEM,
    WARPS_K,
    ctc_plan,
)

SHAPES = [1, 3, 21, 31, 33, 63, 65, 81, 97, 129, 361, 511, 513, 601, 1023, 1025, 1201, 4095,
          4097, 8193, 20001]


@pytest.mark.parametrize("s", SHAPES)
@pytest.mark.parametrize("grad", [True, False])
def test_plan_covers_every_lane_once(s, grad):
    """The chain threads' lanes tid * K .. tid * K + K - 1 cover 0 .. S-1, and
    the last thread holds a real lane (the global route loops over lanes)."""
    plan = ctc_plan(32, 400, s, grad)
    threads = 32 * plan.chain_warps
    if plan.route == "global":
        assert plan.lanes_per_thread == 0 and threads == 32 * MAX_CHAIN_WARPS
        return
    k = plan.lanes_per_thread
    assert k in CHAIN_K
    covered = [j for tid in range(threads) for j in range(tid * k, (tid + 1) * k) if j < s]
    assert covered == list(range(s))
    smaller = [x for x in CHAIN_K if x < k]
    assert not smaller or threads * smaller[-1] < s  # the smallest K that covers S


@pytest.mark.parametrize("s,route,warps,k", [
    (1, "one_warp", 1, 1), (21, "one_warp", 1, 1), (31, "one_warp", 1, 1),
    (33, "one_warp", 1, 2), (63, "one_warp", 1, 2), (65, "warps", 2, 2), (81, "warps", 2, 2),
    (361, "warps", 6, 2), (601, "warps", 10, 2), (1023, "warps", 16, 2), (1025, "warps", 16, 3),
    (1201, "warps", 16, 3), (4095, "warps", 16, 8), (4097, "global", 16, 0),
    (20001, "global", 16, 0),
])
def test_plan_cuts_between_one_warp_several_warps_and_global_rows(s, route, warps, k):
    plan = ctc_plan(32, 400, s)
    assert (plan.route, plan.chain_warps, plan.lanes_per_thread) == (route, warps, k)
    assert (s <= 32 * WARPS_K) == (route == "one_warp")
    assert plan.chain_warps <= MAX_CHAIN_WARPS
    if route == "warps":  # each thread holds its two edge lanes; WARPS_K while 16 warps do
        assert plan.lanes_per_thread >= 2
        assert (plan.lanes_per_thread == WARPS_K) == (s <= 32 * MAX_CHAIN_WARPS * WARPS_K)


@pytest.mark.parametrize("b,t,s", [(32, 400, 81), (32, 400, 361), (7, 23, 11), (2, 9, 20001),
                                   (1, 1, 1)])
def test_plan_scratch_and_grids(b, t, s):
    train, evaluate = ctc_plan(b, t, s), ctc_plan(b, t, s, grad=False)
    frames = b * t
    sp = -(-s // 4) * 4  # rows 16-byte aligned for the bulk copies
    assert train.lane_stride == evaluate.lane_stride == sp >= s
    # lpz rows [B, T, Sp]; training: alpha and beta rows [2, B, T, Sp]; an alpha
    # and a beta block per utterance; a list block per utterance after the
    # frame blocks
    assert train.lpz_floats == evaluate.lpz_floats == frames * sp
    assert train.row_floats == 2 * frames * sp and train.chain_blocks == 2 * b
    assert train.frame_blocks == -(-frames // FRAME_WARPS) + b
    # gradient tiles of one utterance each: every frame once
    tiles = train.grad_blocks // b
    assert train.grad_blocks == b * tiles and tiles * train.grad_frames >= t > \
        (tiles - 1) * train.grad_frames
    # exp(min(gamma, 40)) of each (frame, lane) and the lane list fit shared memory
    assert train.grad_smem_bytes == 4 * (train.grad_frames + 1) * s <= MAX_SMEM
    assert train.grad_frames == min(GRAD_FRAMES, (MAX_SMEM // 4 - s) // s)
    # eval: the alpha chain alone, no rows, no gradient pass
    assert (evaluate.row_floats, evaluate.grad_blocks, evaluate.grad_frames) == (0, 0, 0)
    assert evaluate.chain_blocks == b and evaluate.frame_blocks == -(-frames // FRAME_WARPS)
    # the chain's rings: chunks of D lpz rows in, (training) of new rows out,
    # with the slack of one row of every thread's lanes after each
    width = 32 * train.chain_warps * train.lanes_per_thread
    assert width >= sp or train.route == "global"
    d = train.chunk
    if train.route == "global":
        assert d == evaluate.chunk == train.chain_smem_bytes == 0
    else:
        assert 1 <= d <= CHUNK and 1 <= evaluate.chunk <= CHUNK
        assert train.chain_smem_bytes == 4 * ((RING_CHUNKS + STAGE_CHUNKS) * d * sp + 2 * width)
        assert evaluate.chain_smem_bytes == 4 * (RING_CHUNKS * evaluate.chunk * sp + 2 * width)
        assert max(train.chain_smem_bytes, evaluate.chain_smem_bytes) <= MAX_SMEM - STATIC_SMEM
    assert evaluate[:3] == train[:3]  # the same chain layout
    ws = 4 * b * s if train.route == "global" else 0
    assert train.ws_floats == evaluate.ws_floats == ws


def test_plan_scratch_at_the_train_step_fits_l2():
    """B = 32, T = 400, U = 40: the alpha and beta rows take 8.6 MB and the lpz
    rows 4.3 MB (L2 holds 50 MB)."""
    plan = ctc_plan(32, 400, 81)
    assert (plan.row_floats * 4, plan.lpz_floats * 4) == (8_601_600, 4_300_800)


@pytest.mark.parametrize("b,t,s", [(0, 400, 81), (32, 0, 81), (32, 400, 0), (32, 400, 80),
                                   (-1, 4, 3), (32, 400, -1)])
def test_plan_raises_on_bad_shapes(b, t, s):
    with pytest.raises(ValueError, match="bad shape"):
        ctc_plan(b, t, s)


def test_plan_raises_when_a_frame_does_not_fit_shared_memory():
    assert ctc_plan(2, 4, MAX_SMEM // 8 - 1).grad_frames == 1
    s = MAX_SMEM // 8 + 1 | 1  # two frames' lanes do not fit
    with pytest.raises(ValueError, match="shared memory"):
        ctc_plan(2, 4, s)
    assert ctc_plan(2, 4, s, grad=False).route == "global"  # eval has no gradient pass


@pytest.mark.parametrize("s,lanes,route,warps,k", [
    (81, 3, "one_warp", 1, 3), (81, 4, "one_warp", 1, 3), (97, 3, "warps", 2, 2),
    (361, 3, "warps", 4, 3), (361, 4, "warps", 3, 4), (1201, 4, "warps", 10, 4),
    (4095, 8, "warps", 16, 8), (4097, 8, "global", 16, 0),
])
def test_plan_aims_at_the_lanes_per_thread_it_is_given(s, lanes, route, warps, k):
    """Fewer, fuller warps (the probe's layouts): one warp takes 32 * lanes
    lanes, a wider row ceil(S / (32 lanes)) warps, K the smallest that covers
    it; the rings and grids follow the layout."""
    plan = ctc_plan(32, 400, s, lanes=lanes)
    assert (plan.route, plan.chain_warps, plan.lanes_per_thread) == (route, warps, k)
    if route != "global":
        width = 32 * warps * k
        n = RING_CHUNKS + STAGE_CHUNKS
        assert plan.chain_smem_bytes == 4 * (n * plan.chunk * plan.lane_stride + 2 * width)
    assert plan[6:] == ctc_plan(32, 400, s)[6:]  # the frame and gradient passes, scratch


@pytest.mark.parametrize("lanes", [0, 1, 5, 16])
def test_plan_raises_on_lanes_the_kernels_do_not_take(lanes):
    with pytest.raises(ValueError, match="lanes"):
        ctc_plan(32, 400, 81, lanes=lanes)


def test_plan_cuts_the_chunk_at_wide_rows():
    """The rings of five chunks (three in, two out) of D rows of Sp floats
    fit shared memory: D falls from 32 to 2 as the row widens."""
    chunks = {s: ctc_plan(3, 40, s).chunk for s in (81, 361, 1201, 4095)}
    assert chunks == {81: CHUNK, 361: 31, 1201: 9, 4095: 2}
    assert ctc_plan(3, 40, 4095, grad=False).chunk == 4  # three chunks in, none out


def test_ctc_signatures_take_the_plan():
    """#5: 12 pointers, B T C U blank, then K, chain warps, chunk, row stride,
    chain shared memory, frame and chain grids, gradient frames, gradient
    shared memory and grid, and the stream; #6: 8 pointers, B T C U blank,
    K, chain warps, chunk, row stride, chain shared memory, frame and chain
    grids, stream."""
    p, i = build._P, build._I
    assert build.SIGNATURES["ctc_loss_fwd_bwd"] == [p] * 12 + [i] * 15 + [p]
    assert build.SIGNATURES["ctc_loss_fwd_only"] == [p] * 8 + [i] * 12 + [p]
