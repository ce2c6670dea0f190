"""The backward kernels' launch plan and the C entry points' ctypes table, on the CPU.

``ops/lstm.bwd_plan`` lays out kernels #2 and #4 (one cooperative launch
per call, at most one block per SM, each block's slice of ``Wh`` resident
in shared memory where it fits, a batch past the register carries split
into launches); ``ops/build.SIGNATURES`` declares every C
entry point's arguments to ctypes, which passes a wrong count without
complaint. Nothing is compiled and no card is needed.
"""

import re

import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu_torch.ops import build
from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    BWD_MAX_PAIRS,
    BWD_THREADS,
    MAX_CARRIES,
    MAX_SMEM,
    bwd_plan,
    bwd_plan_for,
    fwd_plan,
)

H100_SMS = 132


@pytest.mark.parametrize("h", [1, 24, 40, 70, 256, 270, 320, 512, 1536, 1540])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_covers_every_unit_once(h, dirs):
    plan = bwd_plan(h, dirs, 32, H100_SMS)
    per_dir = plan.blocks // dirs
    assert plan.blocks == dirs * per_dir
    covered = [j for blk in range(per_dir) for j in range(blk * plan.units, (blk + 1) * plan.units)
               if j < h]
    assert covered == list(range(h))  # each unit of a direction exactly once
    assert (per_dir - 1) * plan.units < h  # no block without a unit


@pytest.mark.parametrize("h", [256, 320, 512])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_fits_the_card_with_wh_resident(h, dirs):
    plan = bwd_plan(h, dirs, 32, H100_SMS)
    assert plan.blocks <= H100_SMS
    assert plan.resident and 0 < plan.resident_bytes < plan.smem_bytes <= MAX_SMEM
    # the tile is the smallest that fits: half of it would need more blocks than SMs
    assert dirs * -(-h // (plan.units // 2 or 1)) > H100_SMS or plan.units == 1


@pytest.mark.parametrize("dirs,units,smem,resident", [(2, 8, 161792, 73728),
                                                      (1, 4, 126464, 40960)])
def test_plan_at_the_train_step(dirs, units, smem, resident):
    """#2 and #4 at H = 512: 128 blocks, 72 KB and 40 KB of Wh resident."""
    plan = bwd_plan(512, dirs, 32, H100_SMS)
    assert (plan.units, plan.blocks, plan.smem_bytes, plan.resident_bytes) == (
        units, 128, smem, resident)
    # the 512 x 4u columns of the block's units, rows padded by 4, float32
    assert plan.resident_bytes == 512 * (4 * units + 4) * 4
    # dh partials: 2 steps x dirs x 64 or 128 readers x as many writers x u x 32 rows
    assert plan.part_floats == 2 * dirs * (128 // dirs) ** 2 * units * 32


@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_streams_wh_when_the_slice_does_not_fit(dirs):
    plan = bwd_plan(1536, dirs, 9, H100_SMS)
    assert not plan.resident and plan.resident_bytes == 0
    assert plan.blocks <= H100_SMS and plan.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("h,resident", [(270, True), (1540, False)])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_tiles_that_leave_a_remainder(h, resident, dirs):
    """The card tests' widths whose unit tile does not divide H, so the last
    block of a direction holds units past H, with Wh resident and streamed."""
    for batch in (5, 40):
        plan = bwd_plan(h, dirs, batch, H100_SMS)
        assert h % plan.units and plan.resident == resident
        assert plan.blocks <= H100_SMS and plan.smem_bytes <= MAX_SMEM


def test_plan_for_a_device_uses_its_sm_count(monkeypatch):
    """``bwd_plan_for``, the plan both wrappers launch with, is ``bwd_plan``
    at the device's SM count (read once per device)."""
    seen = []
    monkeypatch.setattr(lstm, "_sm_count", lambda index: seen.append(index) or H100_SMS)
    assert bwd_plan_for(torch.device("cuda", 1), 512, 2, 32) == bwd_plan(512, 2, 32, H100_SMS)
    assert bwd_plan_for(torch.device("cuda"), 320, 1, 64) == bwd_plan(320, 1, 64, H100_SMS)
    assert seen == [1, 0]


def test_plan_for_a_larger_card_exceeds_this_one():
    """The refused-launch case of the card tests: a plan for 8 x the SMs."""
    plan = bwd_plan(512, 2, 32, 8 * H100_SMS)
    assert plan.units == 1 and plan.blocks == 1024 > H100_SMS


@pytest.mark.parametrize("kwargs", [dict(h=512, dirs=2, batch=0),
                                    dict(h=20000, dirs=2, batch=8),
                                    dict(h=512, dirs=3, batch=8)])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs):
    with pytest.raises(ValueError, match="bwd_plan"):
        bwd_plan(sm_count=H100_SMS, **kwargs)


@pytest.mark.parametrize("plan_fn", [bwd_plan, fwd_plan])
@pytest.mark.parametrize("h,dirs,batch,chunks", [
    (512, 2, 300, 2),  # BLSTM-512: 8 units a block, 256 rows a launch
    (512, 2, BWD_THREADS * BWD_MAX_PAIRS, 8),  # the batch the plan once refused
    (512, 1, 600, 2),  # LSTM-512: 4 units, 512 rows
    (1536, 2, 80, 2),  # BLSTM-1536: 32 units, 64 rows, Wh streamed
    (1536, 1, 80, 1),  # LSTM-1536: 16 units, 128 rows
    (512, 2, 256, 1),  # at the cap: one launch
])
def test_plan_splits_a_batch_past_the_register_carries(plan_fn, h, dirs, batch, chunks):
    """Past B x units = 2048 the call becomes launches over contiguous rows:
    every row in exactly one launch, each launch within the cap and planned
    as one launch of its own rows."""
    plan = plan_fn(h, dirs, batch, H100_SMS)
    assert plan.chunks == chunks
    starts = range(0, batch, plan.chunk_rows)
    assert len(starts) == chunks
    rows = [r for b0 in starts for r in range(b0, min(batch, b0 + plan.chunk_rows))]
    assert rows == list(range(batch))
    for b0 in starts:
        n = min(batch, b0 + plan.chunk_rows) - b0
        assert n * plan.units <= MAX_CARRIES == BWD_THREADS * BWD_MAX_PAIRS
        one = plan_fn(h, dirs, n, H100_SMS)
        assert (one.chunks, one.chunk_rows, one.units, one.blocks) == (1, n, plan.units,
                                                                        plan.blocks)
    # the launches take turns with one scratch buffer, sized for the largest
    scratch = "part_floats" if plan_fn is bwd_plan else "hbuf_floats"
    assert getattr(plan, scratch) == getattr(plan_fn(h, dirs, plan.chunk_rows, H100_SMS),
                                             scratch)


def _extern_c_functions() -> dict:
    """name -> argument kinds ('p', 'i', 'f') of each function defined in an
    ``extern "C"`` block of ``csrc/*.cu``."""
    found = {}
    for src in build.CSRC.glob("*.cu"):
        # each source closes its block with `}  // extern "C"`
        blocks = re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', src.read_text(), re.S)
        for block in (re.sub(r"//[^\n]*", "", b) for b in blocks):
            for name, params in re.findall(r"^\s*(?:const\s+)?\w+\s*\*?\s*(\w+)\(([^)]*)\)\s*\{",
                                           block, re.M):
                kinds = []
                for param in filter(None, (p.strip() for p in params.split(","))):
                    kinds.append("p" if "*" in param else "f" if param.startswith("float")
                                 else "i")
                found[name] = kinds
    return found


def test_signatures_match_the_c_entry_points():
    defined = _extern_c_functions()
    kind = {build._P: "p", build._I: "i", build._F: "f"}
    for name, argtypes in build.SIGNATURES.items():
        assert name in defined, name
        assert [kind[a] for a in argtypes] == defined[name], name
    # the plan reaches both backward entry points: sync, part, part_floats, B,
    # T, H, units, resident, smem_bytes, forget_bias, stream
    for name in ("lstm_bidi_bwd", "lstm_layer_bwd"):
        assert defined[name][-11:] == ["p", "p"] + ["i"] * 7 + ["f", "p"], name
    # and both forward entry points: sync, hbuf, hbuf_floats, B, T, H, units,
    # resident, rows, smem_bytes, forget_bias, stream
    for name, streams in (("lstm_bidi_fwd", 9), ("lstm_layer_fwd", 5)):
        assert defined[name] == ["p"] * streams + ["p", "p"] + ["i"] * 8 + ["f", "p"], name
