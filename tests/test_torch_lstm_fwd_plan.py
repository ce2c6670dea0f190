"""The forward kernels' launch plan, on the CPU.

``ops/lstm.fwd_plan`` lays out kernels #1 and #3: one cooperative launch per
call with ``bwd_plan``'s unit tile (at most one block per SM), each block's
slice of ``Wh`` resident in shared memory where it fits, the gate product's
rows per staged chunk chosen from B, and a batch past the register carries
split into launches (tested with the backward's in
``test_torch_lstm_bwd_plan.py``). Nothing is compiled and no card is needed.
"""

import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    FWD_ROWS,
    MAX_SMEM,
    bwd_plan,
    fwd_plan,
    fwd_plan_for,
)

H100_SMS = 132


@pytest.mark.parametrize("h", [1, 24, 40, 70, 256, 270, 320, 512, 1536, 1540])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_covers_every_unit_once(h, dirs):
    plan = fwd_plan(h, dirs, 8, H100_SMS)
    per_dir = plan.blocks // dirs
    assert plan.blocks == dirs * per_dir <= H100_SMS
    covered = [j for blk in range(per_dir) for j in range(blk * plan.units, (blk + 1) * plan.units)
               if j < h]
    assert covered == list(range(h))  # each unit of a direction exactly once
    assert (per_dir - 1) * plan.units < h  # no block without a unit


@pytest.mark.parametrize("h", [24, 256, 270, 512, 1536])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [1, 32, 300])
def test_plan_takes_the_backward_tile(h, dirs, batch):
    """One tile choice for both walks: the same units and blocks, chunks."""
    f, b = fwd_plan(h, dirs, batch, H100_SMS), bwd_plan(h, dirs, batch, H100_SMS)
    assert (f.units, f.blocks, f.chunks, f.chunk_rows) == (b.units, b.blocks, b.chunks,
                                                           b.chunk_rows)


@pytest.mark.parametrize("h", [256, 320, 512])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [8, 32])
def test_plan_keeps_wh_resident_at_model_widths(h, dirs, batch):
    plan = fwd_plan(h, dirs, batch, H100_SMS)
    assert plan.resident and 0 < plan.resident_bytes < plan.smem_bytes <= MAX_SMEM
    assert plan.resident_bytes == -(-h // 4) * 4 * (4 * plan.units + 4) * 4


@pytest.mark.parametrize("h", [1536, 1540])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_streams_wh_when_the_slice_does_not_fit(h, dirs):
    plan = fwd_plan(h, dirs, 40, H100_SMS)
    assert not plan.resident and plan.resident_bytes == 0
    assert plan.blocks <= H100_SMS and plan.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("h,resident", [(270, True), (1540, False)])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [1, 9, 40])
def test_plan_tiles_that_leave_a_remainder(h, resident, dirs, batch):
    """The card tests' widths whose unit tile does not divide H, so the last
    block of a direction holds units past H, with Wh resident and streamed."""
    plan = fwd_plan(h, dirs, batch, H100_SMS)
    assert h % plan.units and plan.resident == resident
    assert plan.blocks <= H100_SMS and plan.smem_bytes <= MAX_SMEM


@pytest.mark.parametrize("batch,rows", [(1, 8), (8, 8), (9, 32), (16, 32), (17, 32), (32, 32),
                                        (33, 32), (64, 32), (256, 32)])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_stages_the_fewest_rows_that_hold_the_batch(batch, rows, dirs):
    """The serving batch B = 8 stages 8 rows, so none of the gate product's
    row tiles idles and its threads split k 16 ways (u = 8) instead of 4;
    past 32 rows the walk takes chunks of 32."""
    plan = fwd_plan(512, dirs, batch, H100_SMS)
    assert plan.rows == rows and rows in FWD_ROWS
    tiles = rows // 4 * min(32, plan.units)  # 4 x 4 output tiles of the product
    assert 256 % tiles == 0


@pytest.mark.parametrize("dirs,batch,units,rows,smem", [
    (2, 8, 8, 8, 107776), (2, 32, 8, 32, 160768),  # #1: CTC serving, CTC train step
    (1, 8, 4, 8, 74496), (1, 32, 4, 32, 125952),  # #3: transducer serving, train step
])
def test_plan_at_the_serving_and_train_shapes(dirs, batch, units, rows, smem):
    """#1 and #3 at H = 512: 128 blocks, 72 KB and 40 KB of Wh resident, one
    two-deep h exchange of [dirs, B, H]."""
    plan = fwd_plan(512, dirs, batch, H100_SMS)
    assert (plan.units, plan.blocks, plan.rows, plan.smem_bytes, plan.chunks) == (
        units, 128, rows, smem, 1)
    assert plan.resident_bytes == 512 * (4 * units + 4) * 4
    assert plan.hbuf_floats == 2 * dirs * batch * 512


def test_plan_for_a_device_uses_its_sm_count(monkeypatch):
    """``fwd_plan_for``, the plan both forward wrappers launch with, is
    ``fwd_plan`` at the device's SM count."""
    seen = []
    monkeypatch.setattr(lstm, "_sm_count", lambda index: seen.append(index) or H100_SMS)
    assert fwd_plan_for(torch.device("cuda", 1), 512, 2, 8) == fwd_plan(512, 2, 8, H100_SMS)
    assert fwd_plan_for(torch.device("cuda"), 320, 1, 64) == fwd_plan(320, 1, 64, H100_SMS)
    assert seen == [1, 0]


@pytest.mark.parametrize("kwargs", [dict(h=512, dirs=2, batch=0),
                                    dict(h=20000, dirs=2, batch=8),
                                    dict(h=512, dirs=3, batch=8),
                                    dict(h=0, dirs=1, batch=8)])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs):
    with pytest.raises(ValueError, match="fwd_plan"):
        fwd_plan(sm_count=H100_SMS, **kwargs)
