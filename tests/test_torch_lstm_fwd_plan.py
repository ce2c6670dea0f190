"""The forward kernels' launch plan, on the CPU.

``ops/lstm.fwd_plan`` lays out kernels #1 and #3: one cooperative launch per
call with ``bwd_plan``'s unit tile (at most one block per SM); a launch of
up to ``FWD_FFMA_ROWS`` rows on FFMA, a larger one with every row's gates
in one pass on the tensor cores, with k split over clusters of 2 blocks
from ``FWD_CLUSTER_MIN_ROWS`` rows where the pair's layout keeps ``Wh`` as
TF32 hi and lo parts; each block's slice of ``Wh`` resident in shared
memory where it fits (as hi and lo parts on the tensor cores where both
copies fit), and a batch past the register carries split into launches
(tested with the backward's in ``test_torch_lstm_bwd_plan.py``). Nothing is
compiled and no card is needed.
"""

import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    BWD_THREADS,
    BWD_WARPS,
    FWD_CLUSTER_MIN_ROWS,
    FWD_FFMA_ROWS,
    FWD_MMA_ROWS,
    MAX_CARRIES,
    MAX_SMEM,
    bwd_plan,
    fwd_plan,
    fwd_plan_for,
)

H100_SMS = 132


@pytest.mark.parametrize("h", [1, 24, 40, 70, 256, 270, 320, 512, 1536, 1540])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [8, 128])
def test_plan_covers_every_unit_once(h, dirs, batch):
    plan = fwd_plan(h, dirs, batch, H100_SMS)
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


def _wc_floats(h: int, units: int, split: bool, cluster: int) -> int:
    """The resident Wh slice: FFMA (cluster 0) Wc [H padded to 4, 4u + 4];
    tensor cores Wc^T [the cluster's 4u columns each padded to 16, the
    block's share of H padded to 16 (then to 16 mod 32)], twice when split."""
    if not cluster:
        return -(-h // 4) * 4 * (4 * units + 4)
    kp = 16 * -(-(-(-h // 16)) // cluster)
    cols = cluster * -(-4 * units // 16) * 16
    return (2 if split else 1) * cols * (kp + 16 if kp % 32 == 0 else kp)


@pytest.mark.parametrize("h", [256, 320, 512])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [8, 32])
def test_plan_keeps_wh_resident_at_model_widths(h, dirs, batch):
    """At the configs' widths the slice is resident on both paths: whole for
    FFMA (B = 8), as TF32 hi and lo parts for the tensor cores (B = 32)."""
    plan = fwd_plan(h, dirs, batch, H100_SMS)
    assert plan.resident and 0 < plan.resident_bytes < plan.smem_bytes <= MAX_SMEM
    assert plan.split == (plan.cluster == 1) == (batch > FWD_FFMA_ROWS)
    assert plan.resident_bytes == _wc_floats(h, plan.units, plan.split, plan.cluster) * 4


@pytest.mark.parametrize("h", [1536, 1540])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [5, 40])
def test_plan_streams_wh_when_the_slice_does_not_fit(h, dirs, batch):
    plan = fwd_plan(h, dirs, batch, H100_SMS)
    assert not plan.resident and not plan.split and plan.resident_bytes == 0
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


@pytest.mark.parametrize("batch", [1, 8, 9, 16, 17, 32, 33, 64, 256])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_stages_the_fewest_rows_that_hold_the_batch(batch, dirs):
    """FFMA stages 8 rows a chunk: the serving batch B = 8 in one, so none of
    its row tiles idles and its threads split k 16 ways (u = 8); a larger
    batch (FFMA forced) chunk after chunk. Past 8 rows the plan takes the
    tensor cores, whose k slices hold the fewest 16-row tiles that hold the
    launch's rows and split k so that every warp of the block has a work
    item, in clusters of 2 from FWD_CLUSTER_MIN_ROWS rows where the pair's
    layout keeps Wh split."""
    ffma = fwd_plan(512, dirs, batch, H100_SMS, 0)
    assert ffma.rows == FWD_FFMA_ROWS == 8 and not ffma.split and ffma.cluster == 0
    assert 256 % (FWD_FFMA_ROWS // 4 * min(32, ffma.units)) == 0  # 4 x 4 tiles of the product
    plan = fwd_plan(512, dirs, batch, H100_SMS)
    if batch <= FWD_FFMA_ROWS:
        assert plan == ffma
        return
    assert plan.rows == FWD_MMA_ROWS * plan.cluster and plan.chunk_rows == batch
    tiles = -(-batch // 16)
    gn = plan.cluster * -(-4 * plan.units // 16) * 16
    items, ksteps = tiles * -(-gn // 64), 32 // plan.cluster
    ks = lstm._ksplit(items, ksteps)
    assert ks * items <= max(items, BWD_WARPS)  # no warp with two items while one idles
    assert ks == ksteps or 2 * ks * items > BWD_WARPS  # and no idle warp left to split k
    floats, wh = lstm._fwd_smem_floats(512, plan.units, plan.rows, plan.resident, plan.split,
                                       batch)
    xch = tiles * 16 * (gn // plan.cluster) if plan.cluster > 1 else 0
    assert floats - wh - xch - lstm.FWD_STAGE_FLOATS == ks * tiles * 16 * (gn + 8)
    paired = fwd_plan(512, dirs, batch, H100_SMS, 2)
    assert (plan.cluster == 2) == (batch >= FWD_CLUSTER_MIN_ROWS and paired.split)


@pytest.mark.parametrize("dirs,batch,units,rows,split,cluster", [
    (2, 8, 8, 8, False, 0), (2, 32, 8, 16, True, 1),  # #1: CTC serving, train step
    (2, 128, 8, 16, True, 1), (2, 100, 8, 16, True, 1),  # #1: the headline, B = 100
    (1, 8, 4, 8, False, 0), (1, 32, 4, 16, True, 1),  # #3: transducer serving, train
    (1, 128, 4, 32, True, 2), (1, 100, 4, 32, True, 2),
])
def test_plan_at_the_serving_and_train_shapes(dirs, batch, units, rows, split, cluster):
    """#1 and #3 at H = 512: 128 blocks, one two-deep h exchange of [dirs, B,
    H]; serving on FFMA with 72 KB and 40 KB of Wh resident, the train step on
    the tensor cores with 132 KB and 66 KB as TF32 hi and lo parts and the
    gates' k slices for every row (B = 32: 4 slices, so that each warp of the
    block has a work item; B = 128: one); at the headline's batch #3's blocks
    pair in clusters of 2 that split k (the pair's 8u columns over half of k
    as hi and lo parts), while #1's pair would hold Wh whole and keeps one
    block a k range."""
    plan = fwd_plan(512, dirs, batch, H100_SMS)
    assert (plan.units, plan.blocks, plan.rows, plan.chunks, plan.split, plan.cluster) == (
        units, 128, rows, 1, split, cluster)
    assert plan.resident and plan.smem_bytes <= MAX_SMEM
    assert plan.resident_bytes == _wc_floats(512, units, split, cluster) * 4
    assert plan.hbuf_floats == 2 * dirs * batch * 512
    floats, _ = lstm._fwd_smem_floats(512, units, rows, True, split, batch)
    assert plan.smem_bytes == floats * 4


@pytest.mark.parametrize("dirs,batch,cluster", [
    (2, 8, 0), (1, 8, 0),  # FFMA: serving 8 requests, and the streaming chunks at B = 8
    (2, 9, 1), (2, 32, 1), (1, 32, 1), (1, 63, 1),  # train steps; below the threshold
    (1, 64, 2), (1, 128, 2), (1, 100, 2),  # #3 at and past it
    (2, 64, 1), (2, 128, 1),  # #1: the pair's layout would hold Wh whole
    (1, 600, 2),  # two launches of 300 rows (B x u past MAX_CARRIES)
])
def test_plan_chooses_the_product_path_by_the_launch_rows(dirs, batch, cluster):
    """FFMA up to FWD_FFMA_ROWS rows a launch, the tensor cores past it, in
    clusters of 2 from FWD_CLUSTER_MIN_ROWS rows where the pair's layout
    keeps Wh as TF32 hi and lo parts, else one block a k range."""
    plan = fwd_plan(512, dirs, batch, H100_SMS)
    assert plan.cluster == cluster
    assert plan.rows == (FWD_MMA_ROWS * cluster if cluster else FWD_FFMA_ROWS)
    assert (cluster == 0) == (plan.chunk_rows <= FWD_FFMA_ROWS)
    paired = fwd_plan(512, dirs, batch, H100_SMS, 2)
    assert (cluster == 2) == (plan.chunk_rows >= FWD_CLUSTER_MIN_ROWS and paired.split)


def test_plan_pairs_blocks_only_where_a_direction_has_an_even_count():
    """A direction of an odd count of blocks keeps one block a k range (H =
    1540: 49 blocks of 32 units; H = 70 in two directions: 35 of 2)."""
    for h, dirs in ((1540, 2), (70, 2)):
        plan = fwd_plan(h, dirs, 128, H100_SMS)
        assert plan.blocks // dirs % 2 == 1 and plan.cluster == 1


@pytest.mark.parametrize("h,resident", [(70, (True, True)), (256, (True, True)),
                                        (270, (True, True)), (320, (True, True)),
                                        (512, (True, True)), (1024, (True, False)),
                                        (1536, (False, False)), (1540, (False, False))])
@pytest.mark.parametrize("batch", [9, 32, 100, 128, 256, 2048])
@pytest.mark.parametrize("dirs", [1, 2])
def test_plan_shared_memory_fits(h, resident, batch, dirs):
    """Past 8 rows (the tensor cores) every launch's shared memory fits MAX_SMEM,
    is what ``fwd_layout`` lays out, and holds Wh as hi and lo parts where
    both copies fit, whole where only one does (one direction at H = 1024, 8
    units a block), and reads it through L2 only where neither fits; with
    clusters and without."""
    plan = fwd_plan(h, dirs, batch, H100_SMS)
    assert plan.smem_bytes <= MAX_SMEM and plan.smem_bytes % 16 == 0
    if batch <= 32:
        assert plan.resident == resident[dirs - 1]
    assert plan.cluster in (1, 2)
    for cluster in (1, 2):
        if plan.blocks // dirs % cluster:
            continue
        p = fwd_plan(h, dirs, batch, H100_SMS, cluster)
        floats, wh = lstm._fwd_smem_floats(h, p.units, p.rows, p.resident, p.split,
                                           p.chunk_rows)
        assert (p.smem_bytes, p.resident_bytes) == (floats * 4, wh * 4) and floats * 4 <= MAX_SMEM
        fits = [lstm._fwd_smem_floats(h, p.units, p.rows, True, split, p.chunk_rows)[0] * 4
                <= MAX_SMEM for split in (True, False)]
        assert (p.resident, p.split) == (fits[0] or fits[1], fits[0])


def _gate_writes(plan, h: int, batch: int):
    """Every float of the gates' k slices the tensor cores' product writes in
    a step, by ``gates_mma_staged`` / ``gates_mma_nt``'s work items over the
    cluster's columns: (slice, row, column) -> offset."""
    c = plan.cluster
    nbp, mp = -(-4 * plan.units // 16) * 16, -(-batch // 16) * 16
    gn, ksteps = c * nbp, -(-(-(-h // 16)) // c)
    ks = lstm._ksplit(mp // 16 * -(-gn // 64), ksteps)
    knt = 2 if h % 4 else min(8, gn // 8)
    nch, ldo = gn // 8 // knt, gn + 8
    for w in range(mp // 16 * nch * ks):  # the warps' (item, slice) pairs
        item, sl = divmod(w, ks)
        mt, t0 = item // nch, item % nch * knt
        for lane in range(32):
            gid, tig = divmod(lane, 4)
            for r in (mt * 16 + gid, mt * 16 + gid + 8):
                for nt in range(knt):
                    for e in range(2):
                        col = (t0 + nt) * 8 + 2 * tig + e
                        yield (sl, r, col), (sl * mp + r) * ldo + col


@pytest.mark.parametrize("h,dirs,batch,cluster", [
    (512, 2, 128, 2), (512, 1, 100, 2), (512, 2, 128, 1), (270, 1, 33, 1), (270, 1, 64, 2),
    (70, 2, 9, 1), (1540, 2, 40, 1), (1536, 2, 40, 2), (24, 1, 17, 1)])
def test_plan_scratch_equals_what_the_kernel_indexes(h, dirs, batch, cluster):
    """The tensor cores' product writes each (k slice, row, column) of its
    layout once and inside it, before the partner's sums and the rings; the
    epilogue reads every slice of each pair's four gate columns (the block's
    own among the cluster's) among them, and with a cluster of 2 the
    partner's sums of them, each written once inside its buffer; the h
    exchange is every float of ``hbuf_floats``, each (parity, direction,
    row, unit) written once."""
    plan = fwd_plan(h, dirs, batch, H100_SMS, cluster)
    assert plan.cluster == cluster
    writes = dict(_gate_writes(plan, h, batch))
    assert len(set(writes.values())) == len(writes)  # each float once
    nbp, mp = -(-4 * plan.units // 16) * 16, -(-batch // 16) * 16
    floats, wh = lstm._fwd_smem_floats(h, plan.units, plan.rows, plan.resident, plan.split,
                                       batch)
    xch = mp * nbp if cluster > 1 else 0
    gates = floats - wh - xch - lstm.FWD_STAGE_FLOATS  # the k slices
    assert max(writes.values()) < gates
    ks = len({k[0] for k in writes})
    for rank in range(cluster):
        own = rank * nbp
        reads = {(sl, b, own + g * plan.units + uu) for sl in range(ks) for b in range(batch)
                 for g in range(4) for uu in range(plan.units)}
        assert reads <= set(writes)
    if cluster > 1:  # the partner's sums: [B, 4u] of [mp, nbp]
        sums = [b * nbp + c for b in range(batch) for c in range(4 * plan.units)]
        assert len(set(sums)) == len(sums) and max(sums) < xch
    hbuf = [((p * dirs + d) * batch + b) * h + j for p in range(2) for d in range(dirs)
            for b in range(batch) for j in range(h)]
    assert sorted(hbuf) == list(range(plan.hbuf_floats))


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
                                    dict(h=0, dirs=1, batch=8),
                                    dict(h=512, dirs=2, batch=128, sm_count=0),
                                    dict(h=70, dirs=2, batch=128, cluster=2),
                                    dict(h=512, dirs=2, batch=128, cluster=4),
                                    dict(h=512, dirs=2, batch=128, cluster=-1)])
def test_plan_refuses_what_the_kernel_does_not_take(kwargs):
    with pytest.raises(ValueError, match="fwd_plan"):
        fwd_plan(**{"sm_count": H100_SMS, **kwargs})


def test_plan_keeps_each_launch_within_the_register_carries():
    """Each thread of a block carries at most BWD_MAX_PAIRS (row, unit) pairs
    on either path: a launch's rows times units stay within MAX_CARRIES, and
    the tensor cores' work items keep every warp busy at the headline."""
    for h, dirs, batch in ((512, 2, 2048), (512, 1, 2048), (1536, 2, 300), (70, 1, 4096)):
        plan = fwd_plan(h, dirs, batch, H100_SMS)
        assert plan.chunk_rows * plan.units <= MAX_CARRIES == BWD_THREADS * 8
    plan = fwd_plan(512, 2, 128, H100_SMS)
    assert 128 // 16 * 1 == BWD_WARPS  # 8 row tiles of 4u = 32 columns: a tile a warp
