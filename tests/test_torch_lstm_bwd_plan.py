"""The backward kernels' launch plan and the C entry points' ctypes table, on the CPU.

``ops/lstm.bwd_plan`` lays out kernels #2 and #4 (one cooperative launch
per call, at most one block per SM, the blocks of a direction in clusters
that sum their dh partials in shared memory, each block's two slices of
``Wh`` resident in shared memory where they fit, as TF32 hi and lo parts
where both copies fit, a batch past the register carries split into
launches); ``ops/build.SIGNATURES`` declares every C entry point's
arguments to ctypes, which passes a wrong count without complaint. Nothing
is compiled and no card is needed.
"""

import re

import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu_torch.ops import build
from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm
from tensorflow_end2end_speech_recognition_tpu_torch.ops.lstm import (
    BWD_CLUSTERS,
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


@pytest.mark.parametrize("dirs,units,smem,resident,split", [(2, 8, 200704, 137216, False),
                                                            (1, 4, 180224, 141312, True)])
def test_plan_at_the_train_step(dirs, units, smem, resident, split):
    """#2 and #4 at H = 512, B = 32: 128 blocks in clusters of 8, 134 KB and
    138 KB of Wh resident (#4's as TF32 hi and lo parts)."""
    plan = bwd_plan(512, dirs, 32, H100_SMS)
    assert (plan.units, plan.blocks, plan.cluster, plan.smem_bytes, plan.resident_bytes,
            plan.split) == (units, 128, 8, smem, resident, split)
    # Wc^T: the 4u columns of the block's units padded to 16, k = 512 rows
    # padded to 16 mod 32; Wr: the 64 units of the rank's readers by the
    # cluster's 8 x 4u columns, padded the same way; float32, twice when split
    nbp, units_per_rank = 4 * units if units >= 4 else 16, (128 // dirs) // 8 * units
    kc = 8 * nbp
    assert plan.resident_bytes == (2 if split else 1) * (
        nbp * (512 + 16) + units_per_rank * (kc + (16 if kc % 32 == 0 else 0))) * 4
    # dh partials: 2 step parities x dirs x 64 or 128 readers x 8 or 16
    # clusters x 32 rows x u
    assert plan.part_floats == 2 * dirs * (128 // dirs) * (128 // dirs // 8) * 32 * units


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
    at the device's SM count (read once per device), its clusters held to
    the device's cluster occupancy for the kernel of the stream dtype."""
    seen, asked = [], []
    monkeypatch.setattr(lstm, "_sm_count", lambda index: seen.append(index) or H100_SMS)
    monkeypatch.setattr(lstm, "_max_clusters",
                        lambda *args: asked.append(args[:3]) or H100_SMS)
    assert bwd_plan_for(torch.device("cuda", 1), 512, 2, 32) == bwd_plan(512, 2, 32, H100_SMS)
    assert bwd_plan_for(torch.device("cuda"), 320, 1, 64, bf16=True) == bwd_plan(
        320, 1, 64, H100_SMS)
    assert seen == [1, 0]
    assert asked == [(1, 2, False), (0, 1, True)]  # device, directions, bf16 kernel


@pytest.mark.parametrize("h", [1, 24, 40, 70, 256, 270, 320, 512, 1024, 1536, 1540])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("batch", [1, 37, 128])
def test_plan_clusters_divide_each_directions_blocks(h, dirs, batch):
    """The cluster is the largest in BWD_CLUSTERS that divides a direction's
    blocks and keeps Wh resident where one does (every size's clusters
    resident when no card is asked): a larger size that divides was passed
    over only because its layout does not fit, or would read Wh through L2
    where this one holds it."""
    plan = bwd_plan(h, dirs, batch, H100_SMS)
    per_dir = plan.blocks // dirs
    assert plan.cluster in BWD_CLUSTERS and per_dir % plan.cluster == 0
    for c in BWD_CLUSTERS:
        if c > plan.cluster and per_dir % c == 0:
            resident, _, floats, _ = lstm._bwd_fit(h, plan.units, plan.chunk_rows, c)
            assert floats * 4 > MAX_SMEM or (plan.resident and not resident), c


def test_plan_takes_the_largest_cluster_the_card_holds():
    """``max_clusters`` (the card's cudaOccupancyMaxActiveClusters) decides:
    a size whose clusters cannot all be resident is passed over."""
    asked = []

    def holds(limits):
        def max_clusters(cluster, resident, split, smem_bytes, blocks):
            asked.append((cluster, resident, split, smem_bytes, blocks))
            return limits.get(cluster, 0)
        return max_clusters

    assert bwd_plan(512, 2, 32, H100_SMS, holds({8: 16})).cluster == 8
    # asked with the kernel and the layout that cluster size launches with
    floats, _ = lstm._bwd_smem_floats(512, 8, 32, 8, True, False)
    assert asked == [(8, True, False, floats * 4, 64)]
    assert bwd_plan(512, 2, 32, H100_SMS, holds({8: 15, 4: 32})).cluster == 4
    assert bwd_plan(512, 1, 128, H100_SMS, holds({8: 15, 4: 31, 2: 64})).cluster == 2
    plan = bwd_plan(512, 2, 128, H100_SMS, holds({}))
    assert plan.cluster == 1 and plan.part_floats == 2 * 2 * 64 * 64 * 128 * 8
    assert [a[0] for a in asked[-3:]] == [8, 4, 2]  # largest first; 1 needs no query


@pytest.mark.parametrize("h,resident", [(256, True), (320, True), (512, True), (1024, False),
                                        (1536, False)])
@pytest.mark.parametrize("batch", [1, 8, 32, 128, 256])
@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("cards_clusters", [True, False])
def test_plan_shared_memory_fits(h, resident, batch, dirs, cards_clusters):
    """At the configs' widths and the batches of serving, training and the
    headline, every launch's shared memory fits MAX_SMEM, with Wh resident
    up to H = 512 and read through L2 past it up to the headline's B = 128
    (past it the rows' buffers may leave no room), with clusters and
    without; split (hi and lo copies) only where Wh is resident, and Wh
    read through L2 only where its slices would not fit."""
    plan = bwd_plan(h, dirs, batch, H100_SMS, None if cards_clusters else lambda *a: 0)
    assert plan.smem_bytes <= MAX_SMEM and plan.smem_bytes % 16 == 0
    if cards_clusters and batch <= 128:
        assert plan.resident == resident
    assert plan.resident or (plan.resident_bytes == 0 and not plan.split)
    if not plan.resident:  # the slices would not fit
        assert lstm._bwd_smem_floats(h, plan.units, plan.chunk_rows, plan.cluster, True,
                                     False)[0] * 4 > MAX_SMEM
    floats, wh = lstm._bwd_smem_floats(h, plan.units, plan.chunk_rows, plan.cluster,
                                       plan.resident, plan.split)
    assert (plan.smem_bytes, plan.resident_bytes) == (floats * 4, wh * 4)
    if plan.resident and not plan.split:  # the hi and lo copies would not fit
        assert lstm._bwd_smem_floats(h, plan.units, plan.chunk_rows, plan.cluster, True,
                                     True)[0] * 4 > MAX_SMEM


def _partial_writes(h, units, batch, cluster, dirs, parity):
    """Every float of the dh partials the kernel writes in a step of the
    parity, by bwd_walk's part_at and bwd_partials' indexing: (dir, writer
    block, row, unit) -> offset in part."""
    per_dir = -(-h // units)
    ncl, ni = per_dir // cluster, per_dir // cluster * units
    slot = ncl * batch * units
    for d in range(dirs):
        base = (parity * dirs + d) * per_dir * slot
        for blk in range(per_dir):
            ck, rank = divmod(blk, cluster)
            for n in range(ni):
                i = rank * ni + n
                r = i // units
                for b in range(batch):
                    yield (d, blk, b, i), base + ((r * ncl + ck) * batch + b) * units \
                        + i - r * units


def _partial_reads(h, units, batch, cluster, dirs, parity):
    """Every float of the dh partials the kernel reads in a step, those a
    step of the parity wrote (the dh sum of each block's pairs over the
    clusters)."""
    per_dir = -(-h // units)
    ncl = per_dir // cluster
    slot = ncl * batch * units
    for d in range(dirs):
        base = (parity * dirs + d) * per_dir * slot
        for blk in range(per_dir):
            for k in range(ncl):
                for b in range(batch):
                    for uu in range(units):
                        yield base + blk * slot + (k * batch + b) * units + uu


@pytest.mark.parametrize("h,dirs,batch", [(40, 2, 5), (70, 1, 3), (24, 2, 17), (270, 1, 2)])
def test_plan_scratch_equals_what_the_kernel_indexes(h, dirs, batch):
    """part_floats is exactly the floats the kernel writes and reads in
    two steps, one of each parity: in each, each (direction, writer cluster,
    row, unit) once, every offset read by its reader block and written by one
    block of each cluster; the two steps' offsets apart."""
    plan = bwd_plan(h, dirs, batch, H100_SMS)
    offsets = []
    for parity in (0, 1):
        writes = dict(_partial_writes(h, plan.units, batch, plan.cluster, dirs, parity))
        step = sorted(writes.values())
        assert len(step) == len(writes)  # every float once in a step
        assert sorted(_partial_reads(h, plan.units, batch, plan.cluster, dirs, parity)) == step
        offsets += step
    assert sorted(offsets) == list(range(plan.part_floats))  # none twice, none past the end


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
    # T, H, units, resident, split, cluster, smem_bytes, forget_bias, stream
    for name in ("lstm_bidi_bwd", "lstm_layer_bwd"):
        assert defined[name][-13:] == ["p", "p"] + ["i"] * 9 + ["f", "p"], name
        # and their cluster occupancy: blocks, cluster, resident, split,
        # smem_bytes, bf16
        assert defined[f"{name}_max_clusters"] == ["i"] * 6, name
    # and both forward entry points: sync, hbuf, hbuf_floats, B, T, H, units,
    # resident, rows, smem_bytes, forget_bias, stream
    for name, streams in (("lstm_bidi_fwd", 9), ("lstm_layer_fwd", 5)):
        assert defined[name] == ["p"] * streams + ["p", "p"] + ["i"] * 8 + ["f", "p"], name
