"""Fused LSTM layers over hoisted input projections: bidirectional and one direction.

Counterparts of ``lstm_bidi_pallas`` and ``lstm_layer_pallas`` with their
VJPs in ``tensorflow_end2end_speech_recognition_tpu/ops/pallas/
lstm_kernel.py``, with the same contracts:

    lstm_bidi(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias) -> (ys_f, ys_b)
    lstm_layer(xproj, wh, mask, forget_bias) -> ys
    lstm_layer(xproj, wh, mask, forget_bias, initial_state=(h0, c0)) -> (ys, (hT, cT))

``xproj*`` [B, T, 4H] = x @ Wx + b per direction, ``xproj_b`` already
reversed over each row's valid prefix; ``wh*`` [H, 4H]; ``mask`` [B, T]
float, monotone per row (a length mask). Gates are i, f, g, o with
``forget_bias`` added to f. A masked step carries h and c through and emits
0. Returns ``ys*`` [B, T, H], ``ys_b`` still in reversed order. A
streaming chunk resumes one direction from a carried ``(h0, c0)`` and gets
the carried state back, as the scan branch of ``rnn_scan`` with an
``initial_state`` does (kernel #3's ``lstm_layer_fwd_carry`` entry); at
``compute_dtype: bfloat16`` that scan rounds ``h`` and ``Wh`` to bf16 for
each step's product and keeps every stream float32, which
``bf16_product=True`` takes (the ``lstm_layer_fwd_carry_bf16`` entry).

Streams come in float32 or bf16 (``compute_dtype: bfloat16``): the stream
dtype is ``xproj``'s, and ``ys``, ``cs``, the cotangents and ``dxproj``
share it, while ``wh``, ``mask``, the carried ``h`` and ``c`` and all gate
math stay float32, as in the Pallas kernels (only their HBM streams
round). The forward rounds only the emitted ``ys = h * m`` and ``cs``; the
backward recomputes the gates from the bf16 ``ys[t-1]`` and ``cs``,
carries ``dh = dgates @ Wh^T`` from the float32 ``dgates`` and rounds only
the emitted ``dxproj``. A carried ``initial_state`` takes float32 streams
only: the reference's chunk takes the scan, which has no bf16 streams (its
bf16 mode rounds the product's operands: ``bf16_product``).

When a gradient may be taken, the call goes through ``LSTMBidi`` or
``LSTMLayer``, a ``torch.autograd.Function``: its forward also keeps the
cell-state streams ``cs``, and its backward recomputes the gates step by
step (``lstm_bidi_bwd``, ``lstm_layer_bwd``) and forms ``dWh`` per
direction as one contraction over [T*B] of the shifted ``ys`` against
``dxproj``, as ``_bidi_bwd_call`` and ``_bwd_call`` do.

CPU tensors take the plain versions (``lstm_layer_fwd_plain``,
``lstm_layer_bwd_plain`` and their two-direction forms), time loops in plain
PyTorch. CUDA tensors launch the hand-written kernels (``csrc/lstm_bidi_fwd.cu``
#1, ``lstm_bidi_bwd.cu`` #2, ``lstm_layer_fwd.cu`` #3, ``lstm_layer_bwd.cu`` #4,
all in ``csrc/lstm_step.cuh``: each one persistent cooperative launch per
call, laid out by ``fwd_plan`` and ``bwd_plan``; a batch past a block's
register carries is split into launches over contiguous rows) or raise;
there is no fallback. Each kernel has a float32 and a bf16 instantiation,
separate C entries (``lstm_bidi_fwd`` and ``lstm_bidi_fwd_bf16``, ...); a
bf16 CUDA tensor launches the bf16 one or raises. ``lstm_bidi.launches``,
``lstm_bidi_bwd.launches``, ``lstm_layer.launches`` and
``lstm_layer_bwd.launches`` count the calls that launched each float32
kernel, and ``.launches_bf16`` on the same functions the bf16 ones;
``lstm_layer.launches_bf16_product`` counts the carried walk with bf16
products.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import bf16 as bf16_ops
from . import build


def _gates(gates, h, forget_bias):
    i, f, g, o = gates.split(h, dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f + forget_bias), torch.tanh(g), torch.sigmoid(o)


def lstm_layer_fwd_plain(xproj, wh, mask, forget_bias: float = 1.0, initial_state=None,
                         bf16_product: bool = False):
    """Plain version of the forward kernels: one ``h @ Wh + xproj[t]`` step per t.

    Returns ``(ys, cs)``, each [B, T, H] in ``xproj``'s dtype; ``cs`` holds
    the carried cell state at every step. The walk runs in float32 from
    ``xproj.float()``; a bf16 ``xproj`` gets bf16 ``ys`` and ``cs``, rounded
    from the float32 carries as they are emitted (``_fwd_kernel``). With
    ``initial_state`` ``(h0, c0)`` ([B, H] each) the walk starts from it,
    and the carried ``(hT, cT)`` after the last step comes third: ``(ys,
    cs, (hT, cT))``, the scan branch of ``rnn_scan(..., initial_state=...)``.
    ``bf16_product`` (float32 streams) rounds ``h`` and ``Wh`` to bf16 for
    each step's product and sums the exact products in float32: that scan at
    ``compute_dtype: bfloat16`` (``_lstm_step``'s bf16 branch).
    """
    b, t, g4 = xproj.shape
    h = g4 // 4
    sdt, xproj = xproj.dtype, xproj.float()
    if bf16_product:
        wh = wh.to(bf16_ops.BF16).float()
    if initial_state is None:
        h_prev, c_prev = xproj.new_zeros((b, h)), xproj.new_zeros((b, h))
    else:
        h_prev, c_prev = initial_state
    ys, cs = [], []
    for s in range(t):
        hw = (h_prev.to(bf16_ops.BF16).float() if bf16_product else h_prev) @ wh
        i, f, g, o = _gates(xproj[:, s] + hw, h, forget_bias)
        c = f * c_prev + i * g
        h_new = o * torch.tanh(c)
        m = mask[:, s, None]
        on = m > 0
        h_prev = torch.where(on, h_new, h_prev)
        c_prev = torch.where(on, c, c_prev)
        ys.append((h_prev * m).to(sdt))
        cs.append(c_prev.to(sdt))
    out = torch.stack(ys, dim=1), torch.stack(cs, dim=1)
    return out if initial_state is None else (*out, (h_prev, c_prev))


def lstm_bidi_fwd_plain(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias: float = 1.0):
    """Both directions of ``lstm_layer_fwd_plain``: ``(ys_f, ys_b, cs_f, cs_b)``."""
    ys_f, cs_f = lstm_layer_fwd_plain(xproj_f, wh_f, mask, forget_bias)
    ys_b, cs_b = lstm_layer_fwd_plain(xproj_b, wh_b, mask, forget_bias)
    return ys_f, ys_b, cs_f, cs_b


def _shift_one(x):
    """[B, T, H] -> step t holds x[:, t-1], step 0 zeros (the h_{t-1} stream)."""
    return F.pad(x[:, :-1], (0, 0, 1, 0))


def lstm_layer_bwd_plain(xproj, wh, mask, ys, cs, gys, forget_bias: float = 1.0):
    """Plain version of the backward kernels: ``dxproj`` [B, T, 4H].

    The reverse walk of ``_bwd_kernel``: recompute the gates at t from
    ``xproj[t]`` and ``h_{t-1} = ys[t-1]``, carry ``dh`` and ``dc``, emit
    ``dgates`` (zero on a masked step, which carries dh and dc through).
    bf16 streams are upcast as they are read; the carries and ``dh =
    dgates @ Wh^T`` stay float32, and only the emitted ``dxproj`` rounds to
    the stream dtype.
    """
    b, t, g4 = xproj.shape
    h = g4 // 4
    sdt = xproj.dtype
    xproj, ys, cs, gys = (x.float() for x in (xproj, ys, cs, gys))
    h_prev_all, c_prev_all = _shift_one(ys), _shift_one(cs)
    dh = xproj.new_zeros((b, h))
    dc = xproj.new_zeros((b, h))
    dxs = [None] * t
    for s in reversed(range(t)):
        on = mask[:, s, None] > 0
        i, f, g, o = _gates(xproj[:, s] + h_prev_all[:, s] @ wh, h, forget_bias)
        dh_total = torch.where(on, gys[:, s], 0.0) + dh
        tc = torch.tanh(cs[:, s])
        do = dh_total * tc
        dc_total = dc + dh_total * o * (1.0 - tc * tc)
        dgates = torch.cat([
            dc_total * g * i * (1.0 - i),
            dc_total * c_prev_all[:, s] * f * (1.0 - f),
            dc_total * i * (1.0 - g * g),
            do * o * (1.0 - o),
        ], dim=-1)
        dgates = torch.where(on, dgates, 0.0)
        dxs[s] = dgates.to(sdt)
        dh = torch.where(on, dgates @ wh.t(), dh_total)
        dc = torch.where(on, dc_total * f, dc)
    return torch.stack(dxs, dim=1)


def lstm_bidi_bwd_plain(xproj_f, xproj_b, wh_f, wh_b, mask, ys_f, ys_b, cs_f, cs_b,
                        gys_f, gys_b, forget_bias: float = 1.0):
    """Both directions of ``lstm_layer_bwd_plain``: ``(dxproj_f, dxproj_b)``."""
    return (lstm_layer_bwd_plain(xproj_f, wh_f, mask, ys_f, cs_f, gys_f, forget_bias),
            lstm_layer_bwd_plain(xproj_b, wh_b, mask, ys_b, cs_b, gys_b, forget_bias))


STREAM_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(what, **tensors) -> torch.dtype:
    """Same device, contiguous, and the shapes of the first tensor's [B, T,
    4H]: ``wh*`` [H, 4H], ``mask`` [B, T], ``xproj*`` [B, T, 4H], and every
    other stream (``ys``, ``cs``, ``gys``) [B, T, H]. ``wh*`` and ``mask``
    are float32; the streams are all float32 or all bf16 (the first
    tensor's dtype, which is returned: the stream dtype)."""
    first_name, first = next(iter(tensors.items()))
    dev, sdt = first.device, first.dtype
    if sdt not in STREAM_DTYPES:
        raise ValueError(f"{what}: {first_name} must be float32 or bfloat16, got {sdt}")
    for name, x in tensors.items():
        if x.device != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, {first_name} on {dev}")
        want = torch.float32 if name.startswith("wh") or name == "mask" else sdt
        if x.dtype != want:
            raise ValueError(f"{what}: {name} must be {want} (streams in {first_name}'s "
                             f"dtype; wh and mask float32), got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if first.dim() != 3 or first.shape[-1] % 4:
        raise ValueError(f"{what}: {first_name} must be [B, T, 4H], got {tuple(first.shape)}")
    b, t, g4 = first.shape
    h = g4 // 4
    for name, x in tensors.items():
        if name.startswith("wh"):
            want = (h, g4)
        elif name == "mask":
            want = (b, t)
        else:
            want = (b, t, g4 if name.startswith("xproj") else h)
        if tuple(x.shape) != want:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, expected {want}")
    if b == 0 or t == 0 or h == 0:
        raise ValueError(f"{what}: empty input {tuple(first.shape)}")
    return sdt


def _device_of(what, x):
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    return dev


# The walks' launch geometry; csrc/lstm_step.cuh (fwd_layout, bwd_layout,
# run_fwd_walk, run_bwd_walk) holds the same numbers and refuses a plan that
# disagrees.
BWD_THREADS = 256  # threads per block
BWD_WARPS = BWD_THREADS // 32
BWD_CLUSTERS = (8, 4, 2, 1)  # thread-block clusters the backward takes, largest first
FWD_FFMA_ROWS = 8  # launches of at most this many rows take the forward's FFMA product
FWD_MMA_ROWS = 16  # past them, the tensor cores' row tile: the plan's rows / cluster
FWD_CLUSTER_MIN_ROWS = 64  # launches of at least this many rows split its k over 2 blocks
FWD_STAGE_FLOATS = BWD_WARPS * 3 * 16 * 48  # kStageFloats: the warps' rings of h_{t-1}
BWD_STAGE_ROW = 256 + 4  # floats per staged row (256 k and 4 of padding)
BWD_UNITS = (1, 2, 4, 8, 16, 32, 64, 128)  # unit tiles the kernels take
BWD_MAX_PAIRS = 8  # (row, unit) carries a thread keeps in registers
MAX_CARRIES = BWD_THREADS * BWD_MAX_PAIRS  # B x units of one launch
MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use


class FwdPlan(NamedTuple):
    """Launch plan of the forward kernels #1 and #3 (``fwd_plan``)."""

    units: int  # hidden units per block, of one direction, for every batch row
    blocks: int  # blocks of a launch, all directions
    resident: bool  # the block's slice of Wh held in shared memory
    rows: int  # the product path: FWD_FFMA_ROWS, or FWD_MMA_ROWS x cluster
    smem_bytes: int  # dynamic shared memory per block
    resident_bytes: int  # of which the Wh slice (0 when streamed)
    hbuf_floats: int  # the h exchange of a launch: [2, dirs, chunk_rows, H]
    chunks: int  # launches per call: the batch split to fit the register carries
    chunk_rows: int  # batch rows of every launch but the last
    split: bool  # the resident slice held as TF32 hi and lo parts (tensor cores)
    cluster: int  # blocks (a cluster along x) that split the tensor cores' k; 0: FFMA


class BwdPlan(NamedTuple):
    """Launch plan of the backward kernels #2 and #4 (``bwd_plan``)."""

    units: int  # hidden units per block, of one direction, for every batch row
    blocks: int  # blocks of a launch, all directions
    cluster: int  # blocks of a direction per thread-block cluster (1: none)
    resident: bool  # the block's slices of Wh held in shared memory
    split: bool  # and held as TF32 hi and lo parts (else split as they are read)
    smem_bytes: int  # dynamic shared memory per block
    resident_bytes: int  # of which the Wh slices (0 when streamed)
    part_floats: int  # scratch for the dh partials of a launch of chunk_rows rows
    chunks: int  # launches per call: the batch split to fit the register carries
    chunk_rows: int  # batch rows of every launch but the last


def _unit_tile(what: str, h: int, dirs: int, batch: int, sm_count: int) -> int:
    """The smallest tile in ``BWD_UNITS`` that gives at most one block per SM.

    Both walks are one cooperative launch of ``dirs * ceil(h / units)``
    blocks that meet at a grid barrier every step, so all of them must be
    resident.
    """
    if h <= 0 or batch <= 0 or dirs not in (1, 2) or sm_count <= 0:
        raise ValueError(f"{what}: bad arguments h={h} dirs={dirs} batch={batch} "
                         f"sm_count={sm_count}")
    units = next((u for u in BWD_UNITS if dirs * -(-h // u) <= sm_count), None)
    if units is None:
        raise ValueError(f"{what}: H={h} needs more than {BWD_UNITS[-1]} units per block "
                         f"for {dirs} direction(s) on {sm_count} SMs")
    return units


def _batch_chunks(batch: int, units: int, max_rows: int | None = None) -> tuple[int, int]:
    """(launches, rows of every launch but the last): as few launches as keep
    each one's B x units within ``MAX_CARRIES`` (and its rows within
    ``max_rows``), their rows as even as can be. The rows of a batch are
    independent, so each launch walks its own."""
    cap = MAX_CARRIES // units if max_rows is None else min(max_rows, MAX_CARRIES // units)
    rows = -(-batch // -(-batch // cap))
    return -(-batch // rows), rows


def _fwd_smem_floats(h: int, units: int, rows: int, resident: bool, split: bool = False,
                     batch: int = 0) -> tuple[int, int]:
    """(all, Wh slice) floats of one forward block's shared memory: ``fwd_layout``.

    FFMA (``rows`` ``FWD_FFMA_ROWS``): Wc, the staged chunk, the k slices'
    partial sums, the chunk's gates. Tensor cores (``rows`` ``FWD_MMA_ROWS``
    x C, ``batch`` the launch's rows): Wc^T of the C blocks' columns over one
    block's share of k (twice when ``split``), the gates' k slices for every
    row, the partner's sums of this block's columns when C = 2, and the
    warps' staging rings of h_{t-1}.
    """
    if rows == FWD_FFMA_ROWS:
        hp, nb = -(-h // 4) * 4, 4 * units
        wh = hp * (nb + 4) if resident else 0
        return wh + 2 * rows * BWD_STAGE_ROW + BWD_THREADS * 16 + rows * nb, wh
    c = rows // FWD_MMA_ROWS
    nbp, mp = -(-4 * units // 16) * 16, -(-batch // 16) * 16
    ksteps = -(-(-(-h // 16)) // c)
    wh = (2 if split else 1) * c * nbp * _pad16(16 * ksteps) if resident else 0
    gates = _ksplit(mp // 16 * -(-c * nbp // 64), ksteps) * mp * (c * nbp + 8)
    return wh + gates + (mp * nbp if c > 1 else 0) + FWD_STAGE_FLOATS, wh


def _fwd_fit(h: int, units: int, rows: int, batch: int) -> tuple[bool, bool, int, int]:
    """(resident, split, all, Wh slice) floats of a forward layout: the slice
    as TF32 hi and lo parts on the tensor cores where both copies fit
    ``MAX_SMEM``, whole where one does, else read through L2."""
    layouts = ((True, False),) if rows == FWD_FFMA_ROWS else ((True, True), (True, False))
    for resident, split in (*layouts, (False, False)):
        floats, wh = _fwd_smem_floats(h, units, rows, resident, split, batch)
        if floats * 4 <= MAX_SMEM:
            break
    return resident, split, floats, wh


def fwd_plan(h: int, dirs: int, batch: int, sm_count: int, cluster: int | None = None) -> FwdPlan:
    """Unit tile, grid, product path and shared memory of one forward call.

    The tile is ``bwd_plan``'s. A launch of more than ``FWD_FFMA_ROWS`` rows
    forms every row's gates in one pass on the tensor cores (3xTF32
    ``mma.sync``), the block's ``Wh`` slice held as TF32 hi and lo parts where
    both copies fit, whole where one does, else read through L2; from
    ``FWD_CLUSTER_MIN_ROWS`` rows, where a direction's blocks pair up and the
    pair's layout still holds ``Wh`` as hi and lo parts, the blocks pair in
    clusters that split the product's k (``rows`` = ``FWD_MMA_ROWS`` x
    ``cluster``). A launch of up to ``FWD_FFMA_ROWS`` rows (serving, the
    streaming chunks) takes FFMA (``rows`` = ``FWD_FFMA_ROWS``, ``cluster``
    0), whose sums a streamed chunk and its whole utterance share.
    ``cluster`` forces the path: 0 FFMA, 1 or 2 the tensor cores (the probe's
    comparison). Past ``MAX_CARRIES``, or past the rows whose shared memory
    fits, the call is split into ``chunks`` launches over contiguous rows.
    """
    units = _unit_tile("fwd_plan", h, dirs, batch, sm_count)
    per_dir = -(-h // units)
    carried = _batch_chunks(batch, units)[1]  # the rows of a launch as the carries allow
    if cluster is None:
        if carried <= FWD_FFMA_ROWS:
            cluster = 0
        else:
            cluster = 2 if (carried >= FWD_CLUSTER_MIN_ROWS and per_dir % 2 == 0
                            and _fwd_fit(h, units, 2 * FWD_MMA_ROWS, carried)[1]) else 1
    elif cluster not in (0, 1, 2) or (cluster and per_dir % cluster):
        raise ValueError(f"fwd_plan: no clusters of {cluster} for {per_dir} blocks a direction")
    rows = FWD_MMA_ROWS * cluster if cluster else FWD_FFMA_ROWS
    max_rows = MAX_CARRIES // units
    while rows != FWD_FFMA_ROWS and _fwd_fit(h, units, rows, max_rows)[2] * 4 > MAX_SMEM:
        max_rows //= 2
    chunks, chunk_rows = _batch_chunks(batch, units, max_rows)
    resident, split, floats, wh = _fwd_fit(h, units, rows, chunk_rows)
    return FwdPlan(units, dirs * per_dir, resident, rows, floats * 4, wh * 4,
                   2 * dirs * chunk_rows * h, chunks, chunk_rows, split, cluster)


def _pad16(n: int) -> int:
    """A multiple of 16 padded to 16 mod 32 floats (``mma_ld``)."""
    return n + 16 if n % 32 == 0 else n


def _ksplit(items: int, ksteps: int) -> int:
    """``mma_ksplit``: k slices that keep each warp on its own work item."""
    ks = 1
    while 2 * ks * items <= BWD_WARPS and 2 * ks <= ksteps:
        ks *= 2
    return ks


def _dh_slices(values: int, planes: int) -> int:
    """``bwd_dh_slices``: slices of the dh sum's planes over the threads."""
    s = 1
    while 2 * s <= planes and 2 * s * values <= MAX_CARRIES:
        s *= 2
    return s


def _bwd_smem_floats(h: int, units: int, rows: int, cluster: int, resident: bool,
                     split: bool) -> tuple[int, int]:
    """(all, Wh slices) floats of one backward block's shared memory: ``bwd_layout``."""
    per_dir = -(-h // units)
    nbp = -(-4 * units // 16) * 16
    kp = -(-h // 16) * 16
    ni = per_dir // cluster * units
    nip = -(-ni // 8) * 8
    kc = cluster * nbp
    mp = -(-rows // 16) * 16
    copies = 2 if split else 1
    wh = copies * (nbp * _pad16(kp) + nip * _pad16(kc)) if resident else 0
    gate = _ksplit(mp // 16 * -(-nbp // 64), kp // 16) * mp * (nbp + 8)
    red = _dh_slices(rows * units, per_dir // cluster) * rows * units
    return wh + mp * _pad16(kc) + gate + red, wh


def _bwd_fit(h: int, units: int, rows: int, cluster: int) -> tuple[bool, bool, int, int]:
    """(resident, split, all, Wh slices) floats: the slices split into TF32 hi
    and lo where both copies fit ``MAX_SMEM``, else held whole where they fit,
    else read through L2."""
    for resident, split in ((True, True), (True, False), (False, False)):
        floats, wh = _bwd_smem_floats(h, units, rows, cluster, resident, split)
        if floats * 4 <= MAX_SMEM:
            break
    return resident, split, floats, wh


def bwd_plan(h: int, dirs: int, batch: int, sm_count: int, max_clusters=None) -> BwdPlan:
    """Unit tile, cluster, grid and shared memory of one backward call.

    The kernel is one cooperative launch of ``dirs * ceil(h / units)``
    blocks that meet at a grid barrier every step, so all of them must be
    resident: the tile is the smallest in ``BWD_UNITS`` that gives at most
    one block per SM. The blocks of a direction form clusters of a size in
    ``BWD_CLUSTERS`` that divides their count and at which
    ``max_clusters(cluster, resident, split, smem_bytes, blocks)`` (the
    card's ``cudaOccupancyMaxActiveClusters``; None: every size) keeps all
    of them resident: the largest at which a block keeps its two slices of
    ``Wh`` in shared memory (as TF32 hi and lo parts when both copies fit),
    else the largest, reading them through L2. A cluster sums its dh
    partials in shared memory (each block holds a copy of the cluster's
    dgates, so a larger cluster takes more of it) and the clusters exchange
    theirs through ``part_floats`` of scratch, two steps' partials by the
    step's parity. Past ``MAX_CARRIES``, or past
    the rows whose shared memory fits, the call is split into ``chunks``
    launches over contiguous rows.
    """
    units = _unit_tile("bwd_plan", h, dirs, batch, sm_count)
    per_dir = -(-h // units)
    max_rows = MAX_CARRIES // units
    while _bwd_fit(h, units, max_rows, 1)[2] * 4 > MAX_SMEM:
        max_rows //= 2
    chunks, chunk_rows = _batch_chunks(batch, units, max_rows)
    # the largest cluster size whose clusters the card holds at once and whose
    # layout keeps Wh resident; else the largest that the card holds
    chosen = None
    for cluster in BWD_CLUSTERS:
        if per_dir % cluster:
            continue
        fit = (cluster, *_bwd_fit(h, units, chunk_rows, cluster))
        if fit[3] * 4 > MAX_SMEM or (
                cluster > 1 and max_clusters is not None
                and max_clusters(cluster, fit[1], fit[2], fit[3] * 4, per_dir)
                < dirs * per_dir // cluster):
            continue
        if fit[1]:
            chosen = fit
            break
        chosen = chosen or fit
    cluster, resident, split, floats, wh = chosen
    # two step parities x dirs x reader blocks x clusters x rows x units
    part = 2 * dirs * per_dir * (per_dir // cluster) * chunk_rows * units
    return BwdPlan(units, dirs * per_dir, cluster, resident, split, floats * 4, wh * 4, part,
                   chunks, chunk_rows)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fwd_plan_for(dev: torch.device, h: int, dirs: int, batch: int) -> FwdPlan:
    """``fwd_plan`` for the SMs of CUDA device ``dev``: the plan both forward
    wrappers launch with."""
    return fwd_plan(h, dirs, batch, _sm_count(dev.index or 0))


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, dirs: int, bf16: bool, cluster: int, resident: bool, split: bool,
                  smem_bytes: int, blocks: int) -> int:
    """Clusters of the backward kernel that device ``index`` holds at once
    (``cudaOccupancyMaxActiveClusters``, through the C entry); raises on a
    CUDA error."""
    lib = build.load_library()
    what = f"lstm_{'bidi' if dirs == 2 else 'layer'}_bwd_max_clusters"
    with torch.cuda.device(index):
        n = getattr(lib, what)(blocks, cluster, int(resident), int(split), smem_bytes, int(bf16))
    build.check(lib, -min(n, 0), what)
    return n


def bwd_plan_for(dev: torch.device, h: int, dirs: int, batch: int,
                 bf16: bool = False) -> BwdPlan:
    """``bwd_plan`` for the SMs and the cluster occupancy of CUDA device
    ``dev`` (``bf16``: of the bf16-stream kernel): the plan both backward
    wrappers launch with."""
    index = dev.index or 0
    return bwd_plan(h, dirs, batch, _sm_count(index),
                    functools.partial(_max_clusters, index, dirs, bf16))


# The walks' step traces (``csrc/lstm_step.cuh`` kTraceSteps, kTracePoints,
# kFwdTracePoints) and the phases between their marks; a phase runs from its
# mark to the next (the last to the next step's first).
BWD_TRACE_STEPS, BWD_TRACE_POINTS = 64, 9
BWD_TRACE_PHASES = ("gates", "wait", "dh_sum", "derivatives", "dg_copy", "cluster_barrier",
                    "partials", "arrive", "dx_and_loads")
FWD_TRACE_POINTS = 5
FWD_TRACE_PHASES = ("stream_loads", "wait", "product", "epilogue", "arrive")


def _trace(entry: str, call) -> list:
    """The trace of one ``call`` that launches a walk of the source whose
    trace entry is ``entry``_trace: the values the kernel wrote, clock64() and
    the global timer (ns) at the launch's start and end last. Raises on a CUDA
    error."""
    lib = build.load_library()
    ctl, what = getattr(lib, f"{entry}_trace"), f"{entry}_trace"
    buf = (ctypes.c_longlong * (BWD_TRACE_STEPS * BWD_TRACE_POINTS + 4))()
    build.check(lib, ctl(1, None), what)
    try:
        call()
        torch.cuda.synchronize()
    finally:
        build.check(lib, ctl(0, None), what)
    build.check(lib, ctl(0, ctypes.cast(buf, ctypes.c_void_p)), what)
    return list(buf)


def _step_phases(trace: list, points: int, phases: tuple) -> dict:
    """µs per phase of a step: the mean over steps 1 .. ``BWD_TRACE_STEPS`` -
    2 of a trace of ``points`` marks a step, cycles converted by the launch's
    clock and timer."""
    c0, n0, c1, n1 = trace[-4:]
    us = (n1 - n0) / max(c1 - c0, 1) / 1e3  # µs per cycle
    steps = range(1, BWD_TRACE_STEPS - 1)
    sums = [0.0] * len(phases)
    for st in steps:
        marks = trace[st * points:(st + 1) * points + 1]
        for k in range(len(phases)):
            sums[k] += (marks[k + 1] - marks[k]) * us
    return {ph: x / len(steps) for ph, x in zip(phases, sums)}


def bwd_trace(entry: str, call) -> list:
    """The step trace of one ``call`` that launches backward kernel ``entry``
    (``lstm_bidi_bwd`` or ``lstm_layer_bwd``, either stream type): clock64()
    of thread 0 of block (0, 0) at the ``BWD_TRACE_POINTS`` marks of each of
    the first ``BWD_TRACE_STEPS`` steps, then clock64() and the global timer
    (ns) at the launch's start and end. While the trace is on the kernel
    meets at a block barrier at some marks, so the traced call is timed
    apart from an untraced one. Raises on a CUDA error."""
    return _trace(entry, call)


def bwd_step_phases(trace: list) -> dict:
    """µs per phase of a backward step (``BWD_TRACE_PHASES``) of a ``bwd_trace``."""
    return _step_phases(trace, BWD_TRACE_POINTS, BWD_TRACE_PHASES)


def fwd_trace(entry: str, call) -> list:
    """The step trace of one ``call`` that launches forward kernel ``entry``
    (``lstm_bidi_fwd`` or ``lstm_layer_fwd``: any walk of its source, either
    stream type, the carried ones too): clock64() of thread 0 of block (0, 0)
    at the ``FWD_TRACE_POINTS`` marks of each of the first
    ``BWD_TRACE_STEPS`` steps (from the buffer's start), then, at the
    buffer's end as in ``bwd_trace``, the launch's clocks and timers. A
    traced call meets at block barriers at some marks: time it apart. Raises
    on a CUDA error."""
    return _trace(entry, call)


def fwd_step_phases(trace: list) -> dict:
    """µs per phase of a forward step (``FWD_TRACE_PHASES``) of a ``fwd_trace``."""
    return _step_phases(trace, FWD_TRACE_POINTS, FWD_TRACE_PHASES)


def _rows(b0: int, b1: int, *tensors) -> tuple:
    """Device pointers of rows [b0, b1) of batch-major tensors (None stays None)."""
    return tuple(None if x is None else x[b0:b1].data_ptr() for x in tensors)


def _walk(lib, what: str, plan_for, dev, dirs: int, batch: int, t: int, h: int,
          forget_bias: float, pointers) -> None:
    """One call of a walk kernel: the C entry ``what`` once per launch of
    ``plan_for``'s plan, on the current stream.

    A launch takes the rows [b0, b1) of the batch (all of them up to
    ``MAX_CARRIES``) with the plan for its own rows, ``dirs`` zeroed barrier
    counters of its own, and the exchange scratch (``hbuf`` or the dh
    partials) that the launches share in stream order. ``pointers(b0, b1)``
    gives the entry's tensor arguments before the counters. A refused
    launch raises.
    """
    plan = plan_for(dev, h, dirs, batch)
    fwd = isinstance(plan, FwdPlan)
    starts = range(0, batch, plan.chunk_rows)
    plans = [plan if plan.chunks == 1
             else plan_for(dev, h, dirs, min(batch, b0 + plan.chunk_rows) - b0) for b0 in starts]
    sync = torch.zeros(plan.chunks * dirs, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(p.hbuf_floats if fwd else p.part_floats for p in plans),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, (b0, p) in enumerate(zip(starts, plans)):
            b1 = min(batch, b0 + plan.chunk_rows)
            layout = ((p.hbuf_floats, b1 - b0, t, h, p.units, int(p.resident) + int(p.split),
                       p.rows)
                      if fwd else (p.part_floats, b1 - b0, t, h, p.units, int(p.resident),
                                   int(p.split), p.cluster))
            code = getattr(lib, what)(*pointers(b0, b1), sync[i * dirs:].data_ptr(),
                                      scratch.data_ptr(), *layout, p.smem_bytes,
                                      float(forget_bias), stream)
            build.check(lib, code, what)


def _entry(name: str, sdt: torch.dtype) -> str:
    """The C entry of a kernel for the stream dtype: ``name`` or ``name_bf16``."""
    return name + ("_bf16" if sdt == torch.bfloat16 else "")


def _bwd_plan_for(sdt: torch.dtype):
    """``bwd_plan_for`` for the kernel of stream dtype ``sdt``."""
    return functools.partial(bwd_plan_for, bf16=sdt == torch.bfloat16)


def _count(fn, sdt: torch.dtype) -> None:
    """One launch on ``fn.launches`` (float32) or ``fn.launches_bf16``."""
    if sdt == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def lstm_bidi_fwd(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias: float = 1.0,
                  with_cs: bool = False):
    """Kernel #1: ``(ys_f, ys_b)``, and ``(cs_f, cs_b)`` after them when ``with_cs``.

    Launched with the plan ``fwd_plan_for`` gives this card; a launch whose
    blocks cannot all be resident raises. Calls are counted on
    ``lstm_bidi.launches`` (``launches_bf16`` for bf16 streams).
    """
    sdt = _check_inputs("lstm_bidi", xproj_f=xproj_f, xproj_b=xproj_b, wh_f=wh_f, wh_b=wh_b,
                        mask=mask)
    dev = _device_of("lstm_bidi", xproj_f)
    if dev.type == "cpu":
        out = lstm_bidi_fwd_plain(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias)
        return out if with_cs else out[:2]
    lib = build.load_library()
    b, t, g4 = xproj_f.shape
    h = g4 // 4
    ys_f = torch.empty((b, t, h), dtype=sdt, device=dev)
    ys_b = torch.empty_like(ys_f)
    cs_f = torch.empty_like(ys_f) if with_cs else None
    cs_b = torch.empty_like(ys_f) if with_cs else None
    _walk(lib, _entry("lstm_bidi_fwd", sdt), fwd_plan_for, dev, 2, b, t, h, forget_bias,
          lambda b0, b1: (*_rows(b0, b1, xproj_f, xproj_b), wh_f.data_ptr(), wh_b.data_ptr(),
                          *_rows(b0, b1, mask, ys_f, ys_b, cs_f, cs_b)))
    _count(lstm_bidi, sdt)
    return (ys_f, ys_b, cs_f, cs_b) if with_cs else (ys_f, ys_b)


def lstm_bidi_bwd(xproj_f, xproj_b, wh_f, wh_b, mask, ys_f, ys_b, cs_f, cs_b,
                  gys_f, gys_b, forget_bias: float = 1.0):
    """Kernel #2: ``(dxproj_f, dxproj_b)``; arguments as ``lstm_bidi_bwd_plain``.

    Launched with the plan ``bwd_plan_for`` gives this card; a launch whose
    blocks cannot all be resident raises. Calls are counted on
    ``lstm_bidi_bwd.launches`` (``launches_bf16`` for bf16 streams).
    """
    sdt = _check_inputs("lstm_bidi_bwd", xproj_f=xproj_f, xproj_b=xproj_b, wh_f=wh_f, wh_b=wh_b,
                  mask=mask, ys_f=ys_f, ys_b=ys_b, cs_f=cs_f, cs_b=cs_b, gys_f=gys_f,
                  gys_b=gys_b)
    args = (xproj_f, xproj_b, wh_f, wh_b, mask, ys_f, ys_b, cs_f, cs_b, gys_f, gys_b)
    dev = _device_of("lstm_bidi_bwd", xproj_f)
    if dev.type == "cpu":
        return lstm_bidi_bwd_plain(*args, forget_bias)
    lib = build.load_library()
    b, t, g4 = xproj_f.shape
    h = g4 // 4
    dx_f = torch.empty_like(xproj_f)
    dx_b = torch.empty_like(xproj_b)
    _walk(lib, _entry("lstm_bidi_bwd", sdt), _bwd_plan_for(sdt), dev, 2, b, t, h, forget_bias,
          lambda b0, b1: (*_rows(b0, b1, xproj_f, xproj_b), wh_f.data_ptr(), wh_b.data_ptr(),
                          *_rows(b0, b1, *args[4:], dx_f, dx_b)))
    _count(lstm_bidi_bwd, sdt)
    return dx_f, dx_b


lstm_bidi_bwd.launches = 0
lstm_bidi_bwd.launches_bf16 = 0


def _dwh(ys, dx):
    """dWh = sum_t h_{t-1}^T dgates_t: one float32 contraction over [T*B] of
    the shifted ``ys`` against ``dxproj``, as ``_bwd_call`` forms it (bf16
    streams: bf16 operands, float32 sums)."""
    h = ys.shape[-1]
    a, b = _shift_one(ys).reshape(-1, h).t(), dx.reshape(-1, 4 * h)
    return bf16_ops.mm_f32(a, b) if ys.dtype == torch.bfloat16 else torch.matmul(a, b)


def _cotangent(g, ys):
    """The cotangent of ``ys`` at the stream dtype (``gys_tm.astype(sdt)``),
    zeros when autograd passes none."""
    return torch.zeros_like(ys) if g is None else g.to(ys.dtype).contiguous()


class LSTMBidi(torch.autograd.Function):
    """``lstm_bidi`` with its gradient: kernel #1 forward, kernel #2 backward."""

    @staticmethod
    def forward(ctx, xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias):
        ys_f, ys_b, cs_f, cs_b = lstm_bidi_fwd(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias,
                                               with_cs=True)
        ctx.save_for_backward(xproj_f, xproj_b, wh_f, wh_b, mask, ys_f, ys_b, cs_f, cs_b)
        ctx.forget_bias = forget_bias
        return ys_f, ys_b

    @staticmethod
    def backward(ctx, gys_f, gys_b):
        xproj_f, xproj_b, wh_f, wh_b, mask, ys_f, ys_b, cs_f, cs_b = ctx.saved_tensors
        gys_f, gys_b = _cotangent(gys_f, ys_f), _cotangent(gys_b, ys_b)
        dx_f, dx_b = lstm_bidi_bwd(xproj_f, xproj_b, wh_f, wh_b, mask, ys_f, ys_b, cs_f, cs_b,
                                   gys_f, gys_b, ctx.forget_bias)
        return dx_f, dx_b, _dwh(ys_f, dx_f), _dwh(ys_b, dx_b), None, None


def lstm_bidi(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias: float = 1.0):
    """Both LSTM directions of one layer; see the module docstring.

    Goes through ``LSTMBidi`` when autograd may need a gradient; otherwise
    (serving, eval) runs the forward kernel alone, with no ``cs`` stream.
    """
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (xproj_f, xproj_b, wh_f, wh_b)
    ):
        return LSTMBidi.apply(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias)
    return lstm_bidi_fwd(xproj_f, xproj_b, wh_f, wh_b, mask, forget_bias)


lstm_bidi.launches = 0
lstm_bidi.launches_bf16 = 0


def _check_state(what, xproj, initial_state) -> None:
    """``initial_state`` is ``(h0, c0)``, each [B, H] float32, contiguous, on
    ``xproj``'s device."""
    b, _, g4 = xproj.shape
    if not isinstance(initial_state, (tuple, list)) or len(initial_state) != 2:
        raise ValueError(f"{what}: initial_state must be (h0, c0)")
    for name, x in zip(("h0", "c0"), initial_state):
        if x.device != xproj.device:
            raise ValueError(f"{what}: {name} is on {x.device}, xproj on {xproj.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32")
        if tuple(x.shape) != (b, g4 // 4):
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, "
                             f"expected {(b, g4 // 4)}")


def lstm_layer_fwd(xproj, wh, mask, forget_bias: float = 1.0, with_cs: bool = False,
                   initial_state=None, bf16_product: bool = False):
    """Kernel #3: ``ys``, or ``(ys, cs)`` when ``with_cs``.

    With ``initial_state`` ``(h0, c0)`` ([B, H] each; a streaming chunk's
    carried state) the walk starts from it (the ``lstm_layer_fwd_carry``
    entry) and the carried ``(hT, cT)`` after the last step comes last:
    ``(ys, (hT, cT))`` or ``(ys, cs, (hT, cT))``. A row masked at every step
    gets back ``h0`` and ``c0`` bit for bit. ``bf16_product`` (with
    ``initial_state`` and float32 streams) rounds each step's product
    operands to bf16 (``lstm_layer_fwd_carry_bf16``). Launched as
    ``lstm_bidi_fwd``. Calls are counted on ``lstm_layer.launches``
    (``launches_bf16`` for bf16 streams, which take no ``initial_state``;
    ``launches_bf16_product`` for the bf16-product walk).
    """
    sdt = _check_inputs("lstm_layer", xproj=xproj, wh=wh, mask=mask)
    if initial_state is not None:
        if sdt != torch.float32:
            raise NotImplementedError(
                "lstm_layer: a carried initial_state takes float32 streams; the reference's "
                "chunk takes rnn_scan's scan, which has no bf16 streams (at bf16 it rounds the "
                "h @ Wh operands: bf16_product=True)")
        _check_state("lstm_layer", xproj, initial_state)
    elif bf16_product:
        raise ValueError("lstm_layer: bf16_product is the carried walk's mode; pass "
                         "initial_state")
    dev = _device_of("lstm_layer", xproj)
    if dev.type == "cpu":
        ys, cs, *final = lstm_layer_fwd_plain(xproj, wh, mask, forget_bias, initial_state,
                                              bf16_product)
    else:
        lib = build.load_library()
        b, t, g4 = xproj.shape
        h = g4 // 4
        ys = torch.empty((b, t, h), dtype=sdt, device=dev)
        cs = torch.empty_like(ys) if with_cs else None
        if initial_state is None:
            final = []
            _walk(lib, _entry("lstm_layer_fwd", sdt), fwd_plan_for, dev, 1, b, t, h, forget_bias,
                  lambda b0, b1: (*_rows(b0, b1, xproj), wh.data_ptr(),
                                  *_rows(b0, b1, mask, ys, cs)))
        else:
            final = [tuple(torch.empty_like(x) for x in initial_state)]
            entry = "lstm_layer_fwd_carry" + ("_bf16" if bf16_product else "")
            _walk(lib, entry, fwd_plan_for, dev, 1, b, t, h, forget_bias,
                  lambda b0, b1: (*_rows(b0, b1, xproj), wh.data_ptr(),
                                  *_rows(b0, b1, mask, *initial_state, ys, cs, *final[0])))
        if bf16_product:
            lstm_layer.launches_bf16_product += 1
        else:
            _count(lstm_layer, sdt)
    out = ((ys, cs) if with_cs else (ys,)) + tuple(final)
    return out if len(out) > 1 else ys


def lstm_layer_bwd(xproj, wh, mask, ys, cs, gys, forget_bias: float = 1.0):
    """Kernel #4: ``dxproj`` [B, T, 4H]; arguments as ``lstm_layer_bwd_plain``.

    Launched as ``lstm_bidi_bwd``. Launches are counted on
    ``lstm_layer_bwd.launches`` (``launches_bf16`` for bf16 streams).
    """
    sdt = _check_inputs("lstm_layer_bwd", xproj=xproj, wh=wh, mask=mask, ys=ys, cs=cs, gys=gys)
    dev = _device_of("lstm_layer_bwd", xproj)
    if dev.type == "cpu":
        return lstm_layer_bwd_plain(xproj, wh, mask, ys, cs, gys, forget_bias)
    lib = build.load_library()
    b, t, g4 = xproj.shape
    h = g4 // 4
    dx = torch.empty_like(xproj)
    _walk(lib, _entry("lstm_layer_bwd", sdt), _bwd_plan_for(sdt), dev, 1, b, t, h, forget_bias,
          lambda b0, b1: (*_rows(b0, b1, xproj), wh.data_ptr(),
                          *_rows(b0, b1, mask, ys, cs, gys, dx)))
    _count(lstm_layer_bwd, sdt)
    return dx


lstm_layer_bwd.launches = 0
lstm_layer_bwd.launches_bf16 = 0


class LSTMLayer(torch.autograd.Function):
    """``lstm_layer`` with its gradient: kernel #3 forward, kernel #4 backward."""

    @staticmethod
    def forward(ctx, xproj, wh, mask, forget_bias):
        ys, cs = lstm_layer_fwd(xproj, wh, mask, forget_bias, with_cs=True)
        ctx.save_for_backward(xproj, wh, mask, ys, cs)
        ctx.forget_bias = forget_bias
        return ys

    @staticmethod
    def backward(ctx, gys):
        xproj, wh, mask, ys, cs = ctx.saved_tensors
        dx = lstm_layer_bwd(xproj, wh, mask, ys, cs, _cotangent(gys, ys), ctx.forget_bias)
        return dx, _dwh(ys, dx), None, None


def lstm_layer(xproj, wh, mask, forget_bias: float = 1.0, initial_state=None,
               bf16_product: bool = False):
    """One LSTM direction over hoisted projections; see the module docstring.

    Goes through ``LSTMLayer`` when autograd may need a gradient; otherwise
    (serving, eval) runs the forward kernel alone, with no ``cs`` stream.
    ``initial_state`` ``(h0, c0)`` (streaming) returns ``(ys, (hT, cT))`` and
    takes no gradient: it raises where one may be taken. ``bf16_product``:
    its steps' products on bf16 operands (``lstm_layer_fwd``).
    """
    grad = torch.is_grad_enabled() and (xproj.requires_grad or wh.requires_grad)
    if initial_state is not None or bf16_product:  # the carried walk (lstm_layer_fwd checks)
        if grad:
            raise NotImplementedError(
                "lstm_layer: a carried initial_state takes no gradient (streaming is "
                "inference only); run it under torch.no_grad()")
        return lstm_layer_fwd(xproj, wh, mask, forget_bias, initial_state=initial_state,
                              bf16_product=bf16_product)
    if grad:
        return LSTMLayer.apply(xproj, wh, mask, forget_bias)
    return lstm_layer_fwd(xproj, wh, mask, forget_bias)


lstm_layer.launches = 0
lstm_layer.launches_bf16 = 0
lstm_layer.launches_bf16_product = 0
