"""The mesh: one process per rank over ``torch.distributed``, with named axes.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/mesh.py``
and of the mesh builders of its ``tp``, ``sp`` and ``ep`` modules. There a
mesh spans the devices of one program, weights and batches are placed with
``NamedSharding`` and jit inserts the collectives. Here each rank is a
process that owns one device: it takes its rows of every global batch
(``shard_batch``), holds its blocks of the training state and the train
step (``train/ctc_task.guarded_train_step``) runs the collectives itself,
so one step over the ranks is the one-program step over the global batch.

A mesh has named axes, major to minor, whose sizes multiply to the world
size: ``data`` alone (data parallelism), ``(data, model)``, ``(data, seq,
model)``, ``(data, seq)``, ``(data, expert)``, ``(data, pipe)`` or ``(data,
pipe, model)``. Rank r sits where JAX puts
device r: the minor axis varies fastest, so rank = ((d·S) + s)·M + m on a
``(data, seq, model)`` mesh, and block r of a sharded leaf lives on rank r
as it lives on device r. ``along(axes)`` is the 1-D mesh of this rank's
line along some axes: its ``group`` is the ``torch.distributed`` subgroup
of the ranks that differ from this one only there (every rank creates every
subgroup, in one order, when the mesh is built).

A placement spec is a tuple with one entry per leading dim, the axis that
splits that dim or None, as ``tuple(PartitionSpec)`` of the JAX spec:
``()`` is replicated, ``("data",)`` the batch's rows, ``(None, "model")`` a
column-parallel weight, ``("data", "model")`` one that ZeRO-3 also splits.
Dim i of a leaf split over an axis of n ranks is cut into n contiguous
blocks, block k on the ranks whose index on that axis is k
(``local_block``).

Along ``pipe`` a stage hands its activations to the next one
(``send_stage`` / ``recv_stage``; the backward's hop is their transpose,
the same calls toward the previous stage): over ``nccl`` as a point-to-point
send, over ``gloo``, whose send takes no card tensor, as a broadcast on the
two-rank group of the pair of stages (``Mesh.pipe_pairs``).

A mesh with no process group (``make_mesh()`` outside ``torchrun``, or
``LOCAL``) has one rank and runs no collective: the one-process train step
is the data-parallel step over ``LOCAL``.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
BATCH_AXES = (DATA_AXIS, SEQ_AXIS)  # the axes whose ranks hold different rows or frames


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the mesh. ``group`` is the process group of all
    its ranks (None: no group, one rank, no collective); ``axes`` the named
    axes ``((name, size), ...)`` major to minor (empty: one ``data`` axis of
    ``size``); ``subgroups`` ``((axis names, group), ...)`` this rank's
    group along each proper subset of the axes of more than one rank;
    ``pipe_pairs`` ``((lower rank, upper rank, group), ...)`` the two-rank
    groups of this rank and its neighbour stages along ``pipe``."""

    rank: int
    size: int
    device: torch.device | None
    group: object = None
    axes: tuple = ()
    subgroups: tuple = ()
    pipe_pairs: tuple = ()

    @property
    def axis_sizes(self) -> tuple:
        return self.axes or ((DATA_AXIS, self.size),)

    @property
    def shape(self) -> dict:
        return dict(self.axis_sizes)

    @property
    def is_lead(self) -> bool:
        """Rank 0: the rank that writes logs, metrics and checkpoints."""
        return self.rank == 0

    def coords(self) -> dict:
        """This rank's index on every axis."""
        out, rest = {}, self.rank
        for name, n in reversed(self.axis_sizes):
            out[name] = rest % n
            rest //= n
        return out

    def coord(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 on an axis the mesh does not have)."""
        return self.coords().get(axis, 0)

    def degree(self, *axes: str) -> int:
        """How many ranks the axes span together (1 for axes the mesh lacks)."""
        shape = self.shape
        return math.prod(shape.get(a, 1) for a in axes)

    def split_axes(self, axes) -> tuple:
        """The axes of ``axes`` with more than one rank, in mesh order."""
        axes = set(axes)
        return tuple(a for a, n in self.axis_sizes if a in axes and n > 1)

    def along(self, *axes: str) -> "Mesh":
        """The 1-D mesh of this rank's line along ``axes``: its rank is this
        rank's index there (the first axis major), its size the line's
        length, its group the line's subgroup (None for one rank)."""
        live = self.split_axes(axes)
        if not live:
            return Mesh(0, 1, self.device)
        coords, shape = self.coords(), self.shape
        idx = 0
        for a in live:
            idx = idx * shape[a] + coords[a]
        size = math.prod(shape[a] for a in live)
        if live == self.split_axes(shape):
            group = self.group
        else:
            group = dict(self.subgroups)[live]
        return Mesh(idx, size, self.device, group)


LOCAL = Mesh(0, 1, None)  # one process, no group: the one-process train step's mesh


def local_rank(rank: int) -> int:
    """``LOCAL_RANK`` as ``torchrun`` sets it, else the rank modulo the cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def rank_device(device=None, rank: int = 0) -> torch.device:
    """This rank's device: the card ``cuda:LOCAL_RANK`` unless ``device``
    names another (``"cpu"``, or a card by its index)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank(rank))
    return dev


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of rank ``rank`` from ``seed``: rank 0 keeps
    ``seed`` (a one-process run's stream), the others draw streams of their
    own, so no two ranks repeat each other's dropout or SpecAugment masks.
    The others stay within 32 bits: the CPU generator keeps only those.
    ``fit`` seeds by the data index: the ranks of one data line (model,
    sequence or expert shards of the same rows) draw the same masks."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B1) % (1 << 32)


def _world(total: int) -> tuple:
    """(rank, size, group) of the initialized default group, which must hold
    ``total`` ranks; (0, 1, None) for one rank without a group."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        if total != size:
            raise ValueError(f"num_devices {total} does not match the process group's "
                             f"world size {size}")
        return rank, size, dist.group.WORLD
    if total > 1:
        raise ValueError(f"num_devices {total} needs {total} ranks in an initialized process "
                         f"group (launch with torchrun --nproc-per-node {total}); none is "
                         "initialized")
    return 0, 1, None


def _lines(axes: tuple, sub: tuple) -> list:
    """The rank lists of every line along the axes ``sub`` of a mesh with
    ``axes``: the ranks that agree on every other axis."""
    names = [a for a, _ in axes]
    grid = np.arange(math.prod(n for _, n in axes)).reshape([n for _, n in axes])
    keep = [names.index(a) for a in sub]
    rest = [i for i in range(len(names)) if i not in keep]
    lines = grid.transpose(rest + keep).reshape(-1, math.prod(grid.shape[i] for i in keep))
    return [[int(r) for r in line] for line in lines]


def make_grid(axes: dict, device=None) -> Mesh:
    """The mesh with named ``axes`` (``{name: size}``, major to minor) over
    the initialized default process group, whose world size must be their
    product, on this rank's device (``rank_device``). Every rank creates
    the subgroup of every line along every proper subset of the axes of
    more than one rank, then the group of every pair of neighbour stages
    along ``pipe``, in the same order (``dist.new_group`` is collective)."""
    axes = tuple((name, int(n)) for name, n in axes.items())
    total = math.prod(n for _, n in axes)
    rank, size, group = _world(total)
    subgroups, pairs = [], []
    if group is not None:
        live = [a for a, n in axes if n > 1]
        for k in range(1, len(live)):
            for sub in itertools.combinations(live, k):
                mine = None
                for ranks in _lines(axes, sub):
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        mine = g
                subgroups.append((sub, mine))
        if PIPE_AXIS in live:
            for line in _lines(axes, (PIPE_AXIS,)):
                for lo, hi in zip(line, line[1:]):
                    g = dist.new_group([lo, hi])
                    if rank in (lo, hi):
                        pairs.append((lo, hi, g))
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank, size, dev, group, axes, tuple(subgroups), tuple(pairs))


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """The 1-D data mesh of the initialized default process group on this
    rank's device (``rank_device``). ``num_devices`` must equal the group's
    world size; with no group only one device is possible."""
    if dist.is_available() and dist.is_initialized() and num_devices is None:
        num_devices = dist.get_world_size()
    return make_grid({DATA_AXIS: num_devices or 1}, device)


def batch_sharding(mesh: Mesh) -> tuple:
    """The batch's placement: its leading axis split over the data axis."""
    return (DATA_AXIS,)


def replicated(mesh: Mesh) -> tuple:
    """A replicated placement: every rank holds the whole tensor."""
    return ()


def local_block(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` placed by ``spec``."""
    coords, shape = mesh.coords(), mesh.shape
    for dim, axis in enumerate(spec or ()):
        if axis is not None and shape.get(axis, 1) > 1:
            x = x.tensor_split(shape[axis], dim)[coords[axis]]
    return x.contiguous()


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows (``multihost.process_slice`` at its data index: the
    ranks of one data line take the same rows) of a host batch, as tensors
    on the rank's device; the host-side ``names`` are dropped."""
    from .multihost import process_slice

    return to_device(mesh, process_slice(batch, mesh.coord(DATA_AXIS), mesh.degree(DATA_AXIS)))


def to_device(mesh: Mesh, rows: dict) -> dict:
    """Host rows as tensors on the rank's device, the host-side ``names`` dropped."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            .to(mesh.device) for k, v in rows.items() if k != "names"}


def replicate(mesh: Mesh, tree):
    """Every tensor of nested dicts on the rank's device, broadcast from rank
    0, so all ranks start bit-identical; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    x = tree.detach().to(mesh.device).contiguous()
    if mesh.group is not None:
        x = x.clone()
        dist.broadcast(x, dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return x


TRAFFIC: dict = {}  # collective -> [calls, bytes this rank put in], since reset_traffic()


def count_traffic(kind: str, t: torch.Tensor) -> None:
    """Count one collective of ``kind`` on the buffer ``t`` this rank puts in."""
    calls = TRAFFIC.setdefault(kind, [0, 0])
    calls[0] += 1
    calls[1] += t.numel() * t.element_size()


def reset_traffic() -> None:
    TRAFFIC.clear()


def all_reduce_flat(mesh: Mesh, tensors: list, dtype: torch.dtype = torch.float32) -> list:
    """Each tensor summed over the ranks of ``mesh.group``, in one collective
    on a flat buffer of ``dtype`` (float32; float64 for the clip's norm;
    each comes back in its dtype and shape)."""
    if mesh.group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    count_traffic("all_reduce", flat)
    dist.all_reduce(flat, group=mesh.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _stage_peer(mesh: Mesh, step: int) -> tuple:
    """(global rank, pair group) of the stage ``step`` (+1 or -1) away along
    ``pipe`` (the rank with this rank's other coordinates)."""
    stride = 1
    for name, n in reversed(mesh.axis_sizes):
        if name == PIPE_AXIS:
            break
        stride *= n
    peer = mesh.rank + step * stride
    lo, hi = sorted((mesh.rank, peer))
    group = next(g for a, b, g in mesh.pipe_pairs if (a, b) == (lo, hi))
    return peer, group


def send_stage(mesh: Mesh, x: torch.Tensor, step: int) -> None:
    """Hand ``x`` to the stage ``step`` (+1: the next, -1: the previous) away
    along ``pipe``; it takes it with ``recv_stage(mesh, ..., -step)``."""
    peer, group = _stage_peer(mesh, step)
    x = x.detach().contiguous()
    count_traffic("pipe_hop", x)
    if dist.get_backend(mesh.group) == "nccl":
        dist.send(x, peer)
    else:
        dist.broadcast(x, mesh.rank, group=group)


def recv_stage(mesh: Mesh, shape, dtype, step: int) -> torch.Tensor:
    """The tensor that the stage ``step`` away along ``pipe`` hands to this
    one (``send_stage(mesh, x, -step)`` there)."""
    peer, group = _stage_peer(mesh, step)
    x = torch.empty(shape, dtype=dtype, device=mesh.device)
    if dist.get_backend(mesh.group) == "nccl":
        dist.recv(x, peer)
    else:
        dist.broadcast(x, peer, group=group)
    return x


_STEPS: list = []  # (mesh, specs) of the train steps running in this process


@contextlib.contextmanager
def global_batch(mesh: Mesh, specs: dict | None = None):
    """Inside, the model sees the train step's mesh and placement
    (``step_placement``): ``batch_sum`` sums over the ranks that hold other
    rows or frames, so a term that is not linear in the rows (the MoE
    load-balance loss) is taken over the global batch, and the conformer
    runs its model, sequence and expert shards."""
    _STEPS.append((mesh, specs))
    try:
        yield
    finally:
        _STEPS.pop()


def step_placement() -> tuple:
    """(mesh, specs) of the train step running now; (``LOCAL``, None) outside one."""
    return _STEPS[-1] if _STEPS else (LOCAL, None)


def batch_sum(*tensors: torch.Tensor) -> tuple:
    """Per-rank totals that carry no gradient (counts) summed over the ranks
    of the running train step that hold other rows or frames (``data`` x
    ``seq``; ``global_batch``); as they are outside a step or on one rank."""
    mesh, _ = step_placement()
    return tuple(all_reduce_flat(mesh.along(*BATCH_AXES), list(tensors)))


def setup_data_parallel(mesh: Mesh, params, opt_state, batch=None):
    """Place training state for DP under ``mesh``: params and optimizer state
    replicated (broadcast from rank 0), the batch's rows split by data
    index. The train step built with ``mesh=`` then reduces loss and
    gradients over the ranks."""
    params = replicate(mesh, params)
    opt_state = replicate(mesh, opt_state)
    if batch is not None:
        batch = shard_batch(mesh, batch)
    return params, opt_state, batch
