"""The data-parallel mesh: one process per rank over ``torch.distributed``.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/mesh.py``.
There a 1-D ``data`` mesh spans the devices of one program, batches are
sharded on their leading axis and jit inserts the gradient all-reduce.
Here each rank is a process that owns one device: it takes its rows of
every global batch (``shard_batch``), holds a replica of the training
state (``replicate``: a broadcast from rank 0) and the train step
(``train/ctc_task.guarded_train_step``) reduces loss and gradients with
explicit collectives, so one step over N ranks is the one-program step
over the global batch.

A placement spec is the dim a tensor is split on over the data axis, or
``None`` for replicated: ``batch_sharding`` gives 0 (the rows) and
``replicated`` gives None, the port's ``P("data")`` and ``P()``.

A mesh with no process group (``make_mesh()`` outside ``torchrun``, or
``LOCAL``) has one rank and runs no collective: the one-process train step
is the data-parallel step over ``LOCAL``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This rank's place on the 1-D data mesh. ``group`` is the process
    group of the ranks (None: no group, one rank, no collective)."""

    rank: int
    size: int
    device: torch.device | None
    group: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}

    @property
    def is_lead(self) -> bool:
        """Rank 0: the rank that writes logs, metrics and checkpoints."""
        return self.rank == 0


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
    The others stay within 32 bits: the CPU generator keeps only those."""
    return seed if rank == 0 else (seed + rank * 0x9E3779B1) % (1 << 32)


def make_mesh(num_devices: int | None = None, device=None) -> Mesh:
    """The mesh of the initialized default process group on this rank's
    device (``rank_device``). ``num_devices`` must equal the group's world
    size; with no group only one device is possible."""
    if dist.is_available() and dist.is_initialized():
        rank, size, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
        if num_devices is not None and num_devices != size:
            raise ValueError(f"num_devices {num_devices} does not match the process group's "
                             f"world size {size}")
    else:
        if (num_devices or 1) > 1:
            raise ValueError(f"num_devices {num_devices} needs {num_devices} ranks in an "
                             "initialized process group (launch with torchrun "
                             f"--nproc-per-node {num_devices}); none is initialized")
        rank, size, group = 0, 1, None
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(rank, size, dev, group)


def batch_sharding(mesh: Mesh) -> int:
    """The batch's placement: its leading axis split over the data axis."""
    return 0


def replicated(mesh: Mesh) -> None:
    """A replicated placement: every rank holds the whole tensor."""
    return None


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows (``multihost.process_slice``) of a host batch, as
    tensors on the rank's device; the host-side ``names`` are dropped."""
    from .multihost import process_slice

    rows = process_slice(batch, mesh.rank, mesh.size)
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


def all_reduce_flat(mesh: Mesh, tensors: list) -> list:
    """Each tensor summed over the ranks, in one collective on a flat
    float32 buffer (each comes back in its dtype and shape)."""
    if mesh.group is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


_STEP_MESHES: list = []  # the meshes of the train steps running in this process


@contextlib.contextmanager
def global_batch(mesh: Mesh):
    """Inside, ``batch_sum`` sums over ``mesh``'s ranks: the train step's
    forward runs in it, so a term that is not linear in the rows (the MoE
    load-balance loss) is taken over the global batch."""
    _STEP_MESHES.append(mesh)
    try:
        yield
    finally:
        _STEP_MESHES.pop()


def batch_sum(*tensors: torch.Tensor) -> tuple:
    """Per-rank totals that carry no gradient (counts) summed over the ranks
    of the train step running now (``global_batch``); as they are outside a
    step or on one rank."""
    mesh = _STEP_MESHES[-1] if _STEP_MESHES else LOCAL
    return tuple(all_reduce_flat(mesh, list(tensors)))


def setup_data_parallel(mesh: Mesh, params, opt_state, batch=None):
    """Place training state for DP under ``mesh``: params and optimizer state
    replicated (broadcast from rank 0), the batch's rows split by rank.
    The train step built with ``mesh=`` then reduces loss and gradients over
    the ranks."""
    params = replicate(mesh, params)
    opt_state = replicate(mesh, opt_state)
    if batch is not None:
        batch = shard_batch(mesh, batch)
    return params, opt_state, batch
