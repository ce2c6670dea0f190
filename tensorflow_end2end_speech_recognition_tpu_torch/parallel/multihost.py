"""Per-rank rows of every batch, and counts summed across ranks.

Counterpart of
``tensorflow_end2end_speech_recognition_tpu/parallel/multihost.py``, whose
design holds here with a process per rank instead of one per host:

- every rank builds the IDENTICAL batch schedule: ``Dataset.batches`` is a
  pure function of (utterances, seed, epoch), so the ranks need no
  coordination to stay in lockstep;
- each rank takes only its OWN rows of every global batch, rows
  ``[r·B/N, (r+1)·B/N)`` for rank r of N (``process_slice``), and moves
  them to its device (``distribute_batch``);
- eval scores each rank's rows on the host and sums the small count
  vectors (``allreduce_counts``), so the rates equal one process scoring
  the whole set.

``global_device_batch`` lifts process-local rows into one global
``jax.Array`` for a program that spans processes. Here one process owns
one device and its rows are already its whole input: it only places them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _rank_and_size() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_slice(batch: dict, process_index: int | None = None,
                  process_count: int | None = None) -> dict:
    """This rank's rows of a global host batch (the default group's rank and
    size unless given).

    ``batch`` maps names to arrays with a common leading (batch) axis; the
    host-side ``names`` list is sliced the same way, which keeps eval
    bookkeeping per rank. The global batch must divide evenly: ``Dataset``
    always emits full-size batches (a short final batch is padded with fill
    rows, which have ``names`` None), so this only rejects a misconfigured
    batch size."""
    p, n = _rank_and_size()
    p = p if process_index is None else process_index
    n = n if process_count is None else process_count
    if n == 1:
        return batch
    sizes = {len(v) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent leading axis across batch entries: {sizes}")
    (b,) = sizes
    if b % n:
        raise ValueError(f"global batch size {b} not divisible by {n} processes")
    k = b // n
    return {key: v[p * k : (p + 1) * k] for key, v in batch.items()}


def distribute_batch(mesh, batch: dict) -> dict:
    """``process_slice`` and placement on the rank's device in one call (the
    ``fit`` hook; ``mesh.shard_batch``)."""
    from .mesh import shard_batch

    return shard_batch(mesh, batch)


def global_device_batch(mesh, local_batch: dict) -> dict:
    """This rank's rows (``process_slice``'s) as tensors on its device: the
    rank's whole input, since each process owns one device (JAX's
    ``process_count`` has nothing to count here)."""
    from .mesh import to_device

    return to_device(mesh, local_batch)


def local_replica(tree: dict, mesh=None, specs: dict | None = None) -> dict:
    """The whole parameters on this rank: under DP the replica it holds,
    with ``specs`` that split a leaf (ZeRO-3, model or expert shards,
    pipeline stages) gathered from the ranks' blocks, stacked layers
    unstacked (``fsdp.gather_whole``): the one-device layout. Eval and
    checkpoints read this."""
    if mesh is None or specs is None or not any(specs.values()):
        return tree
    from .fsdp import gather_whole

    return gather_whole(mesh, tree, specs)


def allreduce_counts(counts, mesh=None) -> np.ndarray:
    """A small numpy count vector summed over the ranks of ``mesh.group``
    (float64; ``mesh.along("data")`` for the ranks that hold other rows);
    one rank returns it as it is."""
    counts = np.asarray(counts)
    if mesh is None or mesh.group is None:
        return counts
    t = torch.as_tensor(counts, dtype=torch.float64).to(mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return t.cpu().numpy()
