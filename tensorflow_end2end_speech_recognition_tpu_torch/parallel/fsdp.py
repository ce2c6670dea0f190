"""Fully-sharded data parallelism (ZeRO-3) over the ``data`` mesh axis.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/fsdp.py``.
Each rank keeps 1/N of every parameter and of its optimizer moments at
rest: a leaf is split on its LARGEST axis divisible by N into N contiguous
blocks, block r on rank r (the JAX ``NamedSharding`` of the same spec);
a leaf with no such axis stays whole on every rank. The JAX package
states only the placement and lets XLA insert the collectives; here the
train step (``train/ctc_task.guarded_train_step`` with ``specs``) runs
them itself, per step:

1. ``gather_params``: one all-gather rebuilds every whole leaf before the
   forward;
2. ``reduce_scatter_grads``: after the backward, one reduce-scatter sums
   the ranks' weighted gradients and leaves rank r its block (the whole
   leaves' gradients and the loss ride one all-reduce);
3. the optimizer updates the blocks; the global-norm clip sums the blocks'
   squares over the ranks and counts a whole leaf once
   (``train/optimizer.global_norm``).

The state stays sharded between steps. Checkpoints gather it
(``gather_tree``), and a restore re-shards it (``setup_fsdp``), so a
checkpoint keeps the one-device layout.

Composition with tp / ep (``base=``) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh, replicate, shard_batch


def _no_base(base) -> None:
    if base is not None:
        raise NotImplementedError("fsdp composed with tensor or expert parallelism (base specs) "
                                  "is not ported yet")


def fsdp_spec_for(leaf, num_shards: int, base=None) -> int | None:
    """The dim to shard: the largest divisible by ``num_shards`` (the first
    of equal ones), else None (replicated), as the JAX rule picks it."""
    _no_base(base)
    best, best_size = None, 0
    for i, s in enumerate(tuple(np.shape(leaf))):
        if s % num_shards == 0 and s >= num_shards and s > best_size:
            best, best_size = i, s
    return best


def fsdp_partition_specs(params: dict, num_shards: int, base_specs=None) -> dict:
    """``{name: dim or None}`` for every leaf of ``params``."""
    _no_base(base_specs)
    return {k: fsdp_spec_for(v, num_shards) for k, v in params.items()}


def _is_param_dict(tree, specs: dict) -> bool:
    return isinstance(tree, dict) and set(tree) == set(specs)


def shard_tree(mesh: Mesh, tree, specs: dict):
    """Every dict keyed like the parameters (the parameters, the optimizer's
    moments) cut to this rank's blocks; other tensors kept whole."""
    if _is_param_dict(tree, specs):
        return {k: v if specs[k] is None
                else v.tensor_split(mesh.size, specs[k])[mesh.rank].contiguous()
                for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: shard_tree(mesh, v, specs) for k, v in tree.items()}
    return tree


def _to_blocks(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` as [n, numel / n]: row r is block r of dim ``dim``."""
    shape = x.shape
    x = x.reshape(shape[:dim] + (n, shape[dim] // n) + shape[dim + 1:])
    return x.movedim(dim, 0).reshape(n, -1)


def _from_blocks(rows: torch.Tensor, shape, dim: int, n: int) -> torch.Tensor:
    """Inverse of ``_to_blocks``."""
    block = tuple(shape[:dim]) + (shape[dim] // n,) + tuple(shape[dim + 1:])
    return rows.reshape((n,) + block).movedim(0, dim).reshape(shape)


def full_shape(shard: torch.Tensor, dim: int | None, n: int) -> tuple:
    shape = list(shard.shape)
    if dim is not None:
        shape[dim] *= n
    return tuple(shape)


def gather_params(mesh: Mesh, shards: dict, specs: dict) -> dict:
    """Every whole leaf from the ranks' blocks, in one all-gather of a flat
    float32 buffer (whole leaves pass through)."""
    sharded = [k for k in shards if specs[k] is not None]
    if mesh.group is None or not sharded:
        return dict(shards)
    n = mesh.size
    local = torch.cat([shards[k].detach().reshape(-1).to(torch.float32) for k in sharded])
    out = torch.empty(n * local.numel(), dtype=torch.float32, device=local.device)
    dist.all_gather_into_tensor(out, local, group=mesh.group)
    rows = out.view(n, -1)
    full, at = dict(shards), 0
    for k in sharded:
        s = shards[k]
        full[k] = _from_blocks(rows[:, at:at + s.numel()], full_shape(s, specs[k], n),
                               specs[k], n).to(s.dtype)
        at += s.numel()
    return full


def reduce_scatter_grads(mesh: Mesh, grads: dict, specs: dict) -> dict:
    """Whole gradients summed over the ranks; rank r keeps block r of each
    sharded leaf, in one reduce-scatter. Whole leaves are not touched here:
    they ride the step's all-reduce."""
    sharded = [k for k in grads if specs[k] is not None]
    if mesh.group is None or not sharded:
        return dict(grads)
    n = mesh.size
    rows = torch.cat([_to_blocks(grads[k].to(torch.float32), specs[k], n) for k in sharded],
                     dim=1).contiguous()
    out = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    dist.reduce_scatter_tensor(out, rows.view(-1), group=mesh.group)
    res, at = dict(grads), 0
    for k in sharded:
        g = grads[k]
        block = g.tensor_split(n, specs[k])[0].shape
        res[k] = out[at:at + block.numel()].view(block).to(g.dtype)
        at += block.numel()
    return res


def gather_tree(mesh: Mesh, tree, specs: dict):
    """``shard_tree``'s inverse: every parameter-keyed dict gathered whole."""
    if _is_param_dict(tree, specs):
        return gather_params(mesh, tree, specs)
    if isinstance(tree, dict):
        return {k: gather_tree(mesh, v, specs) for k, v in tree.items()}
    return tree


def setup_fsdp(mesh: Mesh, params: dict, opt_state=None, batch=None, base_specs=None):
    """Place training state fully sharded over the mesh's ``data`` axis.

    Whole params and optimizer state (as ``init`` or a checkpoint gives
    them) are broadcast from rank 0 and cut per ``fsdp_partition_specs``
    (moments follow their parameter; a step count stays whole); the batch's
    rows split as under plain DP. Build the train step with the same specs
    (``make_train_step(..., mesh=mesh, specs=fsdp_partition_specs(params,
    mesh.size))``)."""
    _no_base(base_specs)
    specs = fsdp_partition_specs(params, mesh.shape[DATA_AXIS])
    params = shard_tree(mesh, replicate(mesh, params), specs)
    if opt_state is not None:
        opt_state = shard_tree(mesh, replicate(mesh, opt_state), specs)
    if batch is not None:
        batch = shard_batch(mesh, batch)
    return params, opt_state, batch
