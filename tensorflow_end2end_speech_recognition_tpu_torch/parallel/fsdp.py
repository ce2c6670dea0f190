"""Fully-sharded data parallelism (ZeRO-3) over the ``data`` mesh axis.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/fsdp.py``.
Each rank keeps 1/N of every parameter and of its optimizer moments at
rest: a leaf is split on its LARGEST axis divisible by N into N contiguous
blocks, block r on the ranks of data index r (the JAX ``NamedSharding`` of
the same spec); a leaf with no such axis stays whole. The JAX package
states only the placement and lets XLA insert the collectives; here the
train step (``train/ctc_task.guarded_train_step`` with ``specs``) runs
them itself, per step:

1. ``gather_params``: one all-gather over ``data`` rebuilds every leaf's
   data-split dim before the forward;
2. ``reduce_scatter_grads``: after the backward, one reduce-scatter over
   ``data`` sums the ranks' weighted gradients and leaves each rank its
   block (the other leaves' gradients and the loss ride all-reduces);
3. the optimizer updates the blocks; the global-norm clip sums each leaf's
   squares over the axes that split it (``train/optimizer.global_norm``).

``base=`` composes ZeRO-3 with the placements of tensor and expert
parallelism (``tp.param_partition_specs``, ``ep.expert_partition_specs``):
``data`` fills the largest axis of the leaf's whole shape that the base
leaves free, so a column-parallel ``[d, 4d]`` at ``(None, "model")``
becomes ``("data", "model")``; axes the base names are left alone, and a
leaf with no free divisible axis keeps its base spec. Sequence parallelism
replicates its weights: its base is None.

The state stays sharded between steps. Checkpoints gather it whole
(``gather_whole``, which also unstacks pipeline stages' layers), and a
restore re-shards it (``shard_tree``), so a checkpoint keeps the one-device
layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (
    DATA_AXIS,
    PIPE_AXIS,
    Mesh,
    count_traffic,
    local_block,
    replicate,
    shard_batch,
)


def fsdp_spec_for(leaf, num_shards: int, axis_name: str = DATA_AXIS, base=None) -> tuple:
    """The leaf's spec (``parallel/mesh.py``): ``axis_name`` on the largest
    dim divisible by ``num_shards`` that ``base`` leaves free (the first of
    equal ones), else ``base`` as it is (``()``: replicated), as the JAX
    rule picks it."""
    shape = tuple(np.shape(leaf))
    entries = list(base) if base is not None else []
    entries += [None] * (len(shape) - len(entries))
    best, best_size = -1, 0
    for i, s in enumerate(shape):
        if entries[i] is None and s % num_shards == 0 and s >= num_shards and s > best_size:
            best, best_size = i, s
    if best < 0:
        return tuple(base) if base is not None else ()
    entries[best] = axis_name
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def fsdp_partition_specs(params: dict, num_shards: int, base_specs: dict | None = None) -> dict:
    """``{name: spec}`` for every leaf of ``params``; with ``base_specs``
    (another axis's specs of the same leaves) ``data`` composes into each."""
    return {k: fsdp_spec_for(v, num_shards, base=None if base_specs is None else base_specs[k])
            for k, v in params.items()}


def _is_param_dict(tree, specs: dict) -> bool:
    return isinstance(tree, dict) and set(tree) == set(specs)


def shard_tree(mesh: Mesh, tree, specs: dict):
    """Every dict keyed like the parameters (the parameters, the optimizer's
    moments) cut to this rank's blocks; other tensors kept whole."""
    if _is_param_dict(tree, specs):
        return {k: local_block(v, specs[k], mesh) for k, v in tree.items()}
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


def spec_dim(spec, axis: str) -> int | None:
    """The dim that ``spec`` splits over ``axis``, or None."""
    spec = tuple(spec or ())
    return spec.index(axis) if axis in spec else None


def gather_axis(mesh: Mesh, shards: dict, specs: dict, axis: str = DATA_AXIS) -> dict:
    """Every leaf's ``axis``-split dim rebuilt from the blocks of the ranks
    along ``axis``, in one all-gather of a flat float32 buffer (the other
    leaves pass through)."""
    line = mesh.along(axis)
    split = [k for k in shards if spec_dim(specs[k], axis) is not None]
    if line.group is None or not split:
        return dict(shards)
    n = line.size
    local = torch.cat([shards[k].detach().reshape(-1).to(torch.float32) for k in split])
    out = torch.empty(n * local.numel(), dtype=torch.float32, device=local.device)
    count_traffic("all_gather", local)
    dist.all_gather_into_tensor(out, local, group=line.group)
    rows = out.view(n, -1)
    full, at = dict(shards), 0
    for k in split:
        s, dim = shards[k], spec_dim(specs[k], axis)
        shape = list(s.shape)
        shape[dim] *= n
        full[k] = _from_blocks(rows[:, at:at + s.numel()], tuple(shape), dim, n).to(s.dtype)
        at += s.numel()
    return full


def gather_params(mesh: Mesh, shards: dict, specs: dict) -> dict:
    """The leaves with their ``data``-split dims rebuilt (``gather_axis``):
    the weights the forward of a ZeRO-3 step runs on."""
    return gather_axis(mesh, shards, specs, DATA_AXIS)


def gather_whole(mesh: Mesh, tree, specs: dict | None):
    """Every parameter-keyed dict of ``tree`` with each leaf whole, gathered
    over every axis that splits it, and pipeline stages' stacked layer
    leaves unstacked (``pp.pp_unstack_tree``): the one-device layout that
    eval and checkpoints read."""
    if specs is None:
        return tree
    if _is_param_dict(tree, specs):
        for axis, _ in mesh.axis_sizes:
            tree = gather_axis(mesh, tree, specs, axis)
        if any(PIPE_AXIS in spec for spec in specs.values()):
            from .pp import pp_unstack_tree

            tree = pp_unstack_tree(tree)
        return tree
    if isinstance(tree, dict):
        return {k: gather_whole(mesh, v, specs) for k, v in tree.items()}
    return tree


def reduce_scatter_grads(mesh: Mesh, grads: dict, specs: dict) -> dict:
    """The ``data``-split leaves' gradients summed over the data line; each
    rank keeps its block, in one reduce-scatter. Other leaves are not
    touched here: they ride the step's all-reduces."""
    line = mesh.along(DATA_AXIS)
    split = [k for k in grads if spec_dim(specs[k], DATA_AXIS) is not None]
    if line.group is None or not split:
        return dict(grads)
    n = line.size
    rows = torch.cat([_to_blocks(grads[k].to(torch.float32), spec_dim(specs[k], DATA_AXIS), n)
                      for k in split], dim=1).contiguous()
    out = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    count_traffic("reduce_scatter", rows)
    dist.reduce_scatter_tensor(out, rows.view(-1), group=line.group)
    res, at = dict(grads), 0
    for k in split:
        g = grads[k]
        block = g.tensor_split(n, spec_dim(specs[k], DATA_AXIS))[0].shape
        res[k] = out[at:at + block.numel()].view(block).to(g.dtype)
        at += block.numel()
    return res


def place(mesh: Mesh, params: dict, opt_state, specs: dict | None, batch=None):
    """Whole params and optimizer state (as ``init`` or a checkpoint gives
    them) broadcast from rank 0 and cut to this rank's blocks per ``specs``
    (moments follow their parameter; a step count stays whole); the batch's
    rows split by data index."""
    params = replicate(mesh, params)
    if specs is not None:
        params = shard_tree(mesh, params, specs)
    if opt_state is not None:
        opt_state = replicate(mesh, opt_state)
        if specs is not None:
            opt_state = shard_tree(mesh, opt_state, specs)
    if batch is not None:
        batch = shard_batch(mesh, batch)
    return params, opt_state, batch


def setup_fsdp(mesh: Mesh, params: dict, opt_state=None, batch=None, base_specs=None):
    """Place training state fully sharded over the mesh's ``data`` axis
    (``fsdp_partition_specs`` at the data degree, composed with
    ``base_specs``; ``place``). Build the train step with the same specs
    (``make_train_step(..., mesh=mesh, specs=fsdp_partition_specs(params,
    mesh.shape["data"], base_specs))``)."""
    specs = fsdp_partition_specs(params, mesh.shape[DATA_AXIS], base_specs)
    return place(mesh, params, opt_state, specs, batch)
