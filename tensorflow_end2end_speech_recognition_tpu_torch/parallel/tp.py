"""Tensor (model) parallelism: Megatron column -> row pairs over ``model``.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/tp.py``.
The JAX package places the conformer / transformer block weights with
``NamedSharding``s and lets XLA's partitioner find the column -> row
pairing and insert one all-reduce per block output. The port has no
partitioner: the same placement (``param_partition_specs``, by the rules of
``_spec_for``) cuts each rank's blocks, and ``models/conformer.py`` runs the
pairs with Megatron's two collectives written out as autograd functions:

- ``copy_to`` (*f*): identity forward, all-reduce of the gradient backward,
  in front of each column-parallel product (``q`` / ``k`` / ``v``, the FF's
  ``in``), whose input every model rank holds whole;
- ``reduce_from`` (*g*): all-reduce forward, identity backward, after each
  row-parallel product (``o``, the FF's ``out``), before its replicated
  bias.

MHSA runs its h/M heads and each FF its ff/M columns. Every replicated
leaf gets its whole gradient on each model rank: LayerNorms, the conv
module, the CTC head and MoE banks are computed whole on each, and the
replicated leaves that a rank slices to its own heads (``pos.w``,
``pos_u``, ``pos_v`` under ``pos_encoding: relative``) pass *f* before the
slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, count_traffic, make_grid

_COLUMN_PARALLEL = {"q", "k", "v", "in"}
_ROW_PARALLEL = {"o", "out"}


def make_mesh_2d(num_data: int, num_model: int, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the process group's ``num_data x
    num_model`` ranks, ``model`` minor."""
    return make_grid({DATA_AXIS: num_data, MODEL_AXIS: num_model}, device)


def make_mesh_3d(num_data: int, num_seq: int, num_model: int, device=None) -> Mesh:
    """A ``(data, seq, model)`` mesh: tensor and sequence parallelism with
    data parallelism, ``model`` minor and ``seq`` between."""
    return make_grid({DATA_AXIS: num_data, SEQ_AXIS: num_seq, MODEL_AXIS: num_model}, device)


def _spec_for(path_keys: list, leaf) -> tuple:
    """One leaf's spec by its ``state_dict`` path: only conformer subtrees
    split; their conv modules and MoE banks stay replicated; ``q`` / ``k`` /
    ``v`` / ``in`` split their columns (``w`` dim 1, ``b`` dim 0); ``o`` /
    ``out`` their rows (``w`` dim 0; the bias is added after the reduce)."""
    ndim = len(leaf.shape)
    if "conformer" not in path_keys or "conv" in path_keys or "moe" in path_keys:
        return ()
    name = path_keys[-1]
    parent = path_keys[-2] if len(path_keys) >= 2 else ""
    if parent in _COLUMN_PARALLEL:
        if name == "w" and ndim == 2:
            return (None, MODEL_AXIS)
        if name == "b" and ndim == 1:
            return (MODEL_AXIS,)
    if parent in _ROW_PARALLEL and name == "w" and ndim == 2:
        return (MODEL_AXIS, None)
    return ()


def param_partition_specs(params: dict) -> dict:
    """``{name: spec}`` for every leaf of ``params`` (``state_dict`` keys)."""
    return {k: _spec_for(k.split("."), v) for k, v in params.items()}


def opt_state_shardings(opt_state, param_specs: dict):
    """The optimizer state's specs: a dict keyed like the parameters (Adam's
    ``mu`` / ``nu``, ...) takes its parameters' specs; anything else (a
    step count) is replicated."""
    if isinstance(opt_state, dict) and set(opt_state) == set(param_specs):
        return dict(param_specs)
    if isinstance(opt_state, dict):
        return {k: opt_state_shardings(v, param_specs) for k, v in opt_state.items()}
    return ()


def setup_tensor_parallel(mesh: Mesh, params: dict, opt_state=None, batch=None):
    """Place training state for dp x tp: each rank's Megatron blocks of the
    parameters and their moments (``param_partition_specs``), the batch's
    rows by data index (replicated along ``model``)."""
    from .fsdp import place

    return place(mesh, params, opt_state, param_partition_specs(params), batch)


class _CopyTo(torch.autograd.Function):
    """Megatron's *f*: identity forward, gradient all-reduced over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        count_traffic("all_reduce", g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's *g*: partial sums all-reduced over ``group``, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        count_traffic("all_reduce", y)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """*f* over ``group`` (identity without a group)."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """*g* over ``group`` (identity without a group)."""
    return x if group is None else _ReduceFrom.apply(x, group)
