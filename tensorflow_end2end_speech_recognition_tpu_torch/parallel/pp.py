"""Pipeline parallelism (GPipe) over a ``pipe`` mesh axis.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/parallel/pp.py``.
The uniform blocks of a conformer or transformer stack are split into S
contiguous stages, one per rank along ``pipe``; each rank holds only its
stage's L/S layers and their optimizer moments, and M microbatches of its
rows flow through the stages. The recurrent encoders are not pipelined, as
in the JAX package (a BLSTM layer needs the whole sequence before its
successor starts).

The resident layout is the JAX one: each leaf of the layers is stacked
``[S, L/S, ...]`` under the name of its JAX stacked tree path
(``encoder.conformer.layers.ff1.in.w`` in place of ``...layers.{i}.ff1.in.w``;
``pp_stack_tree``) and placed ``("pipe", None, ...)`` (``pipeline_param_
specs``), with the layer's Megatron spec after the two stage dims under pp x
tp. The spec-driven rules of the other axes then count a stage's leaves once
over the pipe line: the clip's norm (``train/optimizer.global_norm``), the
weight decay (``ops/losses.l2_weight_decay``, fed this stage's layers as
per-layer views with the stacked leaf's spec: ``stage_views``), and
``fsdp.gather_whole``, which unstacks what it gathers, so eval and
checkpoints read the one-device list layout (``pp_unstack_tree``).

The schedule (``pipeline_apply``) is one ``torch.autograd.Function`` per
rank. Its forward runs the rank's stage over the M microbatches in order:
take microbatch m from the previous stage (stage 0: from the input), run
the stage, hand it to the next stage (``parallel.mesh.send_stage``); the
graph of each microbatch is kept, and the last stage's output is broadcast
to every rank of the pipe line (JAX's ``out[-1]``). Its backward mirrors it:
take the output's gradient of microbatch m from the next stage (the last
stage: from its own output gradient), back through the kept graph, hand the
input's gradient to the previous stage, in the order M-1 .. 0 on every
stage, so each hop meets its partner; stage 0's input gradient is then
broadcast over the pipe line. No bubble is computed.

The gradient rule: every rank of a pipe line computes the head and the loss
on the same output, so a replicated leaf (``proj``, the positions, the head,
``ln_out``) gets its whole gradient on each, equal bit for bit, and the
pipe line sums nothing; a stage leaf gets its gradient on its own stage
alone. JAX reaches the same sums by transposing a replicated ``shard_map``
input.

Rows: each data rank holds its rows of the global batch
(``mesh.shard_batch``) and cuts them into M contiguous microbatches (JAX
splits each global microbatch over ``data`` instead). Rows do not interact
in the stack, and the loss is the global batch's weighted mean
(``train/ctc_task.guarded_train_step``), so only the summation order
differs. Dropout inside the stages draws from a generator per stage, seeded
from the rank's generator (``stage_generator``): the ranks of a pipe line
keep their generators in step for the draws outside the stack (SpecAugment,
decoders), and no two stages repeat a mask. JAX folds its key with the
microbatch and layer index, a different stream by design.
"""

from __future__ import annotations

import hashlib

import torch
import torch.distributed as dist

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    count_traffic,
    make_grid,
    recv_stage,
    send_stage,
)


def make_mesh_pp(num_stages: int, device=None) -> Mesh:
    """A 1-D ``(pipe,)`` mesh over the process group's ``num_stages`` ranks."""
    return make_grid({PIPE_AXIS: num_stages}, device)


def make_mesh_dp_pp(num_data: int, num_stages: int, device=None) -> Mesh:
    """A ``(data, pipe)`` mesh, ``pipe`` minor: neighbour stages are
    neighbour ranks."""
    return make_grid({DATA_AXIS: num_data, PIPE_AXIS: num_stages}, device)


def make_mesh_dp_pp_tp(num_data: int, num_stages: int, num_model: int, device=None) -> Mesh:
    """A ``(data, pipe, model)`` mesh: pipeline and tensor parallelism with
    data parallelism, ``model`` minor and ``pipe`` between."""
    return make_grid({DATA_AXIS: num_data, PIPE_AXIS: num_stages, MODEL_AXIS: num_model},
                     device)


def layer_key(key: str):
    """``(prefix, layer index or None, rest)`` of a leaf of a conformer's
    layers (``...conformer.layers.{i}.rest``: index i; the stacked
    ``...conformer.layers.rest``: None); None for any other leaf."""
    parts = key.split(".")
    for i in range(len(parts) - 2):
        if parts[i] == "conformer" and parts[i + 1] == "layers":
            prefix = ".".join(parts[:i + 2])
            if parts[i + 2].isdigit():
                return prefix, int(parts[i + 2]), ".".join(parts[i + 3:])
            return prefix, None, ".".join(parts[i + 2:])
    return None


def stack_layers(layers: list, num_stages: int) -> dict:
    """L per-layer dicts ``{name: tensor}`` -> one dict of ``[S, L/S, ...]``
    tensors, stage-major: stage s holds layers ``s·L/S .. (s+1)·L/S - 1``."""
    n = len(layers)
    if n % num_stages:
        raise ValueError(f"{n} layers not divisible by {num_stages} stages")
    return {k: torch.stack([layer[k] for layer in layers]).reshape(
        (num_stages, n // num_stages) + tuple(layers[0][k].shape)) for k in layers[0]}


def unstack_layers(stacked: dict) -> list:
    """Inverse of ``stack_layers``: the per-layer dicts."""
    first = next(iter(stacked.values()))
    n = first.shape[0] * first.shape[1]
    flat = {k: v.reshape((n,) + tuple(v.shape[2:])) for k, v in stacked.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _is_leaf_dict(tree) -> bool:
    return isinstance(tree, dict) and any(isinstance(v, torch.Tensor) and layer_key(k)
                                          for k, v in tree.items())


def _regroup(leaves: dict, stacked: bool, fn) -> dict:
    """``leaves`` with each conformer's layer leaves (the list layout when
    ``stacked`` is False, else the stacked one) replaced by ``fn(prefix,
    {rest: leaf})`` (``{rest: {index: leaf}}`` for the list layout), which
    returns ``{name: leaf}`` put where the first of them stood."""
    groups, order = {}, []
    for k, v in leaves.items():
        key = layer_key(k)
        if key is None or (key[1] is None) != stacked:
            order.append(k)
            continue
        prefix, i, rest = key
        if prefix not in groups:
            groups[prefix] = {}
            order.append((prefix,))
        if stacked:
            groups[prefix][rest] = v
        else:
            groups[prefix].setdefault(rest, {})[i] = v
    out = {}
    for k in order:
        if isinstance(k, tuple):
            out.update(fn(k[0], groups[k[0]]))
        else:
            out[k] = leaves[k]
    return out


def pp_stack_tree(tree, num_stages: int):
    """Every dict of leaves in ``tree`` (the parameters, the optimizer's
    moments) with each conformer's ``layers.{i}`` leaves stacked ``[S, L/S,
    ...]`` under the stacked names. Already stacked leaves stay."""
    if _is_leaf_dict(tree):
        def stack(prefix, by_rest):
            n = len(next(iter(by_rest.values())))
            layers = [{rest: by_i[i] for rest, by_i in by_rest.items()} for i in range(n)]
            return {f"{prefix}.{rest}": v for rest, v in stack_layers(layers, num_stages).items()}

        return _regroup(tree, False, stack)
    if isinstance(tree, dict):
        return {k: pp_stack_tree(v, num_stages) for k, v in tree.items()}
    return tree


def pp_unstack_tree(tree):
    """Inverse of ``pp_stack_tree``: the per-layer list layout that eval,
    serving and checkpoints read (the one-device ``state_dict`` names, in
    their order)."""
    if _is_leaf_dict(tree):
        def unstack(prefix, by_rest):
            return {f"{prefix}.{i}.{rest}": v for i, layer in enumerate(unstack_layers(by_rest))
                    for rest, v in layer.items()}

        return _regroup(tree, True, unstack)
    if isinstance(tree, dict):
        return {k: pp_unstack_tree(v) for k, v in tree.items()}
    return tree


def pipeline_param_specs(params: dict, model: bool = False) -> dict:
    """``{name: spec}`` of a stacked parameter dict: a stacked layer leaf
    splits its stage dim over ``pipe`` (``("pipe",)``), with ``model`` (pp x
    tp) also its Megatron spec after the two stage dims (``("pipe", None,
    None, "model")`` for a column-parallel weight); every other leaf is
    replicated."""
    from .tp import _spec_for

    specs = {}
    for k, v in params.items():
        key = layer_key(k)
        if key is None or key[1] is not None:
            specs[k] = ()
        elif model:
            specs[k] = (PIPE_AXIS, None) + _spec_for(k.split("."), v[0, 0])
        else:
            specs[k] = (PIPE_AXIS,)
    return specs


def place_pipeline_params(mesh: Mesh, stacked: dict, model: bool = False) -> dict:
    """Stacked layer leaves (whole, as ``pp_stack_tree`` gives them) cut to
    this rank's stage (and model blocks with ``model``)."""
    from .fsdp import place

    return place(mesh, stacked, None, pipeline_param_specs(stacked, model))[0]


def setup_pipeline_parallel(mesh: Mesh, params: dict, opt_state=None, batch=None,
                            model: bool = False):
    """Place training state for dp x pp (x tp with ``model``): ``params`` and
    ``opt_state`` whole in the stacked layout (``pp_stack_tree``), broadcast
    from rank 0 and cut to this rank's stage (``pipeline_param_specs``); the
    batch's rows by data index. Build the train step with the same specs."""
    from .fsdp import place

    return place(mesh, params, opt_state, pipeline_param_specs(params, model), batch)


def stage_views(leaves: dict, specs: dict, mesh: Mesh) -> tuple:
    """(views, their specs): ``leaves`` with this rank's block ``[1, L/S,
    ...]`` of each stacked leaf replaced by its L/S per-layer views under the
    list names of this stage's layers (``...layers.{s·L/S + l}.rest``: what
    the model's modules are called), each view with the stacked leaf's spec.
    Gradients flow through the views to the stacked leaves."""
    stage = mesh.coord(PIPE_AXIS)
    views, view_specs = {}, {}
    for k, v in leaves.items():
        key = layer_key(k)
        if key is None or key[1] is not None:
            views[k], view_specs[k] = v, specs[k]
            continue
        prefix, _, rest = key
        per = v.shape[1]
        for li in range(per):
            name = f"{prefix}.{stage * per + li}.{rest}"
            views[name], view_specs[name] = v[0, li], specs[k]
    return views, view_specs


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...] (leading-axis split, order-preserving)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} microbatches")
    return x.reshape((num_microbatches, b // num_microbatches) + tuple(x.shape[1:]))


def stage_generator(generator: torch.Generator, stage: int) -> torch.Generator:
    """A generator of stage ``stage``'s own, seeded from the state of
    ``generator``, which advances by one draw (on every rank of a pipe line
    alike, so their generators stay in step). Reading a card generator's
    state does not wait for the card."""
    torch.empty(1, device=generator.device).uniform_(generator=generator)
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes()
                             + stage.to_bytes(4, "little"), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    return torch.Generator(device=generator.device).manual_seed(seed)


def _broadcast_line(line: Mesh, x: torch.Tensor, src: int) -> torch.Tensor:
    """``x`` of the line's rank ``src`` on every rank of the pipe line."""
    x = x.contiguous()
    count_traffic("broadcast", x)
    dist.broadcast(x, dist.get_global_rank(line.group, src), group=line.group)
    return x


class _Pipeline(torch.autograd.Function):
    """GPipe over the pipe line: the forward and backward of the module
    docstring. Inputs: the stage function, the mesh, M, the input [B, ...]
    and the stage's weights."""

    @staticmethod
    def forward(ctx, stage_fn, mesh, num_microbatches, x, *weights):
        line = mesh.along(PIPE_AXIS)
        s, last = line.rank, line.size - 1
        ws = [w.detach().requires_grad_(w.requires_grad) for w in weights]
        xs = microbatch(x.detach(), num_microbatches)
        kept, outs = [], []
        for m in range(num_microbatches):
            a = xs[m] if s == 0 else recv_stage(mesh, xs.shape[1:], x.dtype, -1)
            a = a.detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(ws, a, m)
            kept.append((a, y))
            if s < last:
                send_stage(mesh, y, +1)
            else:
                outs.append(y.detach())
        out = torch.cat(outs) if s == last else x.new_empty(
            (x.shape[0],) + tuple(kept[0][1].shape[1:]))
        ctx.stash = (mesh, kept, ws, num_microbatches, x.shape, x.dtype)
        return _broadcast_line(line, out, last)

    @staticmethod
    def backward(ctx, dout):
        mesh, kept, ws, num_microbatches, x_shape, x_dtype = ctx.stash
        ctx.stash = None
        line = mesh.along(PIPE_AXIS)
        s, last = line.rank, line.size - 1
        dys = microbatch(dout.contiguous(), num_microbatches)
        live = [i for i, w in enumerate(ws) if w.requires_grad]
        gws = [None] * len(ws)
        dxs = [None] * num_microbatches
        for m in reversed(range(num_microbatches)):
            a, y = kept[m]
            kept[m] = None  # this microbatch's graph goes with its backward
            dy = dys[m] if s == last else recv_stage(mesh, y.shape, y.dtype, +1)
            grads = torch.autograd.grad(y, [a] + [ws[i] for i in live], dy, allow_unused=True)
            for i, g in zip(live, grads[1:]):
                if g is not None:
                    gws[i] = g if gws[i] is None else gws[i] + g
            if s > 0:
                send_stage(mesh, grads[0], -1)
            else:
                dxs[m] = grads[0]
        dx = torch.cat(dxs) if s == 0 else torch.empty(x_shape, dtype=x_dtype,
                                                        device=dout.device)
        dx = _broadcast_line(line, dx, 0)
        return (None, None, None, dx, *gws)


def pipeline_apply(stage_fn, weights: list, x: torch.Tensor, mesh: Mesh,
                   num_microbatches: int) -> torch.Tensor:
    """The stage of this rank over ``x``'s M microbatches; returns the last
    stage's output [B, ...] on every rank of the pipe line.

    ``x`` [B, ...] is this rank's rows, the same on every rank of its pipe
    line; ``weights`` the stage's tensors; ``stage_fn(weights, act, m)``
    applies the stage to microbatch m's activation ``act`` [B/M, ...] (its
    rows ``m·B/M ..``) with the given tensors in place of ``weights``."""
    return _Pipeline.apply(stage_fn, mesh, num_microbatches, x, *weights)


def apply_conformer_pipelined(layers, x: torch.Tensor, mask: torch.Tensor, shards, drop,
                              mesh: Mesh, num_microbatches: int) -> torch.Tensor:
    """The pipelined twin of the conformer's layer loop (JAX's
    ``apply_conformer_pipelined`` between ``proj`` and ``ln_out``, which
    ``models/conformer.Conformer`` runs for both): this rank's stage of
    ``layers`` (an ``nn.ModuleList`` whose modules run as the sequential
    stack runs them: ``layer(x, mask, shards, drop) -> (x, aux)``) through
    ``pipeline_apply``, each microbatch with its rows of ``mask`` and of the
    shards' key mask. ``drop`` is the stage's dropout."""
    from torch.func import functional_call

    line = mesh.along(PIPE_AXIS)
    per = len(layers) // line.size
    mine = [layers[line.rank * per + li] for li in range(per)]
    names = [[n for n, _ in layer.named_parameters()] for layer in mine]
    weights = [w for layer in mine for _, w in layer.named_parameters()]
    rows = x.shape[0] // num_microbatches

    def stage_fn(ws, act, m):
        at = slice(m * rows, (m + 1) * rows)
        sh = shards._replace(key_mask=shards.key_mask[at])
        i = 0
        for layer, ns in zip(mine, names):
            act, _ = functional_call(layer, dict(zip(ns, ws[i:i + len(ns)])),
                                     (act, mask[at], sh, drop))
            i += len(ns)
        return act

    return pipeline_apply(stage_fn, weights, x, mesh, num_microbatches)
