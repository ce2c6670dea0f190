"""CTC task: device-side input pipeline, loss, and the train and eval steps.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/
ctc_task.py``: raw waveforms -> frontend -> frame stacking -> splicing ->
encoder -> CTC loss -> gradient -> clip and update, on the device of the
inputs, with the host feeding batches and a scalar learning rate.
Parameters travel as a dict of tensors (``state_dict`` keys) and run
through one parameter-free copy of the model with
``torch.func.functional_call``, so a step is a function of
``(params, opt_state, batch, lr, generator)`` as the jitted JAX step is.
In training, SpecAugment (when the task sets it) masks the stacked
features with draws from the step's generator, and a MoE encoder's
load-balance loss joins the objective. A multitask model's loss mixes the
main and sub heads' batch means, ``w * main + (1 - w) * sub`` at
``main_task_weight`` w; its eval steps read the main head. The beam eval
step decodes with the CTC prefix beam, with an RNN-LM fused when one is
given. A batch with per-speaker CMVN rows (``cmvn_mean`` /
``cmvn_inv_std``) is normalized with them before stacking; a train step
with ``grad_accum`` above 1 takes its loss and gradients over that many
strided microbatches (``train/accum.py``) before its one update. Built
with a ``mesh`` the train step is one step over the ranks: data parallel,
with model, sequence or expert shards, and with ``specs`` that split
leaves (ZeRO-3, tensor, expert or pipeline parallelism;
``guarded_train_step``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.func import functional_call

from ..data.frame_ops import splice_frames, stack_frames
from ..decoding.ctc_greedy import ctc_greedy_decode
from ..decoding.ctc_prefix_beam import ctc_prefix_beam_search
from ..frontend.augment import SpecAugmentConfig, spec_augment
from ..frontend.features import FrontendConfig, extract_features
from ..models.ctc import CTCConfig, CTCModel
from ..ops.ctc import ctc_loss
from ..ops.losses import batch_mean, l2_weight_decay
from ..parallel.fsdp import gather_params, reduce_scatter_grads, spec_dim
from ..parallel.mesh import (
    BATCH_AXES,
    DATA_AXIS,
    LOCAL,
    PIPE_AXIS,
    SEQ_AXIS,
    all_reduce_flat,
    global_batch,
)
from ..parallel.pp import stage_views
from .accum import microbatch_weights, weighted_value_and_grad
from .optimizer import apply_updates, global_norm, tree_where


class CTCTaskConfig(NamedTuple):
    """Same fields and defaults as the JAX ``CTCTaskConfig``. Only
    ``ctc_impl="auto"`` is ported."""

    model: CTCConfig
    frontend: FrontendConfig | None = FrontendConfig()  # None => precomputed features
    num_stack: int = 1
    num_skip: int = 1
    splice: int = 0
    weight_decay: float = 0.0
    ctc_impl: str = "auto"
    spec_augment: SpecAugmentConfig | None = None
    main_task_weight: float = 1.0
    feature_dim: int | None = None

    @property
    def input_dim(self) -> int:
        base = self.frontend.feature_dim if self.frontend else self.feature_dim
        if base is None:
            raise ValueError("precomputed-feature mode needs feature_dim set on the task config")
        return base * self.num_stack * (2 * self.splice + 1)


def device_pipeline(task: CTCTaskConfig, batch: dict):
    """{"inputs", "input_len"} -> (model-ready features [B, T', D], lengths [B]).

    With ``batch["cmvn_mean"]`` / ``batch["cmvn_inv_std"]`` (per-speaker CMVN)
    the base frames are normalized with the rows' speaker statistics and
    frames at or past ``feat_len`` zeroed, before stacking and splicing (the
    frontend's ``cmvn: speaker`` is mask-only)."""
    inputs, input_len = batch["inputs"], batch["input_len"]
    if task.frontend is not None:
        feats, feat_len = extract_features(inputs, input_len, task.frontend)
    else:
        feats, feat_len = inputs, input_len
    if "cmvn_mean" in batch:
        t = feats.shape[1]
        mask = (torch.arange(t, device=feats.device)[None, :, None]
                < feat_len[:, None, None]).to(feats.dtype)
        feats = (feats - batch["cmvn_mean"][:, None, :]) * batch["cmvn_inv_std"][:, None, :]
        feats = feats * mask
    feats, feat_len = stack_frames(feats, feat_len, task.num_stack, task.num_skip)
    return splice_frames(feats, task.splice), feat_len


def augment(task, feats, feat_len, train: bool, generator: torch.Generator | None):
    """SpecAugment on the model-ready features when training with a generator
    and the task sets it (``spec_augment`` of the JAX tasks' ``forward_loss``)."""
    if train and task.spec_augment is not None and generator is not None:
        return spec_augment(feats, feat_len, generator, task.spec_augment)
    return feats


def add_moe_aux(loss, aux: dict, aux_loss, train: bool):
    """Add the encoder's (already weighted) MoE load-balance loss in training,
    reported as ``aux["moe_aux"]``; the eval loss stays a data likelihood."""
    if aux_loss is None or not train:
        return loss
    aux["moe_aux"] = aux_loss
    return loss + aux_loss


def init_model(task: CTCTaskConfig, generator: torch.Generator | None = None,
               input_dim: int | None = None):
    """A ``CTCModel`` for this task, on the CPU (move it with ``.to(device)``)."""
    return CTCModel(task.model, input_dim or task.input_dim, generator)


def init_params(task: CTCTaskConfig, generator: torch.Generator | None = None,
                input_dim: int | None = None) -> dict:
    """Seeded weights as a dict of tensors (``state_dict`` keys), on the CPU."""
    return {k: v.detach() for k, v in init_model(task, generator, input_dim).state_dict().items()}


@functools.lru_cache(maxsize=8)
def skeleton(model_cls, model_cfg, input_dim: int):
    """``model_cls(model_cfg, input_dim)``'s module tree with meta tensors:
    ``functional_call`` supplies the weights."""
    with torch.device("meta"):
        return model_cls(model_cfg, input_dim)


def apply_model(params: dict, task: CTCTaskConfig, feats, feat_len, train: bool = False,
                generator: torch.Generator | None = None):
    """``CTCModel.forward`` on the weights in ``params`` (``apply_ctc``)."""
    dim = feats.shape[-1]
    return functional_call(skeleton(CTCModel, task.model, dim), params, (feats, feat_len),
                           {"train": train, "generator": generator})


def forward_loss(params: dict, task: CTCTaskConfig, batch: dict, train: bool,
                 generator: torch.Generator | None = None):
    """(loss, aux): the weighted batch mean of the CTC nll (mixed with the
    sub head's at ``main_task_weight`` for a multitask model, whose sub
    labels default to the main ones when the batch has none, as the JAX
    loop's ``_to_device_batch`` fills them), plus the MoE load-balance loss
    in training, plus L2 weight decay."""
    feats, feat_len = device_pipeline(task, batch)
    feats = augment(task, feats, feat_len, train, generator)
    out = apply_model(params, task, feats, feat_len, train, generator)
    nll = ctc_loss(out.logits, out.logit_len, batch["labels"], batch["label_len"],
                   blank_id=task.model.blank_id, impl=task.ctc_impl)
    row_w = batch.get("weight")
    loss = batch_mean(nll, row_w)
    aux = {"ctc_nll": loss}
    if out.sub_logits is not None:
        sub_nll = ctc_loss(out.sub_logits, out.sub_logit_len,
                           batch.get("labels_sub", batch["labels"]),
                           batch.get("label_len_sub", batch["label_len"]),
                           blank_id=task.model.num_classes_sub, impl=task.ctc_impl)
        w = task.main_task_weight
        sub_mean = batch_mean(sub_nll, row_w)
        loss = w * loss + (1.0 - w) * sub_mean
        aux["ctc_nll_sub"] = sub_mean
    loss = add_moe_aux(loss, aux, out.aux_loss, train)
    if task.weight_decay:
        loss = loss + l2_weight_decay(params, task.weight_decay)
    aux["loss"] = loss
    return loss, aux


def grad_buckets(mesh, keys, specs: dict | None) -> dict:
    """``{axes: [leaf names]}``: the axes each leaf's gradient is summed over
    by all-reduce. Every leaf sums over the ranks that hold other rows or
    frames (``data`` x ``seq``) but a ``data``-split one, which the
    reduce-scatter sums over ``data`` first."""
    out = {}
    for k in keys:
        axes = (SEQ_AXIS,) if specs is not None and spec_dim(specs[k], DATA_AXIS) is not None \
            else BATCH_AXES
        out.setdefault(mesh.split_axes(axes), []).append(k)
    return out


def guarded_train_step(forward_loss_fn, task, optimizer, grad_accum: int = 1, mesh=None,
                       specs: dict | None = None):
    """``(params, opt_state, batch, lr, generator, **kw) -> (params, opt_state,
    aux)`` around ``forward_loss_fn(params, task, batch, train, generator,
    **kw)`` (the attention step passes the global ``step``).

    One step over the global batch, of which ``batch`` holds this rank's
    rows (``mesh``, ``parallel/mesh.py``; by default ``LOCAL``: one process,
    every collective a no-op). The row weight per microbatch is summed over
    the ``data`` line first; each rank's loss, aux terms and gradients over
    ``grad_accum`` strided microbatches, weighted by its share
    (``accum.weighted_value_and_grad``; with one rank at ``grad_accum`` 1
    the factor is exactly 1, plain autograd), are then summed over the ranks
    that hold other rows or frames (``data`` x ``seq``), so they are the
    global batch's weighted mean (the weight decay term counted once; a
    MoE load-balance term over the global batch's frames). Under ``seq``
    shards every seq rank computes the loss of all frames (``parallel/
    sp.py``) and weighs it by 1/S; a MoE term is a share of the global term
    already and keeps its weight. Model, expert and pipe ranks compute the
    loss whole and are not summed. Then the optimizer's clip and update, and the
    guard of the JAX step: unless the loss is finite and below 1e20 (an
    impossible alignment gives about 1e30), both the parameters and the
    optimizer state keep their old values and ``aux["nonfinite"]`` is true.
    One non-finite microbatch makes the combined loss non-finite and so
    rejects the whole update. The guard is a ``torch.where`` on the device,
    so a step never waits for the host. The clip, the guard and the update
    run alike on every rank, and replicated weights stay bit-identical.

    ``specs`` (``parallel/fsdp.fsdp_partition_specs``, ``tp.param_partition_
    specs``, ``ep.expert_partition_specs``) places the leaves: ``params``
    and the optimizer's moments are this rank's blocks. ``data``-split
    leaves (ZeRO-3) are all-gathered before the forward and their gradients
    reduce-scattered after the backward; model- and expert-split ones stay
    blocks, which the model runs on (``global_batch``); each gradient is
    summed over the axes of ``grad_buckets``, and the clip's norm over the
    axes that split each leaf. Under pipeline stages
    (``parallel/pp.pipeline_param_specs``) ``params`` holds this rank's stage
    of the stacked layer leaves; the model runs them as per-layer views
    (``pp.stage_views``, whose weight decay counts each stage once over the
    pipe line), every pipe rank gets the whole gradient of the replicated
    leaves, and its stage leaves' gradients are summed over ``data`` alone.
    """
    mesh = LOCAL if mesh is None else mesh
    norm_fn = functools.partial(global_norm, mesh=mesh, specs=specs)
    rows = mesh.along(DATA_AXIS)
    seq_share = 1.0 / mesh.degree(SEQ_AXIS)
    piped = mesh.degree(PIPE_AXIS) > 1

    def train_step(params, opt_state, batch, lr, generator=None, **kw):
        w = microbatch_weights(batch, grad_accum)
        (w_all,) = all_reduce_flat(rows, [w])  # each microbatch's weight over the data line
        total = torch.clamp(w_all.sum(), min=1.0)  # 0 only when no row is real
        full = gather_params(mesh, params, specs) if specs is not None else params
        leaves = {k: v.detach().requires_grad_(True) for k, v in full.items()}
        # under pipeline stages the model sees this stage's layers as per-layer views
        views = (lambda p: stage_views(p, specs, mesh)) if piped else (lambda p: (p, specs))
        with global_batch(mesh, views(leaves)[1]):
            loss, aux, grads = weighted_value_and_grad(
                lambda p, mb, g: forward_loss_fn(views(p)[0], task, mb, True, g, **kw),
                leaves, batch, generator, grad_accum, w / total * seq_share, w_all / total)
        del full, leaves
        if specs is not None:
            grads = reduce_scatter_grads(mesh, grads, specs)
        # the loss and aux terms ride the batch axes' all-reduce, first
        batch_axes = mesh.split_axes(BATCH_AXES)
        buckets = {batch_axes: [], **grad_buckets(mesh, grads, specs)}
        terms = [loss, *aux.values()]
        for axes, names in buckets.items():
            ride = terms if axes == batch_axes else []
            reduced = all_reduce_flat(mesh.along(*axes), ride + [grads[k] for k in names])
            if ride:
                terms = reduced[:len(ride)]
            grads.update(zip(names, reduced[len(ride):]))
        loss, aux = terms[0], dict(zip(aux, terms[1:]))
        with torch.no_grad():
            grads = {k: g.to(params[k].dtype) for k, g in grads.items()}
            updates, new_state = optimizer.update(grads, opt_state, norm_fn)
            new_params = apply_updates(params, updates, lr)
            ok = torch.isfinite(loss) & (loss < 1e20)
            params = tree_where(ok, new_params, params)
            opt_state = tree_where(ok, new_state, opt_state)
        aux["nonfinite"] = ~ok
        return params, opt_state, aux

    return train_step


def make_train_step(task: CTCTaskConfig, optimizer, grad_accum: int = 1, mesh=None,
                    specs: dict | None = None):
    """The CTC train step: ``guarded_train_step`` around ``forward_loss``
    (over ``mesh``'s ranks, its leaves placed by ``specs``)."""
    return guarded_train_step(forward_loss, task, optimizer, grad_accum, mesh, specs)


def make_eval_step(task: CTCTaskConfig):
    """``(params, batch) -> (decoded [B, T'], lengths [B], nll [B])``: greedy
    decode and the loss-only CTC kernel, with no gradient kept."""

    def eval_step(params, batch):
        with torch.no_grad():
            feats, feat_len = device_pipeline(task, batch)
            out = apply_model(params, task, feats, feat_len)
            nll = ctc_loss(out.logits, out.logit_len, batch["labels"], batch["label_len"],
                           blank_id=task.model.blank_id, impl=task.ctc_impl, need_grad=False)
            decoded, dec_len = ctc_greedy_decode(out.logits, out.logit_len, task.model.blank_id)
        return decoded, dec_len, nll

    return eval_step


def make_beam_eval_step(task: CTCTaskConfig, beam_width: int, top_k_classes: int = 16,
                        lm=None, lm_weight: float = 0.0):
    """``(params, batch) -> (prefixes [B, T'], lengths [B], nll [B])``: the
    best prefix of the CTC prefix beam at ``beam_width`` and the loss-only
    CTC kernel's NLL, from one encoder pass. ``lm`` (an ``RNNLM``) with a
    non-zero ``lm_weight`` rides the beam as carried-state shallow fusion."""
    fusion_lm = None
    if lm is not None and lm_weight:
        from ..models.lm import make_fusion_lm

        fusion_lm = make_fusion_lm(lm, task.model.vocab_with_blank)

    def eval_step(params, batch):
        with torch.no_grad():
            feats, feat_len = device_pipeline(task, batch)
            out = apply_model(params, task, feats, feat_len)
            nll = ctc_loss(out.logits, out.logit_len, batch["labels"], batch["label_len"],
                           blank_id=task.model.blank_id, impl=task.ctc_impl, need_grad=False)
            prefixes, lengths, _ = ctc_prefix_beam_search(
                out.logits, out.logit_len, task.model.blank_id, beam_width=beam_width,
                top_k_classes=top_k_classes, fusion_lm=fusion_lm,
                lm_weight=lm_weight if fusion_lm is not None else 0.0)
        return prefixes[:, 0], lengths[:, 0], nll

    return eval_step
