"""Gradient accumulation: large effective batches at microbatch memory.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/accum.py``.
``grad_accum_steps: A`` splits each train batch into A microbatches, runs
one forward and one backward per microbatch (each graph freed before the
next, so activation memory scales with B/A) and makes ONE optimizer update
from the combined gradient, whose math equals the full-batch step's.

Losses are weighted means over rows (``ops/losses.batch_mean``: a short
final batch's fill rows carry weight 0), so microbatch ``a`` counts with
``w_a = max(s_a, 1)``, ``s_a`` the sum of its row weights, or ``B/A`` when
the batch has no ``weight`` key (``microbatch_weights``). Each microbatch's
loss, aux terms and gradients count ``w_a / sum_a w_a`` and are summed in
float32 (``weighted_value_and_grad``): exactly the full-batch weighted mean.

A microbatch of fill rows only (``s_a = 0``: a short final batch with fewer
real rows than A) counts 0 (``w_a = 0``), so the combined step still equals
the full-batch step, its weight decay term included. The JAX step gives
such a microbatch ``w_a = 1``, which shrinks the data term of that batch's
loss and gradient by ``sum_a s_a / (sum_a s_a + number of all-fill
microbatches)``; the two agree on every batch without one.

Microbatch ``a`` holds the rows ``a, a+A, a+2A, ...`` (a strided layout:
``reshape(B/A, A, ...)[:, a]``), as the JAX step takes them. JAX folds its
key with the microbatch index; here each microbatch draws its dropout and
SpecAugment from the one ``torch.Generator`` in turn.

Across data-parallel ranks (``ctc_task.guarded_train_step`` with a mesh)
the rule carries over: each rank splits its own B/N rows into A strided
microbatches and weighs microbatch ``a`` by ``w_a / W``, W the total
weight of all ranks' microbatches, summed over the ranks before the
forward; the ranks' sums, added by one all-reduce, are the global
batch's weighted mean. Rank r holds rows r·B/N .. (r+1)·B/N - 1 and
``check_trainable`` requires B % (A·N) = 0, so r·B/N is a multiple of A
and the rows of its microbatch ``a`` are the global rows congruent to
``a`` mod A: microbatch ``a`` of all ranks together is JAX's global
microbatch ``a``, row for row. A MoE load-balance term is taken over it
(``weighted_value_and_grad``), as JAX takes it; only the dropout draws
differ. The one-process step is this step over one rank: dividing by W
before the sum makes its factor exactly 1 at A = 1, so it is plain
autograd bit for bit.
"""

from __future__ import annotations

import torch


def microbatch(batch: dict, a: int, accum: int) -> dict:
    """Rows ``a, a+accum, ...`` of every tensor in ``batch``."""
    return {k: v.reshape((v.shape[0] // accum, accum) + v.shape[1:])[:, a].contiguous()
            for k, v in batch.items()}


def microbatch_weights(batch: dict, accum: int) -> torch.Tensor:
    """``[accum]`` float32: microbatch ``a``'s weight ``w_a`` (module docstring)."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch rows {b} not divisible by grad_accum {accum}")
    if "weight" not in batch:
        return torch.full((accum,), float(b // accum), device=next(iter(batch.values())).device)
    # batch_mean divides by max(s_a, 1): multiplying back by the same recovers
    # the weighted numerator; an all-fill microbatch counts 0
    s = batch["weight"].to(torch.float32).reshape(b // accum, accum).sum(0)
    return torch.where(s > 0, torch.clamp(s, min=1.0), 0.0)


def weighted_value_and_grad(loss_fn, params: dict, batch: dict, generator, accum: int,
                            scale: torch.Tensor, global_scale: torch.Tensor | None = None):
    """``(sum_a scale_a loss_a, {k: sum_a scale_a aux_a}, {k: sum_a scale_a
    grad_a})`` over ``accum`` strided microbatches, detached, gradients in
    float32: one rank's sums, which a data-parallel step adds over the
    ranks. ``scale`` ``[accum]`` holds each microbatch's factor; ``loss_fn``
    and ``params`` as ``accum_value_and_grad``.

    A MoE encoder's load-balance term (``aux["moe_aux"]``, inside the loss)
    is a product of two means over the frames of the ranks' microbatch
    ``a`` together (``parallel.mesh.batch_sum``), so this rank's part of it
    is already a share of that global term: it counts ``global_scale_a``
    (default ``scale_a``), microbatch ``a``'s weight over all ranks as a
    fraction of the step's. Each microbatch's objective is ``scale_a
    loss_a`` with that term's factor changed so; ``aux["loss"]`` reports it.
    """
    global_scale = scale if global_scale is None else global_scale
    leaves = list(params.values())
    lsum = 0.0
    auxsum = {}
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    for a in range(accum):
        mb = microbatch(batch, a, accum) if accum > 1 else batch
        with torch.enable_grad():
            loss, aux = loss_fn(params, mb, generator)
            factors = {k: global_scale[a] if k == "moe_aux" else scale[a] for k in aux}
            loss = scale[a] * loss
            if "moe_aux" in aux:
                loss = loss + (global_scale[a] - scale[a]) * aux["moe_aux"]
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            lsum = lsum + loss.detach()
            for k, v in aux.items():
                auxsum[k] = auxsum.get(k, 0.0) + (loss if k == "loss" else v * factors[k]).detach()
            for total, g in zip(gsum, grads):
                total.add_(g.to(torch.float32))
        del loss, aux, grads  # this microbatch's graph is freed before the next
    return lsum, auxsum, dict(zip(params, gsum))


def accum_value_and_grad(loss_fn, params: dict, batch: dict, generator, accum: int):
    """Weighted-mean ``(loss, aux), grads`` of ``loss_fn`` over ``accum``
    microbatches in one process, all detached (the train steps' rule,
    ``ctc_task.guarded_train_step``, with no other rank).

    ``loss_fn(params, microbatch, generator) -> (loss, aux)`` with scalar aux
    tensors (the tasks' ``forward_loss`` contract: the loss is a
    ``batch_mean`` over rows, weighted by ``microbatch["weight"]`` when
    present); ``params`` are leaves that require a gradient. The batch's
    rows must divide by ``accum``. Each microbatch counts ``w_a / sum_a
    w_a`` (``sum_a w_a`` clamped to at least 1: it is 0 only when no row is
    real).
    """
    w = microbatch_weights(batch, accum)
    lsum, auxsum, gsum = weighted_value_and_grad(loss_fn, params, batch, generator, accum,
                                                 w / torch.clamp(w.sum(), min=1.0))
    return (lsum, auxsum), {k: g.to(params[k].dtype) for k, g in gsum.items()}
