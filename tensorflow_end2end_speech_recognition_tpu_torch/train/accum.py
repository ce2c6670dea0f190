"""Gradient accumulation: large effective batches at microbatch memory.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/accum.py``.
``grad_accum_steps: A`` splits each train batch into A microbatches, runs
one forward and one backward per microbatch (each graph freed before the
next, so activation memory scales with B/A) and makes ONE optimizer update
from the combined gradient, whose math equals the full-batch step's.

Losses are weighted means over rows (``ops/losses.batch_mean``: a short
final batch's fill rows carry weight 0), so microbatch ``a`` counts with
``w_a = max(s_a, 1)``, ``s_a`` the sum of its row weights, or ``B/A`` when
the batch has no ``weight`` key. The sums ``sum_a loss_a w_a``,
``sum_a aux_a w_a`` and ``sum_a grad_a w_a`` stay in float32 and are
divided once by ``sum_a w_a``: exactly the full-batch weighted mean.

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
"""

from __future__ import annotations

import torch


def microbatch(batch: dict, a: int, accum: int) -> dict:
    """Rows ``a, a+accum, ...`` of every tensor in ``batch``."""
    return {k: v.reshape((v.shape[0] // accum, accum) + v.shape[1:])[:, a].contiguous()
            for k, v in batch.items()}


def accum_value_and_grad(loss_fn, params: dict, batch: dict, generator, accum: int):
    """Weighted-mean ``(loss, aux), grads`` of ``loss_fn`` over ``accum``
    microbatches, all detached.

    ``loss_fn(params, microbatch, generator) -> (loss, aux)`` with scalar aux
    tensors (the tasks' ``forward_loss`` contract: the loss is a
    ``batch_mean`` over rows, weighted by ``microbatch["weight"]`` when
    present); ``params`` are leaves that require a gradient. The batch's
    rows must divide by ``accum``.
    """
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch rows {b} not divisible by grad_accum {accum}")
    leaves = list(params.values())
    lsum = wsum = 0.0
    auxsum = {}
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    for a in range(accum):
        mb = microbatch(batch, a, accum)
        with torch.enable_grad():
            loss, aux = loss_fn(params, mb, generator)
            grads = torch.autograd.grad(loss, leaves)
        if "weight" in mb:
            # batch_mean divides by max(s_a, 1): multiplying back by the same
            # recovers the weighted numerator; an all-fill microbatch counts 0
            s_a = mb["weight"].to(torch.float32).sum()
            w = torch.where(s_a > 0, torch.clamp(s_a, min=1.0), 0.0)
        else:
            w = torch.tensor(float(b // accum), device=loss.device)
        with torch.no_grad():
            lsum = lsum + loss.detach() * w
            wsum = wsum + w
            for k, v in aux.items():
                auxsum[k] = auxsum.get(k, 0.0) + v.detach() * w
            for total, g in zip(gsum, grads):
                total.add_(g.to(torch.float32) * w)
        del loss, aux, grads  # this microbatch's graph is freed before the next
    inv = 1.0 / torch.clamp(wsum, min=1.0)  # wsum >= 1 unless no row is real
    grads = {k: (g * inv).to(p.dtype) for (k, p), g in zip(params.items(), gsum)}
    return (lsum * inv, {k: v * inv for k, v in auxsum.items()}), grads
