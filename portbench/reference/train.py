"""The reference's first train steps, and the readings they are compared by.

A step's objective is the mean over the batch's rows of each row's term
(the model's ``row_sum`` over blocks of rows, each block drawing its
dropout from its own generator, as each rank of a data-parallel step
draws its own) plus the weight decay; its gradient feeds ``optim.Adam``.
Readings, as the comparison takes them: each step's loss, each leaf's norm
of the first clipped gradient (what Adam receives at step 1) and each
leaf's norm of the weights' change after the last step.
"""

from __future__ import annotations

import torch

from . import ctc_model, optim


def model_of(exp: dict):
    if exp.get("model_type") in ("attention", "joint_ctc_attention"):
        from . import att_model

        return att_model
    return ctc_model


def train_readings(p0: dict, exp: dict, batches: list, blocks: list, q, lr: float,
                   global_step: int = 0) -> dict:
    """Run ``len(batches)`` steps from the weights ``p0`` (device tensors).
    ``blocks`` is a list of ``(rows, generator)``: the rows (a slice) each
    block of every batch covers, and the generator its draws come from."""
    model = model_of(exp)
    p = {k: v.detach().clone() for k, v in p0.items()}
    opt = optim.Adam(p, lr, exp.get("clip_grad_norm"))
    losses, grad1 = [], None
    for batch in batches:
        total_rows = sum(len(range(*rows.indices(len(batch["input_len"])))) for rows, _ in blocks)
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        grads = {k: torch.zeros_like(v) for k, v in p.items()}
        value = torch.zeros((), dtype=torch.float64, device=next(iter(p.values())).device)
        for rows, gen in blocks:
            part = {k: v[rows] for k, v in batch.items()}
            term = model.row_sum(leaves, exp, part, q, gen, global_step) / total_rows
            got = torch.autograd.grad(term, list(leaves.values()), allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g
            value = value + term.detach().double()
        wd = ctc_model.weight_decay(leaves, exp.get("weight_decay", 0.0))
        if wd.requires_grad:
            for k, g in zip(leaves, torch.autograd.grad(wd, list(leaves.values()),
                                                         allow_unused=True)):
                if g is not None:
                    grads[k] += g.float()
        value = value + wd.detach()
        p, g = opt.step(p, grads, value)
        if grad1 is None and g is not None:
            grad1 = {k: float(v.double().norm()) for k, v in g.items()}
        losses.append(float(value))
        global_step += 1
    delta = {k: float((p[k].double() - p0[k].double()).norm()) for k in p}
    return {"loss": losses, "grad1": grad1 or {}, "delta": delta}
