"""Seeded weights on the card, in the layout of the port's parameter dict.

The leaves' names and shapes are the model's (the module tree the port's
train step runs, on the meta device); the values come from one uniform
draw on the card: every leaf uniform in ±``parameter_init``, leaves named
``b`` (biases) zero, as the reference system initialises them.
"""

from __future__ import annotations

import torch


def shapes(task_mod, task) -> dict:
    """{name: shape} of the port's parameter dict for ``task``, from the
    parameter-free module tree its train step runs (``skeleton``, cached)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train.ctc_task import skeleton

    model_cls = getattr(task_mod, "Seq2SeqModel", None) or task_mod.CTCModel
    model = skeleton(model_cls, task.model, task.input_dim)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def make(leaf_shapes: dict, scale: float, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [int(torch.Size(s).numel()) for s in leaf_shapes.values()]
    flat = (torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0) * scale
    out = {}
    for (name, shape), part in zip(leaf_shapes.items(), flat.split(sizes)):
        leaf = part.view(shape)
        out[name] = torch.zeros_like(leaf) if name.rsplit(".", 1)[-1] == "b" else leaf.clone()
    return out
