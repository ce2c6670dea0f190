"""RNN-LM training task: the per-token NLL train step and the eval step.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/
lm_task.py``: the LM is trained on transcripts and consumed by the beams'
shallow fusion. Parameters travel as a dict of tensors (``state_dict``
keys) through one parameter-free ``RNNLM`` (``functional_call``); the step
is ``ctc_task.guarded_train_step`` (clip and update, and the parameters and
optimizer state kept on a non-finite loss). Rows of weight 0 (the fill rows
of a short batch) count neither in the loss nor in the token count, which is
``label_len + 1`` per row: the ``<eos>`` step is supervised.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.func import functional_call

from ..models.lm import LMConfig, RNNLM
from .ctc_task import guarded_train_step


class LMTaskConfig(NamedTuple):
    model: LMConfig


def init_model(task: LMTaskConfig, generator: torch.Generator | None = None) -> RNNLM:
    """An ``RNNLM`` for this task, on the CPU (move it with ``.to(device)``)."""
    return RNNLM(task.model, generator)


def init_params(task: LMTaskConfig, generator: torch.Generator | None = None) -> dict:
    """Seeded weights as a dict of tensors (``state_dict`` keys), on the CPU."""
    return {k: v.detach() for k, v in init_model(task, generator).state_dict().items()}


@functools.lru_cache(maxsize=4)
def _skeleton(cfg: LMConfig) -> RNNLM:
    with torch.device("meta"):
        return RNNLM(cfg)


def sequence_nll(params: dict, task: LMTaskConfig, batch: dict) -> torch.Tensor:
    """``lm_sequence_nll`` [B] on the weights in ``params`` (sos = vocab - 2)."""
    return functional_call(_skeleton(task.model), params, (batch["labels"], batch["label_len"]))


def _weighted(nll, batch):
    """(Σ weight · nll, Σ weight · (label_len + 1)); rows weigh 1 without ``weight``."""
    steps = (batch["label_len"] + 1).to(nll.dtype)
    w = batch.get("weight")
    if w is None:
        return nll.sum(), steps.sum()
    return (nll * w).sum(), (steps * w).sum()


def forward_loss(params: dict, task: LMTaskConfig, batch: dict, train: bool = True,
                 generator: torch.Generator | None = None):
    """(per-token NLL, aux with ``loss`` and ``ppl``)."""
    nll_sum, tokens = _weighted(sequence_nll(params, task, batch), batch)
    loss = nll_sum / tokens.clamp_min(1.0)
    return loss, {"loss": loss, "ppl": torch.exp(loss)}


def make_train_step(task: LMTaskConfig, optimizer):
    """``(params, opt_state, batch, lr, generator=None) -> (params, opt_state, aux)``."""
    return guarded_train_step(forward_loss, task, optimizer)


def make_eval_step(task: LMTaskConfig):
    """``(params, batch) -> (nll_sum, token_count)``, weighted by the rows' weights."""

    def eval_step(params, batch):
        with torch.no_grad():
            return _weighted(sequence_nll(params, task, batch), batch)

    return eval_step
