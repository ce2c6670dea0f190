"""Attention / joint CTC-attention task: its config and model construction.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/
att_task.py``. ``AttTaskConfig`` has the same fields and defaults; its
input pipeline is ``train/ctc_task.device_pipeline``, which the JAX module
imports the same way. The loss, the train step and the eval steps are not ported
yet: the port serves attention models but does not train them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend.features import FrontendConfig
from ..models.seq2seq import Seq2SeqConfig, Seq2SeqModel


class AttTaskConfig(NamedTuple):
    model: Seq2SeqConfig
    frontend: FrontendConfig | None = FrontendConfig()  # None => precomputed features
    num_stack: int = 1
    num_skip: int = 1
    splice: int = 0
    weight_decay: float = 0.0
    label_smoothing: float = 0.0
    ctc_impl: str = "auto"
    scheduled_sampling_ramp_max_step: int = 0
    spec_augment: object | None = None
    guided_attention_weight: float = 0.0
    guided_attention_sigma: float = 0.2
    guided_attention_decay_steps: int = 0
    ctc_weight_init: float | None = None
    ctc_weight_anneal_steps: int = 0
    feature_dim: int | None = None

    @property
    def input_dim(self) -> int:
        base = self.frontend.feature_dim if self.frontend else self.feature_dim
        if base is None:
            raise ValueError("precomputed-feature mode needs feature_dim set on the task config")
        return base * self.num_stack * (2 * self.splice + 1)


def init_model(task: AttTaskConfig, generator: torch.Generator | None = None,
               input_dim: int | None = None) -> Seq2SeqModel:
    """A ``Seq2SeqModel`` for this task, on the CPU (move it with ``.to(device)``)."""
    return Seq2SeqModel(task.model, input_dim or task.input_dim, generator)


def init_params(task: AttTaskConfig, generator: torch.Generator | None = None,
                input_dim: int | None = None) -> dict:
    """Seeded weights as a dict of tensors (``state_dict`` keys), on the CPU."""
    return {k: v.detach() for k, v in init_model(task, generator, input_dim).state_dict().items()}
