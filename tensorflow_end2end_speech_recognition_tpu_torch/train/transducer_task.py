"""Transducer task: the RNN-T loss and the train and eval steps.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/
transducer_task.py``: raw waveforms -> ``ctc_task.device_pipeline`` (the
same frontend and stacking, as the JAX task imports it) -> encoder ->
prediction net over ``[SOS, labels]`` -> RNN-T lattice loss -> gradient ->
clip and update, with the same guard as the CTC step. In training,
SpecAugment (when set) masks the stacked features and a MoE encoder's
load-balance loss joins the objective. Parameters travel as a dict of
tensors (``state_dict`` keys) through one parameter-free copy of the model
(``torch.func.functional_call``). The beam eval step decodes with the
transducer beam search, with an RNN-LM fused when one is given. With
``grad_accum`` above 1 the train step accumulates over strided microbatches
(``train/accum.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from ..decoding.transducer_beam import transducer_beam_search
from ..frontend.augment import SpecAugmentConfig
from ..frontend.features import FrontendConfig
from ..models.transducer import TransducerConfig, TransducerModel, pred_tokens
from ..ops.losses import batch_mean, l2_weight_decay
from ..ops.transducer import rnnt_loss
from .ctc_task import add_moe_aux, augment, device_pipeline, guarded_train_step, skeleton


class TransducerTaskConfig(NamedTuple):
    """Same fields and defaults as the JAX ``TransducerTaskConfig``."""

    model: TransducerConfig
    frontend: FrontendConfig | None = FrontendConfig()  # None => precomputed features
    num_stack: int = 1
    num_skip: int = 1
    splice: int = 0
    weight_decay: float = 0.0
    spec_augment: SpecAugmentConfig | None = None
    feature_dim: int | None = None

    @property
    def input_dim(self) -> int:
        base = self.frontend.feature_dim if self.frontend else self.feature_dim
        if base is None:
            raise ValueError("precomputed-feature mode needs feature_dim set on the task config")
        return base * self.num_stack * (2 * self.splice + 1)


def init_model(task: TransducerTaskConfig, generator: torch.Generator | None = None,
               input_dim: int | None = None) -> TransducerModel:
    """A ``TransducerModel`` for this task, on the CPU (move it with ``.to(device)``)."""
    return TransducerModel(task.model, input_dim or task.input_dim, generator)


def init_params(task: TransducerTaskConfig, generator: torch.Generator | None = None,
                input_dim: int | None = None) -> dict:
    """Seeded weights as a dict of tensors (``state_dict`` keys), on the CPU."""
    return {k: v.detach() for k, v in init_model(task, generator, input_dim).state_dict().items()}


def _apply(params: dict, task: TransducerTaskConfig, batch: dict, train: bool = False,
           generator: torch.Generator | None = None, decode: bool = False):
    """Pipeline (with SpecAugment when training), then ``TransducerModel.forward``
    on the weights in ``params`` with the teacher-forced tokens of ``batch``;
    returns (output, its nll [B])."""
    feats, feat_len = device_pipeline(task, batch)
    feats = augment(task, feats, feat_len, train, generator)
    cfg = task.model
    labels = batch["labels"]
    out = functional_call(skeleton(TransducerModel, cfg, feats.shape[-1]), params,
                          (feats, feat_len, pred_tokens(labels, cfg.blank_id)),
                          {"train": train, "generator": generator, "decode": decode})
    nll = rnnt_loss(out.f_proj, out.g_proj, params["out.w"], params["out.b"], labels,
                    out.enc_len, batch["label_len"], cfg.blank_id)
    return out, nll


def forward_loss(params: dict, task: TransducerTaskConfig, batch: dict, train: bool,
                 generator: torch.Generator | None = None):
    """(loss, aux): the weighted batch mean of the RNN-T nll, plus the MoE
    load-balance loss in training, plus L2 weight decay."""
    out, nll = _apply(params, task, batch, train, generator)
    loss = batch_mean(nll, batch.get("weight"))
    aux = {"rnnt_nll": loss}
    loss = add_moe_aux(loss, aux, out.aux_loss, train)
    if task.weight_decay:
        loss = loss + l2_weight_decay(params, task.weight_decay)
    aux["loss"] = loss
    return loss, aux


def make_train_step(task: TransducerTaskConfig, optimizer, grad_accum: int = 1, mesh=None,
                    specs: dict | None = None):
    """``(params, opt_state, batch, lr, generator) -> (params, opt_state, aux)``
    with the CTC step's clip, update and non-finite / >= 1e20 guard (data
    parallel over ``mesh``, ZeRO-3 with ``specs``)."""
    return guarded_train_step(forward_loss, task, optimizer, grad_accum, mesh, specs)


def make_eval_step(task: TransducerTaskConfig):
    """``(params, batch) -> (decoded [B, T' * S], lengths [B], nll [B])``:
    the greedy decode and the teacher-forced nll, with no gradient kept."""

    def eval_step(params, batch):
        with torch.no_grad():
            out, nll = _apply(params, task, batch, decode=True)
        return out.decoded, out.dec_len, nll

    return eval_step


def _bound_model(params: dict, task: TransducerTaskConfig) -> TransducerModel:
    """A ``TransducerModel`` whose weights are the tensors of ``params`` (no
    copy), for the decoders that call its methods (the beam search)."""
    with torch.device("meta"):
        model = TransducerModel(task.model, task.input_dim)
    model.load_state_dict(params, assign=True)
    return model.eval()


def make_beam_eval_step(task: TransducerTaskConfig, beam_width: int, lm=None,
                        lm_weight: float = 0.0):
    """``(params, batch) -> (tokens [B, T' * S], lengths [B], nll [B])``: the
    best hypothesis of the transducer beam at ``beam_width``, and the
    teacher-forced nll (not the beam score, so ``bin/eval``'s loss means the
    same at any beam), from one encoder pass. ``lm`` (an ``RNNLM``) with a
    non-zero ``lm_weight`` is fused into label emissions."""
    fusion_lm = None
    if lm is not None and lm_weight:
        from ..models.lm import make_fusion_lm

        fusion_lm = make_fusion_lm(lm, task.model.vocab_with_blank)

    def eval_step(params, batch):
        with torch.no_grad():
            out, nll = _apply(params, task, batch)
            res = transducer_beam_search(_bound_model(params, task), out.f_proj, out.enc_len,
                                         beam_width=beam_width, fusion_lm=fusion_lm,
                                         lm_weight=lm_weight if fusion_lm is not None else 0.0)
        return res.tokens[:, 0], res.lengths[:, 0], nll

    return eval_step
