"""Attention / joint CTC-attention task: loss, and the train and eval steps.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/train/
att_task.py``: raw waveforms -> ``ctc_task.device_pipeline`` (as the JAX
module imports it) -> encoder -> teacher-forced decoder unroll with
scheduled sampling -> label-smoothed cross entropy, mixed with the joint
CTC term by λ (annealed from ``ctc_weight_init`` in training), plus the
guided-attention penalty (annealed) and L2 weight decay -> gradient -> clip
and update, with the CTC step's guard (``ctc_task.guarded_train_step``).
In training, SpecAugment (when set) masks the stacked features and a MoE
encoder's load-balance loss joins the objective after the guided term.
The schedules read the global ``step`` as a Python int, so they cost the
device nothing. Parameters travel as a dict of tensors (``state_dict``
keys) through one parameter-free copy of the model
(``torch.func.functional_call``). The beam eval step shares one encoder
pass between the attention beam (with joint CTC rescoring for joint models
and, given an RNN-LM, shallow fusion) and the teacher-forced NLL it
reports. With ``grad_accum`` above 1 the train step accumulates over
strided microbatches (``train/accum.py``), the global step the same for each.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import functional_call

from ..decoding.attention_beam import attention_beam_search
from ..decoding.joint_rescoring import joint_rescore
from ..frontend.augment import SpecAugmentConfig
from ..frontend.features import FrontendConfig
from ..models.seq2seq import Seq2SeqConfig, Seq2SeqModel
from ..ops.ctc import ctc_loss
from ..ops.losses import batch_mean, joint_loss, l2_weight_decay, smoothed_cross_entropy
from .ctc_task import add_moe_aux, augment, device_pipeline, guarded_train_step, skeleton


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
    spec_augment: SpecAugmentConfig | None = None
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


def make_decoder_io(cfg: Seq2SeqConfig, labels: torch.Tensor, label_len: torch.Tensor):
    """labels [B, U] (-1 pad) -> (labels_in [B, U+1], targets [B, U+1], mask).

    ``labels_in`` = [sos, l1..lU] with the padding filled by eos; ``targets``
    = [l1..lU] with eos at position ``label_len`` and -1 past it; ``mask``
    (float32) covers ``label_len + 1`` positions.
    """
    b, u = labels.shape
    safe = torch.where(labels >= 0, labels, cfg.eos_id)
    labels_in = torch.cat([torch.full_like(labels[:, :1], cfg.sos_id), safe], dim=1)
    pos = torch.arange(u + 1, device=labels.device)[None, :]
    targets = torch.cat([safe, torch.full_like(labels[:, :1], cfg.eos_id)], dim=1)
    targets = torch.where(pos == label_len[:, None], cfg.eos_id, targets)
    mask = pos <= label_len[:, None]
    return labels_in, torch.where(mask, targets, -1), mask.to(torch.float32)


def scheduled_sampling_prob(task: AttTaskConfig, step: int) -> float:
    """The scheduled-sampling probability, ramped linearly to the config's over
    ``scheduled_sampling_ramp_max_step`` steps."""
    base = task.model.scheduled_sampling_prob
    ramp = task.scheduled_sampling_ramp_max_step
    if base == 0.0 or ramp <= 0:
        return base
    return base * min(step / ramp, 1.0)


def ga_weight_schedule(task: AttTaskConfig, step: int) -> float:
    """The guided-attention weight, decayed linearly to 0 (train only)."""
    w = task.guided_attention_weight
    if w == 0.0 or task.guided_attention_decay_steps <= 0:
        return w
    return w * max(0.0, 1.0 - step / task.guided_attention_decay_steps)


def ctc_lambda(task: AttTaskConfig, step: int) -> float:
    """The joint loss's λ, annealed from ``ctc_weight_init`` to ``ctc_loss_weight``."""
    lam = task.model.ctc_loss_weight
    if task.ctc_weight_init is None or task.ctc_weight_anneal_steps <= 0:
        return lam
    frac = min(step / task.ctc_weight_anneal_steps, 1.0)
    return task.ctc_weight_init + frac * (lam - task.ctc_weight_init)


def guided_attention_penalty(att_w, label_mask, enc_len, sigma: float) -> torch.Tensor:
    """Per-utterance [B] guided-attention penalty (Tachibana et al. 2017).

    The attention mass of ``att_w`` [B, U, T] weighted by its distance from
    the diagonal, ``1 - exp(-(t/T - u/U)^2 / (2 sigma^2))``, over valid
    frames and label positions, as a mean over the valid label positions.
    """
    _, u_dim, t_dim = att_w.shape
    dev = att_w.device
    upos = torch.arange(u_dim, dtype=torch.float32, device=dev)[None, :, None]
    tpos = torch.arange(t_dim, dtype=torch.float32, device=dev)[None, None, :]
    n_labels = label_mask.sum(dim=1).clamp_min(1.0)
    ulen = n_labels[:, None, None]
    tlen = enc_len.to(torch.float32).clamp_min(1.0)[:, None, None]
    off_diag = 1.0 - torch.exp(-0.5 * (tpos / tlen - upos / ulen).square() / (sigma * sigma))
    pen = att_w * off_diag * (tpos < tlen) * label_mask[:, :, None]
    return pen.sum(dim=(1, 2)) / n_labels


def _apply(params: dict, task: AttTaskConfig, batch: dict, train: bool = False,
           generator: torch.Generator | None = None, ss_prob: float = 0.0,
           decode=False):
    """Pipeline (with SpecAugment when training) and ``Seq2SeqModel.forward``
    on the weights in ``params``: (teacher-forced output, the decode's output
    or None, targets, mask)."""
    cfg = task.model
    feats, feat_len = device_pipeline(task, batch)
    feats = augment(task, feats, feat_len, train, generator)
    labels_in, targets, mask = make_decoder_io(cfg, batch["labels"], batch["label_len"])
    out, greedy = functional_call(
        skeleton(Seq2SeqModel, cfg, feats.shape[-1]), params, (feats, feat_len, labels_in),
        {"train": train, "generator": generator, "ss_prob": ss_prob, "decode": decode})
    return out, greedy, targets, mask


def forward_loss(params: dict, task: AttTaskConfig, batch: dict, train: bool,
                 generator: torch.Generator | None = None, step: int = 0):
    """(loss, aux): the smoothed attention NLL, mixed with the CTC NLL by λ for
    joint models, plus the guided-attention term and the MoE load-balance
    loss (train only) and L2 weight decay; every mean weighted by the
    batch's row weights."""
    cfg = task.model
    out, _, targets, mask = _apply(params, task, batch, train, generator,
                                   scheduled_sampling_prob(task, step) if train else 0.0)
    row_w = batch.get("weight")  # 0 on the filler rows of a short batch
    att_nll = batch_mean(smoothed_cross_entropy(out.logits, targets, mask,
                                                task.label_smoothing), row_w)
    aux = {"att_nll": att_nll}
    loss = att_nll
    if cfg.is_joint:
        ctc_nll = batch_mean(ctc_loss(out.ctc_logits, out.ctc_logit_len, batch["labels"],
                                      batch["label_len"], blank_id=cfg.num_classes,
                                      impl=task.ctc_impl), row_w)
        aux["ctc_nll"] = ctc_nll
        loss = joint_loss(ctc_nll, att_nll,
                          ctc_lambda(task, step) if train else cfg.ctc_loss_weight)
    # after the joint mix, which replaces the loss: added before it, the
    # term would be dropped for joint models
    if train and task.guided_attention_weight > 0.0:
        ga = batch_mean(guided_attention_penalty(out.attention_weights, mask, out.enc_len,
                                                 task.guided_attention_sigma), row_w)
        aux["guided_att"] = ga
        loss = loss + ga_weight_schedule(task, step) * ga
    loss = add_moe_aux(loss, aux, out.aux_loss, train)
    if task.weight_decay:
        loss = loss + l2_weight_decay(params, task.weight_decay)
    aux["loss"] = loss
    return loss, aux


def make_train_step(task: AttTaskConfig, optimizer, grad_accum: int = 1, mesh=None,
                    specs: dict | None = None):
    """``(params, opt_state, batch, lr, generator, step=0) -> (params,
    opt_state, aux)``: ``guarded_train_step`` around ``forward_loss``, with
    the global ``step`` for the schedules (data parallel over ``mesh``,
    ZeRO-3 with ``specs``)."""
    return guarded_train_step(forward_loss, task, optimizer, grad_accum, mesh, specs)


def make_eval_step(task: AttTaskConfig):
    """``(params, batch) -> (ids [B, max_decode_length], lengths [B], nll [B])``:
    one encoder pass shared by the greedy decode (kernel #7 on the card) and
    the teacher-forced NLL, with no gradient kept. Ids after the first eos
    are -1 and the length is the index of the first eos."""
    cfg = task.model

    def eval_step(params, batch):
        with torch.no_grad():
            out, greedy, targets, mask = _apply(params, task, batch, decode=True)
            preds = greedy.predicted_ids
            seen = torch.cumsum((preds == cfg.eos_id).to(torch.int32), dim=1) > 0
            nll = smoothed_cross_entropy(out.logits, targets, mask, 0.0)
        return torch.where(seen, -1, preds), (~seen).sum(dim=1), nll

    return eval_step


def make_beam_eval_step(task: AttTaskConfig, beam_width: int, length_penalty: float = 0.0,
                        joint_rescore_weight: float | None = None, lm=None,
                        lm_weight: float = 0.0):
    """``(params, batch) -> (ids [B, max_decode_length], lengths [B], nll [B])``:
    the best hypothesis of the attention beam (kernel #7 on the card), re-ranked
    by ``joint_rescore`` (kernel #6 on B·W rows) for a joint model when
    ``joint_rescore_weight`` is given, with ``lm`` (an ``RNNLM``) fused at
    ``lm_weight``. The NLL is the teacher-forced one of the greedy eval step,
    not the beam score, so the reported loss means the same for both."""
    cfg = task.model

    def beam(model, feats, feat_len, enc):
        result = attention_beam_search(model, feats, feat_len, beam_width, length_penalty,
                                       lm=lm, lm_weight=lm_weight if lm is not None else 0.0,
                                       precomputed=enc)
        if joint_rescore_weight is not None and cfg.is_joint:
            result = joint_rescore(result, joint_rescore_weight, cfg.num_classes, length_penalty)
        return result

    def eval_step(params, batch):
        with torch.no_grad():
            out, result, targets, mask = _apply(params, task, batch, decode=beam)
            nll = smoothed_cross_entropy(out.logits, targets, mask, 0.0)
        return result.tokens[:, 0], result.lengths[:, 0], nll

    return eval_step
