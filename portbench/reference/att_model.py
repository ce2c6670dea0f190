"""Plain joint CTC-attention model: pyramidal BLSTM encoder, hybrid location
attention, LSTM decoder with scheduled sampling, joint loss.

Per row of the objective: ``λ · CTC nll + (1 - λ) · attention loss``, the
attention loss the label-smoothed cross entropy (``(1 - ε) nll + ε ·
mean(-log p)`` over the whole output vocabulary) averaged over the row's
``U + 1`` target positions ([l1..lU, eos]); the guided-attention penalty
enters with weight 0 past its decay and is left out. The schedules are read
at the traffic's global step: λ annealed from ``ctc_loss_weight_init`` to
``ctc_loss_weight`` over ``ctc_loss_weight_anneal_steps``, the sampling
probability ramped to ``scheduled_sampling_prob`` over
``scheduled_sampling_ramp_max_step``.

Decoder step (carry h, c, context, alignment, zeros at the start): the
input token is the gold one ([sos, l1..lU], padding read as eos) or, with
a draw below the sampling probability (one uniform per row and step from
the step's generator, after the encoder's dropout draws), the argmax of the
previous step's logits (sos at the first step); ``x = [embedding[token];
context]``; the LSTM cell (gates i, f, g, o, forget bias 1.0) on ``x @ Wx +
b + h @ Wh``; the hybrid read ``energies = tanh(((b + keys) + h @ W_dec) +
loc @ W_loc) @ v`` with ``keys = enc @ W_enc`` and ``loc`` the SAME
cross-correlation of the previous alignment with the [W, 1, C] taps, masked
past the row's frames, softmax, ``context = align @ enc``; logits ``[h;
context] @ W_out + b``. Encoder rows are read in float32; at bf16 each
read's gradient is rounded and their sum kept in bf16, as the encoder's
bf16 output receives it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import blstm, ctc_model, frontend

NEG = -1e30


def schedules(exp: dict, step: int) -> tuple:
    """(λ, sampling probability) at the global ``step``."""
    lam = exp.get("ctc_loss_weight", 0.0) if exp["model_type"] == "joint_ctc_attention" else 0.0
    init, steps = exp.get("ctc_loss_weight_init"), exp.get("ctc_loss_weight_anneal_steps", 0)
    if init is not None and steps > 0:
        lam = init + min(step / steps, 1.0) * (lam - init)
    ss = exp.get("scheduled_sampling_prob", 0.0)
    ramp = exp.get("scheduled_sampling_ramp_max_step", 0)
    if ss and ramp > 0:
        ss = ss * min(step / ramp, 1.0)
    return lam, ss


def location(prev_align, taps):
    """[N, T] alignments, [W, 1, C] taps -> [N, T, C], SAME cross-correlation."""
    w = taps.shape[0]
    left = (w - 1) // 2
    x = F.pad(prev_align, (left, w - 1 - left))
    return x.unfold(1, w, 1) @ taps[:, 0, :]


def row_sum(p: dict, exp: dict, batch: dict, q, generator=None, step: int = 0) -> torch.Tensor:
    """Sum over the rows of each row's objective term."""
    lam, ss = schedules(exp, step)
    feats, lengths = frontend.features(batch["inputs"], batch["input_len"], exp)
    enc, enc_len = blstm.encoder(feats, lengths, p, exp, q, generator)
    b, t, _ = enc.shape
    num_classes = p["ctc_head.w"].shape[1] - 1
    sos, eos = num_classes, num_classes + 1
    stored = enc.to(torch.bfloat16) if q.kind == "bfloat16" else enc
    read = (lambda: stored.float()) if q.kind == "bfloat16" else (lambda: q(stored))  # noqa: E731
    ctc = ctc_model.ctc_nll(read() @ p["ctc_head.w"] + p["ctc_head.b"], enc_len,
                            batch["labels"], batch["label_len"])
    keys = read() @ p["attention.w_enc"]
    mask = torch.arange(t, device=enc.device)[None, :] < enc_len.to(enc.device)[:, None]
    labels, label_len = batch["labels"].long(), batch["label_len"].long()
    gold_in = torch.cat([torch.full_like(labels[:, :1], sos),
                         torch.where(labels >= 0, labels, eos)], 1)
    pos = torch.arange(labels.shape[1] + 1, device=enc.device)[None, :]
    targets = torch.cat([torch.where(labels >= 0, labels, eos),
                         torch.full_like(labels[:, :1], eos)], 1)
    targets = torch.where(pos == label_len[:, None], eos, targets)
    valid = (pos <= label_len[:, None]).to(torch.float32)
    hd = p["decoder_cell.wh"].shape[0]
    h = enc.new_zeros((b, hd))
    c = enc.new_zeros((b, hd))
    context = enc.new_zeros((b, enc.shape[2]))
    align = enc.new_zeros((b, t))
    pred = torch.full((b,), sos, dtype=torch.long, device=enc.device)
    logits_all = []
    for s in range(gold_in.shape[1]):
        token = gold_in[:, s]
        if ss > 0.0:
            pick = torch.rand((b,), generator=generator, device=enc.device) < ss
            token = torch.where(pick, pred, token)
        x = torch.cat([p["embedding"][token], context], -1)
        gates = x @ p["decoder_cell.wx"] + p["decoder_cell.b"] + h @ p["decoder_cell.wh"]
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        pre = (((p["attention.b"] + keys) + (h @ p["attention.w_dec"])[:, None, :])
               + location(align, p["attention.conv"]) @ p["attention.w_loc"])
        energies = torch.tanh(pre) @ p["attention.v"]
        align = torch.softmax(torch.where(mask, energies, NEG), -1)
        context = torch.bmm(align[:, None, :], read())[:, 0]
        logits = torch.cat([h, context], -1) @ p["out_proj.w"] + p["out_proj.b"]
        pred = logits.argmax(-1)
        logits_all.append(logits)
    logp = torch.log_softmax(torch.stack(logits_all, 1), -1)
    nll = -logp.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    eps = exp.get("label_smoothing_prob", 0.0)
    if eps > 0.0:
        nll = (1.0 - eps) * nll + eps * -logp.mean(-1)
    att = (nll * valid).sum(-1) / valid.sum(-1).clamp(min=1.0)
    return (lam * ctc + (1.0 - lam) * att.double()).sum()
