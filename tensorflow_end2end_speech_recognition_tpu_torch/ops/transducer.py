"""RNN-Transducer (RNN-T) loss: the log-space lattice forward, in plain PyTorch.

Counterpart of ``tensorflow_end2end_speech_recognition_tpu/ops/
transducer.py`` (no Pallas kernel there, so none here). Graves 2012 over the
[T, U+1] lattice:

    alpha[0, 0] = 0
    alpha[t, u] = logaddexp(alpha[t-1, u] + lp_blank[t-1, u],
                            alpha[t, u-1] + lp_label[t, u-1])
    -log p(y|x) = -(alpha[T-1, U] + lp_blank[T-1, U])

Within one time row the u-dependency is the log-semiring linear recurrence
``x_u = logaddexp(a_u, m_u + x_{u-1})``. The JAX package evaluates it with
``lax.associative_scan``; here the same combine runs as a Hillis-Steele
scan of ceil(log2(U+1)) rounds over u, inside a Python loop over t. It is
not rewritten as ``cumsum`` + ``logcumsumexp``: the masked ``-1e30`` entries
would cancel catastrophically in float32. Rows past each utterance's
``t_len`` carry alpha unchanged, and the loss reads the terminal blank at
``(t_len - 1, u_len)``.

``transducer_logprobs`` forms the whole [B, T, U+1, J] joint at once (one
``tanh`` and one matmul) and reduces it to the two channels the lattice
needs; the JAX package scans T with ``jax.checkpoint`` to keep one slice
live. At the ls_transducer train shape (B = 32, T = 400, U = 40, J = 256)
the ``tanh`` is 0.54 GB of float32, kept for the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30  # finite -inf: keeps logaddexp gradients NaN-free


def _log_linear_recurrence(m, a):
    """x_u = logaddexp(a_u, m_u + x_{u-1}) with x_{-1} = -inf, along the last axis.

    Element (m, a) stands for f(x) = logaddexp(a, m + x); composing left then
    right gives (m_l + m_r, logaddexp(a_r, m_r + a_l)). An inclusive
    Hillis-Steele scan combines each element with the one ``d`` to its left
    for d = 1, 2, 4, ...
    """
    n = a.shape[-1]
    d = 1
    while d < n:
        ml, al = m[..., :-d], a[..., :-d]
        mr, ar = m[..., d:], a[..., d:]
        m = torch.cat([m[..., :d], ml + mr], dim=-1)
        a = torch.cat([a[..., :d], torch.logaddexp(ar, mr + al)], dim=-1)
        d *= 2
    return a


def rnnt_loss_from_logprobs(lp_blank, lp_label, t_len, u_len):
    """Negative log-likelihood per row.

    lp_blank: [B, T, U+1] log P(blank | t, u)
    lp_label: [B, T, U+1] log P(y_{u+1} | t, u) (entries at u >= u_len are
        ignored)
    t_len:    [B] valid encoder frames (>= 1)
    u_len:    [B] label lengths (0 <= u_len <= U)
    """
    b, t, u1 = lp_blank.shape
    dev = lp_blank.device
    t_len, u_len = t_len.to(dev).long(), u_len.to(dev).long()
    u_idx = torch.arange(u1, device=dev)[None, :]
    valid_u = u_idx <= u_len[:, None]  # lattice rows above u_len are unreachable
    emit_ok = u_idx < u_len[:, None]  # only the u_len real labels can be emitted
    lp_label = torch.where(emit_ok[:, None, :], lp_label, NEG)

    # t = 0 row: the pure emission chain, a shifted cumsum of lp_label[:, 0]
    row0 = F.pad(torch.cumsum(lp_label[:, 0, :-1], dim=-1), (1, 0))
    alpha = torch.where(valid_u, torch.clamp_min(row0, NEG), NEG)
    no_emitter = lp_label.new_full((b, 1), NEG)  # u = 0 has no label below it
    for s in range(1, t):
        arrive_blank = alpha + lp_blank[:, s - 1]  # horizontal transition
        m = torch.cat([no_emitter, lp_label[:, s, :-1]], dim=-1)  # m_u = lp_label[t, u-1]
        alpha_t = _log_linear_recurrence(m, torch.clamp_min(arrive_blank, NEG))
        alpha_t = torch.where(valid_u, alpha_t, NEG)
        alpha = torch.where((s < t_len)[:, None], alpha_t, alpha)

    # terminal blank at (t_len - 1, u_len)
    t_last = torch.clamp(t_len - 1, 0, t - 1)
    lpb_last = lp_blank[torch.arange(b, device=dev), t_last]  # [B, U+1]
    total = torch.gather(alpha + lpb_last, 1, u_len[:, None])[:, 0]
    return -torch.clamp_min(total, NEG)


def transducer_logprobs(f_enc, g_pred, w_out, b_out, labels, blank_id: int):
    """Per-lattice-node blank and next-label log-probs, each [B, T, U+1].

    f_enc [B, T, J] and g_pred [B, U+1, J] are the projected encoder and
    prediction-net activations; the joint is ``tanh(f_t + g_u) @ w_out + b_out``
    with ``w_out`` [J, V+1] (blank last); labels [B, U] int, -1 padded.
    """
    lab_u = F.pad(torch.where(labels >= 0, labels, 0).long(), (0, 1))  # [B, U+1]; u = U dummy
    z = torch.tanh(f_enc[:, :, None, :] + g_pred[:, None, :, :])  # [B, T, U+1, J]
    logits = torch.matmul(z, w_out) + b_out  # [B, T, U+1, V+1]
    lse = torch.logsumexp(logits, dim=-1)
    lp_b = logits[..., blank_id] - lse
    idx = lab_u[:, None, :, None].expand(*logits.shape[:3], 1)
    lp_l = torch.gather(logits, -1, idx)[..., 0] - lse
    return lp_b, lp_l


def rnnt_loss(f_enc, g_pred, w_out, b_out, labels, t_len, u_len, blank_id: int):
    """Full RNN-T nll [B] from projected encoder / prediction activations."""
    lp_blank, lp_label = transducer_logprobs(f_enc, g_pred, w_out, b_out, labels, blank_id)
    return rnnt_loss_from_logprobs(lp_blank, lp_label, t_len, u_len)
