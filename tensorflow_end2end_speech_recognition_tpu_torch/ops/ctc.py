"""CTC loss over the blank-interleaved label lattice.

Counterpart of ``ctc_loss`` in ``tensorflow_end2end_speech_recognition_tpu/
ops/ctc.py`` and of its TPU kernels ``ctc_loss_pallas`` (loss and gradient
fused) and ``ctc_loss_pallas_fwd_only`` (``ops/pallas/ctc_kernel.py``):

    ctc_loss(logits [B, T, C], logit_len [B], labels [B, U] (-1 padded),
             label_len [B], blank_id, impl="auto", need_grad=True) -> nll [B]

Labels expand to ``z = [blank, l1, blank, l2, ..., blank]`` of width
``S = 2U+1``; rows past ``logit_len`` are padding. Log-space values are
floored at -1e30, so an impossible alignment (more labels than frames)
gives a finite loss of about 1e30, which the train step's guard rejects.

``need_grad=True`` goes through ``CTCLoss``, a ``torch.autograd.Function``
whose forward computes the loss and the gradient together (kernel #5) and
whose backward scales that gradient, as ``_ctc_vjp_bwd`` does.
``need_grad=False`` (eval) runs the loss-only kernel #6; its output cannot
be differentiated, and trying raises.

CPU tensors take the plain versions (``ctc_loss_plain``,
``ctc_loss_fwd_only_plain``), time loops in plain PyTorch. CUDA tensors
launch the hand-written kernels of ``csrc/ctc_loss.cu`` or raise; there is
no fallback. ``ctc_loss_fwd_bwd.launches`` and ``ctc_loss_fwd_only.launches``
count kernel launches. Only ``impl="auto"`` exists in the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

_NEG = -1e30


def _expand_labels(labels, label_len, blank_id: int):
    """[B, U] -> lattice labels z [B, 2U+1] and the additive skip mask [B, 2U+1].

    The s-2 -> s transition is allowed iff lane s holds a real label (odd,
    below 2 * label_len) that differs from lane s-2, as ``_prepare`` has it.
    """
    b, u = labels.shape
    s = 2 * u + 1
    z = labels.new_full((b, s), blank_id)
    z[:, 1::2] = torch.where(labels >= 0, labels, blank_id)
    prev2 = F.pad(z[:, :-2], (2, 0), value=blank_id)
    lane = torch.arange(s, device=labels.device)[None, :]
    is_label = (lane % 2 == 1) & (lane < 2 * label_len[:, None])
    skip_add = torch.where(is_label & (z != prev2), 0.0, _NEG).to(torch.float32)
    return z, skip_add


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    ms = m.clamp_min(_NEG)
    out = ms + torch.log(torch.exp(a - ms) + torch.exp(b - ms) + torch.exp(c - ms))
    return out.clamp_min(_NEG)


def _shift_right(x, n):
    return F.pad(x[:, :-n], (n, 0), value=_NEG)


def _shift_left(x, n):
    return F.pad(x[:, n:], (0, n), value=_NEG)


def _log_softmax(logits):
    """(x - max) - log(sum(exp(x - max))), the kernels' order of operations."""
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _alpha(lp, logit_len, labels, label_len, blank_id, keep_rows: bool):
    """Alpha recursion -> (loss [B], alpha [B, T, S] or None, lpz, z, skip_add)."""
    b, t, _ = lp.shape
    z, skip_add = _expand_labels(labels, label_len, blank_id)
    s = z.shape[1]
    lpz = torch.gather(lp, 2, z[:, None, :].expand(b, t, s))  # [B, T, S]
    tl = logit_len.clamp(0, t)
    lane = torch.arange(s, device=lp.device)[None, :]
    start = (lane == 0) | ((lane == 1) & (label_len[:, None] > 0))
    alpha = torch.where(start, lpz[:, 0], _NEG)
    rows = [alpha]
    for ti in range(1, t):
        new = _lse3(alpha, _shift_right(alpha, 1), _shift_right(alpha, 2) + skip_add)
        new = (new + lpz[:, ti]).clamp_min(_NEG)
        alpha = torch.where((ti < tl)[:, None], new, alpha)  # pad frames carry
        if keep_rows:
            rows.append(alpha)
    e1 = torch.gather(alpha, 1, (2 * label_len)[:, None])[:, 0]
    e2 = torch.gather(alpha, 1, (2 * label_len - 1).clamp_min(0)[:, None])[:, 0]
    e2 = torch.where(label_len > 0, e2, _NEG)
    m = torch.maximum(e1, e2)
    logp = m + torch.log(torch.exp(e1 - m) + torch.exp(e2 - m))
    return -logp, (torch.stack(rows, dim=1) if keep_rows else None), lpz, z, skip_add


def ctc_loss_plain(logits, logit_len, labels, label_len, blank_id: int):
    """Plain version of kernel #5: ``(loss [B], grad [B, T, C])``.

    Log-softmax, the alpha scan, the beta scan fused with
    ``gamma = alpha + beta - lpz - logp``, then per class
    ``grad = softmax - sum_{s: z[s]=c} exp(min(gamma, 40))``; pad frames 0.
    """
    logit_len, labels, label_len = logit_len.long(), labels.long(), label_len.long()
    b, t, c = logits.shape
    lp = _log_softmax(logits)
    loss, alpha, lpz, z, skip_add = _alpha(lp, logit_len, labels, label_len, blank_id, True)
    logp = -loss
    tl = logit_len.clamp(0, t)
    rows = torch.arange(b, device=logits.device)
    t_last = (tl - 1).clamp_min(0)
    lane = torch.arange(z.shape[1], device=logits.device)[None, :]
    end = (lane == 2 * label_len[:, None]) | (
        (lane == 2 * label_len[:, None] - 1) & (label_len[:, None] > 0))
    beta = torch.where(end, lpz[rows, t_last], _NEG)
    skip_left = _shift_left(skip_add, 2)
    gammas = [None] * t
    for ti in reversed(range(t)):
        real = (ti < tl)[:, None]
        g = (alpha[:, ti] + beta - lpz[:, ti] - logp[:, None]).clamp_min(_NEG)
        gammas[ti] = torch.where(real, g, _NEG)
        if ti > 0:
            new = _lse3(beta, _shift_left(beta, 1), _shift_left(beta, 2) + skip_left)
            beta = torch.where(real, (new + lpz[:, ti - 1]).clamp_min(_NEG), beta)
    post = torch.exp(torch.stack(gammas, dim=1).clamp_max(40.0))  # [B, T, S]
    contrib = torch.bmm(post, F.one_hot(z, c).to(post.dtype))  # per class, [B, T, C]
    frames = (torch.arange(t, device=logits.device)[None, :] < tl[:, None])[..., None]
    grad = torch.where(frames, torch.exp(lp) - contrib, 0.0)
    return loss, grad


def ctc_loss_fwd_only_plain(logits, logit_len, labels, label_len, blank_id: int):
    """Plain version of kernel #6: the loss [B] from the alpha scan alone."""
    return _alpha(_log_softmax(logits), logit_len.long(), labels.long(), label_len.long(),
                  blank_id, False)[0]


def _prepare(what, logits, logit_len, labels, label_len, blank_id):
    """Check the inputs; return int32 labels and lengths on the logits' device."""
    dev = logits.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if logits.dtype == torch.bfloat16:
        raise NotImplementedError(f"{what}: bfloat16 logits are not ported yet")
    if logits.dtype != torch.float32:
        raise ValueError(f"{what}: logits must be float32, got {logits.dtype}")
    if logits.dim() != 3 or not logits.is_contiguous():
        raise ValueError(f"{what}: logits must be a contiguous [B, T, C] tensor, "
                         f"got {tuple(logits.shape)}")
    b, t, c = logits.shape
    if b == 0 or t == 0 or c == 0:
        raise ValueError(f"{what}: empty logits {tuple(logits.shape)}")
    if not 0 <= blank_id < c:
        raise ValueError(f"{what}: blank_id {blank_id} outside [0, {c})")
    ints = {"logit_len": logit_len, "labels": labels, "label_len": label_len}
    for name, x in ints.items():
        if x.device != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, logits on {dev}")
        if x.dtype.is_floating_point or x.dtype == torch.bool:
            raise ValueError(f"{what}: {name} must be an integer tensor, got {x.dtype}")
    if labels.dim() != 2 or labels.shape[0] != b:
        raise ValueError(f"{what}: labels must be [B, U], got {tuple(labels.shape)}")
    for name in ("logit_len", "label_len"):
        if tuple(ints[name].shape) != (b,):
            raise ValueError(f"{what}: {name} must be [B], got {tuple(ints[name].shape)}")
    return (logit_len.to(torch.int32).contiguous(), labels.to(torch.int32).contiguous(),
            label_len.to(torch.int32).contiguous())


def _launch(what, fn_name, logits, logit_len, labels, label_len, blank_id, outs):
    lib = build.load_library()
    b, t, c = logits.shape
    u = labels.shape[1]
    s = 2 * u + 1
    loss = torch.empty((b,), dtype=torch.float32, device=logits.device)
    stats = torch.empty((b, t, 2), dtype=torch.float32, device=logits.device)
    ws = torch.empty((b, 3 * s), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = getattr(lib, fn_name)(
            logits.data_ptr(), labels.data_ptr(), logit_len.data_ptr(), label_len.data_ptr(),
            loss.data_ptr(), *(o.data_ptr() for o in outs), stats.data_ptr(), ws.data_ptr(),
            b, t, c, u, int(blank_id), stream,
        )
    build.check(lib, code, what)
    return loss


def ctc_loss_fwd_bwd(logits, logit_len, labels, label_len, blank_id: int):
    """Kernel #5: ``(loss [B], grad [B, T, C])``, the gradient of ``loss.sum()``."""
    logit_len, labels, label_len = _prepare("ctc_loss", logits, logit_len, labels, label_len,
                                            blank_id)
    if logits.device.type == "cpu":
        return ctc_loss_plain(logits, logit_len, labels, label_len, blank_id)
    b, t, c = logits.shape
    grad = torch.empty_like(logits)
    gamma = torch.empty((b, t, 2 * labels.shape[1] + 1), dtype=torch.float32,
                        device=logits.device)
    loss = _launch("ctc_loss", "ctc_loss_fwd_bwd", logits, logit_len, labels, label_len,
                   blank_id, (grad, gamma))
    ctc_loss_fwd_bwd.launches += 1
    return loss, grad


ctc_loss_fwd_bwd.launches = 0


def ctc_loss_fwd_only(logits, logit_len, labels, label_len, blank_id: int):
    """Kernel #6: the loss [B] alone."""
    logit_len, labels, label_len = _prepare("ctc_loss_fwd_only", logits, logit_len, labels,
                                            label_len, blank_id)
    if logits.device.type == "cpu":
        return ctc_loss_fwd_only_plain(logits, logit_len, labels, label_len, blank_id)
    loss = _launch("ctc_loss_fwd_only", "ctc_loss_fwd_only", logits, logit_len, labels,
                   label_len, blank_id, ())
    ctc_loss_fwd_only.launches += 1
    return loss


ctc_loss_fwd_only.launches = 0


class CTCLoss(torch.autograd.Function):
    """Loss with the gradient kept from the fused forward (``_ctc_vjp_*``)."""

    @staticmethod
    def forward(ctx, logits, logit_len, labels, label_len, blank_id):
        loss, grad = ctc_loss_fwd_bwd(logits, logit_len, labels, label_len, blank_id)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None, None] * grad, None, None, None, None


class _NoGrad(torch.autograd.Function):
    """Identity on the loss whose backward raises (the loss-only kernel)."""

    @staticmethod
    def forward(ctx, loss, logits):
        return loss.clone()

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "ctc_loss(need_grad=False) has no gradient; pass need_grad=True to train"
        )


def ctc_loss(logits, logit_len, labels, label_len, blank_id: int | None = None,
             impl: str = "auto", need_grad: bool = True):
    """Per-utterance negative log-likelihood [B]; ``blank_id`` defaults to C-1."""
    if impl != "auto":
        raise NotImplementedError(
            f"ctc impl {impl!r} is not ported; the port has the fused kernels only ('auto')"
        )
    if blank_id is None:
        blank_id = logits.shape[-1] - 1
    if need_grad:
        return CTCLoss.apply(logits, logit_len, labels, label_len, blank_id)
    loss = ctc_loss_fwd_only(logits.detach(), logit_len, labels, label_len, blank_id)
    if torch.is_grad_enabled() and logits.requires_grad:
        return _NoGrad.apply(loss, logits)
    return loss
