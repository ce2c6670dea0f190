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
no fallback. ``ctc_plan`` lays them out (lanes per thread, chain warps, the
gradient pass's frames per block, scratch). ``ctc_loss_fwd_bwd.launches``
and ``ctc_loss_fwd_only.launches`` count calls that launched the kernels
(three device launches for #5, two for #6). Only ``impl="auto"`` exists in
the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build

_NEG = -1e30

MAX_SMEM = 232448  # bytes of shared memory a Hopper block may use
STATIC_SMEM = 1024  # of which a chain block keeps for its barriers and edge lanes
CHAIN_K = (1, 2, 3, 4, 6, 8)  # lattice lanes per thread the chain kernels take
WARPS_K = 2  # lanes per thread a chain aims at: a step's lse3 chains per thread
MAX_CHAIN_WARPS = 16  # widest chain block; the global route's block
FRAME_WARPS = 8  # frames per block of the frame pass
CHUNK = 32  # chain steps per bulk copy of lpz rows (and per bulk store of new rows)
RING_CHUNKS = 3  # chunks of lpz rows in a chain's ring: two copies ahead of the chain
STAGE_CHUNKS = 2  # chunks of new rows on their way out (training)
GRAD_FRAMES = 32  # frames per block of the gradient pass, where they fit (a lane each)


class CtcPlan(NamedTuple):
    """Layout of kernels #5 and #6 (``ctc_plan``)."""

    route: str  # "one_warp", "warps" (named barrier) or "global" (rows in ws)
    lanes_per_thread: int  # K, consecutive lattice lanes in a thread's registers (0: global)
    chain_warps: int  # warps of a chain block
    chain_blocks: int  # alpha blocks (eval); alpha and beta blocks (training)
    chunk: int  # D, chain steps per bulk copy of lpz rows (and per bulk store of rows)
    chain_smem_bytes: int  # a chain block's rings: lpz rows in, (training) new rows out
    lane_stride: int  # Sp, S rounded up to 4 floats: the row stride of lpz and rows
    frame_blocks: int  # the frame pass: a warp per frame, and a list block per utterance
    grad_frames: int  # frames per block of the gradient pass (tiles of one utterance)
    grad_blocks: int
    grad_smem_bytes: int  # exp(min(gamma, 40)) of each (frame, lane), and the lane list
    lpz_floats: int  # lpz rows [B, T, Sp]
    row_floats: int  # alpha and beta rows [2, B, T, Sp] (training)
    ws_floats: int  # running rows of the global route [B, 2, 2, S]


def ctc_plan(b: int, t: int, s: int, grad: bool = True, lanes: int = WARPS_K) -> CtcPlan:
    """Lanes per thread, chain warps, grids and scratch of one call at S = 2U+1 lanes.

    A chain aims at ``lanes`` lattice lanes per thread. A row of up to
    ``32 lanes`` lanes is one warp's, K the smallest in ``CHAIN_K`` that
    covers it, and steps with shuffles alone. A wider row is split over
    ``ceil(S / (32 lanes))`` warps, at most ``MAX_CHAIN_WARPS``, that meet
    at a named barrier each step, K the smallest that covers it (``lanes``
    while 16 warps do, then more); past ``32 MAX_CHAIN_WARPS CHAIN_K[-1]``
    lanes the running rows live in global memory (``ws``). A step's time is
    about that of K interleaved lse3 chains, so few lanes per thread and more
    warps walk faster (``probes/ctc_chain_step.py`` times the layouts of
    ``lanes`` = 2, 3, 4). ``grad=False`` (kernel #6) has no beta blocks, rows
    or gradient pass. ``csrc/ctc_loss.cu`` refuses a plan that differs from
    its own reckoning of the sizes and grids.
    """
    if b <= 0 or t <= 0 or s <= 0 or s % 2 == 0:
        raise ValueError(f"ctc_plan: bad shape B={b} T={t} S={s} (S = 2U+1 lanes)")
    if lanes not in CHAIN_K or lanes < 2:
        raise ValueError(f"ctc_plan: lanes={lanes} is not one of {CHAIN_K[1:]}")
    if s <= 32 * lanes:
        route, warps = "one_warp", 1
    elif s <= 32 * MAX_CHAIN_WARPS * CHAIN_K[-1]:
        route, warps = "warps", min(MAX_CHAIN_WARPS, -(-s // (32 * lanes)))
    else:
        route, warps = "global", MAX_CHAIN_WARPS
    k = 0 if route == "global" else next(k for k in CHAIN_K if 32 * warps * k >= s)
    grad_frames = min(GRAD_FRAMES, (MAX_SMEM // 4 - s) // s) if grad else 0
    if grad and grad_frames < 1:
        raise ValueError(f"ctc_plan: S={s} lanes of one frame do not fit shared memory")
    frames, sp = b * t, -(-s // 4) * 4
    # the rings: chunks of D rows of Sp floats, and the slack of one row of
    # every thread's lanes after each
    width, n = 32 * warps * k, RING_CHUNKS + (STAGE_CHUNKS if grad else 0)
    d = 0 if route == "global" else min(CHUNK, ((MAX_SMEM - STATIC_SMEM) // 4 - 2 * width) //
                                        (n * sp))
    if route != "global" and d < 1:
        raise ValueError(f"ctc_plan: S={s} lanes do not fit a chain's rings")
    ring = 4 * (n * d * sp + 2 * width) if d else 0
    return CtcPlan(
        route, k, warps, b * (2 if grad else 1), d, ring, sp,
        -(-frames // FRAME_WARPS) + (b if grad else 0),
        grad_frames, b * -(-t // grad_frames) if grad else 0,
        4 * (grad_frames + 1) * s if grad else 0, frames * sp, 2 * frames * sp if grad else 0,
        4 * b * s if route == "global" else 0)


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
    """Check the inputs; return float32 logits (bf16 ones cast, as
    ``ctc_loss_pallas`` casts them in its call's arguments) and int32
    labels and lengths on the logits' device."""
    dev = logits.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if logits.dtype == torch.bfloat16:
        logits = logits.float()
    if logits.dtype != torch.float32:
        raise ValueError(f"{what}: logits must be float32 or bfloat16, got {logits.dtype}")
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
    return (logits, logit_len.to(torch.int32).contiguous(), labels.to(torch.int32).contiguous(),
            label_len.to(torch.int32).contiguous())


def _launch(what, fn_name, plan, logits, logit_len, labels, label_len, blank_id, grad=None):
    """Kernel #5 (``grad`` given, written in place) or #6 laid out by ``plan``; the loss."""
    lib = build.load_library()
    b, t, c = logits.shape
    u = labels.shape[1]
    f32 = dict(dtype=torch.float32, device=logits.device)
    loss = torch.empty((b,), **f32)
    stats = torch.empty((b, t, 2), **f32)
    lpz = torch.empty((plan.lpz_floats,), **f32)
    ws = torch.empty((plan.ws_floats,), **f32)
    tail = (plan.lanes_per_thread, plan.chain_warps, plan.chunk, plan.lane_stride,
            plan.chain_smem_bytes, plan.frame_blocks, plan.chain_blocks)
    if grad is None:
        outs = (loss, stats, lpz, ws)
    else:
        rows = torch.empty((plan.row_floats,), **f32)
        lanes = torch.empty((b, 2 * u + 1), dtype=torch.int32, device=logits.device)
        offs = torch.empty((b, c + 1), dtype=torch.int32, device=logits.device)
        outs = (loss, grad, rows, stats, lpz, lanes, offs, ws)
        tail += (plan.grad_frames, plan.grad_smem_bytes, plan.grad_blocks)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        code = getattr(lib, fn_name)(
            logits.data_ptr(), labels.data_ptr(), logit_len.data_ptr(), label_len.data_ptr(),
            *(o.data_ptr() for o in outs), b, t, c, u, int(blank_id), *tail, stream,
        )
    build.check(lib, code, what)
    return loss


def ctc_loss_fwd_bwd(logits, logit_len, labels, label_len, blank_id: int):
    """Kernel #5: ``(loss [B], grad [B, T, C])``, the gradient of ``loss.sum()``."""
    logits, logit_len, labels, label_len = _prepare("ctc_loss", logits, logit_len, labels,
                                                    label_len, blank_id)
    if logits.device.type == "cpu":
        return ctc_loss_plain(logits, logit_len, labels, label_len, blank_id)
    grad = torch.empty_like(logits)
    plan = ctc_plan(*logits.shape[:2], 2 * labels.shape[1] + 1)
    loss = _launch("ctc_loss", "ctc_loss_fwd_bwd", plan, logits, logit_len, labels, label_len,
                   blank_id, grad)
    ctc_loss_fwd_bwd.launches += 1
    return loss, grad


ctc_loss_fwd_bwd.launches = 0


def ctc_loss_fwd_only(logits, logit_len, labels, label_len, blank_id: int):
    """Kernel #6: the loss [B] alone."""
    logits, logit_len, labels, label_len = _prepare("ctc_loss_fwd_only", logits, logit_len,
                                                    labels, label_len, blank_id)
    if logits.device.type == "cpu":
        return ctc_loss_fwd_only_plain(logits, logit_len, labels, label_len, blank_id)
    plan = ctc_plan(*logits.shape[:2], 2 * labels.shape[1] + 1, grad=False)
    loss = _launch("ctc_loss_fwd_only", "ctc_loss_fwd_only", plan, logits, logit_len, labels,
                   label_len, blank_id)
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
    """Per-utterance negative log-likelihood [B]; ``blank_id`` defaults to C-1.

    bf16 logits are cast to float32 before the kernels (``_prepare``); their
    gradient comes back bf16.
    """
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


def ctc_posteriors(logits: torch.Tensor) -> torch.Tensor:
    """Per-frame class posteriors (the reference's ``posteriors()`` op), float32."""
    return torch.softmax(logits.float(), dim=-1)
