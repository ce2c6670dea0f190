"""One location-aware (or hybrid) attention read, fused.

Counterpart of ``location_attend_pallas`` in
``tensorflow_end2end_speech_recognition_tpu/ops/pallas/attention_kernel.py``
(and of ``_reference_math`` there, which restates it in plain XLA):

    location_attend(keys_in [N, T, A], enc_out [N, T, He], q [N, A],
                    prev_align [N, T], enc_mask [N, T] bool, conv_w [W, 1, C],
                    w_loc [C, A], v [A], sharpening) -> (ctx [N, He], align [N, T])

``keys_in`` is ``enc_out @ W_enc + b`` (or ``b`` broadcast for a pure
location scorer) and ``q = dec_state @ W_dec``. The location features are a
SAME convolution of ``prev_align`` with the W taps, ``(W-1)//2`` of them on
the left even for an even W; then ``pre = keys_in + f @ w_loc + q``,
``e = tanh(pre) @ v * sharpening``, an additive -1e30 on masked frames,
``align = softmax_T(e)`` and ``ctx = align @ enc_out``. A row with no valid
frame (a micro-batcher's filler row) gets ``align = 1/T`` everywhere, as
``_reference_math`` gives it.

CPU tensors take ``location_attend_plain``. CUDA tensors launch the
hand-written kernel ``csrc/location_attend.cu`` (its energies and its
softmax-and-context passes, two launches on the stream) or raise; there is
no fallback. ``location_attend.launches`` counts calls that launched it. The
kernel has no backward yet (the reference's ``_fused_bwd``, ``jax.vjp`` of
``_reference_math``; attention training is not ported), so a CUDA call
raises when grad is enabled and an input requires grad, instead of
returning outputs with no ``grad_fn``; the plain version on the CPU is
differentiable.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

_NEG = -1e30


def conv_same(prev_align: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """[N, T] alignments, [W, 1, C] taps -> location features [N, T, C].

    Cross-correlation with SAME padding, ``(W-1)//2`` zeros on the left, as
    ``lax.conv_general_dilated(..., padding="SAME")`` pads.
    """
    w = conv_w.shape[0]
    left = (w - 1) // 2
    x = F.pad(prev_align[:, None, :], (left, w - 1 - left))
    return F.conv1d(x, conv_w.permute(2, 1, 0)).transpose(1, 2)


def location_attend_plain(keys_in, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                          sharpening: float = 1.0):
    """Plain version of kernel #7: ``_reference_math`` in PyTorch."""
    f = conv_same(prev_align, conv_w)
    pre = keys_in + torch.matmul(f, w_loc)
    pre = pre + q[:, None, :]
    e = torch.matmul(torch.tanh(pre), v) * sharpening
    e = e + torch.where(enc_mask, 0.0, _NEG)
    align = torch.softmax(e, dim=-1)
    ctx = torch.bmm(align[:, None, :], enc_out)[:, 0]
    return ctx, align


def _check_inputs(keys_in, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v) -> None:
    what = "location_attend"
    floats = {"keys_in": keys_in, "enc_out": enc_out, "q": q, "prev_align": prev_align,
              "conv_w": conv_w, "w_loc": w_loc, "v": v}
    dev = keys_in.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    for name, x in {**floats, "enc_mask": enc_mask}.items():
        if x.device != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, keys_in on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, x in floats.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {x.dtype}")
    if enc_mask.dtype != torch.bool:
        raise ValueError(f"{what}: enc_mask must be bool, got {enc_mask.dtype}")
    if keys_in.dim() != 3 or conv_w.dim() != 3 or conv_w.shape[1] != 1:
        raise ValueError(f"{what}: keys_in must be [N, T, A] and conv_w [W, 1, C], got "
                         f"{tuple(keys_in.shape)} and {tuple(conv_w.shape)}")
    n, t, a = keys_in.shape
    w, _, c = conv_w.shape
    want = {"enc_out": (n, t, enc_out.shape[-1]), "q": (n, a), "prev_align": (n, t),
            "enc_mask": (n, t), "w_loc": (c, a), "v": (a,)}
    for name, shape in want.items():
        x = enc_mask if name == "enc_mask" else floats[name]
        if tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, expected {shape}")
    if enc_out.dim() != 3 or 0 in (n, t, a, w, c, enc_out.shape[-1]):
        raise ValueError(f"{what}: empty or misshapen input: keys_in {tuple(keys_in.shape)}, "
                         f"enc_out {tuple(enc_out.shape)}, conv_w {tuple(conv_w.shape)}")


def location_attend(keys_in, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                    sharpening: float = 1.0):
    """Kernel #7: ``(ctx [N, He], align [N, T])``; see the module docstring."""
    _check_inputs(keys_in, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v)
    if keys_in.device.type == "cpu":
        return location_attend_plain(keys_in, enc_out, q, prev_align, enc_mask, conv_w, w_loc,
                                     v, sharpening)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (keys_in, enc_out, q, prev_align, conv_w, w_loc, v)):
        raise NotImplementedError(
            "location_attend: the CUDA kernel has no backward (the reference's _fused_bwd is "
            "not ported); call it under torch.no_grad() or on inputs that require no grad")
    lib = build.load_library()
    dev = keys_in.device
    n, t, a = keys_in.shape
    w, _, c = conv_w.shape
    he = enc_out.shape[-1]
    ctx = torch.empty((n, he), dtype=torch.float32, device=dev)
    align = torch.empty((n, t), dtype=torch.float32, device=dev)
    energies = torch.empty((n, t), dtype=torch.float32, device=dev)  # scratch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.location_attend(
            keys_in.data_ptr(), enc_out.data_ptr(), q.data_ptr(), prev_align.data_ptr(),
            enc_mask.data_ptr(), conv_w.data_ptr(), w_loc.data_ptr(), v.data_ptr(),
            ctx.data_ptr(), align.data_ptr(), energies.data_ptr(),
            n, t, a, he, c, w, float(sharpening), stream,
        )
    build.check(lib, code, "location_attend")
    location_attend.launches += 1
    return ctx, align


location_attend.launches = 0
