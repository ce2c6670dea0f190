"""One location-aware (or hybrid) attention read, fused.

Counterpart of ``location_attend_pallas`` in
``tensorflow_end2end_speech_recognition_tpu/ops/pallas/attention_kernel.py``
(and of ``_reference_math`` there, which restates it in plain XLA):

    location_attend(keys [U, T, A] or None, enc_out [U, T, He], q [N, A],
                    prev_align [N, T], enc_mask [U, T] bool, conv_w [W, 1, C],
                    w_loc [C, A], v [A], sharpening, *, b [A] or None, group=G)
        -> (ctx [N, He], align [N, T])

with N = U * G: row n reads utterance n // G, so the beam's G rows of one
utterance share its encoder output and keys instead of G copies of them.
The reference's ``keys_in`` is ``keys + b`` (``keys = enc_out @ W_enc``),
or ``b`` broadcast for a pure location scorer (``keys=None``), tiled G
times; ``q = dec_state @ W_dec``. The location features are a SAME
convolution of ``prev_align`` with the W taps, ``(W-1)//2`` of them on the
left even for an even W; then ``pre = ((keys + b) + f @ w_loc) + q``,
``e = tanh(pre) @ v * sharpening``, an additive -1e30 on masked frames,
``align = softmax_T(e)`` and ``ctx = align @ enc_out``. A row with no valid
frame (a micro-batcher's filler row) gets ``align = 1/T`` everywhere, as
``_reference_math`` gives it.

``enc_out`` may be bf16 (``compute_dtype: bfloat16``: the reference's
encoder emits bf16 and its kernel reads the bf16 rows); every other float
input is float32, and ``ctx`` and ``align`` are float32 either way, as the
Pallas kernel's ``out_shape`` is. The plain version widens the rows to
float32, which is exact, and the kernel widens each value where it loads it.

CPU tensors take ``location_attend_plain``. CUDA tensors launch the
hand-written kernel ``csrc/location_attend.cu`` (its energies and its
softmax-and-context passes, two launches on the stream; the C entry
``location_attend_bf16`` for bf16 rows) or raise; there is no fallback.
``location_attend.launches`` counts calls that launched it on float32 rows,
``location_attend.launches_bf16`` on bf16 rows.
When a gradient may be taken the read goes through ``LocationAttend``:
the forward is the kernel, and the backward recomputes
``location_attend_plain`` under autograd and takes its vector-Jacobian
product, as the reference's ``_fused_bwd`` takes ``jax.vjp`` of
``_reference_math``. So the backward is plain arithmetic on either device,
as the reference's is plain XLA; bf16 rows get a bf16 gradient, the float32
one rounded, as the transpose of their promotion to float32 gives it.
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


def location_attend_plain(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                          sharpening: float = 1.0, *, b=None, group: int = 1):
    """Plain version of kernel #7: ``keys + b``, tiled ``group`` times, then
    ``_reference_math`` in PyTorch on ``enc_out`` widened to float32."""
    enc_out = enc_out.float()
    if keys is None:
        keys_in = b.expand(enc_out.shape[:2] + b.shape)
    else:
        keys_in = keys if b is None else keys + b
    if group > 1:
        keys_in, enc_out, enc_mask = (x.repeat_interleave(group, dim=0)
                                      for x in (keys_in, enc_out, enc_mask))
    f = conv_same(prev_align, conv_w)
    pre = keys_in + torch.matmul(f, w_loc)
    pre = pre + q[:, None, :]
    e = torch.matmul(torch.tanh(pre), v) * sharpening
    e = e + torch.where(enc_mask, 0.0, _NEG)
    align = torch.softmax(e, dim=-1)
    ctx = torch.bmm(align[:, None, :], enc_out)[:, 0]
    return ctx, align


def _check_inputs(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v, b, group) -> None:
    what = "location_attend"
    floats = {"keys": keys, "enc_out": enc_out, "q": q, "prev_align": prev_align,
              "conv_w": conv_w, "w_loc": w_loc, "v": v, "b": b}
    floats = {name: x for name, x in floats.items() if x is not None}
    dev = enc_out.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if keys is None and b is None:
        raise ValueError(f"{what}: keys and b are both None")
    if not isinstance(group, int) or group < 1:
        raise ValueError(f"{what}: group must be a positive int, got {group!r}")
    for name, x in {**floats, "enc_mask": enc_mask}.items():
        if x.device != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, enc_out on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, x in floats.items():
        if x.dtype != torch.float32 and not (name == "enc_out" and x.dtype == torch.bfloat16):
            raise ValueError(f"{what}: {name} must be float32"
                             + (" or bfloat16" if name == "enc_out" else "") + f", got {x.dtype}")
    if enc_mask.dtype != torch.bool:
        raise ValueError(f"{what}: enc_mask must be bool, got {enc_mask.dtype}")
    if enc_out.dim() != 3 or q.dim() != 2 or conv_w.dim() != 3 or conv_w.shape[1] != 1:
        raise ValueError(f"{what}: enc_out must be [U, T, He], q [N, A] and conv_w [W, 1, C], "
                         f"got {tuple(enc_out.shape)}, {tuple(q.shape)} and "
                         f"{tuple(conv_w.shape)}")
    u, t, he = enc_out.shape
    n, a = q.shape
    w, _, c = conv_w.shape
    if n % group != 0 or n // group != u:
        raise ValueError(f"{what}: {n} rows of q in groups of {group} do not match the {u} "
                         "utterances of enc_out")
    want = {"keys": (u, t, a), "prev_align": (n, t), "enc_mask": (u, t), "w_loc": (c, a),
            "v": (a,), "b": (a,)}
    for name, shape in want.items():
        x = enc_mask if name == "enc_mask" else floats.get(name)
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(x.shape)}, expected {shape}")
    if 0 in (n, t, a, he, w, c):
        raise ValueError(f"{what}: empty input: enc_out {tuple(enc_out.shape)}, q "
                         f"{tuple(q.shape)}, conv_w {tuple(conv_w.shape)}")


def location_attend_fwd(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                        sharpening: float = 1.0, b=None, group: int = 1):
    """Kernel #7's forward on inputs ``_check_inputs`` accepted: the plain
    version for CPU tensors, else one call of the kernel (its bf16 entry for
    bf16 rows), counted."""
    if enc_out.device.type == "cpu":
        return location_attend_plain(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                                     sharpening, b=b, group=group)
    lib = build.load_library()
    dev = enc_out.device
    t, he = enc_out.shape[1:]
    n, a = q.shape
    w, _, c = conv_w.shape
    ctx = torch.empty((n, he), dtype=torch.float32, device=dev)
    align = torch.empty((n, t), dtype=torch.float32, device=dev)
    energies = torch.empty((n, t), dtype=torch.float32, device=dev)  # scratch
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    bf16 = enc_out.dtype == torch.bfloat16
    entry = "location_attend_bf16" if bf16 else "location_attend"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(
            ptr(keys), ptr(b), enc_out.data_ptr(), q.data_ptr(), prev_align.data_ptr(),
            enc_mask.data_ptr(), conv_w.data_ptr(), w_loc.data_ptr(), v.data_ptr(),
            ctx.data_ptr(), align.data_ptr(), energies.data_ptr(),
            n, group, t, a, he, c, w, float(sharpening), stream,
        )
    build.check(lib, code, entry)
    if bf16:
        location_attend.launches_bf16 += 1
    else:
        location_attend.launches += 1
    return ctx, align


def location_attend_bwd(saved, needs, sharpening: float, group: int, g_ctx, g_align):
    """The gradients of ``LocationAttend``: autograd through
    ``location_attend_plain`` recomputed on the ``saved`` inputs (keys,
    enc_out, q, prev_align, enc_mask, conv_w, w_loc, v, b), for the floats
    whose entry of ``needs`` is true; None for the others."""
    keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v, b = saved
    floats = [keys, enc_out, q, prev_align, conv_w, w_loc, v, b]
    leaves = [None if x is None else x.detach().requires_grad_(need)
              for x, need in zip(floats, needs)]
    with torch.enable_grad():
        k, e, qq, p, cw, wl, vv, bb = leaves
        outs = location_attend_plain(k, e, qq, p, enc_mask, cw, wl, vv, sharpening, b=bb,
                                     group=group)
        # align does not depend on enc_out: with only enc_out's gradient
        # needed, ctx alone carries one
        outs, cts = zip(*((o, g) for o, g in zip(outs, (g_ctx, g_align)) if o.requires_grad))
        grads = iter(torch.autograd.grad(outs, [x for x, need in zip(leaves, needs) if need],
                                         cts))
    return [next(grads) if need else None for need in needs]


class LocationAttend(torch.autograd.Function):
    """Kernel #7 with its gradient: the kernel forward, the plain backward."""

    @staticmethod
    def forward(ctx, keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v, sharpening,
                b, group):
        ctx.save_for_backward(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v, b)
        ctx.sharpening, ctx.group = sharpening, group
        return location_attend_fwd(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                                   sharpening, b, group)

    @staticmethod
    def backward(ctx, g_ctx, g_align):
        n = ctx.needs_input_grad
        needs = (*n[:4], *n[5:8], n[9])  # every float input; not enc_mask
        dk, de, dq, dp, dcw, dwl, dv, db = location_attend_bwd(
            ctx.saved_tensors, needs, ctx.sharpening, ctx.group, g_ctx, g_align)
        return dk, de, dq, dp, None, dcw, dwl, dv, None, db, None


def location_attend(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                    sharpening: float = 1.0, *, b=None, group: int = 1):
    """Kernel #7: ``(ctx [N, He], align [N, T])``; see the module docstring.

    Goes through ``LocationAttend`` when autograd may need a gradient;
    otherwise (serving, decoding) runs the forward alone.
    """
    _check_inputs(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v, b, group)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (keys, enc_out, q, prev_align, conv_w, w_loc, v, b)):
        return LocationAttend.apply(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                                    sharpening, b, group)
    return location_attend_fwd(keys, enc_out, q, prev_align, enc_mask, conv_w, w_loc, v,
                               sharpening, b, group)


location_attend.launches = 0
location_attend.launches_bf16 = 0
