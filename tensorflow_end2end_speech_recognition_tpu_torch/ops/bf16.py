"""bf16 matrix products with float32 accumulation (``compute_dtype: bfloat16``).

The JAX package's bf16 mode writes ``jnp.matmul(x.astype(bf16),
w.astype(bf16), preferred_element_type=jnp.float32)``: both operands
rounded to bf16, every product and sum in float32, a float32 result
(``models/rnn.py`` ``bidirectional_scan``, ``models/conformer.py``
``_dense`` and its einsums). ``matmul`` is that product with its gradient,
formed as JAX's transpose forms it: the float32 cotangent times the other
bf16 operand, products and sums in float32, and only the result rounded to
bf16, the operand's type.

These are plain products outside any kernel, as the JAX package leaves
them to XLA. On a CUDA tensor ``mm_f32`` is one cuBLAS call with a float32
output (``torch.mm`` / ``torch.bmm`` with ``out_dtype``); on the CPU, where
that overload has no kernel, the bf16 values are upcast first, which gives
the same exact products summed in float32. A gradient's product of the
float32 cotangent with a bf16 operand is exact float32 arithmetic on the
CPU; on the card the cotangent is split once per backward into two bf16
parts, ``hi = g.bf16()`` and ``lo = (g - hi).bf16()`` (``cotangent_parts``),
and their bf16 products are summed in float32, so every product stays on
the bf16 tensor cores. The split drops the cotangent's bits below 2**-17 of
each entry, far below the result's bf16 rounding (2**-9). A caller that
rounds the product to bf16 itself (``BiLSTM``'s ``xproj``) gets a
bf16-exact cotangent back and says so (``bf16_cotangent``): ``hi`` alone.
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 tensors (``torch.matmul`` broadcasting), float32
    products and sums, a float32 result; no gradient."""
    if a.dtype != BF16 or b.dtype != BF16:
        raise ValueError(f"mm_f32 takes bf16 operands, got {a.dtype} and {b.dtype}")
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if a.dim() == 2 and b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    if b.dim() == 2:  # [..., K] @ [K, N]: one product over the flattened rows
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(*batch, a.shape[-2], b.shape[-1])


def cotangent_parts(g: torch.Tensor, exact: bool = False) -> tuple:
    """A float32 cotangent as the parts ``_mm_sum`` multiplies: on the card
    two bf16 tensors ``hi + lo`` that sum to it within 2**-17 of each entry,
    or ``hi`` alone when ``exact`` (the caller knows ``g`` is bf16-exact);
    on the CPU ``g`` itself."""
    if g.device.type != "cuda":
        return (g,)
    hi = g.to(BF16)
    return (hi,) if exact else (hi, (g - hi).to(BF16))  # g - hi: a float32 difference


def _mm_sum(xs: tuple, ys: tuple) -> torch.Tensor:
    """``sum(x) @ sum(y)`` of bf16 parts (``mm_f32`` of each pair, summed in
    float32); on the CPU, one part each, the float32 product."""
    if xs[0].device.type != "cuda":
        return torch.matmul(xs[0].float(), ys[0].float())
    out, *rest = (mm_f32(x, y) for x in xs for y in ys)
    for p in rest:
        out += p
    return out


class _Matmul(torch.autograd.Function):
    """``mm_f32`` of two bf16 operands, with bf16 gradients formed from the
    float32 cotangent."""

    @staticmethod
    def forward(ctx, a, b, bf16_cotangent):
        ctx.save_for_backward(a, b)
        ctx.bf16_cotangent = bf16_cotangent
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gs = cotangent_parts(g.float(), ctx.bf16_cotangent)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_sum(gs, (b.transpose(-1, -2),)).sum_to_size(a.shape).to(BF16)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                db = _mm_sum((a.reshape(-1, a.shape[-1]).t(),),
                             tuple(x.reshape(-1, x.shape[-1]) for x in gs))
            else:
                db = _mm_sum((a.transpose(-1, -2),), gs).sum_to_size(b.shape)
            db = db.to(BF16)
        return da, db, None


def matmul(x: torch.Tensor, w: torch.Tensor, bf16_cotangent: bool = False) -> torch.Tensor:
    """``x @ w`` with both rounded to bf16 and a float32 result (the JAX
    package's ``preferred_element_type=jnp.float32`` product at bf16);
    the gradients of float32 operands come back as float32 tensors.
    ``bf16_cotangent``: the caller rounds the result to bf16 (after adding a
    float32 bias, as ``BiLSTM`` forms its bf16 ``xproj``), so the cotangent
    that comes back is bf16-exact and each gradient takes one bf16 product."""
    return _Matmul.apply(x.to(BF16), w.to(BF16), bf16_cotangent)


def linear(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``x @ w``: float32 operands as they are, or ``matmul`` when ``bf16``."""
    return matmul(x, w) if bf16 else torch.matmul(x, w)
