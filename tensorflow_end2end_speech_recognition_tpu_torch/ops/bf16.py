"""bf16 matrix products with float32 accumulation (``compute_dtype: bfloat16``).

The JAX package's bf16 mode writes ``jnp.matmul(x.astype(bf16),
w.astype(bf16), preferred_element_type=jnp.float32)``: both operands
rounded to bf16, every product and sum in float32, a float32 result
(``models/rnn.py`` ``bidirectional_scan``, ``models/conformer.py``
``_dense`` and its einsums). ``matmul`` is that product with its gradient:
the operands' gradients are formed the same way from the cotangent rounded
to bf16, and come back rounded to bf16, as JAX's transpose of a bf16
``dot_general`` converts them to the operands' type. The reference keeps
the cotangent in float32 inside its products; rounding it lets the card
run all three products on the bf16 tensor cores.

These are plain products outside any kernel, as the JAX package leaves
them to XLA. On a CUDA tensor ``mm_f32`` is one cuBLAS call with a float32
output (``torch.mm`` / ``torch.bmm`` with ``out_dtype``); on the CPU, where
that overload has no kernel, the bf16 values are upcast first, which gives
the same exact products summed in float32.
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


class _Matmul(torch.autograd.Function):
    """``mm_f32`` of two bf16 operands, with bf16 gradients."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(BF16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = mm_f32(g, b.transpose(-1, -2)).sum_to_size(a.shape).to(BF16)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                db = mm_f32(a.reshape(-1, a.shape[-1]).t(), g.reshape(-1, g.shape[-1]))
            else:
                db = mm_f32(a.transpose(-1, -2), g).sum_to_size(b.shape)
            db = db.to(BF16)
        return da, db


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both rounded to bf16 and a float32 result (the JAX
    package's ``preferred_element_type=jnp.float32`` product at bf16);
    the gradients of float32 operands come back as float32 tensors."""
    return _Matmul.apply(x.to(BF16), w.to(BF16))


def linear(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> torch.Tensor:
    """``x @ w``: float32 operands as they are, or ``matmul`` when ``bf16``."""
    return matmul(x, w) if bf16 else torch.matmul(x, w)
