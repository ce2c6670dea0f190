"""Rounding points of a compute type, as autograd nodes on float32 tensors.

``Q(x)`` rounds a value where the configuration's compute type stores it,
and its backward rounds the cotangent the same way, as a value of that type
receives its gradient (the cotangent of a bf16 tensor is bf16). Everything
between two rounding points is float32 arithmetic.

- ``"float32"``: no rounding.
- ``"bfloat16"``: round to nearest even bf16.
- ``"float8"``: the control's step below bf16: fp8 e4m3 with one scale per
  tensor (its largest magnitude maps to 448), as fp8 training scales.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUND = {"float32": None, "bfloat16": _bf16, "float8": _fp8}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Quant:
    """The rounding of one compute type: ``q(x)`` for a value with its
    cotangent rounded in the backward, ``q.value(x)`` for a value alone."""

    def __init__(self, kind: str):
        if kind not in ROUND:
            raise ValueError(f"unknown compute type {kind!r}; expected one of {sorted(ROUND)}")
        self.kind = kind
        self._fn = ROUND[kind]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._fn is None else _Round.apply(x, self._fn)

    def value(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._fn is None else self._fn(x)
