"""Plain global-norm clip and Adam (optax's constants), and the guard.

The clip keeps the gradients when their global norm is below the limit and
otherwise scales them by ``limit / norm``. Adam: ``m = 0.9 m + 0.1 g``,
``v = 0.999 v + 0.001 g²``, both bias-corrected by the step count, ``u =
m̂ / (sqrt(v̂) + 1e-8)``, ``p -= lr · u``. A step whose loss is not finite
or not below 1e20 leaves the weights and the moments as they were.
"""

from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def clip(grads: dict, limit: float | None) -> dict:
    if not limit:
        return dict(grads)
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    scale = torch.where(norm < limit, torch.ones_like(norm), limit / norm)
    return {k: g * scale for k, g in grads.items()}


class Adam:
    def __init__(self, params: dict, lr: float, limit: float | None):
        self.lr, self.limit, self.count = lr, limit, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict, loss: torch.Tensor) -> tuple:
        """(new params, the clipped gradients); unchanged when the guard trips."""
        if not (torch.isfinite(loss) and loss < 1e20):
            return params, None
        g = clip(grads, self.limit)
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        out = {}
        for k, p in params.items():
            self.m[k] = B1 * self.m[k] + (1 - B1) * g[k]
            self.v[k] = B2 * self.v[k] + (1 - B2) * g[k].square()
            out[k] = p - self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + EPS)
        return out, g
