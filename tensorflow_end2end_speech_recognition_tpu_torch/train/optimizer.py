"""Optimizers with global-norm clipping, as functions over dicts of tensors.

Counterpart of ``build_optimizer`` / ``apply_updates`` in
``tensorflow_end2end_speech_recognition_tpu/train/optimizer.py``, which
chains ``optax.clip_by_global_norm`` with one of ``scale_by_adam``,
``scale_by_adadelta``, ``identity``, ``trace(0.9)``, ``trace(0.9,
nesterov=True)`` or ``scale_by_rms``. The arithmetic here is optax's, with
its default constants, so one step matches it on the same gradients:

- the clip keeps ``g`` when ``||g|| < max_norm`` and otherwise scales by
  ``max_norm / ||g||`` (not ``torch.nn.utils``' ``max / (||g|| + 1e-6)``);
- Adam bias-corrects both moments by the step count and adds ``eps``
  outside the square root.

The transforms yield unscaled update directions; ``apply_updates`` applies
``p - lr * u`` so the learning rate can change every step without touching
the state. ``torch.optim`` is not used: its Adam and clip differ in these
details. Everything stays on the parameters' device; nothing syncs. Every
transform but the clip is elementwise, so with leaves split over ranks
(ZeRO-3, model or expert shards) the update runs on each rank's blocks as
it is; the clip takes the norm over the ranks (``global_norm(..., mesh,
specs)``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

OPTIMIZERS = ("adam", "adadelta", "sgd", "momentum", "nesterov", "rmsprop")

# optax's defaults (scale_by_adam, scale_by_adadelta, scale_by_rms) and the
# 0.9 decay of the reference's momentum / nesterov
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6
RMS_DECAY, RMS_EPS = 0.9, 1e-8
MOMENTUM = 0.9


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, norm_fn=global_norm)
    -> (updates, state)``, ``norm_fn`` the clip's norm (over shards under
    FSDP)."""

    init: Callable
    update: Callable


def global_norm(tree: dict, mesh=None, specs: dict | None = None) -> torch.Tensor:
    """The L2 norm over every tensor of ``tree``, float32. With ``mesh`` and
    ``specs`` that split a leaf (``parallel/``: ZeRO-3, model or expert
    shards) ``tree`` holds this rank's blocks: each leaf's squares are summed
    over exactly the axes that split it, so a replicated leaf counts once,
    not once per rank. The squares are summed in float64, so that a sharded
    step clips by the same float32 norm as the data-parallel step: float32
    sums over blocks and over whole leaves differ in their last bits, and
    Adam's first steps carry that into the weights whose gradients are near
    its epsilon."""
    def sq(x):
        return torch.linalg.vector_norm(x, dtype=torch.float64).square()

    if mesh is None or specs is None or not any(specs.values()):
        return torch.sqrt(sum(sq(x) for x in tree.values())).float()
    from ..parallel.mesh import all_reduce_flat

    zero = torch.zeros((), dtype=torch.float64, device=next(iter(tree.values())).device)
    parts = {}
    for k, x in tree.items():
        axes = mesh.split_axes(a for a in specs[k] if a is not None)
        parts[axes] = parts.get(axes, zero) + sq(x)
    total = zero
    for axes in sorted(parts):
        (part,) = all_reduce_flat(mesh.along(*axes), [parts[axes]], dtype=torch.float64)
        total = total + part
    return torch.sqrt(total).float()


def clip_by_global_norm(grads: dict, max_norm: float, norm_fn=global_norm) -> dict:
    """``optax.clip_by_global_norm``: unchanged below ``max_norm``, else
    rescaled; ``norm_fn(grads)`` is the global norm (``global_norm``)."""
    g_norm = norm_fn(grads)
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, (g / g_norm) * max_norm) for k, g in grads.items()}


def _zeros(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _moment(g, m, decay, order):
    return (1 - decay) * (g ** order) + decay * m


def _adam():
    def init(params):
        count = torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)
        return {"count": count, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state):
        mu = {k: _moment(g, state["mu"][k], ADAM_B1, 1) for k, g in grads.items()}
        nu = {k: _moment(g, state["nu"][k], ADAM_B2, 2) for k, g in grads.items()}
        count = state["count"] + 1
        c1 = 1 - ADAM_B1 ** count.to(torch.float32)
        c2 = 1 - ADAM_B2 ** count.to(torch.float32)
        updates = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS) for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _adadelta():
    def init(params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(grads, state):
        e_g = {k: _moment(g, state["e_g"][k], ADADELTA_RHO, 2) for k, g in grads.items()}
        updates = {k: (torch.sqrt(state["e_x"][k] + ADADELTA_EPS)
                       / torch.sqrt(e_g[k] + ADADELTA_EPS)) * g for k, g in grads.items()}
        e_x = {k: _moment(u, state["e_x"][k], ADADELTA_RHO, 2) for k, u in updates.items()}
        return updates, {"e_g": e_g, "e_x": e_x}

    return Optimizer(init, update)


def _sgd():
    return Optimizer(lambda params: {}, lambda grads, state: (dict(grads), {}))


def _trace(nesterov: bool):
    def init(params):
        return {"trace": _zeros(params)}

    def update(grads, state):
        trace = {k: g + MOMENTUM * state["trace"][k] for k, g in grads.items()}
        if nesterov:
            updates = {k: g + MOMENTUM * trace[k] for k, g in grads.items()}
        else:
            updates = dict(trace)
        return updates, {"trace": trace}

    return Optimizer(init, update)


def _rmsprop():
    def init(params):
        return {"nu": _zeros(params)}

    def update(grads, state):
        nu = {k: _moment(g, state["nu"][k], RMS_DECAY, 2) for k, g in grads.items()}
        return {k: torch.rsqrt(nu[k] + RMS_EPS) * g for k, g in grads.items()}, {"nu": nu}

    return Optimizer(init, update)


def build_optimizer(name: str, clip_grad_norm: float | None = 5.0) -> Optimizer:
    """Clip (when ``clip_grad_norm`` is set) then the named core transform."""
    name = name.lower()
    cores = {"adam": _adam, "adadelta": _adadelta, "sgd": _sgd, "rmsprop": _rmsprop,
             "momentum": lambda: _trace(False), "nesterov": lambda: _trace(True)}
    if name not in cores:
        raise ValueError(f"unknown optimizer {name!r}; expected one of {OPTIMIZERS}")
    core = cores[name]()

    def update(grads, state, norm_fn=global_norm):
        if clip_grad_norm:
            grads = clip_by_global_norm(grads, clip_grad_norm, norm_fn)
        return core.update(grads, state)

    return Optimizer(core.init, update)


def apply_updates(params: dict, updates: dict, lr) -> dict:
    """``p - lr * u`` for every parameter."""
    return {k: p - lr * updates[k] for k, p in params.items()}


def tree_where(cond: torch.Tensor, new, old):
    """``torch.where(cond, new, old)`` over matching nested dicts of tensors."""
    if isinstance(new, dict):
        return {k: tree_where(cond, new[k], old[k]) for k in new}
    return torch.where(cond, new, old)
