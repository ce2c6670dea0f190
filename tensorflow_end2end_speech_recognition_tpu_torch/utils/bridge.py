"""Weights across the two packages: JAX parameter pytree <-> ``state_dict``.

The port's modules mirror the JAX pytree (``models/ctc.py``), so a tree
``{"encoder": {"layers": [{"fwd": {"wx", "wh", "b"}, ...}, ...]}, "head":
{"w", "b"}}`` maps to ``state_dict`` keys by joining its path with dots
(list positions become indices). Arrays cross as numpy, so neither side
imports the other's framework. Every load is strict: an unknown, missing or
misshapen key raises.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a.0.b": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_tree(flat: dict[str, np.ndarray]):
    """Inverse of ``flatten_tree``: integer path parts become list positions."""
    root: dict = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            if sorted(int(k) for k in node) != list(range(len(node))):
                raise KeyError(f"non-contiguous list positions {sorted(node)}")
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def check_state_dict(model: nn.Module, state: dict) -> None:
    """Raise unless ``state`` has exactly the model's keys and shapes."""
    want = model.state_dict()
    unknown = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if unknown or missing:
        raise KeyError(f"weights do not match the model: unknown {unknown}, missing {missing}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(
                f"weight {k!r} has shape {tuple(v.shape)}, the model expects {tuple(want[k].shape)}"
            )


def params_from_jax(tree, model: nn.Module) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (of numpy arrays) -> ``state_dict`` for ``model``."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flatten_tree(tree).items()}
    check_state_dict(model, state)
    return state


def params_to_jax(state: dict[str, torch.Tensor]):
    """``state_dict`` -> JAX parameter pytree of numpy arrays."""
    return unflatten_tree({k: v.detach().cpu().numpy() for k, v in state.items()})


def save_weights(path, state: dict[str, torch.Tensor]) -> None:
    """Write a ``state_dict`` as ``.npz`` (flat dotted keys) or, otherwise, ``torch.save``."""
    path = Path(path)
    if path.suffix == ".npz":
        np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state.items()})
    else:
        torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def load_weights(path, model: nn.Module) -> nn.Module:
    """Load ``.npz`` or ``torch.save`` weights into ``model``, strictly."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            state = {k: torch.from_numpy(z[k]) for k in z.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    check_state_dict(model, state)
    model.load_state_dict(state)
    return model


def adam_state_from_jax(opt_state, model: nn.Module) -> dict:
    """optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) -> the port's Adam state.

    ``opt_state`` is the state of ``build_optimizer("adam", ...)`` in the JAX
    package: the Adam state alone, or a tuple (the clip chain) holding it.
    The moments are parameter pytrees and map as ``params_from_jax`` maps
    weights; arrays must already be numpy.
    """
    states = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    for s in states:
        if all(hasattr(s, f) for f in ("count", "mu", "nu")):
            return {"count": torch.tensor(int(np.asarray(s.count)), dtype=torch.int32),
                    "mu": params_from_jax(s.mu, model), "nu": params_from_jax(s.nu, model)}
    raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
