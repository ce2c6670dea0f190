"""The port's optimizers vs ``build_optimizer`` + ``apply_updates`` of the JAX package.

Three steps of each of the six optimizers on a small dict of parameters,
with the global-norm clip inactive (norm below the limit), active, and off.
Tolerance atol/rtol 1e-6 in float32: both sides run the same arithmetic in
the same order, and pow / sqrt may differ by an ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    apply_updates as japply_updates,
)
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import (
    OPTIMIZERS,
    apply_updates,
    build_optimizer,
    clip_by_global_norm,
)

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-6)


def _params_and_grads(seed):
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 0.5).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    return params, grads


def _flatten_state(state):
    """Port optimizer state -> sorted list of numpy arrays (count, then moments)."""
    if isinstance(state, dict):
        return [a for k in sorted(state) for a in _flatten_state(state[k])]
    return [state.numpy()]


@pytest.mark.parametrize("clip", [100.0, 0.5, None])  # inactive, active, off
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_three_steps_match_optax(name, clip):
    params, grads = _params_and_grads(seed=len(name))
    jopt = jbuild_optimizer(name, clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = build_optimizer(name, clip)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = opt.init(tparams)
    for i, g in enumerate(grads):
        lr = 0.1 / (i + 1)
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate,
                                      jparams)
        jparams = japply_updates(jparams, updates, lr)
        tupdates, tstate = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        tparams = apply_updates(tparams, tupdates, lr)
        for k in params:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), **TOL)
    # the state holds the same arrays: optax's leaves (Adam: count, mu, nu;
    # dict keys sorted) come in the order of the port's sorted keys
    want = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    got = _flatten_state(tstate)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_clip_is_optax_not_torch():
    g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    torch.testing.assert_close(clip_by_global_norm(g, 5.0)["a"], torch.tensor([3.0, 4.0]) * 1.0)
    torch.testing.assert_close(clip_by_global_norm(g, 6.0)["a"], g["a"])
    torch.testing.assert_close(clip_by_global_norm(g, 1.0)["a"], torch.tensor([0.6, 0.8]))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="adagrad"):
        build_optimizer("adagrad")
