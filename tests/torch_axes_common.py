"""Shared set-up of ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_seq_expert_parallel.py`` and
``tests/test_torch_pipeline_parallel.py``: the toy conformer CTC tasks on
both sides, the seeded batch, the JAX one-device references, the jobs for
the ranks (``tests/torch_parallel_workers.py``) and the checks.

The toy: width 16, 4 heads, 2 layers, FF expansion 2, kernel 5, precomputed
features of width 10 stacked 3/3 (T = 60 frames -> T' = 20, 10 per seq rank
of 2 and 5 of 4), C = 6 classes, weight decay 1e-2; families ``absolute``,
``relative``, ``rotary`` with ``left_context`` 4 (the window and the causal
conv's 4-frame halo), and ``moe`` (4 experts, top 2, load-balance weight
0.5); for the pipeline also ``transformer`` (the pre-LN block, absolute
positions) and ``deep`` (4 conformer layers, rotary + ``left_context``).
B = 4 ragged rows, the last a filler of weight 0 and full length (a data
rank of 2 holds rows 2 and 3).

The reference of every step is the JAX package's one-device step on the
whole batch, compiled once per family: one Adam step (lr 1e-3, clip 5.0)
gives the loss, each aux term, Adam's weights and moments, and its first
moment the clipped gradient (mu / (1 - b1)), from which the SGD step's
weights (lr 0.1) follow. Tolerances, float32, as
``tests/test_torch_parallel.py``: the loss and aux terms atol 1e-4 + rtol
1e-5; SGD's weights atol 2e-5 + rtol 1e-4; Adam's weights within 0.1 lr,
its moments within 1e-3 of their largest entry + rtol 1e-3. Under
absolute and relative positions the key bias ``mhsa.k.b`` has a gradient
of 0 in exact arithmetic (a softmax is invariant to one shift of all its
scores): its computed gradient is rounding, which Adam's first step turns
into a move of up to lr either way, so that leaf is held by the SGD step
(its gradient within the SGD tolerance) and left out of the Adam check.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    params_from_jax,
)

C, D, T = 6, 10, 60
LR = {"sgd": 0.1, "adam": 1e-3}
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
ADAM_B1 = 0.9
FAMILIES = {
    "absolute": {},
    "relative": dict(pos_encoding="relative"),
    "rotary": dict(pos_encoding="rotary", left_context=4),
    "moe": dict(moe_experts=4, moe_top_k=2, moe_aux_weight=0.5),
}
PIPELINE_FAMILIES = {
    "transformer": dict(encoder_type="transformer"),
    "deep": dict(num_layers=4, pos_encoding="rotary", left_context=4),
}


def options(family: str) -> dict:
    """The encoder fields of ``family`` that differ from the toy's."""
    return {**FAMILIES, **PIPELINE_FAMILIES}[family]


def encoder_kw(family: str, keep: float = 1.0) -> dict:
    return {**dict(encoder_type="conformer", num_units=16, num_layers=2, num_heads=4,
                   conv_kernel_size=5, ff_expansion=2, dropout_keep_prob=keep),
            **options(family)}


def tasks(family: str, keep: float = 1.0) -> tuple:
    """(JAX task, port task) of the toy conformer CTC model."""
    enc = encoder_kw(family, keep)
    kw = dict(frontend=None, feature_dim=D, num_stack=3, num_skip=3, weight_decay=1e-2)
    return (jctc.CTCTaskConfig(model=JCTCConfig(encoder=jencoders.EncoderConfig(**enc),
                                                num_classes=C), **kw),
            ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                   **kw))


def make_batch(seed: int = 3) -> dict:
    """4 ragged [T, D] feature rows, the last a filler of weight 0."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(4, T, D).astype(np.float32) * 2.0 + 1.0
    input_len = np.asarray([T, 44, 29, T], np.int32)
    for i, n in enumerate(input_len):
        feats[i, n:] = 0.0
    label_len = np.asarray([3, 1, 2, 3], np.int32)
    labels = np.full((4, 4), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, C, n)
    return {"inputs": feats, "input_len": input_len, "labels": labels, "label_len": label_len,
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


def setup(family: str, keep: float = 1.0) -> tuple:
    """(JAX task, port task, JAX weights, the same weights bridged)."""
    return _setup(family, keep)  # one cache key however the caller passes keep


@functools.lru_cache(maxsize=None)
def _setup(family: str, keep: float) -> tuple:
    jtask, task = tasks(family, keep)
    jparams = jctc.init_params(jax.random.PRNGKey(0), jtask)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), ctc_task.init_model(task))
    return jtask, task, jparams, params


def jax_batch() -> dict:
    return {k: jnp.asarray(v) for k, v in make_batch().items()}


def reference(family: str, accum: int = 1) -> dict:
    """The JAX one-device step's results by optimizer: ``{"adam": (weights,
    Adam state, aux), "sgd": (weights, None, aux)}`` in the port's layout
    (``accum`` above 1: one SGD step over that many microbatches alone)."""
    return _reference(family, accum)  # one compile however the caller passes accum


@functools.lru_cache(maxsize=None)
def _reference(family: str, accum: int) -> dict:
    jtask, task, jparams, params = setup(family)
    model = ctc_task.init_model(task)
    opt = "adam" if accum == 1 else "sgd"
    jopt = jbuild_optimizer(opt, 5.0)
    jstep = jctc.make_train_step(jtask, jopt, grad_accum=accum)
    p = jax.tree.map(jnp.array, jparams)  # the step donates its inputs
    p, s, aux = jstep(p, jopt.init(p), jax_batch(), LR[opt], jax.random.PRNGKey(1))
    aux = {k: float(v) for k, v in aux.items()}
    weights = params_from_jax(jax.tree.map(np.asarray, p), model)
    if accum > 1:
        return {"sgd": (weights, None, aux)}
    adam = adam_state_from_jax(jax.tree.map(np.asarray, s), model)
    grad = {k: v / (1 - ADAM_B1) for k, v in adam["mu"].items()}
    sgd = {k: v - LR["sgd"] * grad[k] for k, v in params.items()}
    return {"adam": (weights, adam, aux), "sgd": (sgd, None, aux)}


def step_job(name: str, family: str, opt: str, axes: dict, place=None, fsdp: bool = False,
             keep: float = 1.0, **kw) -> dict:
    """A ``"steps"`` job of ``tests/torch_parallel_workers.py``: one step of
    the family's toy on ``make_batch`` over the mesh ``axes``."""
    _, task, _, params = setup(family, keep)
    job = dict(kind="steps", name=name, module="ctc_task", task=task, params=params,
               batch=make_batch(), opt=opt, lr=LR[opt], axes=axes, place=place, fsdp=fsdp)
    if keep < 1.0:
        job["seed"] = 11
    job.update(kw)
    return job


def shift_invariant(key: str, family: str) -> bool:
    """Whether the leaf's exact gradient is 0: the key bias without RoPE."""
    return key.endswith("mhsa.k.b") and options(family).get("pos_encoding") != "rotary"


def assert_step_matches(got: dict, family: str, opt: str, accum: int = 1) -> None:
    """A rank's aux terms and whole (gathered) weights and Adam state against
    the JAX one-device step (Adam: the leaves of exact gradient 0 aside,
    ``shift_invariant``)."""
    weights, adam, jaux = reference(family, accum)[opt]
    aux = got["aux"][-1]
    assert not aux["nonfinite"] and not jaux["nonfinite"]
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k], jaux[k], **LOSS_TOL, err_msg=k)
    params, state = got.get("whole", got["params"]), got.get("whole_state", got["state"])
    tol = GRAD_TOL if opt == "sgd" else dict(atol=0.1 * LR[opt], rtol=0)
    assert set(params) == set(weights)
    for k, w in weights.items():
        if opt == "adam" and shift_invariant(k, family):
            continue
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), **tol, err_msg=k)
    if opt == "adam":
        assert int(state["count"]) == int(adam["count"]) == 1
        for m in ("mu", "nu"):
            for k, v in state[m].items():
                if shift_invariant(k, family):
                    continue
                w = adam[m][k].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=1e-3, err_msg=f"{m}.{k}",
                                           atol=1e-3 * float(np.abs(w).max()) + 1e-12)


def jax_leaf(tree, key: str):
    """The leaf of a JAX pytree at a ``state_dict`` key (``utils/bridge.py``)."""
    for part in key.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


def jax_specs(spec_tree, keys) -> dict:
    """``{state_dict key: tuple(PartitionSpec)}`` of a JAX spec tree."""
    return {k: tuple(jax_leaf(spec_tree, k)) for k in keys}


def block_of(whole: torch.Tensor, spec: tuple, axes: dict, coords: dict) -> torch.Tensor:
    """The block of ``whole`` that a JAX ``NamedSharding`` of ``spec`` puts
    on the device at ``coords`` of a mesh with ``axes``."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = axes[axis]
            size = whole.shape[dim] // n
            whole = whole.narrow(dim, coords[axis] * size, size)
    return whole


def assert_blocks(ranks: list, want_specs: dict, axes: dict) -> None:
    """Every rank holds exactly the JAX spec's block of every leaf, and of
    its Adam moments when it has them (bit for bit of the gathered whole)."""
    for r in ranks:
        assert r["specs"] == want_specs
        for k, spec in want_specs.items():
            want = block_of(r["whole"][k], spec, axes, r["coords"])
            assert torch.equal(r["params"][k], want), (r["coords"], k)
            if "mu" in r["state"]:
                m = block_of(r["whole_state"]["mu"][k], spec, axes, r["coords"])
                assert torch.equal(r["state"]["mu"][k], m), (r["coords"], k)


def assert_replicas_identical(ranks: list) -> None:
    """The whole weights agree bit for bit on every rank, and so does every
    leaf a rank holds whole."""
    first = ranks[0]
    for r in ranks[1:]:
        for k, v in first.get("whole", first["params"]).items():
            assert torch.equal(r.get("whole", r["params"])[k], v), (r["coords"], k)
        for k, spec in first.get("specs", {k: () for k in first["params"]}).items():
            if not spec:
                assert torch.equal(r["params"][k], first["params"][k]), (r["coords"], k)
