"""The port's ZeRO-3 (``parallel/fsdp.py``, the train steps built with
``specs=``, ``fit`` with ``fsdp: true``) against the JAX package's
``setup_fsdp`` on ``make_mesh(2)``, on the CPU over a world of 2 ``gloo``
ranks; and the validation of the mesh knobs against the JAX ``fit``.

Pure tests: ``fsdp_spec_for`` on the JAX test's shapes, alone and with
the ``base`` specs of tensor and expert parallelism, and
``fsdp_partition_specs`` on every leaf of the toy-width ls100_ctc,
ls960_joint and ls960_conformer_ctc weights, at 2 and 8 shards, against
JAX's specs (the port's spec is ``tuple(PartitionSpec)``); the errors of
``tests/test_fsdp.py::test_fit_rejects_fsdp_combinations`` and every other
mesh combination the JAX ``fit`` refuses (pipeline stages' microbatches and
data degree included) raised as JAX raises them.

World 2 (one spawn of ``tests/torch_parallel_workers.py`` from the module
fixture): two Adam steps (lr 1e-3, clip 5.0) of the CTC, joint and
transducer toys of ``tests/test_torch_parallel.py`` from the bridged JAX
weights against JAX's steps on ``setup_fsdp`` placement (the tolerances of
that file: Adam's weights within 0.1 lr per step, moments 1e-3 of max),
each rank's blocks against the JAX shard on the same device, every
divisible leaf and its moments held 1/2 per rank; ``fit`` with ``fsdp:
true`` for one toy epoch against ``fit`` in one process, and its
checkpoint (whole tensors) resumed in one process; the clip's norm over
each rank's blocks against the norm over whole leaves, bit for bit.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_workers as workers
from tensorflow_end2end_speech_recognition_tpu.parallel.fsdp import (
    fsdp_partition_specs as jfsdp_partition_specs,
)
from tensorflow_end2end_speech_recognition_tpu.parallel.fsdp import (
    fsdp_spec_for as jfsdp_spec_for,
)
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.parallel import fsdp_partition_specs
from tensorflow_end2end_speech_recognition_tpu_torch.parallel.fsdp import (
    fsdp_spec_for,
    spec_dim,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import build_task, fit
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import flatten_tree
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    corpus_tokenizer,
    experiment_from_dict,
)
from test_torch_parallel import (
    FIT,
    LR,
    REPO,
    WORLD,
    assert_step_matches,
    jax_steps,
    port_job,
)

torch.set_num_threads(1)

FAMILIES = ("ctc", "joint", "transducer")


def jax_leaf(tree, key: str):
    """The leaf of a JAX pytree at a ``state_dict`` key (``utils/bridge.py``)."""
    for part in key.split("."):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[part]
    return tree


SHAPES = [(40, 64), (64, 40), (16, 64), (64,), (7,), (9, 7), (), (8, 8), (3, 16, 16), (1,)]


def test_fsdp_spec_for_matches_jax():
    for n in (2, 8):
        for shape in SHAPES:
            assert fsdp_spec_for(np.zeros(shape), n) == tuple(jfsdp_spec_for(np.zeros(shape),
                                                                             n)), (shape, n)
    assert fsdp_spec_for(np.zeros((40, 64)), 8) == (None, "data")
    assert fsdp_spec_for(np.zeros(7), 8) == ()


# the bases of tests/test_fsdp_composite.py: column / row parallel, a split
# bias, stacked experts, and one that leaves no divisible free axis
@pytest.mark.parametrize("base", [P(None, "model"), P("model", None), P("model"), P("expert"),
                                  P(), P(None, None, "model")])
def test_fsdp_spec_for_base_matches_jax(base):
    for n in (2, 4, 8):
        for shape in SHAPES + [(16, 64), (64, 16), (7, 16), (4, 16, 64)]:
            if len(base) > len(shape):
                continue
            got = fsdp_spec_for(np.zeros(shape), n, base=tuple(base))
            assert got == tuple(jfsdp_spec_for(np.zeros(shape), n, base=base)), (shape, n)


NARROW = {"ls100_ctc": dict(num_units=16, num_layers=2),
          "ls960_joint": dict(num_units=16, num_layers=2, attention_dim=8,
                              decoder_num_units=16, embedding_dim=8),
          "ls960_conformer_ctc": dict(num_units=16, num_layers=2, num_heads=2,
                                      conv_kernel_size=3)}


@pytest.mark.parametrize("name", sorted(NARROW))
def test_partition_specs_match_jax_on_every_leaf(name):
    import yaml

    raw = dict(yaml.safe_load((REPO / "configs" / f"{name}.yml").read_text()), **NARROW[name])
    exp = experiment_from_dict(raw)
    tok = corpus_tokenizer(exp)
    task, mod = build_task(exp, tok)
    params = mod.init_params(task, torch.Generator().manual_seed(0))
    jtask, jmod = jloop.build_task(JExperimentConfig.from_dict(raw), tok)
    jparams = jmod.init_params(jax.random.PRNGKey(0), jtask)
    assert {k: v.shape for k, v in flatten_tree(jax.tree.map(np.asarray, jparams)).items()} \
        == {k: tuple(v.shape) for k, v in params.items()}
    for n in (2, 8):
        got = fsdp_partition_specs(params, n)
        specs = jfsdp_partition_specs(jparams, n)
        want = {k: tuple(jax_leaf(specs, k)) for k in params}
        assert got == want, n
        assert any(got.values())


REJECT = dict(model_type="ctc", label_type="phone61", encoder_type="conformer", num_units=16,
              num_layers=1, num_heads=2, batch_size=8, num_epoch=1, toy_num_utts=8,
              use_delta=False, use_energy=False)


@pytest.mark.parametrize("over", [dict(num_devices=8, fsdp=True, num_pipeline_stages=2,
                                       num_layers=2), dict(fsdp=True)])
def test_fit_rejects_fsdp_combinations_as_jax(tmp_path, over):
    raw = dict(REJECT, **over)
    with pytest.raises(ValueError) as want:
        jloop.fit(JExperimentConfig.from_dict(raw), str(tmp_path / "jax"),
                  print_fn=lambda *a: None)
    with pytest.raises(ValueError) as got:
        fit(experiment_from_dict(raw), tmp_path / "port", print_fn=lambda *a: None,
            device="cpu")
    assert str(got.value) == str(want.value)


# every mesh combination the JAX fit refuses, with one fault each
MOE = dict(moe_num_experts=4)
REFUSED = {
    "ep_with_tp": dict(MOE, num_devices=4, num_expert_shards=2, num_model_shards=2),
    "ep_with_sp": dict(MOE, num_devices=4, num_expert_shards=2, num_sequence_shards=2),
    "ep_with_pp": dict(MOE, num_devices=4, num_expert_shards=2, num_pipeline_stages=2,
                       num_layers=2),
    "pp_with_sp": dict(num_devices=4, num_pipeline_stages=2, num_sequence_shards=2,
                       num_layers=2),
    "sp_not_conformer": dict(encoder_type="blstm", num_devices=2, num_sequence_shards=2),
    "moe_not_conformer": dict(MOE, encoder_type="blstm"),
    "pp_not_conformer": dict(encoder_type="blstm", num_devices=2, num_pipeline_stages=2),
    "pp_layers": dict(num_devices=2, num_pipeline_stages=2, num_layers=3),
    "ep_without_moe": dict(num_devices=2, num_expert_shards=2),
    "ep_not_dividing_experts": dict(moe_num_experts=3, num_devices=2, num_expert_shards=2),
    "batch_by_data_degree_tp": dict(num_devices=8, num_model_shards=2, batch_size=6),
    "batch_by_data_degree_sp": dict(num_devices=8, num_sequence_shards=2, batch_size=6),
    "batch_by_data_degree_ep": dict(MOE, num_devices=8, num_expert_shards=2, batch_size=6),
    "batch_by_data_degree_tp_sp": dict(num_devices=16, num_model_shards=2,
                                       num_sequence_shards=2, batch_size=6),
    "devices_by_tp_sp": dict(num_devices=6, num_model_shards=2, num_sequence_shards=2),
    "devices_by_tp": dict(num_devices=6, num_model_shards=4),
    "fsdp_without_data_axis_tp": dict(fsdp=True, num_devices=2, num_model_shards=2),
    "fsdp_without_data_axis_ep": dict(MOE, fsdp=True, num_devices=4, num_expert_shards=4),
    "devices_by_pp_tp": dict(num_devices=6, num_pipeline_stages=2, num_model_shards=2,
                             num_layers=2),
    "batch_by_pp_microbatches": dict(num_devices=2, num_pipeline_stages=2, num_layers=2,
                                     num_pipeline_microbatches=3),
    "eval_rows_by_pp_data_degree": dict(num_devices=4, num_pipeline_stages=2, num_layers=2,
                                        num_pipeline_microbatches=4, eval_batch_size=4),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_fit_refuses_mesh_combinations_as_jax(tmp_path, case):
    raw = dict(REJECT, **REFUSED[case])
    with pytest.raises(ValueError) as want:
        jloop.fit(JExperimentConfig.from_dict(raw), str(tmp_path / "jax"),
                  print_fn=lambda *a: None)
    with pytest.raises(ValueError) as got:
        fit(experiment_from_dict(raw), tmp_path / "port", print_fn=lambda *a: None,
            device="cpu")
    assert str(got.value) == str(want.value)


def test_data_parallel_validation(tmp_path):
    base = dict(FIT, num_devices=2)
    with pytest.raises(ValueError, match="grad_accum_steps x data-parallel degree = 2x2"):
        experiment_from_dict(dict(base, grad_accum_steps=2, batch_size=6)).check_trainable()
    with pytest.raises(ValueError, match="eval batch size 3 not divisible"):
        experiment_from_dict(dict(base, eval_batch_size=3)).check_trainable()
    experiment_from_dict(dict(base, fsdp=True, grad_accum_steps=2)).check_trainable()
    # num_devices must equal the ranks' world size; here no group is initialized
    with pytest.raises(ValueError, match="needs 2 ranks"):
        fit(experiment_from_dict(base), tmp_path, print_fn=lambda *a: None, device="cpu")


def _load(out, name):
    return [torch.load(out / f"{name}_{r}.pt", weights_only=False) for r in range(WORLD)]


def _gradient_trees(jobs, seeds: int = 4) -> list:
    """Trees with the leaves of each family's weights (the step jobs'),
    each leaf seeded normal values at a scale of its own in 1e-6 .. 1e2."""
    trees = []
    for job in jobs:
        if job["kind"] != "steps":
            continue
        for seed in range(seeds):
            g = torch.Generator().manual_seed(seed)
            trees.append({k: torch.randn(v.shape, generator=g)
                          * 10.0 ** float(torch.rand((), generator=g) * 8 - 6)
                          for k, v in job["params"].items()})
    return trees


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references and the one-process run, then one spawn of 2 ranks
    for every world-2 case of this module, then the world-2 checkpoint
    resumed in one process, one after the other."""
    tmp = tmp_path_factory.mktemp("fsdp")
    out = tmp / "out"
    want = {f"fsdp_{f}": jax_steps(f, "adam", fsdp=True, steps=2) for f in FAMILIES}
    one = fit(experiment_from_dict(FIT), tmp / "one", log_every=1, print_fn=lambda *a: None,
              device="cpu")
    jobs = [port_job(f"fsdp_{f}", f, "adam", fsdp=True, steps=2) for f in FAMILIES]
    exp2 = experiment_from_dict(dict(FIT, num_devices=WORLD, fsdp=True))
    jobs.append(dict(kind="fit", name="fit_fsdp", exp=exp2, model_dir=str(tmp / "two")))
    jobs.append(dict(kind="norm", name="norms", trees=_gradient_trees(jobs)))
    workers.join(workers.spawn(jobs, WORLD, tmp, out))
    lines = []
    resumed = fit(dataclasses.replace(exp2, num_devices=None, fsdp=False, num_epoch=2),
                  tmp / "two", log_every=1, print_fn=lines.append, device="cpu")
    return dict(tmp=tmp, out=out, want=want, one=one, resumed=(resumed, lines))


@pytest.mark.parametrize("family", FAMILIES)
def test_fsdp_steps_match_jax_setup_fsdp(world, family):
    r0, r1 = _load(world["out"], f"fsdp_{family}")
    want = world["want"][f"fsdp_{family}"]
    assert_step_matches(family, "adam", r0, want, lr_steps=2)
    assert r0["specs"] == r1["specs"]
    jp, js, _ = want
    devices = jax.devices()[:WORLD]
    for k, spec in r0["specs"].items():
        leaf = jax_leaf(jp, k)
        assert spec == tuple(leaf.sharding.spec), k  # the step kept the JAX placement
        shards = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        for r, got in enumerate((r0, r1)):
            block = got["params"][k].numpy()
            np.testing.assert_allclose(block, shards[devices[r]], rtol=0,
                                       atol=0.1 * LR["adam"] * 2, err_msg=f"rank {r} {k}")


def test_clip_norm_over_zero3_blocks_equals_the_data_parallel_norm(world):
    """The clip's norm over each rank's ZeRO-3 blocks is, bit for bit, the
    float32 norm over the whole tree that a data-parallel step takes
    (``global_norm`` sums the squares in float64), on 12 seeded trees with
    every leaf of the three families' weights; float32 sums in the two
    orders differ in the last bit on some such trees
    (probes/clip_norm_bits.py)."""
    for r in _load(world["out"], "norms"):
        assert len(r["norms"]) == 4 * len(FAMILIES)
        for dp, zero3 in r["norms"]:
            assert dp.dtype == zero3.dtype == torch.float32
            assert torch.equal(dp, zero3), (float(dp), float(zero3))


@pytest.mark.parametrize("family", FAMILIES)
def test_fsdp_ranks_hold_half_of_every_divisible_leaf(world, family):
    r0, r1 = _load(world["out"], f"fsdp_{family}")
    sharded = 0
    for k, spec in r0["specs"].items():
        dim = spec_dim(spec, "data")
        whole = r0["whole"][k]
        for got in (r0, r1):
            held = [got["params"][k], got["state"]["mu"][k], got["state"]["nu"][k]]
            want = whole.numel() // WORLD if dim is not None else whole.numel()
            assert all(t.numel() == want for t in held), k
        if dim is not None:
            sharded += whole.numel()
            joined = torch.cat([r0["params"][k], r1["params"][k]], dim)
            assert torch.equal(joined, whole), k
        else:
            assert torch.equal(r0["params"][k], r1["params"][k]), k
    total = sum(v.numel() for v in r0["whole"].values())
    assert sharded / total > 0.9  # as tests/test_fsdp.py: most bytes live 1/N per rank
    assert r0["state"]["count"].shape == () and int(r0["state"]["count"]) == 2


def test_fit_fsdp_matches_one_process_and_resumes_in_one(world):
    tmp = world["tmp"]
    r0, r1 = _load(world["out"], "fit_fsdp")
    got, want = r0["summary"], world["one"]
    assert got["steps"] == want["steps"] == 6
    assert got["dev_error_rate"] == want["dev_error_rate"]
    for k in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert any("fsdp: params+moments sharded" in line for line in r0["lines"])
    resumed, lines = world["resumed"]
    assert "resuming from checkpoint epoch 0" in lines
    assert resumed["epochs"] == 2 and resumed["steps"] == 12
    assert np.isfinite(resumed["train_loss"])
    _, state = CheckpointManager(tmp / "two" / "checkpoints").restore(
        {"params": None, "extra": None}, epoch=0)
    ref = CheckpointManager(tmp / "one" / "checkpoints").restore({"params": None})[1]
    for k, v in ref["params"].items():  # whole tensors, as one process writes them
        assert state["params"][k].shape == v.shape
        np.testing.assert_allclose(state["params"][k].numpy(), v.numpy(), rtol=0,
                                   atol=0.1 * LR["adam"] * 6, err_msg=k)
        assert state["extra"]["opt_state"]["mu"][k].shape == v.shape
    assert json.loads((tmp / "two" / "summary.json").read_text())["epochs"] == 2
