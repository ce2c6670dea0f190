"""The port's pipeline parallelism (``parallel/pp.py``: GPipe stages of the
conformer's layers over ``pipe``, alone, with data parallelism and with
tensor parallelism; the train step built with ``mesh=`` and the stacked
``specs=``; ``fit`` and ``bin/train`` with ``num_pipeline_stages: 2``)
against the JAX package on the CPU over worlds of 2 and 4 ``gloo`` ranks.

Pure tests, on JAX trees (no compile): ``pipeline_param_specs`` with and
without ``model=``, ``pp_stack_tree`` / ``pp_unstack_tree`` of the weights
and of an Adam state, against the JAX functions.

The module fixture starts the world of 2 (``tests/torch_parallel_workers.py``,
jax-free) and ``bin/train`` under ``torch.distributed.run``, and runs the
one-process ``fit`` and compiles JAX one-device references
(``tests/torch_axes_common.py``) while they run; then the world of 4, with
the one-process resume of the pipelined run and the other references
beside it:

- pp2 (world 2) for the absolute, relative, rotary + ``left_context`` and
  transformer toys (one layer per stage, 2 microbatches); dp2 x pp2 (the
  4-layer toy, two layers per stage), pp2 x tp2 (relative) and pp4 (the
  4-layer toy, 4 microbatches of one row) in the world of 4; one SGD and one
  Adam step each against the JAX one-device step, with the tolerances of
  ``tests/torch_axes_common.py``; each rank holds its stage's block of each
  stacked layer leaf and of its Adam moments, and nothing of the others';
- dropout on (keep 0.9): after a step under pp2 and under dp2 x pp2 the
  replicated leaves and the gathered weights are bit-identical on every
  rank;
- ``fit`` with ``num_pipeline_stages: 2`` for one toy epoch against one
  process (steps and dev error equal, losses rtol 1e-4); its checkpoint in
  the one-device layout, which ``bin/eval`` restores in one process (dev
  error equal); the one-process checkpoint resumed under dp2 x pp2 and the
  pp2 checkpoint resumed in one process (the second epochs agree);
- ``bin/train`` under ``python -m torch.distributed.run --nproc-per-node 2
  ... --device cpu`` with ``num_pipeline_stages: 2``.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tensorflow_end2end_speech_recognition_tpu.parallel import (
    pipeline_param_specs as jpipeline_param_specs,
)
from tensorflow_end2end_speech_recognition_tpu.parallel import pp_stack_tree as jpp_stack_tree
from tensorflow_end2end_speech_recognition_tpu.parallel import (
    pp_unstack_tree as jpp_unstack_tree,
)
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.bin import eval as eval_cli
from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
    pipeline_param_specs,
    pp_stack_tree,
    pp_unstack_tree,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    flatten_tree,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict
from torch_axes_common import (
    assert_replicas_identical,
    assert_step_matches,
    block_of,
    jax_specs,
    options,
    reference,
    setup,
    step_job,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PP2 = {"data": 1, "pipe": 2}
DP2_PP2 = {"data": 2, "pipe": 2}
PP2_TP2 = {"data": 1, "pipe": 2, "model": 2}
PP4 = {"data": 1, "pipe": 4}
OPTS = ("sgd", "adam")
# name -> (world, axes, family, microbatches)
STEPS = {
    **{f"pp2_{f}": (2, PP2, f, 2) for f in ("absolute", "relative", "rotary", "transformer")},
    "dp2_pp2_deep": (4, DP2_PP2, "deep", 2),
    "pp2_tp2_relative": (4, PP2_TP2, "relative", 2),
    "pp4_deep": (4, PP4, "deep", 4),
}
CASES = [(name, o) for name in STEPS for o in OPTS]
DROPOUT = {"pp2_dropout": (2, PP2, "relative"), "dp2_pp2_dropout": (4, DP2_PP2, "deep")}
FIT_PP = dict(model_type="ctc", corpus="toy", label_type="character", input_size=40,
              use_energy=False, use_delta=False, num_stack=3, num_skip=3,
              encoder_type="conformer", num_units=16, num_layers=2, num_heads=4,
              conv_kernel_size=5, ff_expansion=2, pos_encoding="relative", dropout=1.0,
              batch_size=4, num_epoch=1, optimizer="adam", learning_rate=1e-3,
              clip_grad_norm=5.0, weight_decay=1e-8, sort_utt=True, toy_num_utts=30,
              toy_max_units=4, num_pipeline_microbatches=2)
PIPED = dict(num_devices=2, num_pipeline_stages=2)


def _load(out: Path, name: str, world: int) -> list:
    return [torch.load(out / f"{name}_{r}.pt", weights_only=False) for r in range(world)]


def pp_job(name: str, family: str, opt: str, axes: dict, microbatches: int, **kw) -> dict:
    """A ``"steps"`` job on the stacked placement, the toy's encoder run in
    ``microbatches`` microbatches."""
    job = step_job(name, family, opt, axes, "pp", **kw)
    enc = job["task"].model.encoder._replace(pipeline_microbatches=microbatches)
    job["task"] = job["task"]._replace(model=job["task"].model._replace(encoder=enc))
    return job


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 2 and ``bin/train`` under ``torch.distributed.run``
    started first, the one-process fit and three JAX references computed
    while they run; then the world of 4 (which resumes the one-process
    checkpoint) with the one-process resume of the pipelined run and the
    other two references beside it."""
    tmp = tmp_path_factory.mktemp("pp")
    out = tmp / "out"
    jobs = {2: [], 4: []}
    for name, (size, axes, family, mb) in STEPS.items():
        jobs[size] += [pp_job(f"{name}_{o}", family, o, axes, mb) for o in OPTS]
    for name, (size, axes, family) in DROPOUT.items():
        jobs[size].append(pp_job(name, family, "adam", axes, 2, keep=0.9))
    exp2 = experiment_from_dict(dict(FIT_PP, **PIPED))
    jobs[2].append(dict(kind="fit", name="fit_pp", exp=exp2, model_dir=str(tmp / "two")))
    jobs[4].append(dict(kind="fit", name="fit_resumed_dp2_pp2", model_dir=str(tmp / "one"),
                        exp=dataclasses.replace(exp2, num_devices=4, num_epoch=2)))
    for n in (2, 4):
        (tmp / f"w{n}").mkdir()
    cfg = tmp / "pp.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in dict(FIT_PP, **PIPED).items()))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tensorflow_end2end_speech_recognition_tpu_torch.bin.train", str(cfg),
         str(tmp / "cli"), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = workers.spawn(jobs[2], 2, tmp / "w2", out)
        one = fit(experiment_from_dict(FIT_PP), tmp / "one", log_every=1,
                  print_fn=lambda *a: None, device="cpu")
        for family in ("deep", "absolute", "relative"):
            reference(family)
        workers.join(ranks)
        ranks = workers.spawn(jobs[4], 4, tmp / "w4", out)
        shutil.copytree(tmp / "two", tmp / "pp_then_one")
        resumed = fit(dataclasses.replace(exp2, num_devices=None, num_pipeline_stages=None,
                                          num_epoch=2), tmp / "pp_then_one", log_every=1,
                      print_fn=lambda *a: None, device="cpu")
        for family in ("rotary", "transformer"):
            reference(family)
        workers.join(ranks)
        log, _ = cli.communicate(timeout=300)
    finally:
        cli.kill()
    return dict(tmp=tmp, out=out, one=one, resumed=resumed, cli=(cli.returncode, log))


def _jax_adam_state(jparams):
    """A JAX Adam state whose moments are not zero (no step compiled)."""
    state = jbuild_optimizer("adam", 5.0).init(jparams)

    def fill(s):
        if all(hasattr(s, f) for f in ("count", "mu", "nu")):
            return s._replace(mu=jax.tree.map(lambda x: 2.0 * x, jparams),
                              nu=jax.tree.map(lambda x: x * x, jparams))
        if isinstance(s, tuple) and not hasattr(s, "_fields"):
            return tuple(fill(x) for x in s)
        return s

    return fill(state)


@pytest.mark.parametrize("family,stages", [("relative", 2), ("deep", 2), ("deep", 4)])
@pytest.mark.parametrize("model", [False, True])
def test_pipeline_param_specs_match_jax(family, stages, model):
    _, _, jparams, params = setup(family)
    stacked = pp_stack_tree(params, stages)
    got = pipeline_param_specs(stacked, model=model)
    jstacked = jpp_stack_tree(jparams, stages)
    assert got == jax_specs(jpipeline_param_specs(jstacked, model=model), stacked)
    layers = {k for k in stacked if ".conformer.layers." in k}
    assert all(got[k][0] == "pipe" for k in layers) and all(not got[k] for k in got
                                                            if k not in layers)
    assert any("model" in got[k] for k in layers) == model


@pytest.mark.parametrize("family,stages", [("transformer", 2), ("deep", 2), ("deep", 4)])
def test_stack_trees_match_jax(family, stages):
    _, task, jparams, params = setup(family)
    stacked = pp_stack_tree(params, stages)
    want = flatten_tree(jax.tree.map(np.asarray, jpp_stack_tree(jparams, stages)))
    assert set(stacked) == set(want)
    for k, v in stacked.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        if ".conformer.layers." in k:
            assert v.shape[:2] == (stages, options(family).get("num_layers", 2) // stages), k
    back = pp_unstack_tree(stacked)
    assert list(back) == list(params)  # the one-device names, in the state_dict order
    assert all(torch.equal(back[k], v) for k, v in params.items())
    # a layout already in place stays
    assert pp_stack_tree(stacked, stages).keys() == stacked.keys()
    assert pp_unstack_tree(params).keys() == params.keys()
    # an Adam state: the moments stack as their weights, the count stays
    jstate = _jax_adam_state(jparams)
    state = adam_state_from_jax(jax.tree.map(np.asarray, jstate), ctc_task.init_model(task))
    stacked_state = pp_stack_tree(state, stages)
    jstacked_state = jpp_stack_tree(jstate, stages)
    for m in ("mu", "nu"):
        jm = next(s for s in jstacked_state if hasattr(s, m))
        want = flatten_tree(jax.tree.map(np.asarray, getattr(jm, m)))
        assert set(stacked_state[m]) == set(want)
        for k, v in stacked_state[m].items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=f"{m}.{k}")
    assert torch.equal(stacked_state["count"], state["count"])
    unstacked = pp_unstack_tree(stacked_state)
    assert all(torch.equal(unstacked[m][k], state[m][k]) for m in ("mu", "nu") for k in params)
    jback = flatten_tree(jax.tree.map(np.asarray, jpp_unstack_tree(jpp_stack_tree(jparams,
                                                                                 stages))))
    assert set(jback) == set(params)


@pytest.mark.parametrize("name,opt", CASES)
def test_step_matches_jax_one_device(world, name, opt):
    size, axes, family, _ = STEPS[name]
    ranks = _load(world["out"], f"{name}_{opt}", size)
    for r in ranks:
        assert_step_matches(r, family, opt)
    assert_replicas_identical(ranks)
    # each rank holds its stage's block of every stacked layer leaf and of its moments
    stacked = pp_stack_tree(setup(family)[3], axes["pipe"])
    specs = pipeline_param_specs(stacked, model="model" in axes)
    for r in ranks:
        assert r["specs"] == specs
        whole, whole_state = (pp_stack_tree(r[k], axes["pipe"]) for k in ("whole", "whole_state"))
        for k, spec in specs.items():
            assert torch.equal(r["params"][k], block_of(whole[k], spec, axes, r["coords"]))
            if opt == "adam":
                assert torch.equal(r["state"]["mu"][k],
                                   block_of(whole_state["mu"][k], spec, axes, r["coords"]))
            if spec:
                assert r["params"][k].shape[:2] == (1, stacked[k].shape[1]), k
    rows = [r["rows"]["weight"].numpy().tolist() for r in ranks]
    want = [[1.0, 1.0], [1.0, 0.0]] if axes["data"] == 2 else [[1.0, 1.0, 1.0, 0.0]]
    assert rows == [want[r["coords"]["data"]] for r in ranks]


@pytest.mark.parametrize("name", sorted(DROPOUT))
def test_replicas_bit_identical_with_dropout(world, name):
    size, _, family = DROPOUT[name]
    ranks = _load(world["out"], name, size)
    assert all(not r["aux"][0]["nonfinite"] for r in ranks)
    assert_replicas_identical(ranks)
    # the dropout masks are drawn: the step differs from the one without dropout
    loss = reference(family)["adam"][2]["loss"]
    assert abs(ranks[0]["aux"][0]["loss"] - loss) > 1e-4
    assert len({r["aux"][0]["loss"] for r in ranks}) == 1


def test_fit_pp_matches_one_process_and_restores_in_one(world):
    tmp = world["tmp"]
    r0, r1 = _load(world["out"], "fit_pp", 2)
    got, want = r0["summary"], world["one"]
    assert got["steps"] == want["steps"] == 6
    assert got["dev_error_rate"] == want["dev_error_rate"]
    for k in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert "mesh: 1-way data x 2-stage pipeline (2 microbatches, 2 process(es), backend gloo)" \
        in r0["lines"]
    assert r1["lines"] == []
    _, state = CheckpointManager(tmp / "two" / "checkpoints").restore(
        {"params": None, "extra": None}, epoch=0)
    # the one-device list layout: every layer whole under its own name
    assert "encoder.conformer.layers.1.ff1.in.w" in state["params"]
    assert not any(k.startswith("encoder.conformer.layers.ff1") for k in state["params"])
    for k, v in state["params"].items():
        assert state["extra"]["opt_state"]["mu"][k].shape == v.shape, k
    res = eval_cli.main([str(tmp / "two"), "--device", "cpu"])  # one process
    assert res["dev"]["error_rate"] == got["dev_error_rate"]
    np.testing.assert_allclose(res["dev"]["loss"], got["dev_loss"], rtol=1e-6)


def test_checkpoints_resume_across_pipeline_stages_and_one_process(world):
    # epoch 0 in one process, epoch 1 under dp2 x pp2; and epoch 0 under pp2, epoch 1 in one
    r0 = _load(world["out"], "fit_resumed_dp2_pp2", 4)[0]
    got, want = r0["summary"], world["resumed"]
    assert "resuming from checkpoint epoch 0" in r0["lines"]
    assert got["epochs"] == want["epochs"] == 2 and got["steps"] == want["steps"] == 12
    assert got["dev_error_rate"] == want["dev_error_rate"]
    for k in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_bin_train_under_torchrun_with_pipeline_stages(world):
    rc, log = world["cli"]
    assert rc == 0, log
    cli = world["tmp"] / "cli"
    text = (cli / "train.log").read_text()
    assert "mesh: 1-way data x 2-stage pipeline (2 microbatches, 2 process(es), backend gloo)" \
        in text
    assert text.count("FINAL") == 1  # rank 0 alone logs
    summary = json.loads((cli / "summary.json").read_text())
    assert summary["epochs"] == 1 and summary["steps"] == 6
    assert np.isfinite(summary["train_loss"])
    _, state = CheckpointManager(cli / "checkpoints").restore({"params": None})
    # whole, each layer under its one-device name
    assert state["params"]["encoder.conformer.layers.1.mhsa.q.w"].shape == (16, 16)
    assert state["params"]["encoder.conformer.layers.0.ff1.out.w"].shape == (32, 16)
