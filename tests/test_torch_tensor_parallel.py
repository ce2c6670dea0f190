"""The port's tensor parallelism (``parallel/tp.py``, the conformer's
Megatron column -> row pairs, the train step built with ``mesh=`` and
``specs=``, ``fit`` and ``bin/train`` with ``num_model_shards: 2``) alone,
composed with sequence parallelism (tp x sp) and with ZeRO-3 (fsdp x tp),
against the JAX package on the CPU over worlds of 2 and 4 ``gloo`` ranks.

Pure tests: ``param_partition_specs`` on every leaf of the toy conformers
and of a BLSTM, and ``fsdp_partition_specs(base_specs=)`` of them, against
JAX's specs (the port's spec is ``tuple(PartitionSpec)``).

The module fixture starts ``bin/train`` under ``torch.distributed.run``
and the world of 2 (``tests/torch_parallel_workers.py``, jax-free), computes
the JAX references while they run (the one-device step of each family,
``tests/torch_axes_common.py``), then runs the world of 4 beside the dp2 x
tp2 + fsdp step on ``make_mesh_2d(2, 2)`` and ``fit`` in one process, never
two worlds at once:

- tp2 (world 2) and tp2 x sp2 (world 4) for the absolute, relative and
  rotary + ``left_context`` conformers, one SGD and one Adam step each,
  against the JAX one-device step (tolerances of ``torch_axes_common``),
  every rank's Megatron blocks against JAX's specs;
- dp2 x tp2 + fsdp (world 4, relative): one Adam step against JAX's step on
  ``make_mesh_2d(2, 2)`` with ``setup_fsdp(base_specs=param_partition_specs)``,
  rank r's block of every leaf against the JAX shard on device r (Adam's
  0.1 lr; the key bias, of exact gradient 0, aside as in
  ``torch_axes_common``);
- dropout on (keep 0.9): after a step under tp2 and under dp2 x tp2 the
  replicated leaves and the gathered weights are bit-identical on every
  rank;
- ``fit`` with ``num_model_shards: 2`` for one toy epoch against one
  process (steps and dev error equal, losses rtol 1e-4), its checkpoint
  whole and restored in one process (dev error equal again);
- ``bin/train`` under ``python -m torch.distributed.run --nproc-per-node 2
  ... --device cpu`` with ``num_model_shards: 2``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tensorflow_end2end_speech_recognition_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from tensorflow_end2end_speech_recognition_tpu.parallel import (
    param_partition_specs as jparam_partition_specs,
)
from tensorflow_end2end_speech_recognition_tpu.parallel import setup_fsdp as jsetup_fsdp
from tensorflow_end2end_speech_recognition_tpu.parallel.fsdp import (
    fsdp_partition_specs as jfsdp_partition_specs,
)
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import loop as jloop
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu.utils.config import (
    ExperimentConfig as JExperimentConfig,
)
from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
    fsdp_partition_specs,
    param_partition_specs,
)
from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import (
    build_corpus_splits,
    build_task,
    fit,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import params_from_jax
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import (
    corpus_tokenizer,
    experiment_from_dict,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.metrics import evaluate_ctc
from torch_axes_common import (
    LR,
    assert_blocks,
    assert_replicas_identical,
    assert_step_matches,
    block_of,
    jax_batch,
    jax_leaf,
    jax_specs,
    setup,
    shift_invariant,
    step_job,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TP2 = {"data": 1, "model": 2}
TP2_SP2 = {"data": 1, "seq": 2, "model": 2}
DP2_TP2 = {"data": 2, "model": 2}
DENSE = ("absolute", "relative", "rotary")
STEPS = [(axes, f, o) for axes in ("tp2", "tp2_sp2") for f in DENSE for o in ("sgd", "adam")]
MESHES = {"tp2": TP2, "tp2_sp2": TP2_SP2}
FIT_TP = dict(model_type="ctc", corpus="toy", label_type="character", input_size=40,
              use_energy=False, use_delta=False, num_stack=3, num_skip=3,
              encoder_type="conformer", num_units=16, num_layers=2, num_heads=4,
              conv_kernel_size=5, ff_expansion=2, pos_encoding="relative", dropout=1.0,
              batch_size=4, num_epoch=1, optimizer="adam", learning_rate=1e-3,
              clip_grad_norm=5.0, weight_decay=1e-8, sort_utt=True, toy_num_utts=30,
              toy_max_units=4)


def _load(out: Path, name: str, world: int) -> list:
    return [torch.load(out / f"{name}_{r}.pt", weights_only=False) for r in range(world)]


def jax_mesh_step():
    """JAX's dp2 x tp2 + fsdp Adam step on ``make_mesh_2d(2, 2)``: its params
    (with the partition-safe depthwise conv that the JAX ``fit`` picks under
    model shards)."""
    jtask, _, jparams, _ = setup("relative")
    enc = jtask.model.encoder._replace(depthwise_impl="shifts")
    jtask = jtask._replace(model=jtask.model._replace(encoder=enc))
    jopt = jbuild_optimizer("adam", 5.0)
    jstep = jctc.make_train_step(jtask, jopt)
    p = jax.tree.map(jnp.array, jparams)
    p, s, b = jsetup_fsdp(jmake_mesh_2d(2, 2), p, jopt.init(p), jax_batch(),
                          base_specs=jparam_partition_specs(p))
    p, _, _ = jstep(p, s, b, LR["adam"], jax.random.PRNGKey(1))
    return p


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``bin/train`` under ``torch.distributed.run`` and the world of 2
    started first, the JAX one-device references computed while they run;
    then the world of 4 with the JAX mesh step and the one-process fit beside
    it (each world and JAX on their own processes)."""
    from torch_axes_common import reference

    tmp = tmp_path_factory.mktemp("tp")
    out = tmp / "out"
    jobs2 = [step_job(f"tp2_{f}_{o}", f, o, TP2, "tp") for f in DENSE for o in ("sgd", "adam")]
    jobs2.append(step_job("tp2_dropout", "relative", "adam", TP2, "tp", keep=0.9))
    jobs2.append(dict(kind="fit", name="fit_tp", model_dir=str(tmp / "two"),
                      exp=experiment_from_dict(dict(FIT_TP, num_model_shards=2))))
    jobs4 = [step_job(f"tp2_sp2_{f}_{o}", f, o, TP2_SP2, "tp") for f in DENSE
             for o in ("sgd", "adam")]
    jobs4.append(step_job("dp2_tp2_fsdp", "relative", "adam", DP2_TP2, "tp", fsdp=True))
    jobs4.append(step_job("dp2_tp2_dropout", "rotary", "adam", DP2_TP2, "tp", keep=0.9))
    (tmp / "w2").mkdir()
    (tmp / "w4").mkdir()
    cfg = tmp / "tp.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in
                           dict(FIT_TP, num_model_shards=2).items()))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "tensorflow_end2end_speech_recognition_tpu_torch.bin.train", str(cfg),
         str(tmp / "cli"), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = workers.spawn(jobs2, 2, tmp / "w2", out)
        for f in DENSE:
            reference(f)
        workers.join(ranks)
        ranks = workers.spawn(jobs4, 4, tmp / "w4", out)
        mesh_step = jax_mesh_step()
        one = fit(experiment_from_dict(FIT_TP), tmp / "one", log_every=1,
                  print_fn=lambda *a: None, device="cpu")
        workers.join(ranks)
        log, _ = cli.communicate(timeout=300)
    finally:
        cli.kill()
    return dict(tmp=tmp, out=out, mesh_step=mesh_step, one=one, cli=(cli.returncode, log))


@pytest.mark.parametrize("family", ["absolute", "relative", "moe", "blstm"])
def test_param_partition_specs_match_jax(family):
    if family == "blstm":  # recurrent stacks replicate
        raw = dict(FIT_TP, encoder_type="blstm", num_units=8, num_layers=1)
        exp = experiment_from_dict(raw)
        task, mod = build_task(exp, corpus_tokenizer(exp))
        jtask, jmod = jloop.build_task(JExperimentConfig.from_dict(raw), corpus_tokenizer(exp))
        jparams = jmod.init_params(jax.random.PRNGKey(0), jtask)
        params = mod.init_params(task, torch.Generator().manual_seed(0))
    else:
        _, _, jparams, params = setup(family)
    got = param_partition_specs(params)
    assert got == jax_specs(jparam_partition_specs(jparams), params)
    split = {k for k, s in got.items() if s}
    assert bool(split) == (family != "blstm")
    assert not any(".conv." in k or ".moe." in k for k in split)
    for n in (2, 4):
        composed = fsdp_partition_specs(params, n, got)
        assert composed == jax_specs(jfsdp_partition_specs(jparams, n, base_specs=
                                                            jparam_partition_specs(jparams)),
                                     params)
    heads = {k for k in params if k.endswith(("mhsa.pos.w", "mhsa.pos_u", "mhsa.pos_v"))}
    assert bool(heads) == (family == "relative") and all(not got[k] for k in heads)


def test_parallel_exports_every_jax_name():
    import tensorflow_end2end_speech_recognition_tpu.parallel as jparallel
    import tensorflow_end2end_speech_recognition_tpu_torch.parallel as parallel

    assert set(jparallel.__all__) <= set(parallel.__all__)
    assert all(hasattr(parallel, name) for name in parallel.__all__)
    mesh = parallel.make_mesh(device="cpu")  # no process group: one rank, its rows as they are
    rows = parallel.global_device_batch(mesh, {"a": np.arange(4), "names": ["u"] * 4})
    assert list(rows) == ["a"] and rows["a"].tolist() == [0, 1, 2, 3]


def test_opt_state_shardings_follow_the_weights():
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import opt_state_shardings
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import build_optimizer

    params = setup("relative")[3]
    specs = param_partition_specs(params)
    got = opt_state_shardings(build_optimizer("adam").init(params), specs)
    assert got == {"count": (), "mu": specs, "nu": specs}


@pytest.mark.parametrize("axes,family,opt", STEPS)
def test_step_matches_jax_one_device(world, axes, family, opt):
    mesh = MESHES[axes]
    ranks = _load(world["out"], f"{axes}_{family}_{opt}", 2 if axes == "tp2" else 4)
    for r in ranks:
        assert_step_matches(r, family, opt)
    assert_blocks(ranks, param_partition_specs(setup(family)[3]), mesh)
    assert_replicas_identical(ranks)
    rows = [r["rows"]["weight"].numpy().tolist() for r in ranks]
    assert all(w == [1.0, 1.0, 1.0, 0.0] for w in rows)  # one data line: every rank every row


def test_dp2_tp2_fsdp_matches_jax_mesh_step_shard_for_shard(world):
    ranks = _load(world["out"], "dp2_tp2_fsdp", 4)
    assert_step_matches(ranks[0], "relative", "adam")
    jp = world["mesh_step"]
    params = setup("relative")[3]
    specs = jax_specs(jfsdp_partition_specs(setup("relative")[2], 2, base_specs=
                                            jparam_partition_specs(setup("relative")[2])), params)
    assert_blocks(ranks, specs, DP2_TP2)
    assert any(s == ("data", "model") for s in specs.values())  # 2-D sharded weights
    devices = jax.devices()[:4]
    model = ctc_task.init_model(setup("relative")[1])
    kept = 0
    for k in params:
        leaf = jax_leaf(jp, k)
        # the step's output placement is XLA's: it keeps the input specs but on
        # a leaf or two (a model split propagated onto a replicated one), so
        # each rank's part of the port's weights is cut by the JAX placement
        jspec = tuple(leaf.sharding.spec)
        kept += jspec == specs[k]
        if shift_invariant(k, "relative"):  # rounding that Adam's first step scales to lr
            continue
        shards = {s.device: np.asarray(s.data) for s in leaf.addressable_shards}
        for r, got in enumerate(ranks):
            assert got["coords"] == {"data": r // 2, "model": r % 2}
            mine = block_of(got["whole"][k], jspec, DP2_TP2, got["coords"])
            np.testing.assert_allclose(mine.numpy(), shards[devices[r]], rtol=0,
                                       atol=0.1 * LR["adam"], err_msg=f"rank {r} {k}")
    assert kept >= len(params) - 4
    whole = params_from_jax(jax.tree.map(np.asarray, jp), model)
    for k, v in whole.items():
        if shift_invariant(k, "relative"):
            continue
        np.testing.assert_allclose(ranks[0]["whole"][k].numpy(), v.numpy(), rtol=0,
                                   atol=0.1 * LR["adam"], err_msg=k)
    # each rank holds a quarter of the 2-D sharded leaves, and the rows of its data index
    assert [r["rows"]["weight"].numpy().tolist() for r in ranks] == \
        [[1.0, 1.0], [1.0, 1.0], [1.0, 0.0], [1.0, 0.0]]


@pytest.mark.parametrize("name,world_size", [("tp2_dropout", 2), ("dp2_tp2_dropout", 4)])
def test_replicas_bit_identical_with_dropout(world, name, world_size):
    ranks = _load(world["out"], name, world_size)
    assert all(not r["aux"][0]["nonfinite"] for r in ranks)
    assert_replicas_identical(ranks)
    # the dropout masks are drawn: the step differs from the one without dropout
    family = "relative" if name == "tp2_dropout" else "rotary"
    from torch_axes_common import reference

    loss = reference(family)["adam"][2]["loss"]
    assert abs(ranks[0]["aux"][0]["loss"] - loss) > 1e-4


def test_fit_tp_matches_one_process_and_restores_in_one(world):
    tmp = world["tmp"]
    r0, r1 = _load(world["out"], "fit_tp", 2)
    got, want = r0["summary"], world["one"]
    assert got["steps"] == want["steps"] == 6
    assert got["dev_error_rate"] == want["dev_error_rate"]
    for k in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert any(line.startswith("mesh: 1-way data x 2-way tensor parallel") for line in r0["lines"])
    assert r1["lines"] == []
    exp = experiment_from_dict(FIT_TP)  # one process reads the tp run's checkpoint
    _, state = CheckpointManager(tmp / "two" / "checkpoints").restore(
        {"params": None, "extra": None}, epoch=0)
    _, dev, _, tok = build_corpus_splits(exp, need=("dev",))
    task, mod = build_task(exp, tok)
    model = mod.init_model(task)
    model.load_state_dict(state["params"])  # strict: whole tensors under the one-device names
    for k, v in state["params"].items():
        assert state["extra"]["opt_state"]["mu"][k].shape == v.shape, k
    rates = evaluate_ctc(mod.make_eval_step(task), state["params"],
                         Dataset(dev, exp.batch_size, sort_utt=True), tok, exp.label_type, 0,
                         "cpu")
    assert rates["error_rate"] == got["dev_error_rate"]
    np.testing.assert_allclose(rates["loss"], got["dev_loss"], rtol=1e-6)


def test_bin_train_under_torchrun_with_model_shards(world):
    rc, log = world["cli"]
    assert rc == 0, log
    cli = world["tmp"] / "cli"
    text = (cli / "train.log").read_text()
    assert "mesh: 1-way data x 2-way tensor parallel (2 process(es), backend gloo)" in text
    assert text.count("FINAL") == 1  # rank 0 alone logs
    summary = json.loads((cli / "summary.json").read_text())
    assert summary["epochs"] == 1 and summary["steps"] == 6
    assert np.isfinite(summary["train_loss"])
    _, state = CheckpointManager(cli / "checkpoints").restore({"params": None})
    # whole, not a shard: the column-parallel q and the row-parallel o
    assert state["params"]["encoder.conformer.layers.0.mhsa.q.w"].shape == (16, 16)
    assert state["params"]["encoder.conformer.layers.0.ff1.out.w"].shape == (32, 16)
