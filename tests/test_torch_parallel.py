"""The port's data parallelism (``parallel/mesh.py``, ``parallel/multihost.py``,
the train steps built with ``mesh=``, ``fit`` and ``bin/train`` with
``num_devices: 2``) against the JAX package's DP on ``make_mesh(2)``, on the
CPU over a world of 2 ``gloo`` ranks.

The module fixture starts ``bin/train`` under ``torch.distributed.run``
and the ranks of every case but the resume in one spawn of
``tests/torch_parallel_workers.py`` (jax-free), computes the JAX references
and the one-process runs while they run, then resumes the one-process
checkpoint in a second spawn of the world. Both sides start from the same JAX-initialised weights
(bridged with ``utils/bridge.py``) and take the same seeded numpy batch of
B = 4 ragged rows of precomputed features, the last a filler of weight 0
(rank 1 holds rows 2 and 3): the CTC model (BLSTM-8), the joint
CTC-attention model (BLSTM-8, hybrid attention, every training term on)
and the transducer (LSTM-8), one SGD step (lr 0.1) and one Adam step (lr
1e-3) each, clip 5.0; a MoE conformer CTC model (width 8, 3 experts, top
2, load-balance weight 0.5), one SGD step, whose load-balance term JAX
takes over the global batch's frames (the filler's too); and the CTC model
at ``grad_accum_steps`` 2 (each rank splits its 2 rows into 2
microbatches; the weighted mean equals JAX's one DP step). Dropout stays
at keep 1.0 and scheduled sampling at 0 (jax.random cannot be replayed in
torch).
Tolerances, float32, as ``tests/test_torch_train_step.py``:

- the loss and each aux term: atol 1e-4, rtol 1e-5;
- SGD's weights after the step: atol 2e-5, rtol 1e-4;
- Adam's weights within 0.1 lr per step, its moments within 1e-3 of their
  largest entry + rtol 1e-3.

Under DP the two ranks' weights and optimizer states are bit-identical.
The dev error rates of world 2 (each rank decodes its rows; a filler row
counts on no rank) equal world 1's exactly (loss rtol 1e-6). ``fit`` with
``num_devices: 2`` for one toy epoch matches the first epoch of ``fit`` in
one process (steps and dev error equal, losses rtol 1e-4, weights within
Adam's 0.1 lr per step), that run's epoch-0 checkpoint resumes in world 2
for the epoch its second one trained, and ``bin/train`` runs under ``python -m torch.distributed.run
--nproc-per-node 2 ... --device cpu`` (with ``fsdp: true``).
"""

import csv
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tensorflow_end2end_speech_recognition_tpu.models import encoders as jencoders
from tensorflow_end2end_speech_recognition_tpu.models import seq2seq as jseq2seq
from tensorflow_end2end_speech_recognition_tpu.models.attention import (
    AttentionConfig as JAttentionConfig,
)
from tensorflow_end2end_speech_recognition_tpu.models.ctc import CTCConfig as JCTCConfig
from tensorflow_end2end_speech_recognition_tpu.models.transducer import (
    TransducerConfig as JTransducerConfig,
)
from tensorflow_end2end_speech_recognition_tpu.parallel import make_mesh as jmake_mesh
from tensorflow_end2end_speech_recognition_tpu.parallel import (
    setup_data_parallel as jsetup_data_parallel,
)
from tensorflow_end2end_speech_recognition_tpu.parallel import setup_fsdp as jsetup_fsdp
from tensorflow_end2end_speech_recognition_tpu.parallel.multihost import (
    process_slice as jprocess_slice,
)
from tensorflow_end2end_speech_recognition_tpu.train import att_task as jatt
from tensorflow_end2end_speech_recognition_tpu.train import ctc_task as jctc
from tensorflow_end2end_speech_recognition_tpu.train import transducer_task as jtt
from tensorflow_end2end_speech_recognition_tpu.train.optimizer import (
    build_optimizer as jbuild_optimizer,
)
from tensorflow_end2end_speech_recognition_tpu_torch.models.attention import AttentionConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.ctc import CTCConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.encoders import EncoderConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.seq2seq import Seq2SeqConfig
from tensorflow_end2end_speech_recognition_tpu_torch.models.transducer import TransducerConfig
from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    process_slice,
    replicated,
)
from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import rank_seed
from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task
from tensorflow_end2end_speech_recognition_tpu_torch.train import transducer_task as tt
from tensorflow_end2end_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit
from tensorflow_end2end_speech_recognition_tpu_torch.utils.bridge import (
    adam_state_from_jax,
    params_from_jax,
)
from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
C = 6
D = 10  # precomputed feature width
T = 27  # frames: T' = 9 after 3/3 stacking
H = 8
LR = {"sgd": 0.1, "adam": 1e-3}
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
FEATURES = dict(frontend=None, feature_dim=D, num_stack=3, num_skip=3)


def _ctc():
    enc = dict(encoder_type="blstm", num_units=H, num_layers=1)
    kw = dict(FEATURES, weight_decay=1e-2)
    return (jctc.CTCTaskConfig(model=JCTCConfig(encoder=jencoders.EncoderConfig(**enc),
                                                num_classes=C), **kw),
            ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                   **kw))


def _joint():
    enc = dict(encoder_type="blstm", num_units=H, num_layers=1)
    att = dict(attention_type="hybrid", attention_dim=H, conv_num_channels=4, conv_width=5)
    common = dict(num_classes=C, decoder_num_units=H, embedding_dim=4, max_decode_length=6,
                  scheduled_sampling_prob=0.0, ctc_loss_weight=0.3)
    kw = dict(FEATURES, weight_decay=1e-2, label_smoothing=0.05, guided_attention_weight=5.0,
              guided_attention_sigma=0.2, guided_attention_decay_steps=20,
              ctc_weight_init=0.6, ctc_weight_anneal_steps=60)
    jcfg = jseq2seq.Seq2SeqConfig(encoder=jencoders.EncoderConfig(**enc),
                                  attention=JAttentionConfig(**att), **common)
    cfg = Seq2SeqConfig(encoder=EncoderConfig(**enc), attention=AttentionConfig(**att), **common)
    return jatt.AttTaskConfig(model=jcfg, **kw), att_task.AttTaskConfig(model=cfg, **kw)


def _transducer():
    enc = dict(encoder_type="lstm", num_units=H, num_layers=1)
    model = dict(num_classes=C, pred_num_units=H, embedding_dim=4, joint_dim=H)
    return (jtt.TransducerTaskConfig(
                model=JTransducerConfig(encoder=jencoders.EncoderConfig(**enc), **model),
                weight_decay=1e-2, **FEATURES),
            tt.TransducerTaskConfig(
                model=TransducerConfig(encoder=EncoderConfig(**enc), **model),
                weight_decay=1e-2, **FEATURES))


def _moe():
    enc = dict(encoder_type="conformer", num_units=H, num_layers=1, num_heads=2,
               conv_kernel_size=3, ff_expansion=2, moe_experts=3, moe_top_k=2,
               moe_aux_weight=0.5)
    kw = dict(FEATURES, weight_decay=1e-2)
    return (jctc.CTCTaskConfig(model=JCTCConfig(encoder=jencoders.EncoderConfig(**enc),
                                                num_classes=C), **kw),
            ctc_task.CTCTaskConfig(model=CTCConfig(encoder=EncoderConfig(**enc), num_classes=C),
                                   **kw))


# family -> (tasks, JAX module, port module name, extra step arguments)
FAMILIES = {
    "ctc": (_ctc, jctc, "ctc_task", {}),
    "joint": (_joint, jatt, "att_task", {"step": 7}),
    "transducer": (_transducer, jtt, "transducer_task", {}),
    "moe": (_moe, jctc, "ctc_task", {}),
}
PORT = {"ctc_task": ctc_task, "att_task": att_task, "transducer_task": tt}


def make_batch(seed: int = 3) -> dict:
    """4 ragged [T, D] feature rows, the last a filler of weight 0."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(4, T, D).astype(np.float32) * 2.0 + 1.0
    input_len = np.asarray([T, 22, 14, T], np.int32)
    for i, n in enumerate(input_len):
        feats[i, n:] = 0.0
    label_len = np.asarray([3, 1, 2, 3], np.int32)
    labels = np.full((4, 4), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, C, n)
    return {"inputs": feats, "input_len": input_len, "labels": labels, "label_len": label_len,
            "weight": np.asarray([1, 1, 1, 0], np.float32)}


@functools.lru_cache(maxsize=None)
def setup(family):
    make_tasks, jmod, mod, _ = FAMILIES[family]
    jtask, task = make_tasks()
    jparams = jmod.init_params(jax.random.PRNGKey(0), jtask)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), PORT[mod].init_model(task))
    return jtask, task, jparams, params


def port_job(name, family, opt, **kw) -> dict:
    _, task, _, params = setup(family)
    _, _, mod, extra = FAMILIES[family]
    return dict(kind="steps", name=name, module=mod, task=task, params=params,
                batch=make_batch(), opt=opt, lr=LR[opt], extra=extra, **kw)


def jax_steps(family, opt, accum=1, fsdp=False, steps=1):
    """JAX's train step on ``make_mesh(2)`` (DP, or ``setup_fsdp``): (params,
    optimizer state, aux) after ``steps`` steps, and the mesh-placed params."""
    jtask, _, jparams, _ = setup(family)
    _, jmod, _, extra = FAMILIES[family]
    jopt = jbuild_optimizer(opt, 5.0)
    jstep = jmod.make_train_step(jtask, jopt, grad_accum=accum)
    p = jax.tree.map(jnp.array, jparams)  # the step donates its inputs
    setup_fn = jsetup_fsdp if fsdp else jsetup_data_parallel
    p, s, b = setup_fn(jmake_mesh(WORLD), p, jopt.init(p),
                       {k: jnp.asarray(v) for k, v in make_batch().items()})
    for _ in range(steps):
        p, s, aux = jstep(p, s, b, LR[opt], jax.random.PRNGKey(1), *extra.values())
    return p, s, aux


def assert_step_matches(family, opt, got: dict, want, lr_steps: int = 1):
    """The port's (rank 0's) aux and whole weights and Adam state against
    JAX's (params, state, aux)."""
    jp, js, jaux = want
    model = PORT[FAMILIES[family][2]].init_model(setup(family)[1])
    aux = got["aux"][-1]
    assert not aux["nonfinite"] and not bool(jaux["nonfinite"])
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(aux[k], float(jaux[k]), **LOSS_TOL, err_msg=k)
    params, state = got.get("whole", got["params"]), got.get("whole_state", got["state"])
    ref = params_from_jax(jax.tree.map(np.asarray, jp), model)
    tol = GRAD_TOL if opt == "sgd" else dict(atol=0.1 * LR[opt] * lr_steps, rtol=0)
    for k in ref:
        np.testing.assert_allclose(params[k].numpy(), ref[k].numpy(), **tol, err_msg=k)
    if opt == "adam":
        jadam = adam_state_from_jax(jax.tree.map(np.asarray, js), model)
        assert int(state["count"]) == int(jadam["count"]) == lr_steps
        for m in ("mu", "nu"):
            for k, v in state[m].items():
                w = jadam[m][k].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=1e-3, err_msg=f"{m}.{k}",
                                           atol=1e-3 * float(np.abs(w).max()) + 1e-12)


FIT = dict(model_type="ctc", corpus="toy", label_type="character", input_size=40,
           use_energy=False, use_delta=False, num_stack=3, num_skip=3, encoder_type="blstm",
           num_units=8, num_layers=1, dropout=1.0, batch_size=4, num_epoch=1,
           optimizer="adam", learning_rate=1e-3, clip_grad_norm=5.0, weight_decay=1e-8,
           sort_utt=True, toy_num_utts=30, toy_max_units=4)
EVAL = {
    # dev split of 3 utterances in a batch of 4: rank 1 holds one real row and a filler
    "ctc": FIT,
    "joint": dict(FIT, model_type="joint_ctc_attention", attention_type="hybrid", attention_dim=8,
                  decoder_num_units=8, embedding_dim=4, max_decode_length=8,
                  scheduled_sampling_prob=0.0),
}
STEP_CASES = [(f, o) for f in ("ctc", "joint", "transducer") for o in ("sgd", "adam")]
STEP_CASES.append(("moe", "sgd"))


def _load(out: Path, name: str) -> list:
    return [torch.load(out / f"{name}_{r}.pt", weights_only=False) for r in range(WORLD)]


def _epoch_row(model_dir: Path, epoch: int) -> dict:
    """``fit``'s metrics.csv row of ``epoch`` (floats as written)."""
    rows = list(csv.DictReader(open(model_dir / "metrics.csv")))
    row = next(r for r in rows if int(r["epoch"]) == epoch)
    return {"steps": int(row["step"]), **{k: float(row[k]) for k in
                                          ("train_loss", "dev_loss", "dev_error_rate")}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``bin/train`` under ``torch.distributed.run`` and a spawn of 2 ranks
    for every world-2 case of this module but the resume started first; the
    JAX references and the one-process runs computed while they run; then
    the resume of the one-process checkpoint in world 2."""
    tmp = tmp_path_factory.mktemp("world")
    out = tmp / "out"
    cfg = tmp / "fsdp.yml"
    cfg.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in
                           dict(FIT, num_devices=WORLD, fsdp=True).items()))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(WORLD), "-m", "tensorflow_end2end_speech_recognition_tpu_torch.bin.train",
         str(cfg), str(tmp / "cli"), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        exp2 = experiment_from_dict(dict(FIT, num_devices=WORLD))
        jobs = [port_job(f"dp_{f}_{o}", f, o) for f, o in STEP_CASES]
        jobs.append(port_job("dp_ctc_accum2", "ctc", "sgd", accum=2))
        jobs += [dict(kind="eval", name=f"eval_{k}",
                      exp=experiment_from_dict(dict(raw, num_devices=WORLD)))
                 for k, raw in EVAL.items()]
        jobs.append(dict(kind="fit", name="fit_dp", exp=exp2, model_dir=str(tmp / "two")))
        jobs.append(dict(kind="refused", name="fit_unset", model_dir=str(tmp / "unset"),
                         exp=experiment_from_dict(FIT)))
        (tmp / "w").mkdir()
        ranks = workers.spawn(jobs, WORLD, tmp / "w", out)
        want = {f"dp_{f}_{o}": jax_steps(f, o) for f, o in STEP_CASES}
        eval1 = {k: workers.eval_rates(experiment_from_dict(raw)) for k, raw in EVAL.items()}
        # one process for two epochs (log_every 1, as the ranks' fit jobs: train_loss is
        # the mean of every step's loss); its epoch-0 checkpoint alone resumes in world 2
        one = tmp / "one"
        two_epochs = fit(experiment_from_dict(dict(FIT, num_epoch=2)), one, log_every=1,
                         print_fn=lambda *a: None, device="cpu")
        (tmp / "back" / "checkpoints").mkdir(parents=True)
        shutil.copy(one / "checkpoints" / "epoch_0.pt", tmp / "back" / "checkpoints")
        (tmp / "back" / "checkpoints" / "index.json").write_text(
            json.dumps({"0": _epoch_row(one, 0)["dev_error_rate"]}))
        workers.join(ranks)
        back = dict(kind="fit", name="fit_back", model_dir=str(tmp / "back"),
                    exp=dataclasses.replace(exp2, num_epoch=2))
        workers.join(workers.spawn([back], WORLD, tmp, out))
        log, _ = torchrun.communicate(timeout=300)
    finally:
        torchrun.kill()
    return dict(tmp=tmp, out=out, want=want, one=_epoch_row(one, 0), two_epochs=two_epochs,
                eval1=eval1, cli=(torchrun.returncode, log))


def test_process_slice_matches_jax():
    rng = np.random.RandomState(0)
    batch = {"inputs": rng.randn(8, 5).astype(np.float32), "input_len": np.arange(8),
             "names": [f"u{i}" if i < 6 else None for i in range(8)]}
    for n in (1, 2, 4, 8):
        for p in range(n):
            got, want = process_slice(batch, p, n), jprocess_slice(batch, p, n)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for bad in ({"a": np.zeros(4), "b": np.zeros(3)}, {"a": np.zeros(6)}):
        with pytest.raises(ValueError) as port_err:
            process_slice(bad, 0, 4)
        with pytest.raises(ValueError) as jax_err:
            jprocess_slice(bad, 0, 4)
        assert str(port_err.value) == str(jax_err.value)
    assert process_slice(batch) is batch  # no process group: one rank holds every row


def test_mesh_without_a_process_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.shape) == (0, 1, None, {"data": 1})
    assert batch_sharding(mesh) == ("data",) and replicated(mesh) == ()
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, device="cpu")
    # per-rank dropout streams: rank 0 keeps the one-process seed, rank 1 draws others
    assert rank_seed(5, 0) == 5
    draws = [torch.rand(8, generator=torch.Generator().manual_seed(rank_seed(5, r)))
             for r in range(2)]
    assert not torch.equal(*draws)


@pytest.mark.parametrize("family,opt", STEP_CASES)
def test_dp_step_matches_jax(world, family, opt):
    r0, r1 = _load(world["out"], f"dp_{family}_{opt}")
    assert_step_matches(family, opt, r0, world["want"][f"dp_{family}_{opt}"])
    # each rank held its own rows: rank 1 the last two, the filler among them
    np.testing.assert_array_equal(r1["rows"]["weight"].numpy(), [1.0, 0.0])
    # the replicas stay bit-identical: weights and optimizer state
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    flat = lambda s: {f"{m}.{k}": v for m, d in s.items()  # noqa: E731
                      for k, v in (d.items() if isinstance(d, dict) else [("", d)])}
    s0, s1 = flat(r0["state"]), flat(r1["state"])
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)


def test_dp_grad_accum_matches_jax(world):
    """Each rank's 2 rows in 2 microbatches: the same weighted mean as JAX's
    one DP step (its own accumulated step equals it: tests/test_grad_accum.py)."""
    r0, r1 = _load(world["out"], "dp_ctc_accum2")
    assert_step_matches("ctc", "sgd", r0, world["want"]["dp_ctc_sgd"])
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k


@pytest.mark.parametrize("family", sorted(EVAL))
def test_eval_rates_of_world_2_equal_world_1(world, family):
    r0, r1 = _load(world["out"], f"eval_{family}")
    want = world["eval1"][family]
    assert r0["rates"] == r1["rates"]
    got = r0["rates"]
    assert set(got) == set(want) and got["num_utts"] == want["num_utts"] == 3
    for k in want:
        if k == "loss":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            assert got[k] == want[k], k


def test_fit_world_2_matches_one_process(world):
    tmp = world["tmp"]
    r0, r1 = _load(world["out"], "fit_dp")
    got, want = r0["summary"], world["one"]
    same = lambda d: {k: v for k, v in d.items() if k != "utts_per_sec"}  # noqa: E731 (own clock)
    assert same(r1["summary"]) == same(got) and r1["lines"] == []  # rank 0 alone prints
    assert got["steps"] == want["steps"] == 6 and got["epochs"] == 1
    assert got["dev_error_rate"] == want["dev_error_rate"]
    for k in ("train_loss", "dev_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert any(line.startswith("mesh: 2-way data parallel") for line in r0["lines"])
    # rank 0 alone writes the model dir: one event file, whole weights
    assert len(list((tmp / "two" / "events").iterdir())) == 1
    ckpt = {p: CheckpointManager(tmp / p / "checkpoints").restore(
        {"params": None, "extra": None}, epoch=0)[1] for p in ("one", "two")}
    for k, v in ckpt["one"]["params"].items():
        np.testing.assert_allclose(ckpt["two"]["params"][k].numpy(), v.numpy(),
                                   atol=0.1 * 1e-3 * 6, rtol=0, err_msg=k)
    assert len(ckpt["two"]["extra"]["generators"]) == WORLD


def test_one_process_checkpoint_resumes_in_world_2(world):
    r0, _ = _load(world["out"], "fit_back")
    got, want = r0["summary"], world["two_epochs"]
    assert "resuming from checkpoint epoch 0" in r0["lines"]
    assert got["epochs"] == want["epochs"] == 2 and got["steps"] == want["steps"] == 12
    assert got["dev_error_rate"] == want["dev_error_rate"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)


def test_fit_refuses_num_devices_other_than_the_world_size(world):
    """Two ranks with ``num_devices`` unset would train two copies into one
    model dir: ``fit`` refuses, on every rank."""
    for r in _load(world["out"], "fit_unset"):
        assert r["error"] == "ValueError"
        assert r["message"] == "num_devices 1 does not match the process group's world size 2"
    assert not (world["tmp"] / "unset").exists()


def test_bin_train_under_torchrun(world):
    rc, log = world["cli"]
    assert rc == 0, log
    cli = world["tmp"] / "cli"
    text = (cli / "train.log").read_text()
    assert "mesh: 2-way data parallel (fsdp: params+moments sharded) (2 process(es), " \
           "backend gloo)" in text
    assert text.count("FINAL") == 1  # rank 0 alone logs
    summary = json.loads((cli / "summary.json").read_text())
    assert summary["epochs"] == 1 and summary["steps"] == 6
    assert np.isfinite(summary["train_loss"])
    _, state = CheckpointManager(cli / "checkpoints").restore({"params": None})
    assert state["params"]["encoder.layers.0.fwd.wx"].shape == (120, 32)  # whole, not a shard
