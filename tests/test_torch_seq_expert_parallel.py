"""The port's sequence and expert parallelism (``parallel/sp.py``,
``parallel/ep.py``, the conformer's frame and expert shards, the train step
built with ``mesh=`` and ``specs=``) alone and with ZeRO-3 (fsdp x sp,
fsdp x ep), and a MoE conformer's data-parallel step over microbatches,
against the JAX package on the CPU over worlds of 2 and 4 ``gloo`` ranks.

Pure tests: ``expert_partition_specs`` on every leaf of the toy MoE
conformer and ``fsdp_partition_specs(base_specs=)`` of it against JAX's
specs; ``seq_shard_fn`` cutting frames as ``P(data, seq, None)`` places
them on a ``(data, seq)`` mesh.

The module fixture runs the worlds of 2 and 4 one after the other
(``tests/torch_parallel_workers.py``, jax-free) and computes the JAX
one-device references of each family (``tests/torch_axes_common.py``)
while they run:

- sp2 (world 2) for the absolute, relative and rotary + ``left_context``
  conformers and dp2 x sp2 + fsdp (world 4) for the relative one, one SGD
  and one Adam step each; sp2 for the MoE conformer (its load-balance
  counts over the frames of both seq ranks), one SGD step;
- ep2 (world 2), ep4 and dp2 x ep2 + fsdp (world 4) for the MoE conformer,
  one SGD and one Adam step each, every rank's expert blocks against JAX's
  specs;
- the MoE conformer data parallel at ``grad_accum_steps`` 2 (world 2): rank
  r's microbatch a holds rows r·2 + a, so microbatch a of both ranks is the
  JAX step's microbatch a, and the step equals JAX's one-device step at
  ``grad_accum`` 2 (one SGD step);
- dropout on (keep 0.9): after a step under sp2 and under ep2 the
  replicated leaves and the gathered weights are bit-identical on every rank.

Each step is held against the JAX one-device step on the whole batch, with
the tolerances of ``tests/torch_axes_common.py``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import torch_parallel_workers as workers
from tensorflow_end2end_speech_recognition_tpu.parallel.ep import (
    expert_partition_specs as jexpert_partition_specs,
)
from tensorflow_end2end_speech_recognition_tpu.parallel.fsdp import (
    fsdp_partition_specs as jfsdp_partition_specs,
)
from tensorflow_end2end_speech_recognition_tpu.parallel.sp import (
    make_mesh_dp_sp as jmake_mesh_dp_sp,
)
from tensorflow_end2end_speech_recognition_tpu.parallel.sp import (
    seq_shard_fn as jseq_shard_fn,
)
from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
    expert_partition_specs,
    fsdp_partition_specs,
    seq_shard_fn,
)
from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import Mesh
from torch_axes_common import (
    FAMILIES,
    assert_blocks,
    assert_replicas_identical,
    assert_step_matches,
    jax_specs,
    reference,
    setup,
    step_job,
)

torch.set_num_threads(1)

SP2 = {"data": 1, "seq": 2}
DP2_SP2 = {"data": 2, "seq": 2}
EP2 = {"data": 1, "expert": 2}
EP4 = {"data": 1, "expert": 4}
DP2_EP2 = {"data": 2, "expert": 2}
DENSE = ("absolute", "relative", "rotary")
OPTS = ("sgd", "adam")
# name -> (world, axes, family, placement, fsdp)
STEPS = {
    **{f"sp2_{f}": (2, SP2, f, None, False) for f in DENSE},
    "dp2_sp2_fsdp_relative": (4, DP2_SP2, "relative", None, True),
    "ep2_moe": (2, EP2, "moe", "ep", False),
    "ep4_moe": (4, EP4, "moe", "ep", False),
    "dp2_ep2_fsdp_moe": (4, DP2_EP2, "moe", "ep", True),
}
CASES = [(name, o) for name in STEPS for o in OPTS] + [("sp2_moe", "sgd")]
MESHES = {name: axes for name, (_, axes, _, _, _) in STEPS.items()}
MESHES["sp2_moe"] = SP2


def _load(out: Path, name: str, world: int) -> list:
    return [torch.load(out / f"{name}_{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 2 started first and the JAX references computed while it
    runs, then the world of 4 beside the MoE accumulation's reference (never
    two worlds at once)."""
    tmp = tmp_path_factory.mktemp("sp_ep")
    out = tmp / "out"
    jobs = {2: [], 4: []}
    for name, (size, axes, family, place, fsdp) in STEPS.items():
        jobs[size] += [step_job(f"{name}_{o}", family, o, axes, place, fsdp) for o in OPTS]
    jobs[2].append(step_job("sp2_moe_sgd", "moe", "sgd", SP2))
    jobs[2].append(step_job("dp2_moe_accum2_sgd", "moe", "sgd", {"data": 2}, accum=2))
    jobs[2].append(step_job("sp2_dropout", "rotary", "adam", SP2, keep=0.9))
    jobs[2].append(step_job("ep2_dropout", "moe", "adam", EP2, "ep", keep=0.9))
    (tmp / "w2").mkdir()
    (tmp / "w4").mkdir()
    ranks = workers.spawn(jobs[2], 2, tmp / "w2", out)
    for f in FAMILIES:
        reference(f)
    workers.join(ranks)
    ranks = workers.spawn(jobs[4], 4, tmp / "w4", out)
    reference("moe", accum=2)
    workers.join(ranks)
    return dict(tmp=tmp, out=out)


def test_expert_partition_specs_match_jax():
    _, _, jparams, params = setup("moe")
    got = expert_partition_specs(params)
    assert got == jax_specs(jexpert_partition_specs(jparams), params)
    assert {k for k, s in got.items() if s} == {k for k in params
                                                if ".moe.in." in k or ".moe.out." in k}
    assert all(s == ("expert",) for s in got.values() if s)
    assert not got["encoder.conformer.layers.0.moe.router.w"]
    for n in (2, 4):
        composed = fsdp_partition_specs(params, n, got)
        assert composed == jax_specs(jfsdp_partition_specs(
            jparams, n, base_specs=jexpert_partition_specs(jparams)), params)
        assert any(s[:1] == ("expert",) and "data" in s for s in composed.values())


@pytest.mark.parametrize("t", [20, 21, 7])
def test_seq_shard_fn_cuts_frames_as_jax_places_them(t):
    x = np.random.RandomState(t).randn(4, t, 3).astype(np.float32)
    pad = -(-t // 2) * 2 - t  # JAX needs a divisible axis: the port pads with zeros
    xp = np.pad(x, ((0, 0), (0, pad), (0, 0)))
    jx = jax.device_put(xp, NamedSharding(jmake_mesh_dp_sp(2, 2), jax.sharding.PartitionSpec()))
    placed = jax.jit(jseq_shard_fn(jmake_mesh_dp_sp(2, 2)))(jx)
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    devices = jax.devices()[:4]
    for r in range(4):
        d, s = divmod(r, 2)
        # a mesh built by hand: its lines' sizes and indices, no process group
        mesh = Mesh(r, 4, torch.device("cpu"), None, (("data", 2), ("seq", 2)),
                    ((("data",), None), (("seq",), None)))
        assert mesh.coords() == {"data": d, "seq": s}
        rows = torch.from_numpy(x)[d * 2:(d + 1) * 2]  # the data index's rows (shard_batch)
        np.testing.assert_array_equal(seq_shard_fn(mesh)(rows).numpy(), shards[devices[r]])


@pytest.mark.parametrize("name,opt", CASES)
def test_step_matches_jax_one_device(world, name, opt):
    size = STEPS[name][0] if name in STEPS else 2
    family = STEPS[name][2] if name in STEPS else "moe"
    ranks = _load(world["out"], f"{name}_{opt}", size)
    for r in ranks:
        assert_step_matches(r, family, opt)
    params = setup(family)[3]
    place = STEPS[name][3] if name in STEPS else None
    fsdp = STEPS[name][4] if name in STEPS else False
    if place or fsdp:
        axes = MESHES[name]
        jparams = setup(family)[2]
        base = jexpert_partition_specs(jparams) if place == "ep" else None
        specs = (jfsdp_partition_specs(jparams, axes["data"], base_specs=base) if fsdp
                 else base)
        assert_blocks(ranks, jax_specs(specs, params), axes)
    assert_replicas_identical(ranks)


def test_moe_dp_step_over_microbatches_matches_jax(world):
    ranks = _load(world["out"], "dp2_moe_accum2_sgd", 2)
    for r in ranks:
        assert_step_matches(r, "moe", "sgd", accum=2)
    assert_replicas_identical(ranks)
    assert [r["rows"]["weight"].numpy().tolist() for r in ranks] == [[1.0, 1.0], [1.0, 0.0]]


@pytest.mark.parametrize("name", ["sp2_dropout", "ep2_dropout"])
def test_replicas_bit_identical_with_dropout(world, name):
    ranks = _load(world["out"], name, 2)
    assert all(not r["aux"][0]["nonfinite"] for r in ranks)
    assert_replicas_identical(ranks)
    family = "rotary" if name == "sp2_dropout" else "moe"
    assert abs(ranks[0]["aux"][0]["loss"] - reference(family)["adam"][2]["loss"]) > 1e-4
