"""Rank workers of the port's multi-rank tests (``tests/test_torch_parallel.py``,
``test_torch_fsdp.py``, ``test_torch_tensor_parallel.py``,
``test_torch_seq_expert_parallel.py``).

The ranks are processes started with the ``spawn`` method, so this module
imports torch and the port only, never jax (``tests/conftest.py`` imports
jax; a spawned child imports just this module). ``spawn`` starts a world of
``world`` ranks over ``gloo`` from a ``FileStore`` under the caller's
temporary directory (no fixed TCP port, so parallel test workers never
collide); every rank runs the jobs in order, each writing its results to
``<out>/<job name>_<rank>.pt``.

A job is a dict with ``kind``:

- ``"steps"``: ``steps`` train steps of ``module``'s task on ``batch``
  (this rank's rows of it) on the mesh of ``axes`` (default: ``data``
  over the world), the leaves placed by ``place`` (``"tp"``: Megatron
  blocks, ``"ep"``: expert blocks, ``"pp"``: the stacked layers' stage
  blocks, with Megatron blocks too on a mesh with ``model``, else
  replicated) and, with ``fsdp``, ZeRO-3 on top, from ``params`` (whole,
  on the CPU); ``seed`` turns on the dropout generator (the data index's
  stream). Results: each step's aux floats, this rank's params and
  optimizer state as held, its mesh coordinates, and with split leaves
  their specs and the gathered whole ones.
- ``"fit"``: ``train/loop.fit`` of ``exp`` into ``model_dir`` on the CPU;
  ``"refused"``: the same, expected to raise (its type and text).
- ``"eval"``: ``utils/metrics.evaluate_ctc`` of ``exp``'s model (seeded
  weights) on its dev split, with this rank's rows.
- ``"norm"``: ``train/optimizer.global_norm`` of each of ``trees`` (whole
  leaves on the CPU), over the whole tree as a data-parallel step takes it
  and over this rank's ZeRO-3 blocks (``fsdp_partition_specs`` over the
  world); results: the two norms of each tree.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PKG = "tensorflow_end2end_speech_recognition_tpu_torch"


def spawn(jobs: list, world: int, tmp: Path, out: Path):
    """Start the ranks without waiting: ``.join()`` the returned context
    (it raises if a rank failed)."""
    out.mkdir(parents=True, exist_ok=True)
    return mp.start_processes(run_rank, args=(world, str(tmp / "store"), jobs, str(out)),
                              nprocs=world, start_method="spawn", join=False)


def join(ctx, timeout: float = 300.0) -> None:
    """Wait for every rank of ``spawn``; raise if one failed or the world
    does not finish within ``timeout`` seconds."""
    import time

    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish within {timeout} s")


def run_rank(rank: int, world: int, store: str, jobs: list, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        for job in jobs:
            res = RUNNERS[job["kind"]](rank, world, job)
            torch.save(res, Path(out) / f"{job['name']}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_steps(rank: int, world: int, job: dict) -> dict:
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
        expert_partition_specs,
        fsdp_partition_specs,
        make_grid,
        param_partition_specs,
        pipeline_param_specs,
        pp_stack_tree,
        shard_batch,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.fsdp import (
        gather_whole,
        place,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.mesh import rank_seed
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import (
        build_optimizer,
    )

    mod = importlib.import_module(f"{PKG}.train.{job['module']}")
    mesh = make_grid(job.get("axes", {"data": world}), device="cpu")
    opt = build_optimizer(job["opt"], job.get("clip", 5.0))
    params = {k: v.clone() for k, v in job["params"].items()}
    if job.get("place") == "pp":
        params = pp_stack_tree(params, mesh.shape["pipe"])
    state = opt.init(params)
    base = {"tp": param_partition_specs, "ep": expert_partition_specs,
            "pp": lambda p: pipeline_param_specs(p, "model" in mesh.shape)}.get(job.get("place"))
    specs = base(params) if base is not None else None
    if job.get("fsdp"):
        specs = fsdp_partition_specs(params, mesh.shape["data"], specs)
    params, state, rows = place(mesh, params, state, specs, job["batch"])
    step = mod.make_train_step(job["task"], opt, grad_accum=job.get("accum", 1), mesh=mesh,
                               specs=specs)
    generator = None
    if "seed" in job:  # dropout on: the data index's stream, as fit seeds it
        generator = torch.Generator().manual_seed(rank_seed(job["seed"], mesh.coord("data")))
    auxes = []
    for _ in range(job.get("steps", 1)):
        params, state, aux = step(params, state, rows, job["lr"], generator,
                                  **job.get("extra", {}))
        auxes.append({k: float(v) for k, v in aux.items()})
    res = {"aux": auxes, "params": params, "state": state, "coords": mesh.coords(), "rows": {
        k: v for k, v in shard_batch(mesh, job["batch"]).items()}}
    if specs is not None:
        res.update(specs=specs, whole=gather_whole(mesh, params, specs),
                   whole_state=gather_whole(mesh, state, specs))
    return res


def run_fit(rank: int, world: int, job: dict) -> dict:
    from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit

    lines = []
    summary = fit(job["exp"], job["model_dir"], log_every=job.get("log_every", 1),
                  print_fn=lines.append, device="cpu")
    return {"summary": summary, "lines": lines}


def run_refused(rank: int, world: int, job: dict) -> dict:
    """``fit`` of ``exp`` expected to refuse: the exception's type and text."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import fit

    try:
        fit(job["exp"], job["model_dir"], print_fn=lambda *a: None, device="cpu")
    except (ValueError, NotImplementedError) as e:
        return {"error": type(e).__name__, "message": str(e)}
    return {"error": None}


def run_eval(rank: int, world: int, job: dict) -> dict:
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import make_mesh

    mesh = make_mesh(world, device="cpu")
    return {"rates": eval_rates(job["exp"], mesh)}


def eval_rates(exp, mesh=None) -> dict:
    """``evaluate_ctc`` of ``exp``'s task with weights seeded from ``exp.seed``
    on its dev split, on the CPU (over ``mesh``'s ranks when given)."""
    from tensorflow_end2end_speech_recognition_tpu_torch.data.dataset import Dataset
    from tensorflow_end2end_speech_recognition_tpu_torch.train.loop import (
        build_corpus_splits,
        build_task,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.metrics import evaluate_ctc

    _, dev, _, tok = build_corpus_splits(exp, need=("dev",))
    task, mod = build_task(exp, tok)
    params = mod.init_params(task, torch.Generator().manual_seed(exp.seed))
    ds = Dataset(dev, exp.eval_batch_size or exp.batch_size, sort_utt=True)
    return evaluate_ctc(mod.make_eval_step(task), params, ds, tok, exp.label_type, 0, "cpu",
                        mesh)


def run_norm(rank: int, world: int, job: dict) -> dict:
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel import (
        fsdp_partition_specs,
        make_grid,
    )
    from tensorflow_end2end_speech_recognition_tpu_torch.parallel.fsdp import shard_tree
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import global_norm

    mesh = make_grid({"data": world}, device="cpu")
    norms = []
    for tree in job["trees"]:
        specs = fsdp_partition_specs(tree, world)
        norms.append((global_norm(tree), global_norm(shard_tree(mesh, tree, specs), mesh, specs)))
    return {"norms": norms}


RUNNERS = {"steps": run_steps, "fit": run_fit, "refused": run_refused, "eval": run_eval,
           "norm": run_norm}
