"""Closed-loop training: one train step object driven back to back.

Set-up builds the port's train step (``train/ctc_task`` or ``att_task``
``make_train_step``) with its weights (from the seed, on the card) and
Adam's state, makes the mix's batches in pinned host memory, runs the first
three steps through the window's own call and feed (their losses, the
first gradient Adam received and the weights' change are kept for the
check), then one step on every other batch shape. The window then runs
steps until ``seconds`` have passed, each copying its batch to the card
first, and ends when the card has finished the last one. Afterwards the
program's state is freed and the reference repeats the first three steps.

Faults (tests only): ``frozen`` returns the state unchanged from every
step; ``half_batch`` feeds each step the first half of its rows;
``no_exchange`` leaves out the ranks' all-reduce in the step.
"""

from __future__ import annotations

import functools
import time

import torch

from portbench import correct, traffic, weights
from portbench.reference import full_fp32, quant, train as ref_train
from portbench.trace import busy, breakdown

CHECKED_STEPS = 3


def program(cell):
    """(task module, task, the experiment's typed config) of the port."""
    from tensorflow_end2end_speech_recognition_tpu_torch.train import att_task, ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

    exp = experiment_from_dict(cell.exp)
    task = exp.task(cell.config["num_classes"])
    attention = cell.exp["model_type"] in ("attention", "joint_ctc_attention")
    return (att_task if attention else ctc_task), task, exp


def batches_of(cell, seed: int, device) -> list:
    return traffic.train_batches(cell.mix, cell.config["num_classes"],
                                 cell.config["labels_per_second"], seed, device)


def with_faults(step, faults: set):
    if "no_exchange" in faults:
        from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task

        ctc_task.all_reduce_flat = lambda mesh, tensors, dtype=None: list(tensors)
    if "frozen" in faults:
        inner = step

        def step(params, state, batch, lr, gen, **kw):  # noqa: F811
            _, _, aux = inner(params, state, batch, lr, gen, **kw)
            return params, state, aux
    if "half_batch" in faults:
        inner_half = step

        def step(params, state, batch, lr, gen, **kw):  # noqa: F811
            half = batch["input_len"].shape[0] // 2
            return inner_half(params, state, {k: v[:half] for k, v in batch.items()}, lr, gen,
                              **kw)
    return step


def run(cell, seed: int, seconds: float, trace, device, start: float, faults=frozenset(),
        log=print, mesh=None) -> dict:
    from tensorflow_end2end_speech_recognition_tpu_torch.train.optimizer import (
        ADAM_B1, build_optimizer)

    from tensorflow_end2end_speech_recognition_tpu_torch import set_full_fp32

    set_full_fp32()  # as the port's training entry point (train/loop.fit) runs it
    marks = [("torch", time.perf_counter())]
    task_mod, task, exp = program(cell)
    marks.append(("port", time.perf_counter()))
    mix = cell.mix
    rank = 0 if mesh is None else mesh.rank
    world = 1 if mesh is None else mesh.size
    leaf_shapes = weights.shapes(task_mod, task)
    params = weights.make(leaf_shapes, exp.parameter_init, traffic.torch_seed(seed, 7), device)
    p0 = {k: v.clone() for k, v in params.items()}
    opt = build_optimizer("adam", exp.clip_grad_norm)
    state = opt.init(params)
    global_step = cell.config.get("global_step")
    step = task_mod.make_train_step(task, opt, mesh=mesh)
    if global_step is not None:
        step = functools.partial(step, step=global_step)
    step = with_faults(step, faults)
    lr = exp.learning_rate
    marks.append(("weights", time.perf_counter()))
    batches = batches_of(cell, seed, device)
    marks.append(("batches", time.perf_counter()))
    share = mix["rows"] // world
    mine = slice(rank * share, (rank + 1) * share)
    gen = torch.Generator(device=device).manual_seed(traffic.torch_seed(seed, 8 + rank))

    def feed(b):
        return {k: v[mine].to(device, non_blocking=True) for k, v in b.items()}

    losses, nonfinite = [], []
    grad1 = delta = None
    for i, b in enumerate(batches):
        if i == CHECKED_STEPS and device.type == "cuda":
            torch.cuda.synchronize(device)
            t_warm = time.perf_counter()
        params, state, aux = step(params, state, feed(b), lr, gen)
        if i == 0:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.append(("first step", time.perf_counter()))
        nonfinite.append(aux["nonfinite"])
        if i < CHECKED_STEPS:
            losses.append(aux["loss"])
        if i == 0:
            grad1 = {k: float((m.double() / (1 - ADAM_B1)).norm()) for k, m in state["mu"].items()}
        if i == CHECKED_STEPS - 1:
            delta = {k: float((params[k].double() - p0[k].double()).norm()) for k in params}
            del p0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    steps = None  # one rank: steps until ``seconds`` have passed
    if world > 1:  # ranks step together: rank 0 fixes the count from its warm steps
        per_step = ((time.perf_counter() - t_warm) / (len(batches) - CHECKED_STEPS)
                    if device.type == "cuda" else seconds)
        count = torch.tensor([max(1, round(seconds / per_step))], device=device)
        torch.distributed.broadcast(count, 0)
        steps = int(count.item())
    prog = {"loss": [float(x) for x in losses], "grad1": grad1, "delta": delta}
    setup_s = time.perf_counter() - start
    marks.append(("other steps", time.perf_counter()))
    phases = ", ".join(f"{name} {t - t_prev:.3f}" for (name, t), (_, t_prev)
                       in zip(marks, [("start", start)] + marks))
    log(f"set-up {setup_s:.3f} s ({phases} s): {len(batches)} batches of {mix['rows']} rows "
        f"({share} per rank), first losses {prog['loss']}", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    seconds_of = [traffic.batch_audio_seconds(b) for b in batches]
    ran, audio = [], 0.0
    if mesh is not None:
        from tensorflow_end2end_speech_recognition_tpu_torch.parallel import mesh as mesh_mod

        mesh_mod.reset_traffic()
    with trace.window():
        t0 = time.perf_counter()
        k = 0
        while True:
            i = k % len(batches)
            with trace.span("h2d"):
                fed = feed(batches[i])
            with trace.span("train_step"):
                params, state, aux = step(params, state, fed, lr, gen)
            nonfinite.append(aux["nonfinite"])
            ran.append(i)
            audio += seconds_of[i]
            k += 1
            if (k >= steps) if steps else (time.perf_counter() - t0 >= seconds):
                break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int(sum(bool(x) for x in nonfinite[-len(ran):]))
    bad_setup = int(sum(bool(x) for x in nonfinite[:-len(ran)]))
    log(f"window: {len(ran)} steps in {elapsed:.3f} s, {audio:.1f} s of audio, "
        f"{failed} skipped by the guard (set-up: {bad_setup}), peak {peak} B", flush=True)
    del params, state, aux, fed
    if device.type == "cuda":
        torch.cuda.empty_cache()

    collectives = {} if mesh is None else {k: list(v) for k, v in mesh_mod.TRAFFIC.items()}
    # the CTC cells and the host-paced joint cell spread differently between
    # runs, so their throughputs are two metrics with bounds of their own
    out = {"end_to_end": {"train_audio_s_per_s": audio / elapsed,
                          "joint_train_audio_s_per_s": audio / elapsed,
                          "train_peak_gib": peak / 2**30, "setup_s": setup_s},
           "attempted": len(ran), "failed": failed, "memory_peak_bytes": peak,
           "record": {"exp": cell.exp, "num_classes": cell.config["num_classes"],
                      "batches": [[r.tolist() for r in (b["input_len"][mine],
                                                        b["label_len"][mine])]
                                  for b in batches],
                      "ran": ran, "elapsed_s": elapsed, "world": world,
                      "collectives": collectives,
                      "trace": trace.record}}
    if trace.record is not None:
        out["busy_s"], out["window_s"] = busy(trace.record)
        out["breakdown"] = breakdown(trace.record)
    out["prog"] = prog
    if rank == 0:
        out["checks"] = check(cell, seed, batches, prog, device, world, log)
    return out


def reference_readings(cell, seed: int, batches: list, device, world: int = 1,
                       kind: str | None = None, rows: slice | None = None) -> dict:
    """The reference's first steps from the seed's weights on the checked
    batches, each rank's rows drawing from that rank's generator; ``kind``
    overrides the compute type (the control), ``rows`` keeps only those rows."""
    task_mod, task, exp = program(cell)
    leaf_shapes = weights.shapes(task_mod, task)
    p0 = weights.make(leaf_shapes, exp.parameter_init, traffic.torch_seed(seed, 7), device)
    share = cell.mix["rows"] // world
    blocks = [(slice(r * share, (r + 1) * share),
               torch.Generator(device=device).manual_seed(traffic.torch_seed(seed, 8 + r)))
              for r in range(world)]
    if rows is not None:
        blocks = [(rows, blocks[0][1])]
    q = quant.Quant(kind or cell.exp.get("compute_dtype", "float32"))
    dev_batches = [{k: v.to(device) for k, v in b.items()} for b in batches[:CHECKED_STEPS]]
    return ref_train.train_readings(p0, cell.exp, dev_batches, blocks, q, exp.learning_rate,
                                    cell.config.get("global_step") or 0)


def check(cell, seed: int, batches: list, prog: dict, device, world: int, log) -> dict:
    t0 = time.perf_counter()
    with full_fp32():
        ref = reference_readings(cell, seed, batches, device, world)
    gaps = correct.train_gaps(prog, ref)
    log(f"reference: {CHECKED_STEPS} steps in {time.perf_counter() - t0:.3f} s, losses "
        f"{ref['loss']} (program {prog['loss']})", flush=True)
    return {name: {"value": value, "limit": cell.limits[name]} for name, value in gaps.items()}


def calibrate(cell, seeds, control_seeds, device, log=print) -> None:
    """The readings that the limits are set from, printed one JSON line each:
    the program's numbers on ``seeds`` (short windows), and on
    ``control_seeds`` the control's (the reference in float8 against the
    reference) and the half-batch fault's (the reference on half the rows)."""
    import json

    from portbench import run as harness

    for seed in seeds:
        out = harness.execute(cell, seed, 1.0, False, device, log=lambda *a, **k: None)
        log(json.dumps({"seed": seed, "program": {k: c["value"]
                                                  for k, c in out["checks"].items()}}),
            flush=True)
    world = cell.mix.get("ranks", 1)
    for seed in control_seeds:
        batches = batches_of(cell, seed, device)
        with full_fp32():
            ref = reference_readings(cell, seed, batches, device, world)
            ctl = reference_readings(cell, seed, batches, device, world, kind="float8")
            half = reference_readings(cell, seed, batches, device, world,
                                      rows=slice(0, cell.mix["rows"] // 2))
        log(json.dumps({"seed": seed, "control": correct.train_gaps(ctl, ref),
                        "half_batch": correct.train_gaps(half, ref)}), flush=True)
