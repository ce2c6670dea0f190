"""Open-loop serving: independent callers at a fixed Poisson rate.

Set-up builds the port's model from the seed's weights on the card, its
greedy inference function (``serving.build_inference_fn``) and the
micro-batcher that ``bin/serve.make_server`` puts in front of it
(``serving.MicroBatcher``: rows of ``row_seconds``, batches of
``batch_size``, ``max_wait_ms``), and warms its one batch shape. In the
window a dispatcher hands each request to a caller thread at its due time
(the mix's arrivals from the seed); the caller submits it and waits. A
request's latency runs from its due time to its answer; one that fails or
never comes counts as missing. After the window the sampled requests'
served ids are held against the reference's logits.

Fault (tests only): ``altered_token`` changes the first id of every
batch's first row where the inference function produces it.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import time

import numpy as np
import torch

from portbench import correct, traffic, weights
from portbench.reference import ctc_model, full_fp32, quant
from portbench.trace import breakdown, busy

ANSWER_WAIT_S = 60.0  # past the window's close


def program(cell):
    from tensorflow_end2end_speech_recognition_tpu_torch.train import ctc_task
    from tensorflow_end2end_speech_recognition_tpu_torch.utils.config import experiment_from_dict

    exp = experiment_from_dict(cell.exp)
    return ctc_task, exp.task(cell.config["num_classes"]), exp


def build_model(cell, seed: int, device):
    task_mod, task, exp = program(cell)
    model = task_mod.init_model(task)  # on the CPU, its weights replaced by the seed's
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    params = weights.make(shapes, exp.parameter_init, traffic.torch_seed(seed, 7), device)
    model.load_state_dict(params, assign=True)
    return task, model.eval()


class TimedInfer:
    """The inference function as the batcher calls it, timed on the host up
    to its results on the host; records each call's valid lengths."""

    def __init__(self, infer, faults: set, trace):
        self.infer, self.faults, self.trace = infer, faults, trace
        self.calls = []  # (seconds, lengths)
        self.recording = False

    def __call__(self, batch, lens):
        t0 = time.perf_counter()
        with self.trace.span("infer"):
            ids, n = (x.cpu() for x in self.infer(batch, lens))
        if "altered_token" in self.faults:
            ids = ids.clone()
            ids[0, 0] = ids[0, 0] + 1
        if self.recording:
            self.calls.append((time.perf_counter() - t0, [int(x) for x in lens if x > 0]))
        return ids, n


def percentile(values, p: float) -> float:
    """The p-th percentile (nearest rank) of ``values``, inf counted high."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def run(cell, seed: int, seconds: float, trace, device, start: float, faults=frozenset(),
        log=print) -> dict:
    from tensorflow_end2end_speech_recognition_tpu_torch.serving import (
        MicroBatcher, build_inference_fn)

    mix = cell.mix
    marks = [("torch", time.perf_counter())]
    program(cell)
    marks.append(("port", time.perf_counter()))
    task, model = build_model(cell, seed, device)
    marks.append(("model", time.perf_counter()))
    timed = TimedInfer(build_inference_fn(task, model), faults, trace)
    rows = int(mix["row_seconds"] * traffic.SAMPLE_RATE)
    batcher = MicroBatcher(timed, mix["batch_size"], (rows,), max_wait_ms=mix["max_wait_ms"])
    reqs = traffic.Requests(mix, seed, seconds)
    warm = np.stack([reqs.row(i % len(reqs)) for i in range(mix["batch_size"])])
    for _ in range(3):
        timed(warm, np.full(len(warm), rows, np.int32))
    marks.append(("warm batches", time.perf_counter()))
    with concurrent.futures.ThreadPoolExecutor(mix["batch_size"]) as pool:
        list(pool.map(lambda i: batcher.submit(reqs.row(i), int(reqs.samples[i])),
                      range(mix["batch_size"])))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.freeze()  # the set-up's objects stay out of the collector's full passes, as in a server
    setup_s = time.perf_counter() - start
    marks.append(("warm requests", time.perf_counter()))
    phases = ", ".join(f"{name} {t - t_prev:.3f}" for (name, t), (_, t_prev)
                       in zip(marks, [("start", start)] + marks))
    log(f"set-up {setup_s:.3f} s ({phases} s): {len(reqs)} requests due over {seconds:g} s "
        f"at {mix['rate_per_s']}/s", flush=True)

    n = len(reqs)
    latency = [math.inf] * n
    answers = [None] * n
    late = np.zeros(n)

    def call(i: int, due: float):
        try:
            ids, length = batcher.submit(ready.pop(i), int(reqs.samples[i]),
                                         timeout=seconds + ANSWER_WAIT_S)
        except Exception as e:  # a failed request counts as missing
            log(f"request {i} failed: {e!r}", flush=True)
            return
        latency[i] = time.perf_counter() - due
        answers[i] = np.asarray(ids[:length])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    batches0 = batcher.batches_run
    timed.recording = True
    ready = {}
    with trace.window(), concurrent.futures.ThreadPoolExecutor(mix["callers"]) as pool:
        t0 = time.perf_counter()
        futures = []
        for i in range(n):
            ready[i] = reqs.row(i)  # the caller's audio, ready before it is due
            due = t0 + float(reqs.due[i])
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - due
            futures.append(pool.submit(call, i, due))
        concurrent.futures.wait(futures, timeout=seconds + ANSWER_WAIT_S)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - t0
    timed.recording = False
    batches = batcher.batches_run - batches0
    batcher.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    done = [i for i in range(n) if answers[i] is not None]
    lat_ms = [x * 1e3 for x in latency]
    log(f"window: {n} requests, {len(done)} answered in {elapsed:.3f} s, {batches} batches; "
        f"generator late p50 {np.median(late) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms; "
        f"latency p50 {percentile(lat_ms, 50):.3f} ms, p95 {percentile(lat_ms, 95):.3f} ms, "
        f"peak {peak} B", flush=True)
    out = {"end_to_end": {"serve_latency_p50_ms": percentile(lat_ms, 50),
                          "serve_latency_p95_ms": percentile(lat_ms, 95), "setup_s": setup_s},
           "attempted": n, "failed": n - len(done), "memory_peak_bytes": peak,
           "record": {"exp": cell.exp, "serving": True, "completed": len(done),
                      "batches_run": batches, "infer_calls": timed.calls,
                      "trace": trace.record, "latency_ms": lat_ms}}
    if trace.record is not None:
        out["busy_s"], out["window_s"] = busy(trace.record)
        out["breakdown"] = breakdown(trace.record)
    del model, timed, batcher
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = reqs.sample(seed, mix["check_requests"], done)
    gaps = served_gaps(cell, seed, reqs, sample, [answers[i] for i in sample], device)
    log(f"reference: {len(sample)} requests, widest gap {max(gaps, default=0.0)!r}", flush=True)
    out["checks"] = {"token_gap": {"value": max(gaps, default=0.0),
                                   "limit": cell.limits["token_gap"]},
                     "lost": {"value": n - len(done), "limit": cell.limits["lost"]}}
    return out


def reference_logits(cell, seed: int, reqs, idx: list, device, kind: str | None = None):
    """The reference's logits [R, T', C] and lengths for requests ``idx``,
    each read as the server's padded row, in blocks of the batch size."""
    task_mod, task, exp = program(cell)
    p = weights.make({k: tuple(v.shape) for k, v in task_mod.init_model(task).state_dict().items()},
                     exp.parameter_init, traffic.torch_seed(seed, 7), device)
    q = quant.Quant(kind or cell.exp.get("compute_dtype", "float32"))
    out, lens = [], []
    with full_fp32(), torch.no_grad():
        for at in range(0, len(idx), cell.mix["batch_size"]):
            block = idx[at:at + cell.mix["batch_size"]]
            wav = torch.from_numpy(np.stack([reqs.row(i) for i in block])).to(device)
            samples = torch.tensor([int(reqs.samples[i]) for i in block], device=device)
            logits, length = ctc_model.forward(p, cell.exp, wav, samples, q)
            out += list(logits.cpu().numpy())
            lens += [int(x) for x in length]
    return out, lens


def served_gaps(cell, seed: int, reqs, idx: list, served: list, device) -> list:
    logits, lens = reference_logits(cell, seed, reqs, idx, device)
    blank = cell.config["num_classes"]
    return [correct.served_gap(x, n, ids, blank) for x, n, ids in zip(logits, lens, served)]


def greedy(logits, length: int, blank: int) -> list:
    best = np.asarray(logits[:length]).argmax(1)
    return [int(c) for t, c in enumerate(best) if c != blank and (t == 0 or c != best[t - 1])]


def calibrate(cell, seeds, control_seeds, device, log=print, seconds: float = 3.0) -> None:
    """The program's readings on ``seeds`` (short windows at the cell's rate)
    and, on ``control_seeds``, the control's: the greedy ids of the reference
    in float8, held against the reference, on a run's sample of requests."""
    from portbench import run as harness

    for seed in seeds:
        out = harness.execute(cell, seed, seconds, False, device, log=lambda *a, **k: None)
        log(json.dumps({"seed": seed, "program": {k: c["value"]
                                                  for k, c in out["checks"].items()}}),
            flush=True)
    blank = cell.config["num_classes"]
    for seed in control_seeds:
        reqs = traffic.Requests(cell.mix, seed, seconds)
        idx = reqs.sample(seed, cell.mix["check_requests"], range(len(reqs)))
        low, low_len = reference_logits(cell, seed, reqs, idx, device, kind="float8")
        ctl = [greedy(x, n, blank) for x, n in zip(low, low_len)]
        gaps = served_gaps(cell, seed, reqs, idx, ctl, device)
        log(json.dumps({"seed": seed, "control": {"token_gap": max(gaps)}}), flush=True)


def sweep(cell, seed: int, rates, seconds: float, device, log=print) -> None:
    """Latency at each offered rate, in one process, and whether the backlog
    grew: the median latency of the window's last quarter of requests over
    its first quarter's."""
    from portbench import run as harness

    for rate in rates:
        cell.mix = dict(cell.mix, rate_per_s=rate)
        out = harness.execute(cell, seed, seconds, False, device, log=lambda *a, **k: None)
        lat = out["record"]["latency_ms"]
        q = max(1, len(lat) // 4)
        growth = float(np.median(lat[-q:]) / np.median(lat[:q]))
        log(json.dumps({"rate": rate, **out["end_to_end"], "failed": out["failed"],
                        "rows_per_batch": out["record"]["completed"]
                        / max(1, out["record"]["batches_run"]),
                        "last_over_first_quarter": growth}), flush=True)
