#!/usr/bin/env python3
"""Times the LSTM forward walks #1 and #3 of the package in the working directory.

    python3 probes/lstm_fwd_time.py                     # from the repository root
    cd OTHER && python3 /abs/path/to/probes/lstm_fwd_time.py   # another checkout's
    python3 probes/lstm_fwd_time.py --plans             # and every product path

``OTHER`` is the root of another checkout of the repository, such as an
older commit unpacked with ``git archive``: the same script then times that
checkout's kernels, and running it in turns (this, other, other, this) in
one command compares the two on one card. It times ``lstm_bidi_fwd`` (#1)
and ``lstm_layer_fwd`` (#3) at H = 512: T = 400 at the serving batch B = 8
without ``cs``, the training batch B = 32 with it, the headline's B = 128
with every row 12 s and with ragged rows, and B = 100 (not a multiple of the
16-row tiles), those three in float32 and bf16 streams; #1 at T = 1198, the
pyramidal encoder's B = 8 and ls960_joint's training layer 0 (B = 32 with
``cs``); ragged lengths include 1 and T. Each with CUDA events over 20
back-to-back calls, twice, against the plain forward on the same inputs.
Then #3 resuming from a carried ``(h0, c0)`` at the streaming chunks (B = 8,
T = 10 and T = 5, lengths 0..T), in float32 and with bf16 products, timed
from CUDA-graph replays of 50 calls (the wrapper's host time is longer than
the walk), and a sweep of B = 8, 32, 64, 128 (T = 400, full rows, float32)
for the step time against the rows. ``--plans`` also times each shape on
each product path ``ops/lstm.fwd_plan`` can take (FFMA, the tensor cores,
and the tensor cores in clusters of 2 that split k), where the checkout has
them. It uses only the wrappers' signature, which every
checkout of the port shares. Prints one JSON line per shape with the card's
name and power limit, a SHA-256 of the outputs, the largest difference from
the plain forward, two calls' equality, the launch plan, the kernel's own
trace of a traced call's step phases where the checkout has one
(``ops/lstm.fwd_trace``: µs per phase, mean over 62 steps of block 0; the
trace puts block barriers at its marks), and once the registers and spills
``ptxas`` gave each ``fwd_walk`` and the count of tensor-core (``HMMA``)
instructions in each (``cuobjdump -sass``). Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

from lstm_bwd_time import digest, events_ms, lengths_for, max_err, walk_report

H = 512


def inputs(dev, b: int, t: int, lengths, seed: int):
    """xproj of both directions, their Wh and the length mask, float32."""
    rng = np.random.RandomState(seed)
    xf, xb = (torch.from_numpy(rng.randn(b, t, 4 * H).astype(np.float32)).to(dev)
              for _ in range(2))
    whf, whb = (torch.from_numpy(((rng.rand(H, 4 * H) - 0.5) * 0.2).astype(np.float32)).to(dev)
                for _ in range(2))
    mask = (torch.arange(t, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).float()
    return xf, xb, whf, whb, mask


def graph_ms(fn, reps: int = 50) -> float:
    """Device ms per call from one replay of a CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plan_fields(plan) -> dict:
    return {k: v for k, v in plan._asdict().items()
            if k in ("units", "rows", "resident", "split", "cluster", "smem_bytes")}


def product_paths(lstm, dev, dirs: int, b: int) -> list:
    """(label, fwd_plan_for replacement) for each product path the checkout's
    plan can take at the shape: FFMA (``cluster`` 0), the tensor cores, and
    the tensor cores in clusters of 2 that split k where a direction's blocks
    pair up; none where the checkout's plan takes no cluster."""
    if "cluster" not in lstm.FwdPlan._fields:
        return []
    sms = lstm._sm_count(dev.index or 0)
    even = lstm.fwd_plan(H, dirs, b, sms).blocks // dirs % 2 == 0
    return [(("ffma", "mma", "mma_cluster2")[c], lambda dev_, h_, dirs_, batch_, c=c: lstm.fwd_plan(
        h_, dirs_, batch_, sms, c)) for c in ((0, 1, 2) if even else (0, 1))]


def time_walk(lstm, dev, gpu, checkout, name, b, t, ragged, bf16, with_cs, args,
              path=None) -> None:
    """One JSON line: #1 or #3 (``name``) on ``args``; ``path`` names a forced plan."""
    xf, xb, whf, whb, mask = args
    cast = (lambda v: v.bfloat16()) if bf16 else (lambda v: v)  # noqa: E731
    if name == "lstm_bidi_fwd":
        a = (cast(xf), cast(xb), whf, whb, mask)
        fn = lambda: lstm.lstm_bidi_fwd(*a, 1.0, with_cs=with_cs)  # noqa: E731
        plain = lambda: lstm.lstm_bidi_fwd_plain(*a, 1.0)[:4 if with_cs else 2]  # noqa: E731
        dirs = 2
    else:
        a = (cast(xf), whf, mask)
        fn = lambda: lstm.lstm_layer_fwd(*a, 1.0, with_cs=with_cs)  # noqa: E731
        plain = lambda: lstm.lstm_layer_fwd_plain(*a, 1.0)[:2 if with_cs else 1]  # noqa: E731
        dirs = 1
    runs = [events_ms(fn) for _ in range(2)]
    got, again = fn(), fn()
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    line = {"checkout": checkout, "kernel": name + ("_bf16" if bf16 else ""), "B": b, "T": t,
            "H": H, "ragged": ragged, "with_cs": with_cs, "ms_runs": runs,
            "us_per_step": [r * 1e3 / t for r in runs],
            "plan": plan_fields(lstm.fwd_plan_for(dev, H, dirs, b))}
    if path is not None:
        line["path"] = path
    line.update(max_abs_err_vs_plain=max_err(got, plain()),
                two_calls_equal=all(torch.equal(x, y) for x, y in zip(got, again)),
                sha256=digest(got))
    if hasattr(lstm, "fwd_trace"):
        line["step_trace_us"] = lstm.fwd_step_phases(lstm.fwd_trace(name, fn))
    line["gpu"] = gpu
    print(json.dumps(line), flush=True)


def time_carried(lstm, dev, gpu, checkout, what: str, t: int, path=None) -> None:
    """#3 from a carried state at a streaming chunk: float32 and bf16 products."""
    b = 8
    lengths = [t, 0, t, t - 1, 3, t, 1, 0]
    xf, _, whf, _, mask = inputs(dev, b, t, lengths, seed=60 + t)
    g = torch.Generator().manual_seed(61 + t)
    state = tuple((torch.randn(b, H, generator=g) * 0.5).to(dev) for _ in range(2))
    for bf16_product in (False, True):
        def fn():
            ys, (h_t, c_t) = lstm.lstm_layer(xf, whf, mask, 1.0, initial_state=state,
                                             bf16_product=bf16_product)
            return ys, h_t, c_t
        runs = [graph_ms(fn) for _ in range(2)]
        got, again = fn(), fn()
        ys, _, (h_t, c_t) = lstm.lstm_layer_fwd_plain(xf, whf, mask, 1.0, state, bf16_product)
        line = {"checkout": checkout, "kernel": "lstm_layer_fwd_carry"
                + ("_bf16" if bf16_product else ""), "chunk": what, "B": b, "T": t, "H": H,
                "us_graph_runs": [r * 1e3 for r in runs],
                "plan": plan_fields(lstm.fwd_plan_for(dev, H, 1, b))}
        if path is not None:
            line["path"] = path
        line.update(max_abs_err_vs_plain=max_err(got, (ys, h_t, c_t)),
                    two_calls_equal=all(torch.equal(x, y) for x, y in zip(got, again)),
                    sha256=digest(got), gpu=gpu)
        print(json.dumps(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_fwd_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from tensorflow_end2end_speech_recognition_tpu_torch.ops import build, lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    checkout = os.path.basename(os.getcwd())
    print(json.dumps({"checkout": checkout, "walks": walk_report(build.build(), "fwd_walk"),
                      "gpu": gpu}), flush=True)
    both = ("lstm_bidi_fwd", "lstm_layer_fwd")
    # (B, T, ragged, with_cs, stream types, kernels)
    shapes = [(8, 400, True, False, (False,), both),
              (32, 400, True, True, (False, True), both),
              (128, 400, False, True, (False, True), both),
              (128, 400, True, True, (False, True), both),
              (100, 400, True, True, (False, True), both),
              (8, 1198, True, False, (False,), both[:1]),
              (32, 1198, True, True, (False,), both[:1])]
    plans = "--plans" in sys.argv[1:]
    chosen = lstm.fwd_plan_for
    with torch.no_grad():
        for b, t, ragged, with_cs, types, names in shapes:
            args = inputs(dev, b, t, lengths_for(b, t, ragged, seed=b), seed=b + int(ragged))
            for bf16 in types:
                for name in names:
                    time_walk(lstm, dev, gpu, checkout, name, b, t, ragged, bf16, with_cs, args)
                    if not plans:
                        continue
                    for path, plan_for in product_paths(lstm, dev, 2 if "bidi" in name else 1,
                                                        b):
                        lstm.fwd_plan_for = plan_for
                        try:
                            time_walk(lstm, dev, gpu, checkout, name, b, t, ragged, bf16,
                                      with_cs, args, path)
                        finally:
                            lstm.fwd_plan_for = chosen
        for what, t in (("ls_streaming_ctc", 10), ("ls_transducer", 5)):
            time_carried(lstm, dev, gpu, checkout, what, t)
            if plans:
                for path, plan_for in product_paths(lstm, dev, 1, 8):
                    lstm.fwd_plan_for = plan_for
                    try:
                        time_carried(lstm, dev, gpu, checkout, what, t, path)
                    finally:
                        lstm.fwd_plan_for = chosen
        sweep = {}
        for b in (8, 32, 64, 128):
            xf, xb, whf, whb, mask = inputs(dev, b, 400, [400] * b, seed=b)
            for name, fn in (
                    ("lstm_bidi_fwd", lambda: lstm.lstm_bidi_fwd(xf, xb, whf, whb, mask, 1.0,
                                                                 with_cs=True)),
                    ("lstm_layer_fwd", lambda: lstm.lstm_layer_fwd(xf, whf, mask, 1.0,
                                                                   with_cs=True))):
                sweep.setdefault(name, {})[b] = events_ms(fn) * 1e3 / 400
        print(json.dumps({"checkout": checkout, "sweep_us_per_step_float32_with_cs": sweep,
                          "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
