#!/usr/bin/env python3
"""Times the LSTM forward walks #1 and #3 (from a zero state) of the package in the working directory.

    python3 probes/lstm_fwd_time.py                     # from the repository root
    cd OTHER && python3 /abs/path/to/probes/lstm_fwd_time.py   # another checkout's

``OTHER`` is the root of another checkout of the repository, such as an
older commit unpacked with ``git archive``: the same script then times that
checkout's kernels, and running it in turns (this, other, other, this) in
one command compares the two on one card. It times ``lstm_bidi_fwd`` (#1)
and ``lstm_layer_fwd`` (#3) at ``chip_smoke.py``'s shapes (H = 512, T =
400: the serving batch B = 8 without ``cs`` and the training batch B = 32
with it; ragged lengths that include 1 and T), each with CUDA events over
20 back-to-back calls, twice. It uses only the wrappers' signature, which
every checkout of the port shares. Prints one JSON line per shape with the
card's name and power limit, a SHA-256 of the outputs (two checkouts'
results compared bit for bit) and the registers ``ptxas`` gave each walk.
Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

T, H, REPS = 400, 512, 20


def inputs(dev, b: int, seed: int):
    rng = np.random.RandomState(seed)
    lengths = np.concatenate([[T, 1], rng.randint(T // 2, T + 1, b - 2)])
    xf, xb = (torch.from_numpy(rng.randn(b, T, 4 * H).astype(np.float32)).to(dev)
              for _ in range(2))
    whf, whb = (torch.from_numpy(((rng.rand(H, 4 * H) - 0.5) * 0.2).astype(np.float32)).to(dev)
                for _ in range(2))
    mask = (torch.arange(T, device=dev)[None] < torch.from_numpy(lengths).to(dev)[:, None])
    return xf, xb, whf, whb, mask.float()


def events_ms(fn, reps: int = REPS) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def digest(out) -> str:
    h = hashlib.sha256()
    for x in out if isinstance(out, tuple) else (out,):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    log = build.build().with_suffix(".log").read_text()
    # "Compiling entry function '..._<source>_cu_...fwd_walk<template args>...'"
    # then, a few lines on, "Used N registers"
    registers = {f"{src} {args}": int(n) for src, args, n in re.findall(
        r"Compiling entry function '[^']*(lstm_(?:bidi|layer)_fwd)_cu[^']*fwd_walk(I\w*?E)EvNS"
        r"[^\n]*\n(?:[^\n]*\n){0,3}?[^\n]*Used (\d+) registers", log)}
    checkout = os.path.basename(os.getcwd())
    with torch.no_grad():
        for b, with_cs in ((8, False), (32, True)):
            xf, xb, whf, whb, mask = inputs(dev, b, seed=b)
            for name, fn in (
                    ("lstm_bidi_fwd", lambda: lstm.lstm_bidi_fwd(xf, xb, whf, whb, mask, 1.0,
                                                                 with_cs=with_cs)),
                    ("lstm_layer_fwd", lambda: lstm.lstm_layer_fwd(xf, whf, mask, 1.0,
                                                                   with_cs=with_cs))):
                runs = [events_ms(fn) for _ in range(2)]
                print(json.dumps({"checkout": checkout, "kernel": name, "B": b, "T": T, "H": H,
                                  "with_cs": with_cs, "ms_runs": runs,
                                  "us_per_step": [r * 1e3 / T for r in runs],
                                  "sha256": digest(fn()), "walk_registers": registers,
                                  "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
