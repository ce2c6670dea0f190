#!/usr/bin/env python3
"""Times the CTC kernels #5 and #6 of the package in the working directory.

    python3 probes/ctc_time.py                     # from the repository root
    cd OTHER && python3 /abs/path/to/probes/ctc_time.py   # another checkout's

``OTHER`` is the root of another checkout of the repository, such as an
older commit unpacked with ``git archive``: the same script then times that
checkout's kernels, and running it in turns (this, other, this, other) in
one command compares the two on one card. It makes ``chip_smoke.py``'s CTC
inputs (B=32, T=400, C=29, U = 40 and 180, ragged lengths, seed 5) and times
``ctc_loss_fwd_bwd`` and ``ctc_loss_fwd_only`` of the package found in the
working directory, each from two replays of a CUDA graph of 50 calls. It
uses only the two wrappers' signature, which every checkout of the port
shares. Prints one JSON line per shape, with the card's name and power limit
and a SHA-256 of each call's loss and gradient, so that two checkouts' results
can be compared bit for bit. Imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

B, T, C, REPS = 32, 400, 29, 50


def ctc_inputs(dev, u: int, seed: int = 5):
    """chip_smoke.py's: at most ``u`` labels, ragged lengths, all alignable."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(B, T, C) * 3).astype(np.float32)).to(dev)
    label_len = rng.randint(1, u + 1, B).astype(np.int32)
    label_len[0] = u
    labels = np.full((B, u), -1, np.int32)
    for i, n in enumerate(label_len):
        labels[i, :n] = rng.randint(0, C - 1, n)
    logit_len = rng.randint(2 * u + 1, T + 1, B).astype(np.int32)
    logit_len[0] = T
    as_t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return logits, as_t(logit_len), as_t(labels), as_t(label_len)


def graph_ms(fn, reps: int = REPS, replays: int = 2) -> list[float]:
    """Device time per call from CUDA events around each replay of a graph of
    ``reps`` calls (after one untimed replay)."""
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
    out = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("ctc_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from tensorflow_end2end_speech_recognition_tpu_torch.ops import ctc

    dev, gpu = torch.device("cuda", 0), card()
    for u in (40, 180):
        args = ctc_inputs(dev, u)
        loss, grad = ctc.ctc_loss_fwd_bwd(*args, C - 1)
        fwd = ctc.ctc_loss_fwd_only(*args, C - 1)
        row = {"checkout": os.getcwd(), "shape": f"B={B} T={T} C={C} U={u}",
               "ctc_loss_ms": graph_ms(lambda: ctc.ctc_loss_fwd_bwd(*args, C - 1)),
               "ctc_loss_fwd_only_ms": graph_ms(lambda: ctc.ctc_loss_fwd_only(*args, C - 1)),
               "ctc_loss_sha256": digest(loss, grad), "ctc_loss_fwd_only_sha256": digest(fwd),
               "gpu": gpu}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
