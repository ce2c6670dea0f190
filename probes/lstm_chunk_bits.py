#!/usr/bin/env python3
"""Whether a streamed LSTM layer can give its offline walk's bits, on the card.

    python3 probes/lstm_chunk_bits.py          # from a checkout's root

A streaming chunk runs kernel #3's carried walk (``lstm_layer(...,
initial_state=)``) over 10 steps at a time, the offline decode one walk over
every step. This script feeds both the same xproj (B = 8, T = 400, H = 512,
ragged lengths) and reports whether the carried walk over 40 chunks of 10
steps equals the one walk bit for bit, on the product path the checkout's
plan takes at B = 8 and, where the plan can be forced (``fwd_plan``'s
``cluster``), on the tensor cores too. It then forms xproj = x @ Wx
(cuBLAS, float32) on the chunks and on the whole sequence, as the streaming
and the offline encoders do, and reports how far apart they come. Prints one
JSON line with the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

B, T, H, D, CHUNK = 8, 400, 512, 360, 10
LENGTHS = [400, 133, 400, 260, 399, 57, 400, 210]


def chunked(lstm, xp, wh, mask) -> torch.Tensor:
    """The carried walk over CHUNK steps at a time from a zero state."""
    state = tuple(torch.zeros(B, H, device=xp.device) for _ in range(2))
    outs = []
    for c in range(0, T, CHUNK):
        ys, state = lstm.lstm_layer_fwd(xp[:, c:c + CHUNK].contiguous(), wh,
                                        mask[:, c:c + CHUNK].contiguous(), 1.0,
                                        initial_state=state)
        outs.append(ys)
    return torch.cat(outs, 1)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_chunk_bits: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from tensorflow_end2end_speech_recognition_tpu_torch.ops import lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(B, T, D).astype(np.float32)).to(dev)
    wx = torch.from_numpy((rng.randn(D, 4 * H) * 0.05).astype(np.float32)).to(dev)
    wh = torch.from_numpy(((rng.rand(H, 4 * H) - 0.5) * 0.2).astype(np.float32)).to(dev)
    mask = (torch.arange(T, device=dev)[None]
            < torch.tensor(LENGTHS, device=dev)[:, None]).float()
    line = {"checkout": os.path.basename(os.getcwd()), "B": B, "T": T, "H": H, "chunk": CHUNK}
    with torch.no_grad():
        xp = torch.matmul(x, wx)
        pieces = torch.cat([torch.matmul(x[:, c:c + CHUNK], wx) for c in range(0, T, CHUNK)], 1)
        line["xproj_chunks_equal_whole"] = torch.equal(xp, pieces)
        line["xproj_chunks_max_abs_diff"] = float((xp - pieces).abs().max())
        paths = {"chosen": None}
        if "cluster" in lstm.FwdPlan._fields:
            sms = lstm._sm_count(0)
            paths["tensor_cores"] = lambda d, h, dirs, b: lstm.fwd_plan(h, dirs, b, sms, 1)
        chosen = lstm.fwd_plan_for
        for name, plan_for in paths.items():
            lstm.fwd_plan_for = plan_for or chosen
            try:
                whole, parts = lstm.lstm_layer_fwd(xp, wh, mask, 1.0), chunked(lstm, xp, wh, mask)
            finally:
                lstm.fwd_plan_for = chosen
            line[f"{name}_carried_chunks_equal_one_walk"] = torch.equal(whole, parts)
            line[f"{name}_max_abs_diff"] = float((whole - parts).abs().max())
    line["gpu"] = gpu
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
