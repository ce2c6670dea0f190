#!/usr/bin/env python3
"""Times the LSTM backward walks #2 and #4 of the package in the working directory.

    python3 probes/lstm_bwd_time.py                     # from the repository root
    cd OTHER && python3 /abs/path/to/probes/lstm_bwd_time.py   # another checkout's
    python3 probes/lstm_bwd_time.py --plans             # and every launch plan

``OTHER`` is the root of another checkout of the repository, such as an
older commit unpacked with ``git archive``: the same script then times that
checkout's kernels, and running it in turns (this, other, other, this) in
one command compares the two on one card. It times ``lstm_bidi_bwd`` (#2)
and ``lstm_layer_bwd`` (#4) at H = 512, T = 400: B = 32 with ragged lengths
(1 and T among them) and B = 128 with every row full and ragged, in float32
and bf16 streams; then #2 at the training shapes of the other configs' first
layers (ls960_joint B = 32, T = 1198, H = 512; timit_multitask_ctc B = 32,
T = 780, H = 256; csj_joint B = 32, T = 300, H = 320; ragged, float32), #4
at the timit one too; each with CUDA events over 20 back-to-back calls,
twice. Then a sweep of B = 8, 32, 64, 128 (H = 512, full rows, float32) for
the step time against the rows. ``--plans`` also times, at the timit and
csj shapes and at H = 512, B = 32 and 128, every unit tile and cluster size
the card holds (``ops/lstm.bwd_plan``'s choices forced), where the checkout
has those plans. It uses only the wrappers' signature, which every checkout
of the port shares; the forward streams come from the plain forward, so
both checkouts walk back from the same inputs. Prints one JSON line per
shape with the card's name and power limit, a SHA-256 of the outputs (two
checkouts' results compared bit for bit), the largest difference from the
plain backward, the kernel's own trace of a traced call's step phases where
the checkout has one (``ops/lstm.bwd_trace``: µs per phase, mean over 62
steps of block 0; the trace puts block barriers at its marks), and once the
registers and spills ``ptxas`` gave each ``bwd_walk`` and the count of
tensor-core (``HMMA``) instructions in each (``cuobjdump -sass``). Imports
no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPS = 20


def lengths_for(b: int, t: int, ragged: bool, seed: int) -> list[int]:
    if not ragged:
        return [t] * b
    rng = np.random.RandomState(seed)
    return [t, 1] + [int(x) for x in rng.randint(t // 2, t + 1, b - 2)]


def inputs(lstm, dev, b: int, t: int, h: int, lengths, seed: int):
    """(bidi args, layer args) in float32: xproj, Wh, mask, the plain
    forward's ys and cs, and cotangents."""
    T, H = t, h
    rng = np.random.RandomState(seed)
    xf, xb = (torch.from_numpy(rng.randn(b, T, 4 * H).astype(np.float32)).to(dev)
              for _ in range(2))
    whf, whb = (torch.from_numpy(((rng.rand(H, 4 * H) - 0.5) * 0.2).astype(np.float32)).to(dev)
                for _ in range(2))
    gf, gb = (torch.from_numpy(rng.randn(b, T, H).astype(np.float32)).to(dev) for _ in range(2))
    mask = (torch.arange(T, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).float()
    ysf, ysb, csf, csb = lstm.lstm_bidi_fwd_plain(xf, xb, whf, whb, mask, 1.0)
    return ((xf, xb, whf, whb, mask, ysf, ysb, csf, csb, gf, gb),
            (xf, whf, mask, ysf, csf, gf))


def streams(args, bf16: bool):
    """The arguments with the streams (all but Wh and the mask) in bf16."""
    if not bf16:
        return args
    return tuple(a if a.dim() == 2 else a.bfloat16() for a in args)


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
        h.update(x.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def max_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def step_trace(lstm, name: str, fn) -> dict | None:
    """µs per phase of a traced call's step (``ops/lstm.bwd_trace``); None
    where the checkout's kernel has no trace."""
    if not hasattr(lstm, "bwd_trace"):
        return None
    return lstm.bwd_step_phases(lstm.bwd_trace(name, fn))


def forced_plans(lstm, dev, h: int, dirs: int, batch: int, bf16: bool) -> list:
    """Every (units, cluster) plan ``bwd_plan`` can make for the shape on this
    card, each as a ``bwd_plan_for`` replacement; none where the checkout's
    plan takes no cluster sizes."""
    if not hasattr(lstm, "_max_clusters"):
        return []
    sms = lstm._sm_count(dev.index or 0)
    out = []
    for u in lstm.BWD_UNITS:
        if dirs * -(-h // u) > sms or u > 32:
            continue
        for c in lstm.BWD_CLUSTERS:
            def plan_for(dev_, h_, dirs_, batch_, bf16=bf16, u=u, c=c):
                held = lambda cl, *a: (0 if cl > c  # noqa: E731
                                       else lstm._max_clusters(dev.index or 0, dirs_, bf16, cl, *a))
                return lstm.bwd_plan(h_, dirs_, batch_, dirs_ * -(-h_ // u), held)
            p = plan_for(dev, h, dirs, batch)
            if p.units == u and p.cluster == c:
                out.append(((u, c, p.resident, p.split), plan_for))
    return out


def walk_report(lib_path, walk: str = "bwd_walk") -> dict:
    """Per instantiation of the kernel ``walk``: ptxas registers and spill
    bytes, and its HMMA (tensor-core) instructions in the library's SASS."""
    log = lib_path.with_suffix(".log").read_text()
    out = {}
    for m in re.finditer(rf"Compiling entry function '([^']*{walk}[^']*)'", log):
        tail = log[m.end():m.end() + 600]
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", tail)
        out[m.group(1)] = {"registers": int(regs.group(1)) if regs else None,
                           "spill_stores": int(spill.group(1)) if spill else None}
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    name = None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            continue
        if name in out and "HMMA" in line:
            out[name]["hmma"] = out[name].get("hmma", 0) + 1
    for v in out.values():
        v.setdefault("hmma", 0)
    return out


def time_one(lstm, dev, gpu: str, checkout: str, name: str, b: int, t: int, h: int,
             ragged: bool, bf16: bool, args, plan=None) -> None:
    """One JSON line: #2 or #4 (``name``) on ``args``, with ``plan`` (units,
    cluster, resident, split) forced where given."""
    kernel, plain = ((lstm.lstm_bidi_bwd, lstm.lstm_bidi_bwd_plain) if name == "lstm_bidi_bwd"
                     else (lstm.lstm_layer_bwd, lstm.lstm_layer_bwd_plain))
    a = streams(args, bf16)
    fn = lambda: kernel(*a, 1.0)  # noqa: E731
    runs = [events_ms(fn) for _ in range(2)]
    got, again = fn(), fn()
    equal = all(torch.equal(x, y) for x, y in zip(
        got if isinstance(got, tuple) else (got,),
        again if isinstance(again, tuple) else (again,)))
    line = {"checkout": checkout, "kernel": name + ("_bf16" if bf16 else ""),
            "B": b, "T": t, "H": h, "ragged": ragged, "ms_runs": runs,
            "us_per_step": [r * 1e3 / t for r in runs]}
    if plan is not None:
        line["plan_units_cluster_resident_split"] = plan
    else:
        line.update(max_abs_err_vs_plain=max_err(got, plain(*a, 1.0)))
    line.update(two_calls_equal=equal, sha256=digest(got),
                step_trace_us=step_trace(lstm, name, fn), gpu=gpu)
    print(json.dumps(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lstm_bwd_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from tensorflow_end2end_speech_recognition_tpu_torch.ops import build, lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    checkout = os.path.basename(os.getcwd())
    print(json.dumps({"checkout": checkout, "walks": walk_report(build.build()), "gpu": gpu}),
          flush=True)
    both = ("lstm_bidi_bwd", "lstm_layer_bwd")
    # (B, T, H, ragged, stream types, kernels)
    shapes = [(32, 400, 512, True, (False, True), both),
              (128, 400, 512, False, (False, True), both),
              (128, 400, 512, True, (False, True), both),
              (32, 1198, 512, True, (False,), both[:1]),
              (32, 780, 256, True, (False,), both),
              (32, 300, 320, True, (False,), both[:1])]
    with torch.no_grad():
        for b, t, h, ragged, types, names in shapes:
            lengths = lengths_for(b, t, ragged, seed=b)
            bidi, layer = inputs(lstm, dev, b, t, h, lengths, seed=b + int(ragged))
            for bf16 in types:
                for name in names:
                    args = bidi if name == "lstm_bidi_bwd" else layer
                    time_one(lstm, dev, gpu, checkout, name, b, t, h, ragged, bf16, args)
        sweep = {}
        for b in (8, 32, 64, 128):
            bidi, layer = inputs(lstm, dev, b, 400, 512, [400] * b, seed=b)
            for name, kernel, args in (("lstm_bidi_bwd", lstm.lstm_bidi_bwd, bidi),
                                       ("lstm_layer_bwd", lstm.lstm_layer_bwd, layer)):
                ms = events_ms(lambda: kernel(*args, 1.0))
                sweep.setdefault(name, {})[b] = ms * 1e3 / 400
        print(json.dumps({"checkout": checkout, "sweep_us_per_step_float32": sweep,
                          "gpu": gpu}), flush=True)
        if "--plans" in sys.argv[1:]:
            chosen = lstm.bwd_plan_for
            for b, t, h, bf16 in ((32, 780, 256, False), (32, 300, 320, False),
                                  (32, 400, 512, False), (128, 400, 512, True)):
                lengths = lengths_for(b, t, True, seed=b)
                bidi, layer = inputs(lstm, dev, b, t, h, lengths, seed=b + 1)
                for name, args, dirs in (("lstm_bidi_bwd", bidi, 2), ("lstm_layer_bwd", layer, 1)):
                    for plan, plan_for in forced_plans(lstm, dev, h, dirs, b, bf16):
                        lstm.bwd_plan_for = plan_for
                        try:
                            time_one(lstm, dev, gpu, checkout, name, b, t, h, True, bf16, args,
                                     plan)
                        finally:
                            lstm.bwd_plan_for = chosen
    return 0


if __name__ == "__main__":
    sys.exit(main())
