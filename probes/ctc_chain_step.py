#!/usr/bin/env python3
"""Where a step of the CTC chain kernels' time goes, on one CUDA card.

    python3 probes/ctc_chain_step.py        # from the repository root

Two measurements, each printed as JSON lines beside the card's name and
power limit:

1. ``lse3``: cycles per step (``clock64``, one warp) of 1 and of 3
   interleaved dependent chains of the kernels' three-way log-sum-exp
   (accurate ``expf`` / ``logf``, the ``-1e30`` floor), with and without two
   warp shuffles per step: the latency floor of a chain step; and the SM
   clock over that loop (cycles over ``%globaltimer`` ns). A small kernel of
   its own, built with nvcc into a temporary directory.
2. ``chain``: µs per step of the ``ctc_chains`` launch of kernels #6 and #5
   (``csrc/ctc_loss.cu``; the profiler's device time of that kernel over the
   T-1 steps of the longest utterance) on ``chip_smoke.py``'s inputs (B=32,
   T=400, C=29, ragged lengths) at U = 16, 40 and 180, for each distinct
   layout that ``ops/ctc.ctc_plan`` gives at 2 (its default), 3 and 4 lanes
   per thread, and in cycles at the clock of 1. Each layout's loss is
   checked against the plan's.

Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "probes"))

from ctc_time import C, T, card, ctc_inputs  # noqa: E402

from tensorflow_end2end_speech_recognition_tpu_torch.ops import build, ctc  # noqa: E402

LSE3_PROBE = r"""
#include <cuda_runtime.h>
constexpr float kNeg = -1e30f;
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return fmaxf(out, kNeg);
}
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
template <bool kShfl, int N>
__global__ void chains(float* out, long long* cyc, int n) {
  float a[N];
  for (int k = 0; k < N; ++k) a[k] = 0.1f * (threadIdx.x + k + 1);
  const long long g0 = global_ns();
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float d = kShfl ? __shfl_up_sync(0xffffffffu, a[k], 1) : a[k] * 0.5f;
      const float s = kShfl ? __shfl_up_sync(0xffffffffu, a[k], 2) : a[k] * 0.25f;
      a[k] = fmaxf(lse3(a[k], d, s) - 0.7f, kNeg);
    }
  }
  const long long t1 = clock64();
  const long long g1 = global_ns();
  float acc = 0.0f;
  for (int k = 0; k < N; ++k) acc += a[k];
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cyc[0] = t1 - t0, cyc[1] = g1 - g0;
}
extern "C" int run(int shfl, int n_chains, float* out, long long* cyc, int n) {
  if (shfl) {
    if (n_chains == 1) chains<true, 1><<<1, 32>>>(out, cyc, n);
    else chains<true, 3><<<1, 32>>>(out, cyc, n);
  } else {
    if (n_chains == 1) chains<false, 1><<<1, 32>>>(out, cyc, n);
    else chains<false, 3><<<1, 32>>>(out, cyc, n);
  }
  return (int)cudaDeviceSynchronize();
}
"""


def lse3_cycles(gpu: str, dev) -> float:
    """Prints the lse3 chains' cycles per step; returns the SM clock in MHz."""
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "lse3.cu", Path(tmp) / "lse3.so"
        cu.write_text(LSE3_PROBE)
        subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(so), str(cu)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
        lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int]
        out = torch.zeros(32, device=dev)
        cyc = torch.zeros(2, dtype=torch.int64, device=dev)
        steps, mhz = 20000, []
        for shfl in (0, 1):
            for n in (1, 3):
                for _ in range(2):  # the second run is the one kept
                    if lib.run(shfl, n, out.data_ptr(), cyc.data_ptr(), steps):
                        raise RuntimeError("lse3 probe failed")
                cycles, ns = cyc.tolist()
                mhz.append(1e3 * cycles / ns)
                print(json.dumps({"lse3": {"chains": n, "shuffles": 2 * shfl,
                                           "cycles_per_step": cycles / steps,
                                           "sm_clock_mhz": mhz[-1]}, "gpu": gpu}), flush=True)
        return sum(mhz) / len(mhz)


def chain_us(fn, reps: int = 5) -> float:
    """Device µs of one ``ctc_chains`` launch of ``fn``, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.self_device_time_total / e.count for e in prof.key_averages()
             if "ctc_chains" in e.key and e.self_device_time_total > 0]
    if len(times) != 1:
        raise RuntimeError(f"expected one ctc_chains kernel in the profile, got {len(times)}")
    return times[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("ctc_chain_step: needs a CUDA card", file=sys.stderr)
        return 2
    dev, gpu = torch.device("cuda", 0), card()
    mhz = lse3_cycles(gpu, dev)
    b, blank = 32, C - 1
    for u in (16, 40, 180):
        logits, logit_len, labels, label_len = ctc_inputs(dev, u)
        steps = int(logit_len.max()) - 1
        want = ctc.ctc_loss_fwd_only(logits, logit_len, labels, label_len, blank)
        seen = set()
        for lanes in (2, 3, 4):
            row = {"u": u, "lanes": lanes}
            for fn, grad in (("ctc_loss_fwd_only", False), ("ctc_loss_fwd_bwd", True)):
                plan = ctc.ctc_plan(b, T, 2 * u + 1, grad, lanes=lanes)
                layout = (plan.route, plan.chain_warps, plan.lanes_per_thread)
                row.update(route=plan.route, warps=plan.chain_warps, k=plan.lanes_per_thread)
                g = torch.empty_like(logits) if grad else None

                def call(fn=fn, plan=plan, g=g):
                    return ctc._launch(fn, fn, plan, logits, logit_len, labels, label_len,
                                       blank, g)

                torch.testing.assert_close(call(), want, atol=1e-4, rtol=1e-5)
                us = chain_us(call) / steps
                row[f"{fn[9:]}_chain_us_per_step"] = round(us, 4)
                row[f"{fn[9:]}_chain_cycles_per_step"] = round(us * mhz, 1)
            if layout in seen:
                continue
            seen.add(layout)
            print(json.dumps({"chain": row, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
