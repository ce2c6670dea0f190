#!/usr/bin/env python3
"""Measures on the card what the backward walks' products are built from.

    python3 probes/mma_tf32_rate.py

Compiles a small CUDA source with nvcc (into the gitignored ``_build/``) and
times, with clock64() inside one block per SM: mma.sync m16n8k8 TF32 with
float32 accumulation, as independent chains per warp (issue rate) and as one
dependent chain (latency), with 4 and 8 warps a block; cvt.rna.tf32.f32
throughput; FFMA throughput. Prints one JSON line with cycles per
instruction per SM and the card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int kChains>
__global__ void mma_chains(long long* out, float* sink, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[0], b[1] = a[1];
  float d[kChains][4];
  for (int c = 0; c < kChains; ++c) d[c][0] = d[c][1] = d[c][2] = d[c][3] = 0.0f;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __syncthreads();
  long long t1 = clock64();
  float s = 0.0f;
  for (int c = 0; c < kChains; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}

__global__ void cvt_rate(long long* out, float* sink, int iters) {
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = 1.0f + threadIdx.x * 1e-3f + i * 1e-5f;
  __syncthreads();
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      uint32_t r;
      asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x[i]));
      x[i] = __uint_as_float(r) * 1.0000001f;
    }
  }
  __syncthreads();
  long long t1 = clock64();
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += x[i];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
}

extern "C" int run(int which, int blocks, int threads, int iters, long long* host_cycles) {
  long long* out;
  float* sink;
  cudaMalloc(&out, blocks * sizeof(long long));
  cudaMalloc(&sink, (size_t)blocks * threads * sizeof(float));
  for (int rep = 0; rep < 2; ++rep) {
    if (which == 0) mma_chains<1><<<blocks, threads>>>(out, sink, iters);
    if (which == 1) mma_chains<4><<<blocks, threads>>>(out, sink, iters);
    if (which == 2) mma_chains<8><<<blocks, threads>>>(out, sink, iters);
    if (which == 3) cvt_rate<<<blocks, threads>>>(out, sink, iters);
  }
  cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(host_cycles, out, blocks * sizeof(long long), cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(sink);
  return (int)e;
}
"""


def main() -> int:
    build = Path(__file__).resolve().parent.parent / (
        "tensorflow_end2end_speech_recognition_tpu_torch/_build")
    build.mkdir(parents=True, exist_ok=True)
    src, lib = build / "mma_tf32_rate.cu", build / "libmma_tf32_rate.so"
    src.write_text(SRC)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    so.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    blocks, iters, res = 132, 4096, {}
    for which, name, per_iter in ((0, "mma_1_chain", 1), (1, "mma_4_chains", 4),
                                  (2, "mma_8_chains", 8), (3, "cvt_rna_tf32", 8)):
        for threads in (128, 256):
            cyc = (ctypes.c_longlong * blocks)()
            assert so.run(which, blocks, threads, iters, cyc) == 0
            warps = threads // 32
            mean = sum(cyc) / blocks
            # per SM: instructions issued by all warps of the block
            res[f"{name}_{warps}warps"] = {
                "cycles_per_warp_instr_per_sm": mean / (iters * per_iter * warps),
                "cycles_per_iter_per_warp": mean / iters}
    print(json.dumps({"rates": res, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
