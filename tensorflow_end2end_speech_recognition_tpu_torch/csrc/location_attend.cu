// One location-aware (hybrid) attention read, for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/attention_kernel.py
// _attention_kernel (called by location_attend_pallas / location_attend_fused)
// and computes what _reference_math there computes, per row n:
//
//   f[t, c]   = sum_k prev[t + k - (W-1)/2] * conv[k, c]  (SAME, zero outside [0, T))
//   pre[t, a] = (keys[t, a] + sum_c f[t, c] * w_loc[c, a]) + q[a]
//   e[t]      = (sum_a tanh(pre[t, a]) * v[a]) * sharpening + (mask[t] ? 0 : -1e30)
//   align     = softmax_t(e)
//   ctx[h]    = sum_t align[t] * enc[t, h]
//
// The left offset is (W-1)/2 for an even W too, as XLA pads a SAME conv.
// A row with no valid frame gets align = 1/T (every e is -1e30).
//
// What bounds it. Per row it must read keys [T, A] and enc [T, He] once:
// at T = 300, A = 256, He = 1024 that is 1.5 MB a row against about 3 MFLOP,
// so bytes bound it (N = 64 rows: 99 MB, 29.5 us at 3.35 TB/s). The conv
// taps, w_loc, v and q are a few KB shared by every frame and stay in L1/L2.
// To come near that rate the card needs many loads in flight: one block per
// row (the first design of this file) kept 8 SMs busy at N = 8 and ran at
// 1 % of the bound, latency-bound on its serial loads.
//
// Design: two launches on the stream, no T cap, no padding, no atomics.
// 1. location_energies, grid (N, ceil(T / 16)): a block of 256 threads
//    takes 16 frames. It stages the prev window they need (16 + W - 1
//    values) and, when they fit in shared memory, the conv taps, w_loc, v
//    and q. A thread per (frame, channel) sums the W taps in order into the
//    location features. Then a thread per attention unit a loads keys[t, a]
//    of the 16 frames at once (16 coalesced row reads in flight), adds the
//    location term and q, and keeps tanh(pre) * v per frame; warp shuffles
//    and then the 8 warps in order sum each frame's partials into e[t],
//    written to a [N, T] scratch. A masked frame's e is -1e30 whatever its
//    score (-1e30 + |e| rounds to -1e30 in float32 for |e| < 3.8e22), so its
//    keys are not read. (Earlier designs of this pass, a block per row and
//    then a warp per frame with the lanes splitting taps and units, ran at
//    286 and 25 us at N = 8: latency-bound on serial loads and shuffles.)
// 2. location_context, grid (N, ceil(He / (32 * kVec))): every block of a
//    row takes the row's max and sum of exp over T (block reductions in a
//    fixed order), then walks T in chunks of 1024 frames: align for the
//    chunk goes to shared memory (and, from the row's first block, to the
//    output), and warp w accumulates frames t = w (mod 8) of the chunk over
//    its lanes' kVec columns of enc (16-byte loads when He % 4 == 0 and enc
//    and ctx are 16-byte aligned). It reads masked frames too (their weight
//    is 0, as in the plain version's product), so that no branch stands
//    between the loads. The 8 warps' partial sums are added in order.
// Every sum has a fixed order: the result is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFrames = 16;   // frames per energies block
constexpr int kTChunk = 1024; // frames of align staged at once by the context blocks
constexpr int kMaxSmem = 232448 - 1024;  // bytes of shared memory a block may take

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Block-wide max or sum; every thread gets the result. `red` holds kWarps floats.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

__global__ void __launch_bounds__(kThreads)
location_energies(const float* __restrict__ keys,          // [N, T, A]
                  const float* __restrict__ q,             // [N, A]
                  const float* __restrict__ prev,          // [N, T]
                  const unsigned char* __restrict__ mask,  // [N, T] bool
                  const float* __restrict__ conv,          // [W, C]
                  const float* __restrict__ w_loc,         // [C, A]
                  const float* __restrict__ v,             // [A]
                  float* __restrict__ e,                   // [N, T]
                  int T, int A, int C, int W, float sharpening, int staged) {
  extern __shared__ float smem[];
  float* win = smem;                     // [kFrames + W - 1]: prev[t0 - left ..]
  float* f_s = win + kFrames + W - 1;    // [kFrames, C] location features
  float* red = f_s + kFrames * C;        // [kFrames, kWarps] partial scores
  int* on_s = reinterpret_cast<int*>(red + kFrames * kWarps);  // [kFrames] valid frame
  // when staged, the weights every frame reads:
  float* conv_s = reinterpret_cast<float*>(on_s + kFrames);  // [W * C]
  float* wloc_s = conv_s + W * C;        // [C * A]
  float* v_s = wloc_s + C * A;           // [A]
  float* q_s = v_s + A;                  // [A]
  const int n = blockIdx.x;
  const int t0 = blockIdx.y * kFrames;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int left = (W - 1) / 2;
  const float* pn = prev + (size_t)n * T;
  for (int i = tid; i < kFrames + W - 1; i += kThreads) {
    const int s = t0 - left + i;
    win[i] = (s >= 0 && s < T) ? pn[s] : 0.0f;
  }
  if (tid < kFrames) on_s[tid] = t0 + tid < T && mask[(size_t)n * T + t0 + tid];
  const float* qg = q + (size_t)n * A;
  if (staged) {
    for (int i = tid; i < W * C; i += kThreads) conv_s[i] = __ldg(conv + i);
    for (int i = tid; i < C * A; i += kThreads) wloc_s[i] = __ldg(w_loc + i);
    for (int i = tid; i < A; i += kThreads) {
      v_s[i] = __ldg(v + i);
      q_s[i] = __ldg(qg + i);
    }
    conv = conv_s;
    w_loc = wloc_s;
    v = v_s;
    qg = q_s;
  }
  __syncthreads();

  // location features: a thread per (frame, channel), the W taps in order
  for (int p = tid; p < kFrames * C; p += kThreads) {
    const int i = p / C, c = p - i * C;
    float f = 0.0f;
    if (on_s[i])
      for (int k = 0; k < W; ++k) f = fmaf(win[i + k], conv[k * C + c], f);
    f_s[p] = f;
  }
  __syncthreads();

  // scores: a thread per attention unit a, over the block's frames
  float part[kFrames];
#pragma unroll
  for (int i = 0; i < kFrames; ++i) part[i] = 0.0f;
  const float* kb = keys + ((size_t)n * T + t0) * A;
  for (int a = tid; a < A; a += kThreads) {
    float kv[kFrames];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) kv[i] = on_s[i] ? __ldg(kb + (size_t)i * A + a) : 0.0f;
    const float qa = qg[a], va = v[a];
#pragma unroll
    for (int i = 0; i < kFrames; ++i) {
      if (!on_s[i]) continue;
      float loc = 0.0f;
      for (int c = 0; c < C; ++c) loc = fmaf(f_s[i * C + c], w_loc[c * A + a], loc);
      part[i] = fmaf(tanhf((kv[i] + loc) + qa), va, part[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kFrames; ++i) {
    const float sum = warp_sum(part[i]);
    if (lane == 0) red[i * kWarps + warp] = sum;
  }
  __syncthreads();
  if (tid < kFrames && t0 + tid < T) {
    float sum = red[tid * kWarps];
    for (int w = 1; w < kWarps; ++w) sum += red[tid * kWarps + w];
    // a masked frame's e is -1e30 whatever its score
    e[(size_t)n * T + t0 + tid] = on_s[tid] ? sum * sharpening : kNeg;
  }
}

template <int kVec>
struct VecOf;
template <>
struct VecOf<1> {
  using type = float;
};
template <>
struct VecOf<4> {
  using type = float4;
};

__device__ __forceinline__ void fma_vec(float a, float x, float& acc) { acc = fmaf(a, x, acc); }
__device__ __forceinline__ void fma_vec(float a, const float4& x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
location_context(const float* __restrict__ enc,  // [N, T, He]
                 const float* __restrict__ e,    // [N, T]
                 float* __restrict__ ctx,        // [N, He]
                 float* __restrict__ align,      // [N, T]
                 int T, int He) {
  using Vec = typename VecOf<kVec>::type;
  __shared__ float w_s[kTChunk];
  __shared__ float red[kWarps];
  __shared__ Vec part_s[kWarps][32];
  const int n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* en = e + (size_t)n * T;

  float m = -3.402823466e38f;
  for (int t = threadIdx.x; t < T; t += kThreads) m = fmaxf(m, en[t]);
  m = block_reduce<true>(m, red);
  float sum = 0.0f;
  for (int t = threadIdx.x; t < T; t += kThreads) sum += expf(en[t] - m);
  sum = block_reduce<false>(sum, red);

  const int col = (blockIdx.y * 32 + lane) * kVec;  // this lane's first column
  const bool has_col = col < He;
  const Vec* encv = reinterpret_cast<const Vec*>(enc + (size_t)n * T * He + col);
  const size_t row = He / kVec;  // Vec elements per frame
  Vec acc = Vec{};
  for (int c0 = 0; c0 < T; c0 += kTChunk) {
    const int len = min(kTChunk, T - c0);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float a = expf(en[c0 + i] - m) / sum;
      w_s[i] = a;
      if (blockIdx.y == 0) align[(size_t)n * T + c0 + i] = a;
    }
    __syncthreads();
    if (has_col) {
#pragma unroll 4
      for (int i = warp; i < len; i += kWarps) fma_vec(w_s[i], encv[(size_t)(c0 + i) * row], acc);
    }
    __syncthreads();  // w_s is rewritten for the next chunk
  }
  part_s[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || !has_col) return;
  Vec out = part_s[0][lane];
  for (int w = 1; w < kWarps; ++w) fma_vec(1.0f, part_s[w][lane], out);
  *reinterpret_cast<Vec*>(ctx + (size_t)n * He + col) = out;
}

}  // namespace

extern "C" {

// Device pointers of contiguous tensors: keys [N, T, A], enc [N, T, He],
// q [N, A], prev [N, T], w_loc [C, A], v [A] float32; mask [N, T] bool (one
// byte each); conv [W, 1, C] float32; outputs ctx [N, He] and align [N, T]
// float32, written in full; e [N, T] float32 scratch. Two launches on
// `stream` (energies, then softmax and context); returns the first CUDA
// error (0 when both were accepted). Does not synchronise.
int location_attend(const float* keys, const float* enc, const float* q, const float* prev,
                    const unsigned char* mask, const float* conv, const float* w_loc,
                    const float* v, float* ctx, float* align, float* e, int N, int T, int A,
                    int He, int C, int W, float sharpening, void* stream) {
  if (N <= 0 || T <= 0 || A <= 0 || He <= 0 || C <= 0 || W <= 0 || T > kFrames * 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = (size_t)(kFrames + W - 1 + kFrames * C + kFrames * kWarps + kFrames) * 4;
  const size_t weights = ((size_t)W * C + (size_t)C * A + 2 * (size_t)A) * sizeof(float);
  const int staged = smem + weights <= (size_t)kMaxSmem;
  if (staged) smem += weights;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;  // W above ~56 000 taps
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        location_energies, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_e(N, (T + kFrames - 1) / kFrames);
  location_energies<<<grid_e, kThreads, smem, s>>>(keys, q, prev, mask, conv, w_loc, v, e, T,
                                                    A, C, W, sharpening, staged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (He % 4 == 0 && reinterpret_cast<uintptr_t>(enc) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(ctx) % 16 == 0) {
    const dim3 grid_c(N, (He / 4 + 31) / 32);
    location_context<4><<<grid_c, kThreads, 0, s>>>(enc, e, ctx, align, T, He);
  } else {
    const dim3 grid_c(N, (He + 31) / 32);
    location_context<1><<<grid_c, kThreads, 0, s>>>(enc, e, ctx, align, T, He);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
