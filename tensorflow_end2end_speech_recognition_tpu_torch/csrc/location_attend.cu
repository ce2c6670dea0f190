// One location-aware (hybrid) attention read, for Hopper (sm_90a), float32,
// for N rows that come in groups of G rows per utterance (the beam's W
// rows of one utterance share its encoder output; greedy decoding has G = 1).
// The encoder rows may be bf16 (compute_dtype: bfloat16, whose encoder emits
// bf16): location_attend_bf16 reads them so, widens each value where it is
// loaded and keeps every sum, ctx and align in float32, as the Pallas kernel
// does on bf16 enc_ref rows (its out_shape is float32). Keys, q, prev and the
// weights stay float32 in both modes.
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/attention_kernel.py
// _attention_kernel (called by location_attend_pallas / location_attend_fused)
// and computes what _reference_math there computes on inputs tiled G times
// (keys_in = keys + b), per row n of utterance u = n / G:
//
//   f[t, c]   = sum_k prev[n, t + k - (W-1)/2] * conv[k, c]  (SAME, zero outside [0, T))
//   pre[t, a] = ((keys[u, t, a] + b[a]) + sum_c f[t, c] * w_loc[c, a]) + q[n, a]
//   e[t]      = (sum_a tanh(pre[t, a]) * v[a]) * sharpening + (mask[u, t] ? 0 : -1e30)
//   align     = softmax_t(e)
//   ctx[h]    = sum_t align[t] * enc[u, t, h]
//
// keys may be null (a pure location scorer, whose keys_in is b broadcast)
// and b may be null (keys already hold it). The left offset is (W-1)/2 for
// an even W too, as XLA pads a SAME conv. A row with no valid frame gets
// align = 1/T (every e is -1e30).
//
// What bounds it. The beam's call at ls960_joint widths (N = 64 rows, G = 8,
// so U = 8 utterances; T = 300, A = 256, He = 1024, C = 10, W = 101) needs
// each utterance's keys [T, A] and enc [T, He] once: 12.3 MB at full
// length, 3.7 us at 3.35 TB/s (7.4 MB with bf16 rows: enc is 4.9 MB, not
// 9.8), and small enough to stay in the 50 MB L2 over a decode's 120 calls; its arithmetic is about 200 MFLOP (3 us at
// 67 TFLOP/s). Neither sets the pace. An accurate tanhf and the C-term
// location product take some 32 instructions per (row, frame, unit), so the
// energies are bound by instruction issue, and each block's staging and
// location features are latency it must hide. Inputs tiled W times would
// move 98 MB per call, more than L2 holds.
//
// Design: two launches on the stream, no T cap, no padding, no atomics.
// 1. location_energies<kC4>, grid (U, ceil(T / kFrames), ceil(G / rows)):
//    a block of 256 threads takes kFrames frames of one utterance for up to
//    kMaxRows of its rows (fewer only when shared memory caps them; small
//    blocks, several per SM, balance the SMs and overlap one block's
//    staging with another's scores). It issues asynchronous copies
//    (cp.async) of each row's prev window and q and of the conv taps, reads
//    which frames are valid meanwhile, then copies each thread's column of
//    keys for the valid frames. A group of kTapLanes lanes per (row, frame)
//    sums the W taps into the location features (a fixed split, whatever
//    G). Then a thread per attention unit a keeps its w_loc column (C <= 16:
//    kC4 float4s) and v[a] in registers and walks kChunk frames at a time:
//    keys + b in registers once for all the rows, and for each row
//    tanh(pre) * v per frame, added over the warp by a reduce-scatter
//    (kChunk - 1 + log2(32 / kChunk) shuffles for kChunk sums; lane l ends
//    with frame l / (32 / kChunk)); the 8 warps' sums are added in order
//    into e[n, t], a [N, T] scratch. Every frame of a block is scored, with
//    no branch between frames; a masked frame's e is then set to -1e30
//    whatever its score (-1e30 + |e| rounds to -1e30 in float32 for
//    |e| < 3.8e22), its keys are not read, and a block with no valid frame
//    only writes -1e30.
// 2. location_context<kVec>, grid (U, ceil(He / 32), ceil(G / 8)), launched
//    as a programmatic dependent of the energies: its blocks may start
//    while the energies run, find the utterance's last valid frame (past it
//    every weight is exactly 0) and copy their 32 columns of enc for the
//    frames before it into shared memory (T <= 512), and only then wait for
//    the energies (griddepcontrol.wait). A warp per row stages the row's e,
//    takes its max and sum of exp (lanes strided, then a butterfly) and
//    turns it into weights in place; the first column block writes align.
//    Each enc[t, cols] then feeds the contexts of all the block's rows: G
//    FMAs per 16-byte read (4 bytes when He % 4 != 0 or enc or ctx is not
//    16-byte aligned). The frames are split over the block's 32 (8) frame
//    slices, whose sums are added by shuffles and then over the 8 warps, in
//    order. Longer T reads enc from global memory in chunks of 512 frames.
//    bf16 rows: the tile holds the bf16 values (half the bytes), 4 per
//    8-byte load (2 bytes when He % 4 != 0, enc is not 8-byte aligned or
//    ctx not 16-byte aligned), each widened to float32 by a shift or a mask
//    before its G FMAs; the sums and their order are the float32 pass's.
// Every sum has a fixed order, the same for any G: the result is
// deterministic, and a row's bits do not depend on its group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kMinF = -3.402823466e38f;  // the lowest float
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kFrames = 8;    // frames per energies block
constexpr int kMaxC = 16;     // channels a thread holds in registers
constexpr int kMaxRows = 4;   // rows per energies block
constexpr int kMinBlocks = 3;  // energies blocks an SM must hold at once
constexpr int kChunk = 8;     // frames a thread scores at once (registers)
static_assert(kFrames % kChunk == 0 && kFrames <= 32);
constexpr int kTapLanes = kThreads / (kFrames * kMaxRows);  // lanes per location feature
static_assert(kTapLanes >= 1 && kTapLanes <= 32 && (kTapLanes & (kTapLanes - 1)) == 0);
constexpr int kRows = 8;      // rows per context block (its accumulators)
constexpr int kCols = 32;     // columns of enc per context block
constexpr int kTChunk = 512;  // frames of align staged at once by a context block
constexpr int kMaxSmem = 232448 - 1024;  // bytes of shared memory a block may take

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The warp's sums of v[0..kF): lane l returns the sum of v[l / (32 / kF)]
// over the 32 lanes. Each round halves the values a lane holds: it keeps
// one half, sends the other to the lane `off` away and adds what comes back,
// so kF sums take kF - 1 + log2(32 / kF) shuffles instead of 5 kF.
template <int kF, int kN = kF>
__device__ __forceinline__ void scatter_rounds(float (&v)[kF], int lane) {
  if constexpr (kN > 1) {
    constexpr int off = 16 * kN / kF;
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < kN / 2; ++k) {
      const float send = upper ? v[k] : v[k + kN / 2];
      const float keep = upper ? v[k + kN / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(kFull, send, off);
    }
    scatter_rounds<kF, kN / 2>(v, lane);
  }
}

template <int kF>
__device__ __forceinline__ float warp_sum_scatter(float (&v)[kF], int lane) {
  static_assert(kF >= 1 && kF <= 32 && (kF & (kF - 1)) == 0, "kF: a power of 2 up to 32");
  scatter_rounds<kF>(v, lane);
#pragma unroll
  for (int off = 16 / kF; off > 0; off /= 2) v[0] += __shfl_xor_sync(kFull, v[0], off);
  return v[0];
}

// An asynchronous 4-byte copy from global to shared memory; `copy` false
// writes 0 and reads nothing (src must still be a global address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool copy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(copy ? 4 : 0)
               : "memory");
}

// The same for 16 bytes (both addresses 16-byte aligned), through L2 only.
// The same for 8 bytes (both addresses 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool copy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(copy ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool copy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(copy ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float x, const float4& w, float4& acc) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
}

__device__ __forceinline__ void add_lane(float& acc, int off) {
  acc += __shfl_xor_sync(kFull, acc, off);
}
__device__ __forceinline__ void add_lane(float4& acc, int off) {
  add_lane(acc.x, off);
  add_lane(acc.y, off);
  add_lane(acc.z, off);
  add_lane(acc.w, off);
}

// kC4 > 0: C <= 4 kC4 channels, held as kC4 float4s in registers, with the
// conv taps staged in shared memory; kC4 = 0: any C, taps and w_loc read
// from global memory (L1) as needed.
template <int kC4>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
location_energies(const float* __restrict__ keys,          // [U, T, A] or null
                  const float* __restrict__ b,             // [A] or null
                  const float* __restrict__ q,             // [N, A]
                  const float* __restrict__ prev,          // [N, T]
                  const unsigned char* __restrict__ mask,  // [U, T] bool
                  const float* __restrict__ conv,          // [W, C]
                  const float* __restrict__ w_loc,         // [C, A]
                  const float* __restrict__ v,             // [A]
                  float* __restrict__ e,                   // [N, T]
                  int G, int chunk, int T, int A, int C, int W, float sharpening) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kRegs = kC4 > 0;
  const int cp = kRegs ? 4 * kC4 : C;  // features per frame (zero-padded to 16 bytes)
  const int span = kFrames + W - 1;    // prev window of the block's frames
  float* f_s = smem;                            // [chunk, kFrames, cp] location features
  float* keys_s = f_s + chunk * kFrames * cp;   // [kFrames, kThreads]: column tid is thread tid's
  float* conv_s = keys_s + kFrames * kThreads;  // kRegs: [W, cp], zero-padded
  float* q_s = conv_s + (kRegs ? W * cp : 0);   // [chunk, A]
  float* red = q_s + chunk * A;                 // [chunk, kFrames, kWarps] partial scores
  float* win = red + chunk * kFrames * kWarps;  // [chunk, span]: prev[n, t0 - left ..]
  const int u = blockIdx.x, t0 = blockIdx.y * kFrames;
  const int rows = min(chunk, G - (int)blockIdx.z * chunk);
  const int n0 = u * G + blockIdx.z * chunk;  // the block's first row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int items = rows * kFrames;  // (row, frame) pairs
  // the context pass may start its own loads while this grid finishes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the valid frames (the same for every row of the utterance), loaded
  // first so that their latency overlaps the copies below
  bool valid[kFrames];
#pragma unroll
  for (int i = 0; i < kFrames; ++i) valid[i] = t0 + i < T && mask[(size_t)u * T + t0 + i];
  // staging, as asynchronous copies: the prev windows, q and the taps now,
  // the keys once the valid frames are known
  const int left = (W - 1) / 2;
  for (int i = tid; i < rows * span; i += kThreads) {
    const int g = i / span, s = t0 - left + (i - g * span);
    const bool in = s >= 0 && s < T;
    cp_async4(win + i, prev + (size_t)(n0 + g) * T + (in ? s : 0), in);
  }
  for (int i = tid; i < rows * A; i += kThreads) cp_async4(q_s + i, q + (size_t)n0 * A + i, true);
  if constexpr (kRegs) {
    for (int i = tid; i < W * cp; i += kThreads) {
      const int c = i % cp;
      cp_async4(conv_s + i, conv + (i / cp) * C + (c < C ? c : 0), c < C);
    }
  }
  unsigned on = 0;  // bit i: frame t0 + i is valid
#pragma unroll
  for (int i = 0; i < kFrames; ++i) on |= (unsigned)valid[i] << i;
  if (on == 0) {  // a masked frame's e is -1e30 whatever its score
    cp_async_wait_all();
    for (int p = tid; p < items; p += kThreads)
      if (t0 + p % kFrames < T) e[(size_t)(n0 + p / kFrames) * T + t0 + p % kFrames] = kNeg;
    return;
  }
  // this thread's column of keys for the units a0 + tid: the valid frames'
  // (0 for the others, and for every frame without keys)
  auto stage_keys = [&](int a0) {
    const int a = a0 + tid;
    for (int i = 0; i < kFrames; ++i) {
      const bool copy = keys && a < A && (on >> i & 1);
      cp_async4(keys_s + i * kThreads + tid,
                copy ? keys + ((size_t)u * T + t0 + i) * A + a : q, copy);
    }
  };
  stage_keys(0);
  cp_async_wait_all();
  __syncthreads();

  // location features of each (row, frame): its W taps split over kTapLanes
  // lanes, each lane's taps in order, then their sums by a butterfly (the
  // same split whatever G, so a row's result does not depend on its group)
  if constexpr (kRegs) {
    constexpr int S = kTapLanes;
    for (int base = 0; base < items; base += kThreads / S) {
      const int p = base + tid / S, slice = tid % S, i = p % kFrames;
      float4 f[kC4];
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4) f[c4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p < items && (on >> i & 1)) {
        const float* wg = win + (p / kFrames) * span + i;
#pragma unroll 4
        for (int k = slice; k < W; k += S) {
          const float x = wg[k];
          const float4* ck = reinterpret_cast<const float4*>(conv_s + k * cp);
#pragma unroll
          for (int c4 = 0; c4 < kC4; ++c4) fma4(x, ck[c4], f[c4]);
        }
      }
#pragma unroll
      for (int off = S / 2; off > 0; off /= 2)
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) add_lane(f[c4], off);
      if (p < items && slice == 0)
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) reinterpret_cast<float4*>(f_s + p * cp)[c4] = f[c4];
    }
  } else {
    for (int pc = tid; pc < items * C; pc += kThreads) {
      const int p = pc / C, c = pc - p * C, i = p % kFrames;
      float f = 0.0f;
      if (on >> i & 1) {
        const float* wg = win + (p / kFrames) * span + i;
        for (int k = 0; k < W; ++k) f = fmaf(wg[k], __ldg(conv + k * C + c), f);
      }
      f_s[pc] = f;
    }
  }
  __syncthreads();

  // scores: a thread per attention unit a (one pass when A <= 256) with its
  // w_loc column in registers; kChunk frames at a time, their keys + b in
  // registers for all the rows. Every frame is scored (no branch between
  // them); a masked one has keys and features 0 and its e is overwritten below
  for (int a0 = 0; a0 < A; a0 += kThreads) {
    if (a0 > 0) {
      stage_keys(a0);  // only this thread reads its column
      cp_async_wait_all();
    }
    const int a = a0 + tid;
    const bool has_a = a < A;
    const float ba = has_a && b ? __ldg(b + a) : 0.0f;
    float4 wl[kRegs ? kC4 : 1];
    if constexpr (kRegs) {
      auto w = [&](int c) { return has_a && c < C ? __ldg(w_loc + c * A + a) : 0.0f; };
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4)
        wl[c4] = make_float4(w(4 * c4), w(4 * c4 + 1), w(4 * c4 + 2), w(4 * c4 + 3));
    }
    const float va = has_a ? __ldg(v + a) : 0.0f;
    for (int c0 = 0; c0 < kFrames; c0 += kChunk) {
      float kv[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) kv[i] = keys_s[(c0 + i) * kThreads + tid] + ba;
      for (int g = 0; g < rows; ++g) {
        const float qa = has_a ? q_s[g * A + a] : 0.0f;
        float part[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const float* fr = f_s + (g * kFrames + c0 + i) * cp;
          float loc = 0.0f;  // the padding's features and weights are 0
          if constexpr (kRegs) {
#pragma unroll
            for (int c4 = 0; c4 < kC4; ++c4) {
              const float4 x = reinterpret_cast<const float4*>(fr)[c4];
              loc = fmaf(x.x, wl[c4].x, loc);
              loc = fmaf(x.y, wl[c4].y, loc);
              loc = fmaf(x.z, wl[c4].z, loc);
              loc = fmaf(x.w, wl[c4].w, loc);
            }
          } else {
            for (int c = 0; c < C; ++c)
              loc = fmaf(fr[c], has_a ? __ldg(w_loc + c * A + a) : 0.0f, loc);
          }
          part[i] = tanhf((kv[i] + loc) + qa) * va;
        }
        const float s = warp_sum_scatter<kChunk>(part, lane);
        if (lane % (32 / kChunk) == 0) {
          float* r = red + (g * kFrames + c0 + lane / (32 / kChunk)) * kWarps + warp;
          *r = a0 == 0 ? s : *r + s;
        }
      }
    }
  }
  __syncthreads();
  for (int p = tid; p < items; p += kThreads) {
    const int i = p % kFrames;
    if (t0 + i >= T) continue;
    float sum = red[p * kWarps];
    for (int w = 1; w < kWarps; ++w) sum += red[p * kWarps + w];
    // a masked frame's e is -1e30 whatever its score
    e[(size_t)(n0 + p / kFrames) * T + t0 + i] = (on >> i & 1) ? sum * sharpening : kNeg;
  }
}

// kVec columns of enc of type In: the raw element a thread loads (`Raw`),
// its float32 accumulator (`Acc`), and `widen` from one to the other. A
// bf16 value's bits are the upper half of its float32's.
template <typename In, int kVec>
struct EncCols;
template <>
struct EncCols<float, 1> {
  using Raw = float;
  using Acc = float;
  __device__ static float widen(float x) { return x; }
};
template <>
struct EncCols<float, 4> {
  using Raw = float4;
  using Acc = float4;
  __device__ static float4 widen(const float4& x) { return x; }
};
template <>
struct EncCols<__nv_bfloat16, 1> {
  using Raw = unsigned short;  // the bf16 bits
  using Acc = float;
  __device__ static float widen(unsigned short x) { return __uint_as_float((unsigned)x << 16); }
};
template <>
struct EncCols<__nv_bfloat16, 4> {
  using Raw = uint2;  // 4 bf16 values, element 2k in the low half of word k
  using Acc = float4;
  __device__ static float4 widen(const uint2& x) {
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  }
};

// A copy of one raw element from global to shared memory (0 when `copy` is
// false): asynchronous for 4, 8 and 16 bytes; cp.async has no 2-byte form,
// so a single bf16 is copied by the thread.
template <typename Raw>
__device__ __forceinline__ void stage_raw(Raw* dst, const Raw* src, bool copy) {
  if constexpr (sizeof(Raw) == 16)
    cp_async16(dst, src, copy);
  else if constexpr (sizeof(Raw) == 8)
    cp_async8(dst, src, copy);
  else if constexpr (sizeof(Raw) == 4)
    cp_async4(dst, src, copy);
  else
    *dst = copy ? *src : Raw(0);
}

__device__ __forceinline__ void fma_vec(float a, float x, float& acc) { acc = fmaf(a, x, acc); }
__device__ __forceinline__ void fma_vec(float a, const float4& x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}
template <typename In, int kVec>
__global__ void __launch_bounds__(kThreads, 2)
location_context(const In* __restrict__ enc,              // [U, T, He]
                 const unsigned char* __restrict__ mask,  // [U, T] bool
                 const float* __restrict__ e,             // [N, T]
                 float* __restrict__ ctx,                 // [N, He]
                 float* __restrict__ align,               // [N, T]
                 int G, int T, int He) {
  using Cols = EncCols<In, kVec>;
  using Raw = typename Cols::Raw;
  using Vec = typename Cols::Acc;
  constexpr int kTpf = kCols / kVec;        // threads per frame
  constexpr int kSlices = kThreads / kTpf;  // frames a block reads at once
  // T <= kTChunk: the block's kCols columns of enc for the frames it needs, as In
  extern __shared__ __align__(16) unsigned char tile_bytes[];  // [T, kCols]
  Raw* tile_s = reinterpret_cast<Raw*>(tile_bytes);             // [T, kTpf]
  __shared__ float w_s[kRows][kTChunk];
  __shared__ float m_s[kRows], s_s[kRows];  // each row's max and 1 / sum of exp
  __shared__ unsigned end_s[kWarps];
  __shared__ Vec part_s[kWarps][kRows][kTpf];
  const int u = blockIdx.x;
  const int rows = min(kRows, G - (int)blockIdx.z * kRows);
  const size_t n0 = (size_t)u * G + blockIdx.z * kRows;  // the block's first row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* eb = e + n0 * T;
  const int j = tid % kTpf, slice = tid / kTpf;
  const int col = blockIdx.y * kCols + j * kVec;  // this thread's first column
  const bool has_col = col < He;
  const In* encc = enc + (size_t)u * T * He + col;
  const bool one_chunk = T <= kTChunk;

  // one past the utterance's last valid frame: past it every weight is
  // exp(-1e30 - m) = 0, and its enc rows are not read; with no valid frame, 1/T
  unsigned last = 0;
  for (int t = tid; t < T; t += kThreads)
    if (mask[(size_t)u * T + t]) last = t + 1;
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) end_s[warp] = last;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) last = max(last, end_s[w]);
  const int t_end = last > 0 ? (int)last : T;
  if (one_chunk)  // enc does not depend on the energies: copy it now
    for (int i = slice; i < t_end; i += kSlices)
      stage_raw(tile_s + i * kTpf + j,
                reinterpret_cast<const Raw*>(has_col ? encc + (size_t)i * He : enc), has_col);

  // the energies are the previous launch's: wait for it (it lets this grid
  // start early, so the copies above overlap its last blocks)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // a warp per row: its max and sum of exp over T (lanes strided, then a
  // butterfly); when the row fits in w_s it is staged there and turned into
  // its weights in place, and the first column block writes its align
  if (one_chunk)
    for (int p = tid; p < rows * T; p += kThreads) cp_async4(&w_s[p / T][p % T], eb + p, true);
  cp_async_wait_all();
  __syncthreads();
  if (warp < rows) {
    const float* er = one_chunk ? w_s[warp] : eb + (size_t)warp * T;
    float m = kMinF, sum = 0.0f;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, er[t]);
    m = warp_max(m);
    if (one_chunk) {
      float* wr = w_s[warp];
      for (int t = lane; t < T; t += 32) {
        const float x = expf(wr[t] - m);
        wr[t] = x;
        sum += x;
      }
      const float inv = 1.0f / warp_sum(sum);
      float* al = align + (n0 + warp) * T;
      for (int t = lane; t < T; t += 32) {
        const float x = wr[t] * inv;
        wr[t] = x;
        if (blockIdx.y == 0) al[t] = x;
      }
    } else {
      for (int t = lane; t < T; t += 32) sum += expf(er[t] - m);
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[warp] = m;
        s_s[warp] = 1.0f / sum;
      }
    }
  }
  __syncthreads();
  if (!one_chunk && blockIdx.y == 0)
    for (int p = tid; p < rows * T; p += kThreads)
      align[n0 * T + p] = expf(eb[p] - m_s[p / T]) * s_s[p / T];

  // each enc[t, cols] feeds all the block's rows
  Vec acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = Vec{};
  if (one_chunk) {
    if (has_col) {
      const Raw* tv = tile_s + j;
#pragma unroll 4
      for (int i = slice; i < t_end; i += kSlices) {
        const Vec x = Cols::widen(tv[i * kTpf]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < rows) fma_vec(w_s[r][i], x, acc[r]);
      }
    }
  } else {
    const Raw* encv = reinterpret_cast<const Raw*>(encc);
    const size_t row = He / kVec;  // Raw elements per frame
    for (int c0 = 0; c0 < t_end; c0 += kTChunk) {
      const int len = min(kTChunk, t_end - c0);
#pragma unroll 4
      for (int p = tid; p < rows * len; p += kThreads) {
        const int r = p / len, i = p - r * len;
        w_s[r][i] = expf(eb[(size_t)r * T + c0 + i] - m_s[r]) * s_s[r];
      }
      __syncthreads();
      if (has_col) {
#pragma unroll 4
        for (int i = slice; i < len; i += kSlices) {
          const Vec x = Cols::widen(encv[(size_t)(c0 + i) * row]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            if (r < rows) fma_vec(w_s[r][i], x, acc[r]);
        }
      }
      __syncthreads();  // w_s is rewritten for the next chunk
    }
  }
  // the slices of a warp (lanes j, j + kTpf, ...), then the warps, in order
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = kTpf; off < 32; off *= 2) add_lane(acc[r], off);
    if (lane < kTpf) part_s[warp][r][lane] = acc[r];
  }
  __syncthreads();
  for (int p = tid; p < rows * kTpf; p += kThreads) {
    const int r = p / kTpf, jj = p % kTpf;
    const int cc = blockIdx.y * kCols + jj * kVec;
    if (cc >= He) continue;
    Vec out = part_s[0][r][jj];
    for (int w = 1; w < kWarps; ++w) fma_vec(1.0f, part_s[w][r][jj], out);
    *reinterpret_cast<Vec*>(ctx + (n0 + r) * He + cc) = out;
  }
}

// Both passes on `stream` for enc rows of type In (float or bf16); see the
// C entries below.
template <typename In>
int launch(const float* keys, const float* b, const In* enc, const float* q, const float* prev,
           const unsigned char* mask, const float* conv, const float* w_loc, const float* v,
           float* ctx, float* align, float* e, int N, int G, int T, int A, int He, int C, int W,
           float sharpening, void* stream) {
  if (N <= 0 || G <= 0 || N % G != 0 || T <= 0 || A <= 0 || He <= 0 || C <= 0 || W <= 0 ||
      (keys == nullptr && b == nullptr) || T > kFrames * 65535 ||
      (He + kCols - 1) / kCols > 65535 || (G + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int U = N / G;
  // an energies block's shared memory: per row its features, q, partial
  // scores and prev window; the keys tile, and the conv taps, zero-padded,
  // when C <= kMaxC
  const int c4 = C <= kMaxC ? (C + 3) / 4 : 0;
  const size_t cp = c4 > 0 ? 4 * c4 : C;
  const size_t per_row =
      (kFrames * cp + (size_t)A + kFrames * kWarps + kFrames + (size_t)W - 1) * sizeof(float);
  const size_t taps = ((c4 > 0 ? (size_t)W * cp : 0) + kFrames * kThreads) * sizeof(float);
  if (taps + per_row > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;  // W or A ~ 50 000
  const int chunk =
      (int)std::min<size_t>({(kMaxSmem - taps) / per_row, (size_t)G, (size_t)kMaxRows});
  const int z = (G + chunk - 1) / chunk;
  if (z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = taps + chunk * per_row;
  const decltype(&location_energies<0>) energies = c4 == 1   ? location_energies<1>
                                                  : c4 == 2 ? location_energies<2>
                                                  : c4 == 3 ? location_energies<3>
                                                  : c4 == 4 ? location_energies<4>
                                                            : location_energies<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(energies, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_e(U, (T + kFrames - 1) / kFrames, z);
  energies<<<grid_e, kThreads, smem, s>>>(keys, b, q, prev, mask, conv, w_loc, v, e, G, chunk, T,
                                          A, C, W, sharpening);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the context pass, launched so that its blocks may start before the
  // energies end (it waits for them before it reads e)
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(U, (He + kCols - 1) / kCols, (G + kRows - 1) / kRows);
  config.blockDim = dim3(kThreads);
  config.stream = s;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &early;
  config.numAttrs = 1;
  // 4 columns of enc per load (16 bytes of float32, 8 of bf16) and a float4
  // of ctx per store
  const bool wide = He % 4 == 0 && reinterpret_cast<uintptr_t>(enc) % (4 * sizeof(In)) == 0 &&
                    reinterpret_cast<uintptr_t>(ctx) % 16 == 0;
  const decltype(&location_context<In, 1>) context =
      wide ? location_context<In, 4> : location_context<In, 1>;
  config.dynamicSmemBytes = T <= kTChunk ? (size_t)T * kCols * sizeof(In) : 0;  // enc tile
  if (config.dynamicSmemBytes > 16 * 1024) {
    err = cudaFuncSetAttribute(context, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)config.dynamicSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaLaunchKernelEx(&config, context, enc, mask, e, ctx, align, G, T, He);
  return (int)err;
}

}  // namespace

extern "C" {

// Device pointers of contiguous tensors: keys [N/G, T, A] (or null: a pure
// location scorer) and b [A] (or null: none), enc [N/G, T, He], q [N, A],
// prev [N, T], w_loc [C, A], v [A] float32; mask [N/G, T] bool (one byte
// each); conv [W, 1, C] float32; outputs ctx [N, He] and align [N, T]
// float32, written in full; e [N, T] float32 scratch. Row n reads utterance
// n / G. Two launches on `stream`: the energies, then softmax and context as
// its programmatic dependent (it reads e only after the energies end);
// returns the first CUDA error (0 when both were accepted). Does not
// synchronise.
int location_attend(const float* keys, const float* b, const float* enc, const float* q,
                    const float* prev, const unsigned char* mask, const float* conv,
                    const float* w_loc, const float* v, float* ctx, float* align, float* e,
                    int N, int G, int T, int A, int He, int C, int W, float sharpening,
                    void* stream) {
  return launch(keys, b, enc, q, prev, mask, conv, w_loc, v, ctx, align, e, N, G, T, A, He, C, W,
                sharpening, stream);
}

// The same with enc [N/G, T, He] bf16; every other tensor as above (float32
// ctx and align).
int location_attend_bf16(const float* keys, const float* b, const __nv_bfloat16* enc,
                         const float* q, const float* prev, const unsigned char* mask,
                         const float* conv, const float* w_loc, const float* v, float* ctx,
                         float* align, float* e, int N, int G, int T, int A, int He, int C, int W,
                         float sharpening, void* stream) {
  return launch(keys, b, enc, q, prev, mask, conv, w_loc, v, ctx, align, e, N, G, T, A, He, C, W,
                sharpening, stream);
}

}  // extern "C"
