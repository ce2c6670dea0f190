// One LSTM time step forward and one reverse step of its gradient, for
// Hopper (sm_90a), float32, over hoisted input projections. Shared by the
// bidirectional layer (lstm_bidi_fwd.cu, lstm_bidi_bwd.cu: two directions,
// blockIdx.y picks one) and the unidirectional layer (lstm_layer_fwd.cu,
// lstm_layer_bwd.cu: one direction, a grid of depth 1 and null second
// pointers). ops/build.py hashes this header with the sources that include it.
//
// Gates i, f, g, o of xproj[t] + h_{t-1} @ Wh, with forget_bias added to f.
// A masked (pad) step carries h and c through and emits 0; the mask is a
// monotone length mask, which the backward's h_{t-1} = ys[t-1] read relies on.
//
// What bounds it. The recurrence is a serial chain of T steps, and each step
// needs all of Wh [H, 4H] of a direction: 4 MB at H = 512. The TPU kernels
// keep Wh resident in VMEM; an SM has 227 KB of shared memory, so here Wh
// stays in device memory and is re-read through the 50 MB L2 at every step.
// One launch advances one step, so the step time is launch latency plus one
// L2 pass over Wh (two in the backward).
//
// Forward design. Grid (ceil(H / kUnits), directions, ceil(B / kRows)). A
// block owns kUnits hidden units of one direction for kRows batch rows: it
// stages h_{t-1} for its rows in shared memory, computes the four dot
// products against Wh columns j, H+j, 2H+j, 3H+j for each owned unit itself
// (32 / kUnits lanes split the H-long reduction inside a warp and kWarps
// ways across warps), sums the partials, adds xproj[t] and runs the gate
// math, the mask carry and the writes of h, c and ys[t] = h * m. h
// ping-pongs between two global buffers so no block reads a row another
// block writes in the same step; c is read and written only by the thread
// that owns it. There is no cross-block reduction and no grid barrier: the
// launches on one stream are the step barrier. Training also writes the
// cell-state stream cs[b, t] = c_t (the carried value on a masked step),
// which the backward reads; serving passes null and the store is skipped.
//
// Backward design. One launch per step t = T-1 .. 0, the same grid. A block
// owns kUnits hidden units j of one direction for kRows batch rows:
//  (a) dh from the step above: it stages the dgates_{t+1} rows of its batch
//      rows (dxproj[t+1], written by the previous launch) one gate quarter
//      [kRows, H] at a time in shared memory, and reduces them against the
//      contiguous rows Wh[j, :] of its own units (lanes walk consecutive k,
//      so every Wh read is coalesced). That gives dh_t for exactly its
//      units: no cross-block reduction is needed.
//  (b) the gates at t: it stages h_{t-1} = ys[t-1] rows and reduces them
//      against the columns j, H+j, 2H+j, 3H+j of Wh, as the forward does.
//  (c) one thread per (row, unit) runs the gate derivatives, writes the four
//      dxproj[t] entries of its unit (zero on a masked step, which carries
//      dh and dc through), and keeps its own dh and dc carries in global
//      buffers that no other thread touches.
// Recomputing the gates costs one more h @ Wh per step instead of storing
// 4H gate values per (b, t): 105 MB per direction at B = 32, T = 400.

#pragma once

#include <cuda_runtime.h>

// Internal linkage: each source that includes this header gets its own copy
// of the kernels it instantiates, registered with its own module.
namespace {

constexpr int kWarps = 8;              // warps that split k within a block
constexpr int kRows = 8;               // batch rows per block
constexpr int kThreads = 32 * kWarps;  // 256
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block may use

template <int kUnits>
struct Tile {
  static constexpr int kKSub = 32 / kUnits;             // lanes that split k in a warp
  static constexpr int kKStride = kKSub * kWarps;
  static constexpr int kRed = kWarps * 4 * kRows * kUnits;  // partial sums, floats
  static_assert(32 % kUnits == 0, "kUnits divides a warp");
  static_assert(kRows * kUnits <= kThreads, "one epilogue thread per (row, unit)");
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// h_{t-1} rows staged in hs [kRows, H] times the columns j, H+j, 2H+j, 3H+j
// of Wh for the unit this lane owns; partial sums reduced over the lanes of
// a unit and left in red [kWarps, 4, kRows, kUnits] for the epilogue.
template <int kUnits>
__device__ __forceinline__ void gate_products(const float* __restrict__ wh,
                                              const float* __restrict__ hs,
                                              float* __restrict__ red, int j0, int H,
                                              bool skip) {
  using Tl = Tile<kUnits>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = lane % kUnits;
  const int ks = lane / kUnits;
  const int j = j0 + u;
  const int G = 4 * H;
  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;
  if (j < H && !skip) {
#pragma unroll 4
    for (int k = warp * Tl::kKSub + ks; k < H; k += Tl::kKStride) {
      const float* w = wh + (size_t)k * G + j;
      const float w0 = __ldg(w), w1 = __ldg(w + H), w2 = __ldg(w + 2 * H), w3 = __ldg(w + 3 * H);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = hs[r * H + k];
        acc[0][r] = fmaf(hv, w0, acc[0][r]);
        acc[1][r] = fmaf(hv, w1, acc[1][r]);
        acc[2][r] = fmaf(hv, w2, acc[2][r]);
        acc[3][r] = fmaf(hv, w3, acc[3][r]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = acc[g][r];
#pragma unroll
      for (int off = kUnits; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[g][r] = v;
    }
  if (ks == 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < kRows; ++r) red[((warp * 4 + g) * kRows + r) * kUnits + u] = acc[g][r];
  }
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads)
fwd_step(const float* __restrict__ xf, const float* __restrict__ xb,
         const float* __restrict__ whf, const float* __restrict__ whb,
         const float* __restrict__ mask,
         float* __restrict__ ysf, float* __restrict__ ysb,
         float* __restrict__ csf, float* __restrict__ csb,  // null: skip
         const float* __restrict__ h_in,  // [dirs, B, H]: h_{t-1}
         float* __restrict__ h_out,       // [dirs, B, H]: h_t
         float* __restrict__ c,           // [dirs, B, H]: c_{t-1} -> c_t
         int B, int T, int H, int t, float forget_bias) {
  extern __shared__ float smem[];
  float* hs = smem;                // [kRows, H]
  float* red = smem + kRows * H;   // [kWarps, 4, kRows, kUnits]

  const int dir = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.z * kRows;
  const int G = 4 * H;
  const size_t BH = (size_t)B * H;

  const float* x = dir ? xb : xf;
  const float* wh = dir ? whb : whf;
  float* ys = dir ? ysb : ysf;
  float* cs = dir ? csb : csf;
  const float* hp = h_in + dir * BH;
  float* hn = h_out + dir * BH;
  float* cc = c + dir * BH;

  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int r = i / H;
    const int b = b0 + r;
    hs[i] = b < B ? hp[(size_t)b * H + (i - r * H)] : 0.0f;
  }
  __syncthreads();
  gate_products<kUnits>(wh, hs, red, j0, H, false);
  __syncthreads();

  if (threadIdx.x >= kRows * kUnits) return;
  const int r = threadIdx.x / kUnits;
  const int jj = j0 + threadIdx.x % kUnits;
  const int b = b0 + r;
  if (jj >= H || b >= B) return;

  float gs[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[((w * 4 + g) * kRows + r) * kUnits + (jj - j0)];
    gs[g] = s;
  }
  const size_t bt = (size_t)b * T + t;
  const float* xt = x + bt * G;
  const float ig = sigmoid(xt[jj] + gs[0]);
  const float fg = sigmoid(xt[H + jj] + gs[1] + forget_bias);
  const float gg = tanhf(xt[2 * H + jj] + gs[2]);
  const float og = sigmoid(xt[3 * H + jj] + gs[3]);

  const size_t idx = (size_t)b * H + jj;
  const float c_prev = cc[idx];
  const float h_prev = hp[idx];
  const float c_new = fg * c_prev + ig * gg;
  const float h_new = og * tanhf(c_new);
  const float m = mask[bt];
  const bool on = m > 0.0f;
  const float h = on ? h_new : h_prev;
  const float c_out = on ? c_new : c_prev;
  cc[idx] = c_out;
  hn[idx] = h;
  ys[bt * H + jj] = h * m;
  if (cs != nullptr) cs[bt * H + jj] = c_out;
}

template <int kUnits>
__global__ void __launch_bounds__(kThreads)
bwd_step(const float* __restrict__ xf, const float* __restrict__ xb,
         const float* __restrict__ whf, const float* __restrict__ whb,
         const float* __restrict__ mask,
         const float* __restrict__ ysf, const float* __restrict__ ysb,
         const float* __restrict__ csf, const float* __restrict__ csb,
         const float* __restrict__ gysf, const float* __restrict__ gysb,
         float* __restrict__ dxf, float* __restrict__ dxb,
         float* __restrict__ dh,  // [dirs, B, H] carried dh (owned per thread)
         float* __restrict__ dc,  // [dirs, B, H] carried dc (owned per thread)
         int B, int T, int H, int t, float forget_bias) {
  using Tl = Tile<kUnits>;
  static_assert(kWarps * kUnits * kRows <= Tl::kRed, "phase (a) partials fit in red");
  extern __shared__ float smem[];
  float* buf = smem;                 // [kRows, H] staged rows
  float* red = smem + kRows * H;     // partial sums
  float* dhn = red + Tl::kRed;       // [kRows, kUnits] dh from dgates_{t+1}

  const int dir = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = 4 * H;
  const size_t BH = (size_t)B * H;

  const float* x = dir ? xb : xf;
  const float* wh = dir ? whb : whf;
  const float* ys = dir ? ysb : ysf;
  const float* cs = dir ? csb : csf;
  const float* gys = dir ? gysb : gysf;
  float* dx = dir ? dxb : dxf;

  // (a) dhn[r][u] = sum_k dgates_{t+1}[b0 + r, k] * Wh[j0 + u, k]
  if (t + 1 < T) {
    float da[kUnits][kRows];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) da[u][r] = 0.0f;
    for (int g = 0; g < 4; ++g) {
      __syncthreads();  // the previous quarter is consumed
      for (int i = tid; i < kRows * H; i += kThreads) {
        const int r = i / H;
        const int b = b0 + r;
        buf[i] = b < B ? dx[((size_t)b * T + t + 1) * G + g * H + (i - r * H)] : 0.0f;
      }
      __syncthreads();
      for (int k = tid; k < H; k += kThreads) {
        float w[kUnits];
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          const int j = j0 + u;
          w[u] = j < H ? __ldg(wh + (size_t)j * G + g * H + k) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float v = buf[r * H + k];
#pragma unroll
          for (int u = 0; u < kUnits; ++u) da[u][r] = fmaf(v, w[u], da[u][r]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = da[u][r];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        da[u][r] = v;
      }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
#pragma unroll
        for (int r = 0; r < kRows; ++r) red[(warp * kUnits + u) * kRows + r] = da[u][r];
    }
    __syncthreads();
    if (tid < kRows * kUnits) {
      const int r = tid / kUnits;
      const int u = tid % kUnits;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(w * kUnits + u) * kRows + r];
      dhn[r * kUnits + u] = s;
    }
  }
  __syncthreads();  // buf and red are free again

  // (b) gate pre-activations at t: h_{t-1} @ Wh for columns j, H+j, 2H+j, 3H+j
  for (int i = tid; i < kRows * H; i += kThreads) {
    const int r = i / H;
    const int b = b0 + r;
    buf[i] = (t > 0 && b < B) ? ys[((size_t)b * T + t - 1) * H + (i - r * H)] : 0.0f;
  }
  __syncthreads();
  gate_products<kUnits>(wh, buf, red, j0, H, t == 0);
  __syncthreads();

  // (c) gate derivatives, one thread per (row, unit)
  if (tid >= kRows * kUnits) return;
  const int r = tid / kUnits;
  const int uu = tid % kUnits;
  const int jj = j0 + uu;
  const int b = b0 + r;
  if (jj >= H || b >= B) return;

  float gs[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[((w * 4 + g) * kRows + r) * kUnits + uu];
    gs[g] = s;
  }
  const size_t bt = (size_t)b * T + t;
  const float* xt = x + bt * G;
  const float ig = sigmoid(xt[jj] + gs[0]);
  const float fg = sigmoid(xt[H + jj] + gs[1] + forget_bias);
  const float gg = tanhf(xt[2 * H + jj] + gs[2]);
  const float og = sigmoid(xt[3 * H + jj] + gs[3]);

  const bool on = mask[bt] > 0.0f;
  const bool next_on = t + 1 < T && mask[bt + 1] > 0.0f;
  const size_t idx = dir * BH + (size_t)b * H + jj;
  // dh carried from t+1: dgates_{t+1} @ Wh^T after a real step, else the
  // passed-through total (zero before the first real step of the walk)
  const float dh_carry = next_on ? dhn[r * kUnits + uu] : dh[idx];
  const float dh_tot = (on ? gys[bt * H + jj] : 0.0f) + dh_carry;
  const float tc = tanhf(cs[bt * H + jj]);
  const float c_prev = t > 0 ? cs[(bt - 1) * H + jj] : 0.0f;
  const float dc_old = dc[idx];
  const float dc_tot = dc_old + dh_tot * og * (1.0f - tc * tc);
  const float d_o = dh_tot * tc;
  float* dxt = dx + bt * G;
  if (on) {
    dxt[jj] = dc_tot * gg * ig * (1.0f - ig);
    dxt[H + jj] = dc_tot * c_prev * fg * (1.0f - fg);
    dxt[2 * H + jj] = dc_tot * ig * (1.0f - gg * gg);
    dxt[3 * H + jj] = d_o * og * (1.0f - og);
    dc[idx] = dc_tot * fg;
  } else {
    dxt[jj] = 0.0f;
    dxt[H + jj] = 0.0f;
    dxt[2 * H + jj] = 0.0f;
    dxt[3 * H + jj] = 0.0f;
  }
  dh[idx] = dh_tot;
}

// Launch the T forward steps of `dirs` directions (1 or 2) on `stream`.
// hbuf [2, dirs, B, H] and cbuf [dirs, B, H] are zeroed by the caller; the
// second direction's pointers are ignored when dirs == 1. Returns the first
// CUDA error (0 when every launch was accepted). Does not synchronise.
template <int kUnits>
int run_fwd(const float* xf, const float* xb, const float* whf, const float* whb,
            const float* mask, float* ysf, float* ysb, float* csf, float* csb, float* hbuf,
            float* cbuf, int dirs, int B, int T, int H, float forget_bias, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dirs < 1 || dirs > 2) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kRows * H + Tile<kUnits>::kRed) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fwd_step<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, dirs, (B + kRows - 1) / kRows);
  const size_t state = (size_t)dirs * B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const float* h_in = hbuf + (t & 1) * state;
    float* h_out = hbuf + ((t + 1) & 1) * state;
    fwd_step<kUnits><<<grid, kThreads, smem, s>>>(xf, xb, whf, whb, mask, ysf, ysb, csf, csb,
                                                   h_in, h_out, cbuf, B, T, H, t, forget_bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Launch the T reverse steps, t = T-1 down to 0, of `dirs` directions on
// `stream`. dhbuf and dcbuf [dirs, B, H] are zeroed by the caller. Returns
// the first CUDA error. Does not synchronise.
template <int kUnits>
int run_bwd(const float* xf, const float* xb, const float* whf, const float* whb,
            const float* mask, const float* ysf, const float* ysb, const float* csf,
            const float* csb, const float* gysf, const float* gysb, float* dxf, float* dxb,
            float* dhbuf, float* dcbuf, int dirs, int B, int T, int H, float forget_bias,
            void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || dirs < 1 || dirs > 2) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)kRows * H + Tile<kUnits>::kRed + kRows * kUnits) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bwd_step<kUnits>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, dirs, (B + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = T - 1; t >= 0; --t) {
    bwd_step<kUnits><<<grid, kThreads, smem, s>>>(xf, xb, whf, whb, mask, ysf, ysb, csf, csb,
                                                   gysf, gysb, dxf, dxb, dhbuf, dcbuf, B, T, H,
                                                   t, forget_bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace
