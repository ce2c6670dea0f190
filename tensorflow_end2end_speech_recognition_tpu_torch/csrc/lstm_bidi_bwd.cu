// Bidirectional LSTM layer backward over hoisted input projections, for
// Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _bidi_bwd_kernel (the VJP of lstm_bidi_pallas): a reverse walk over time
// for both directions that recomputes the gates at t from xproj[t] and
// h_{t-1} @ Wh (h_{t-1} = ys[t-1], the mask being a monotone length mask),
// carries dh and dc, and emits dxproj[t] = dgates_t. A masked step emits
// zero and carries dh and dc through. dWh, dWx and db are single large
// contractions over [T*B] done outside (ops/lstm.py), as on the TPU.
//
// What bounds it. Like the forward, a serial chain of T steps, each of
// which needs all of Wh [H, 4H] twice per direction: its columns for the
// gates (h_{t-1} @ Wh) and its rows for dh_{t-1} = dgates_t @ Wh^T. At
// H = 512 that is 8 MB per direction, far above the 227 KB of shared
// memory of a block, so Wh is re-read through the 50 MB L2 at every step,
// and each step also needs the previous step's dgates rows from every
// block. The step time is launch latency plus those L2 passes.
//
// Design. One launch per step t = T-1 .. 0; grid (H / kUnits, 2
// directions, ceil(B / kRows)). A block owns kUnits hidden units j of one
// direction for kRows batch rows:
//  (a) dh from the step above: it stages the dgates_{t+1} rows of its
//      batch rows (dxproj[t+1], written by the previous launch) one gate
//      quarter [kRows, H] at a time in shared memory, and reduces them
//      against the contiguous rows Wh[j, :] of its own units (lanes walk
//      consecutive k, so every Wh read is coalesced). That gives dh_{t}
//      for exactly its units: no cross-block reduction is needed.
//  (b) the gates at t: it stages h_{t-1} rows and reduces them against
//      the columns j, H+j, 2H+j, 3H+j of Wh, as the forward kernel does.
//  (c) one thread per (row, unit) runs the gate derivatives, writes the
//      four dxproj[t] entries of its unit, and keeps its own dh and dc
//      carries in global buffers that no other thread touches.
// The launches on one stream are the step barrier. Shared memory is
// (kRows * H + kRed + 64) floats: about 25 KB at H = 512. No activation
// is saved by the forward beyond ys and cs (2 x [B, T, H] per direction);
// recomputing the gates costs one more h @ Wh per step instead of storing
// 4H gate values per (b, t), which would be 2 x 105 MB at B = 32, T = 400.

#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 8;              // hidden units per block
constexpr int kKSub = 32 / kUnits;     // lanes that split k within a warp (phase b)
constexpr int kWarps = 8;              // warps per block
constexpr int kRows = 8;               // batch rows per block
constexpr int kThreads = 32 * kWarps;  // 256
constexpr int kKStride = kKSub * kWarps;
constexpr int kRed = kWarps * 4 * kRows * kUnits;  // partial sums, floats

static_assert(kRows * kUnits <= kThreads, "one epilogue thread per (row, unit)");
static_assert(kWarps * kUnits * kRows <= kRed, "phase (a) partials fit in red");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
lstm_bidi_bwd_step(const float* __restrict__ xf, const float* __restrict__ xb,
                   const float* __restrict__ whf, const float* __restrict__ whb,
                   const float* __restrict__ mask,
                   const float* __restrict__ ysf, const float* __restrict__ ysb,
                   const float* __restrict__ csf, const float* __restrict__ csb,
                   const float* __restrict__ gysf, const float* __restrict__ gysb,
                   float* __restrict__ dxf, float* __restrict__ dxb,
                   float* __restrict__ dh,  // [2, B, H] carried dh (owned per thread)
                   float* __restrict__ dc,  // [2, B, H] carried dc (owned per thread)
                   int B, int T, int H, int t, float forget_bias) {
  extern __shared__ float smem[];
  float* buf = smem;                // [kRows, H] staged rows
  float* red = smem + kRows * H;    // partial sums
  float* dhn = red + kRed;          // [kRows, kUnits] dh from dgates_{t+1}

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

  const int u = lane % kUnits;
  const int ks = lane / kUnits;
  const int j = j0 + u;
  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;
  if (j < H && t > 0) {
#pragma unroll 4
    for (int k = warp * kKSub + ks; k < H; k += kKStride) {
      const float* w = wh + (size_t)k * G + j;
      const float w0 = __ldg(w), w1 = __ldg(w + H), w2 = __ldg(w + 2 * H), w3 = __ldg(w + 3 * H);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = buf[r * H + k];
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

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// xf, xb [B, T, 4H] (the forward's inputs); whf, whb [H, 4H]; mask [B, T]
// (monotone per row); ysf, ysb, csf, csb [B, T, H] (the forward's outputs);
// gysf, gysb [B, T, H] (cotangents of ys); dxf, dxb [B, T, 4H] (written in
// full); dhbuf, dcbuf [2, B, H], zeroed by the caller. Launches T kernels on
// `stream`, t = T-1 down to 0, and returns the first CUDA error (0 when
// every launch was accepted). Does not synchronise.
int lstm_bidi_bwd(const float* xf, const float* xb, const float* whf, const float* whb,
                  const float* mask, const float* ysf, const float* ysb, const float* csf,
                  const float* csb, const float* gysf, const float* gysb, float* dxf, float* dxb,
                  float* dhbuf, float* dcbuf, int B, int T, int H, float forget_bias,
                  void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kRows * H + kRed + kRows * kUnits) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bidi_bwd_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, 2, (B + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = T - 1; t >= 0; --t) {
    lstm_bidi_bwd_step<<<grid, kThreads, smem, s>>>(xf, xb, whf, whb, mask, ysf, ysb, csf, csb,
                                                     gysf, gysb, dxf, dxb, dhbuf, dcbuf, B, T, H,
                                                     t, forget_bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
