// Bidirectional LSTM layer forward over hoisted input projections, for
// Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _bidi_fwd_kernel (called by lstm_bidi_pallas): both directions of one
// BLSTM layer advance in one time walk; gates i,f,g,o with forget_bias
// added to f; a masked (pad) step carries h and c through and emits 0.
// The backward direction's xproj arrives already reversed over each row's
// valid prefix, so both directions walk t = 0..T-1 under one mask.
//
// What bounds it. The recurrence is a serial chain of T steps, and each step
// needs all of Wh [H, 4H] for both directions: 8 MB at H = 512. The TPU
// kernel keeps Wh resident in VMEM; an SM has 227 KB of shared memory, so
// here Wh stays in device memory and is re-read through the 50 MB L2 at
// every step. One launch advances one step, so a layer is T launches
// (about 5 x T per utterance batch for a 5-layer encoder), and the step
// time is launch latency plus one L2 pass over Wh.
//
// Design. Grid (H / kUnits, 2 directions, ceil(B / kRows)). A block owns
// kUnits hidden units of one direction for kRows batch rows: it stages
// h_{t-1} for its rows in shared memory, computes the four dot products
// against Wh columns j, H+j, 2H+j, 3H+j for each owned unit itself (lanes
// split the H-long reduction four ways inside a warp and eight ways across
// warps), sums the partials, adds xproj[t] and runs the gate math, the mask
// carry and the writes of h, c and ys[t] = h * m. h ping-pongs between two
// global buffers so no block reads a row another block writes in the same
// step; c is read and written only by the thread that owns it. There is no
// cross-block reduction and no grid barrier: the launches on one stream are
// the step barrier.
//
// Training also needs the cell-state stream cs[b, t] = c_t (the carried
// value on a masked step, as the TPU kernel's cs_ref[k] = c), which the
// backward kernel (lstm_bidi_bwd.cu) reads. The caller passes cs pointers
// only when it needs them; serving passes null and the kernel skips the
// store.

#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 8;              // hidden units per block
constexpr int kKSub = 32 / kUnits;     // lanes that split k within a warp
constexpr int kWarps = 8;              // warps that split k within a block
constexpr int kRows = 8;               // batch rows per block
constexpr int kThreads = 32 * kWarps;  // 256
constexpr int kKStride = kKSub * kWarps;
constexpr int kRed = kWarps * 4 * kRows * kUnits;  // partial sums, floats

static_assert(kRows * kUnits <= kThreads, "one epilogue thread per (row, unit)");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
lstm_bidi_step(const float* __restrict__ xf, const float* __restrict__ xb,
               const float* __restrict__ whf, const float* __restrict__ whb,
               const float* __restrict__ mask,
               float* __restrict__ ysf, float* __restrict__ ysb,
               float* __restrict__ csf, float* __restrict__ csb,  // null: skip
               const float* __restrict__ h_in,  // [2, B, H]: h_{t-1}
               float* __restrict__ h_out,       // [2, B, H]: h_t
               float* __restrict__ c,           // [2, B, H]: c_{t-1} -> c_t
               int B, int T, int H, int t, float forget_bias) {
  extern __shared__ float smem[];
  float* hs = smem;                // [kRows, H]
  float* red = smem + kRows * H;   // [kWarps, 4, kRows, kUnits]

  const int dir = blockIdx.y;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.z * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u = lane % kUnits;
  const int ks = lane / kUnits;
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

  const int j = j0 + u;
  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;

  if (j < H) {
#pragma unroll 4
    for (int k = warp * kKSub + ks; k < H; k += kKStride) {
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

  // reduce over the kKSub lanes that share a unit, then across warps
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

}  // namespace

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// xf, xb [B, T, 4H]; whf, whb [H, 4H]; mask [B, T]; ysf, ysb [B, T, H]
// (written in full); csf, csb [B, T, H] written in full, or both null to
// skip the cell-state stream (serving); hbuf [2, 2, B, H] and cbuf [2, B, H], zeroed by the
// caller. Launches T kernels on `stream` and returns the first CUDA error
// (0 when every launch was accepted). Does not synchronise.
int lstm_bidi_fwd(const float* xf, const float* xb, const float* whf, const float* whb,
                  const float* mask, float* ysf, float* ysb, float* csf, float* csb,
                  float* hbuf, float* cbuf,
                  int B, int T, int H, float forget_bias, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if ((csf == nullptr) != (csb == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)kRows * H + kRed) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bidi_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, 2, (B + kRows - 1) / kRows);
  const size_t state = (size_t)2 * B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const float* h_in = hbuf + (t & 1) * state;
    float* h_out = hbuf + ((t + 1) & 1) * state;
    lstm_bidi_step<<<grid, kThreads, smem, s>>>(xf, xb, whf, whb, mask, ysf, ysb, csf, csb,
                                                 h_in, h_out, cbuf, B, T, H, t, forget_bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

const char* asr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
