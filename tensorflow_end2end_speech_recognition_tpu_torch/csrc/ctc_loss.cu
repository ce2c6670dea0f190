// CTC loss over the blank-interleaved label lattice, for Hopper (sm_90a),
// float32: the fused loss + gradient (training) and the loss alone (eval).
//
// Replaces the TPU kernels
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/ctc_kernel.py
// _ctc_kernel (called by ctc_loss_pallas / _ctc_fwd_impl) and
// _ctc_fwd_only_kernel (ctc_loss_pallas_fwd_only). Per utterance:
// log-softmax over the classes, the alpha recursion over the S = 2U+1
// lattice lanes with the -1e30 floor, loss = -logsumexp of the two end
// lanes; for training also the beta recursion fused with gamma = alpha +
// beta - lpz - logp (written over alpha), then per class
// grad = softmax - sum_{s: z[s] = c} exp(min(gamma, 40)), pad frames zero.
// An impossible alignment (no path) gives a finite loss of about 1e30.
//
// What bounds it. The work is small (at B = 32, T = 400, C = 29, U = 40
// about 3 MB of logits and gradient, a few tens of MFLOP) but the two
// recursions are serial chains of T steps per utterance, each step a
// three-way log-sum-exp per lane that needs the previous step's row. The
// chain's latency (a barrier and a few dependent loads per step), not
// bytes or operations, sets the time; one block per utterance leaves most
// SMs idle at B = 32.
//
// Design. One block per utterance, threads over the lattice lanes (looping
// when S exceeds the block), one __syncthreads per time step. The previous
// alpha / beta row is double-buffered in shared memory (in a global
// workspace when 3 S floats do not fit), so a step reads one buffer and
// writes the other. The TPU kernel's one-hot matmuls (an MXU trick) become
// gathers: lpz[t, s] = lp[t, z[s]] read from the logits and two per-frame
// softmax statistics (max and log-sum, computed first by one warp per
// frame with warp reductions). Alpha rows go to a [T, S] global buffer
// that gamma then overwrites; the beta row lives only in shared memory.
// The gradient pass gives each warp a frame and each lane a class, and
// sums that class's lanes in a fixed order, so the result is
// deterministic (no atomics). Neither C nor S is padded.
//
// The loss-only kernel is the same source with kGrad = false: the alpha
// recursion on the running row, no [T, S] buffer, no gradient.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return fmaxf(out, kNeg);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kGrad>
__global__ void ctc_kernel(const float* __restrict__ logits,  // [B, T, C]
                           const int* __restrict__ labels,    // [B, U], -1 padded
                           const int* __restrict__ logit_len, const int* __restrict__ label_len,
                           float* __restrict__ loss,   // [B]
                           float* __restrict__ grad,   // [B, T, C] (kGrad)
                           float* __restrict__ gamma,  // [B, T, S] (kGrad)
                           float* __restrict__ stats,  // [B, T, 2]: row max, log-sum
                           float* __restrict__ ws,     // [B, 3S] when rows are not in smem
                           int T, int C, int U, int blank, int use_smem) {
  extern __shared__ float smem[];
  __shared__ float s_logp;
  const int b = blockIdx.x;
  const int S = 2 * U + 1;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  const int tl = min(max(logit_len[b], 0), T);
  const int ul = min(max(label_len[b], 0), U);
  const int t_last = max(tl - 1, 0);
  const int t_stat = max(tl, 1);  // frame 0 seeds alpha even when tl == 0

  float* base = use_smem ? smem : ws + (size_t)b * 3 * S;
  float* rows = base;                      // [2, S] running alpha / beta rows
  int* z = reinterpret_cast<int*>(base + 2 * S);  // [S] lattice labels
  const float* x = logits + (size_t)b * T * C;
  float* st = stats + (size_t)b * T * 2;
  const int* lab = labels + (size_t)b * U;
  float* gm = kGrad ? gamma + (size_t)b * T * S : nullptr;

  for (int s = tid; s < S; s += nthr) {
    int v = blank;
    if (s & 1) {
      const int l = lab[s >> 1];
      v = l >= 0 ? l : blank;
    }
    z[s] = v;
  }
  // per-frame log-softmax statistics, one warp per frame
  for (int t = warp; t < t_stat; t += nwarps) {
    const float* xt = x + (size_t)t * C;
    float m = -3.402823466e38f;  // -FLT_MAX
    for (int c = lane; c < C; c += 32) m = fmaxf(m, xt[c]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += expf(xt[c] - m);
    sum = warp_sum(sum);
    if (lane == 0) {
      st[2 * t] = m;
      st[2 * t + 1] = logf(sum);
    }
  }
  __syncthreads();

  // lp[t, c] = (x - max) - logsum, as the TPU kernel's log-softmax
  auto lpz = [&](int t, int s) {
    return (x[(size_t)t * C + z[s]] - st[2 * t]) - st[2 * t + 1];
  };
  // additive skip mask for the s-2 -> s transition
  auto skip_add = [&](int s) {
    return ((s & 1) && s < 2 * ul && (s < 2 || z[s] != z[s - 2])) ? 0.0f : kNeg;
  };

  // ---- alpha
  for (int s = tid; s < S; s += nthr) {
    const float v = (s == 0 || (s == 1 && ul > 0)) ? lpz(0, s) : kNeg;
    rows[s] = v;
    if (kGrad) gm[s] = v;
  }
  __syncthreads();
  for (int t = 1; t < tl; ++t) {
    const float* prev = rows + ((t - 1) & 1) * S;
    float* cur = rows + (t & 1) * S;
    for (int s = tid; s < S; s += nthr) {
      const float stay = prev[s];
      const float diag = s >= 1 ? prev[s - 1] : kNeg;
      const float skip = s >= 2 ? prev[s - 2] + skip_add(s) : kNeg;
      const float v = fmaxf(lse3(stay, diag, skip) + lpz(t, s), kNeg);
      cur[s] = v;
      if (kGrad) gm[(size_t)t * S + s] = v;
    }
    __syncthreads();
  }

  // ---- loss: -logsumexp(alpha[t_last, 2U], alpha[t_last, 2U-1])
  if (tid == 0) {
    const float* last = rows + (t_last & 1) * S;
    const float e1 = last[2 * ul];
    const float e2 = ul > 0 ? last[2 * ul - 1] : kNeg;
    const float m = fmaxf(e1, e2);
    const float logp = m + logf(expf(e1 - m) + expf(e2 - m));
    loss[b] = -logp;
    s_logp = logp;
  }
  if (!kGrad) return;
  __syncthreads();
  const float logp = s_logp;

  // ---- beta fused with gamma, walking the real frames down
  {
    float* row0 = rows;
    for (int s = tid; s < S; s += nthr) {
      const bool end = s == 2 * ul || (ul > 0 && s == 2 * ul - 1);
      row0[s] = end ? lpz(t_last, s) : kNeg;
    }
  }
  __syncthreads();
  int p = 0;
  for (int t = tl - 1; t >= 0; --t) {
    const float* bc = rows + p * S;
    float* bn = rows + (1 - p) * S;
    for (int s = tid; s < S; s += nthr) {
      const float beta = bc[s];
      float* g = gm + (size_t)t * S + s;
      *g = fmaxf(*g + beta - lpz(t, s) - logp, kNeg);
      if (t > 0) {
        const float diag = s + 1 < S ? bc[s + 1] : kNeg;
        const float skip = s + 2 < S ? bc[s + 2] + skip_add(s + 2) : kNeg;
        bn[s] = fmaxf(lse3(beta, diag, skip) + lpz(t - 1, s), kNeg);
      }
    }
    __syncthreads();
    p = 1 - p;
  }

  // ---- grad[t, c] = softmax - sum over the class's lanes; pad frames 0
  float* gr = grad + (size_t)b * T * C;
  for (int t = warp; t < T; t += nwarps) {
    float* gt = gr + (size_t)t * C;
    if (t >= tl) {
      for (int c = lane; c < C; c += 32) gt[c] = 0.0f;
      continue;
    }
    const float* xt = x + (size_t)t * C;
    const float m = st[2 * t], ls = st[2 * t + 1];
    const float* gmt = gm + (size_t)t * S;
    for (int c = lane; c < C; c += 32) {
      float acc = 0.0f;
      for (int s = 0; s < S; ++s)
        if (z[s] == c) acc += expf(fminf(gmt[s], 40.0f));
      gt[c] = expf((xt[c] - m) - ls) - acc;
    }
  }
}

int launch_config(int S, size_t* smem, int* use_smem, int* threads) {
  int th = ((S + 31) / 32) * 32;
  th = th < 256 ? 256 : (th > 1024 ? 1024 : th);
  *threads = th;
  const size_t bytes = (size_t)3 * S * sizeof(float);
  *use_smem = bytes <= (size_t)kMaxSmem - 1024;
  *smem = *use_smem ? bytes : 0;
  return 0;
}

template <bool kGrad>
int run(const float* logits, const int* labels, const int* logit_len, const int* label_len,
        float* loss, float* grad, float* gamma, float* stats, float* ws, int B, int T, int C,
        int U, int blank, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || U < 0 || blank < 0 || blank >= C)
    return (int)cudaErrorInvalidValue;
  const int S = 2 * U + 1;
  size_t smem;
  int use_smem, threads;
  launch_config(S, &smem, &use_smem, &threads);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ctc_kernel<kGrad>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ctc_kernel<kGrad><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      logits, labels, logit_len, label_len, loss, grad, gamma, stats, ws, T, C, U, blank,
      use_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers of contiguous tensors: logits [B, T, C] float32; labels
// [B, U] int32 (-1 padded); logit_len, label_len [B] int32; loss [B];
// stats [B, T, 2] and ws [B, 3(2U+1)] float32 scratch. One launch on
// `stream`; returns the CUDA error of the launch (0 when accepted).

// Training: also grad [B, T, C] (written in full) and gamma [B, T, 2U+1]
// float32 scratch.
int ctc_loss_fwd_bwd(const float* logits, const int* labels, const int* logit_len,
                     const int* label_len, float* loss, float* grad, float* gamma,
                     float* stats, float* ws, int B, int T, int C, int U, int blank,
                     void* stream) {
  return run<true>(logits, labels, logit_len, label_len, loss, grad, gamma, stats, ws, B, T, C,
                   U, blank, stream);
}

// Eval: the loss alone.
int ctc_loss_fwd_only(const float* logits, const int* labels, const int* logit_len,
                      const int* label_len, float* loss, float* stats, float* ws, int B, int T,
                      int C, int U, int blank, void* stream) {
  return run<false>(logits, labels, logit_len, label_len, loss, nullptr, nullptr, stats, ws, B,
                    T, C, U, blank, stream);
}

}  // extern "C"
