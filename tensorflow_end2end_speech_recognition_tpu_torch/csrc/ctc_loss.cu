// CTC loss over the blank-interleaved label lattice, for Hopper (sm_90a),
// float32: the fused loss + gradient (training) and the loss alone (eval).
//
// Replaces the TPU kernels
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/ctc_kernel.py
// _ctc_kernel (called by ctc_loss_pallas / _ctc_fwd_impl) and
// _ctc_fwd_only_kernel (ctc_loss_pallas_fwd_only). Per utterance:
// log-softmax over the classes, the alpha recursion over the S = 2U+1
// lattice lanes with the -1e30 floor, loss = -logsumexp of the two end
// lanes; for training also the beta recursion, gamma = ((alpha + beta) -
// lpz) - logp, and per class grad = softmax - sum_{s: z[s] = c}
// exp(min(gamma, 40)), pad frames zero. An impossible alignment (no path)
// gives a finite loss of about 1e30.
//
// What bounds it. The bytes (at B = 32, T = 400, C = 29, U = 40 about 3 MB
// of logits and gradient) and operations (tens of MFLOP) take under a
// microsecond on this card. The time is the latency of the two recursions:
// serial chains of T steps, each a three-way log-sum-exp per lane that
// needs the previous step's row, walked by one warp or a few on an
// otherwise idle SM. A step costs what its warps execute and wait on: the
// accurate expf / logf of their K lanes (one dependent lse3 takes 191
// cycles on the card, three interleaved 271: probes/ctc_chain_step.py),
// the exchange with the neighbouring lanes, and any memory access on the
// way. The first design (one block per utterance, threads over lanes) paid
// a block barrier and a dependent gather of lpz from L2 on every step,
// walked alpha and then beta (2T steps), and summed the gradient with a
// C x S test per frame.
//
// Design. Three launches in order on the caller's stream (programmatic
// dependent launches were tried: their blocks, started early and waiting
// on griddepcontrol.wait, slowed the chains):
// 1. ctc_frames, a wide pass: one warp per valid frame computes the
//    log-softmax statistics (max, log-sum of exp(x - max)) and writes the
//    frame's lpz row, lpz[b, t, s] = (x[z[s]] - max) - log-sum, at a row
//    stride Sp = S rounded up to 4 floats; for training, one more block per
//    utterance makes its class lane lists: lanes[b, offs[b, c] .. offs[b,
//    c + 1]) hold the lattice lanes s with z[s] = c, in ascending s.
// 2. ctc_chains: one block per utterance and chain (alpha; for training
//    also beta, in a block of its own, so the two walk at the same time:
//    beta's seed needs nothing of alpha). A thread holds K consecutive
//    lattice lanes in registers and takes s-1, s-2 (s+1, s+2 for beta) of
//    its neighbours with warp shuffles: a step has no barrier when one warp
//    holds the row (S <= 64). A wider row is split over up to 16 warps that
//    pass their two edge lanes through shared memory behind a named barrier
//    over the chain warps (bar.sync 1). A step costs about K interleaved
//    lse3 chains, so K stays 2 up to S = 1024 and more warps share the row
//    (S = 361: #6's chain takes 0.297 us a step on 6 warps of 2 lanes,
//    0.305 on 4 of 3, 0.370 on 3 of 4: probes/ctc_chain_step.py); past 4096
//    lanes the running rows live in global memory, threads looping over
//    lanes. A thread computes its K lanes' lse3 stage by stage across the
//    lanes, so that the compiler interleaves them (it had walked one lane's
//    logf before the next lane's expf). The steps go in chunks of D (up to
//    32): thread 0 brings a chunk's D lpz rows into a shared ring with one
//    bulk copy (cp.async.bulk, completion on an mbarrier) two chunks ahead
//    and, for training, writes the chunk's new rows from a shared stage of
//    two slots to the [2, B, T, Sp] row scratch with one bulk store, issued
//    after the chunk's last barrier once the store before it has read its
//    slot; no lane of a step touches global memory. (Gathering lpz from L2
//    each step, in registers or with cp.async, or one bulk copy and
//    mbarrier wait per step, cost the chain more than its arithmetic.)
//    The alpha block writes the loss from its end lanes at t_last.
// 3. ctc_grad (training), a wide pass over tiles of up to 32 frames of an
//    utterance: the block forms exp(min(gamma, 40)) of every (frame, lane)
//    in shared memory, then a thread per (frame, class) sums the class's
//    own lanes from the list in ascending s (deterministic: no atomics,
//    equal bits on every call) and writes softmax minus that sum: O(S) per
//    frame, not O(C S). Pad frames are zero. It reads the alpha, beta and
//    lpz rows once: at U = 180 that is 56 MB, more than L2 holds.
// The layout (K, chain warps, chunk, frames per gradient block, shared
// memory, grids) is chosen in Python by ops/ctc.ctc_plan and passed in; run
// refuses a plan that differs from its own reckoning. Every step keeps the
// reference's arithmetic in its order; expf / logf are the accurate ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;
constexpr int kStaticSmem = 1024;   // a chain block's barriers and edge lanes, at most
constexpr int kFrameWarps = 8;      // frames per block of the frame pass
constexpr int kMaxChainWarps = 16;  // widest chain block (and the global route's)
constexpr int kRingChunks = 3;      // chunks of lpz rows in a chain's ring
constexpr int kStageChunks = 2;     // chunks of new rows of a chain on their way out
constexpr int kMaxChunk = 64;       // chain steps of a chunk, at most
constexpr int kMaxGradFrames = 32;  // frames per block of the gradient pass (a thread each)
constexpr int kGradThreads = 256;   // threads of a gradient block

__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, kNeg);
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return fmaxf(out, kNeg);
}

// K lanes' fmaxf(lse3(a, b, c) + lz, kNeg), stage by stage across the
// lanes (the maxima of all lanes, then their exps, sums, logs), so that the
// compiler interleaves the K independent chains instead of walking one
// lane's logf before the next lane's expf. Each lane's arithmetic is
// lse3's, in its order.
template <int K>
__device__ __forceinline__ void lse3_lanes(float (&out)[K], const float (&a)[K],
                                           const float (&b)[K], const float (&c)[K],
                                           const float (&lz)[K]) {
  float ms[K], sum[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ms[k] = fmaxf(fmaxf(fmaxf(a[k], b[k]), c[k]), kNeg);
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = expf(a[k] - ms[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] += expf(b[k] - ms[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] += expf(c[k] - ms[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) sum[k] = logf(sum[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = fmaxf(fmaxf(ms[k] + sum[k], kNeg) + lz[k], kNeg);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// barrier 1 over the block's first n threads (the chain warps)
__device__ __forceinline__ void chain_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one bulk store of `bytes` from shared to global memory, in a group of its own
__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// none of this thread's bulk stores still reads shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's shared-memory writes are visible to its block's bulk copies
__device__ __forceinline__ void fence_to_bulk() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// z[s]: blank on even lanes and on padded (-1) labels
__device__ __forceinline__ int lattice_label(const int* lab, int s, int blank) {
  if (!(s & 1)) return blank;
  const int l = __ldg(lab + (s >> 1));
  return l >= 0 ? l : blank;
}

// the s-2 -> s transition is allowed iff lane s holds a real label that
// differs from lane s-2's
__device__ __forceinline__ bool skip_allowed(const int* lab, int s, int ul, int blank) {
  return (s & 1) && s < 2 * ul &&
         (s < 2 || lattice_label(lab, s, blank) != lattice_label(lab, s - 2, blank));
}

// ---- 1. frame statistics, lpz rows and the class lane lists

__global__ void __launch_bounds__(kFrameWarps * 32)
    ctc_frames(const float* __restrict__ logits, const int* __restrict__ labels,
               const int* __restrict__ logit_len, float* __restrict__ stats,
               float* __restrict__ lpz, int* __restrict__ lanes, int* __restrict__ offs, int B,
               int T, int C, int U, int Sp, int blank, int frame_blocks) {
  extern __shared__ int cursor[];  // [C], list blocks
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = 2 * U + 1;
  if ((int)blockIdx.x < frame_blocks) {
    const long long f = (long long)blockIdx.x * kFrameWarps + warp;
    if (f >= (long long)B * T) return;
    const int b = (int)(f / T), t = (int)(f % T);
    const int tl = min(max(logit_len[b], 0), T);
    if (t >= max(tl, 1)) return;  // frame 0 seeds alpha even when tl == 0
    const float* xt = logits + f * C;
    float m = -3.402823466e38f;  // -FLT_MAX
    for (int c = lane; c < C; c += 32) m = fmaxf(m, __ldg(xt + c));
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += expf(__ldg(xt + c) - m);
    const float ls = logf(warp_sum(sum));
    if (lane == 0) {
      stats[2 * f] = m;
      stats[2 * f + 1] = ls;
    }
    // lp = (x - max) - log-sum, as the reference's log-softmax; 4 lanes per
    // thread and one 16-byte store (Sp is a multiple of 4); with C <= 32 the
    // warp's registers hold the frame's logits, x[z] comes by shuffle
    const int* lab = labels + (size_t)b * U;
    const float xl = lane < C ? __ldg(xt + lane) : 0.0f;
    float* row = lpz + f * Sp;
    for (int base = 0; base < Sp; base += 128) {
      const int s0 = base + 4 * lane;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + q;
        const int z = s < S ? lattice_label(lab, s, blank) : 0;
        const float xz = C <= 32 ? __shfl_sync(kFull, xl, z) : (s < S ? __ldg(xt + z) : 0.0f);
        v[q] = s < S ? (xz - m) - ls : kNeg;
      }
      if (s0 < Sp) *reinterpret_cast<float4*>(row + s0) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
  // one warp makes utterance b's lists: a stable counting sort of the lanes
  // by class (match_any groups the lanes of one chunk that share a class)
  if (warp != 0) return;
  const int b = blockIdx.x - frame_blocks;
  const int* lab = labels + (size_t)b * U;
  int* off = offs + (size_t)b * (C + 1);
  int* ln = lanes + (size_t)b * S;
  const unsigned below = (1u << lane) - 1u;
  for (int c = lane; c < C; c += 32) cursor[c] = 0;
  __syncwarp();
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const int z = s < S ? lattice_label(lab, s, blank) : -1;
    const unsigned peers = __match_any_sync(kFull, z);
    if (s < S && (peers & below) == 0) cursor[z] += __popc(peers);
    __syncwarp();
  }
  int carry = 0;  // exclusive prefix over the classes
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const int n = c < C ? cursor[c] : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (c < C) off[c] = cursor[c] = carry + incl - n;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) off[C] = carry;
  __syncwarp();
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const int z = s < S ? lattice_label(lab, s, blank) : -1;
    const unsigned peers = __match_any_sync(kFull, z);
    if (s < S) ln[cursor[z] + __popc(peers & below)] = s;
    __syncwarp();
    if (s < S && (peers & below) == 0) cursor[z] += __popc(peers);
    __syncwarp();
  }
}

// ---- 2. the chains

// Frame of chain step i (i = 0 is the seed): alpha walks 0 .. t_last, beta
// t_last .. 0. Steps past the end are clamped (their copies are unused).
template <bool kBeta>
__device__ __forceinline__ int frame_of(int i, int t_last) {
  return kBeta ? max(t_last - i, 0) : min(i, t_last);
}

// K consecutive floats of shared memory at p (16-byte aligned when K % 4
// == 0, 8-byte when K % 2 == 0)
template <int K>
__device__ __forceinline__ void load_lanes(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + k);
      v[k] = q.x, v[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = p[k];
  }
}

template <int K>
__device__ __forceinline__ void store_lanes(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int k = 0; k < K; k += 2) *reinterpret_cast<float2*>(p + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] = v[k];
  }
}

// One chain with its row in registers: thread tid holds lanes tid*K ..
// tid*K + K-1. lp and lab are this utterance's lpz rows [T, Sp] and labels;
// rows (training) its [T, Sp] rows of this chain; loss_b (alpha) its loss.
// The steps go in chunks of D: chunk c holds steps c*D + 1 .. c*D + D, whose
// frames are the rows lo .. lo + D - 1 of one bulk copy (alpha ascending,
// beta descending, so a beta step reads its chunk from the far end).
template <int K, bool kBeta, bool kRows>
__device__ __forceinline__ void walk_regs(const float* __restrict__ lp,
                                          const int* __restrict__ lab, float* __restrict__ rows,
                                          float* __restrict__ loss_b, int T, int S, int Sp,
                                          int tl, int ul, int blank, int warps, int D) {
  __shared__ float edge[2][kMaxChainWarps][2];  // each warp's two edge lanes, by step parity
  __shared__ float ends[2];                      // alpha at t_last, lanes 2ul and 2ul-1
  __shared__ uint64_t full[kRingChunks];         // a ring chunk's bulk copy has landed
  // the ring [kRingChunks][D][Sp] of lpz rows, then (training) the stage
  // [kStageChunks][D][Sp] of new rows, each with W floats of slack for the
  // lanes of the last threads past Sp
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nthr = warps * 32, W = nthr * K;
  const bool multi = warps > 1;
  const int s0 = tid * K;
  const int t_last = max(tl - 1, 0);
  const int steps = tl - 1;  // after the seed
  const int chunk = D * Sp;  // floats of a chunk
  float* ring = smem;
  float* stage = smem + kRingChunks * chunk + W;
  // the first frame of chunk c's rows and how many there are
  auto chunk_rows = [&](int c, int& lo) {
    if (!kBeta) {
      lo = 1 + c * D;
      return max(min(D, T - lo), 0);
    }
    const int hi = t_last - c * D - 1;
    lo = max(hi - D + 1, 0);
    return max(hi - lo + 1, 0);
  };
  auto copy_in = [&](int c) {  // thread 0
    int lo;
    const int n = chunk_rows(c, lo);
    uint64_t* bar = &full[c % kRingChunks];
    if (n > 0) {
      bulk_load(ring + (c % kRingChunks) * chunk, lp + (size_t)lo * Sp, n * Sp * sizeof(float),
                bar);
    } else {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 0;\n" ::"r"(
                       smem_addr(bar))
                   : "memory");
    }
  };

  // whether each lane's skip transition is allowed (alpha: s-2 -> s; beta:
  // s -> s+2, lane s+2's)
  unsigned skip_ok = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int sk = s0 + k + (kBeta ? 2 : 0);
    if (sk < S && skip_allowed(lab, sk, ul, blank)) skip_ok |= 1u << k;
  }
  if (tid == 0) {
    for (int r = 0; r < kRingChunks; ++r) mbar_init(&full[r]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < kRingChunks - 1; ++c) copy_in(c);
  }

  float a[K];
  {
    const int f = kBeta ? t_last : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k;
      const bool seed = kBeta ? (s == 2 * ul || (ul > 0 && s == 2 * ul - 1))
                              : (s == 0 || (s == 1 && ul > 0));
      a[k] = seed ? lp[(size_t)f * Sp + s] : kNeg;
      if (kRows && s < S) rows[(size_t)f * Sp + s] = a[k];
    }
  }
  if (multi) {
    if (!kBeta && lane == 31) {
      edge[0][warp][0] = a[K - 1];
      edge[0][warp][1] = a[K >= 2 ? K - 2 : 0];
    }
    if (kBeta && lane == 0) {
      edge[0][warp][0] = a[0];
      edge[0][warp][1] = a[K >= 2 ? 1 : 0];
    }
    chain_sync(nthr);  // also publishes the barriers' init
  } else {
    __syncwarp();
  }

  const int chunks = steps > 0 ? (steps + D - 1) / D : 0;
  for (int c = 0; c < chunks; ++c) {
    mbar_wait(&full[c % kRingChunks], (c / kRingChunks) & 1);
    int lo;
    const int n = min(D, steps - c * D);
    chunk_rows(c, lo);
    const float* in = ring + (c % kRingChunks) * chunk;
    float* out = stage + (c % kStageChunks) * chunk;
    for (int d = 0; d < n; ++d) {
      const int i = c * D + d + 1;
      const int f = frame_of<kBeta>(i, t_last);
      float lz[K];
      load_lanes<K>(lz, in + (f - lo) * Sp + s0);
      const int rb = (i - 1) & 1;
      float n1, n2;  // alpha: s-1, s-2 of lanes 0, 1; beta: s+1, s+2 of lanes K-1, K-2
      if (!kBeta) {
        n1 = __shfl_up_sync(kFull, a[K - 1], 1);
        n2 = K >= 2 ? __shfl_up_sync(kFull, a[K >= 2 ? K - 2 : 0], 1)
                    : __shfl_up_sync(kFull, a[0], 2);
        if (multi && lane == 0 && warp > 0) {
          n1 = edge[rb][warp - 1][0];
          n2 = edge[rb][warp - 1][1];
        }
      } else {
        n1 = __shfl_down_sync(kFull, a[0], 1);
        n2 = K >= 2 ? __shfl_down_sync(kFull, a[K >= 2 ? 1 : 0], 1)
                    : __shfl_down_sync(kFull, a[0], 2);
        if (multi && lane == 31 && warp < warps - 1) {
          n1 = edge[rb][warp + 1][0];
          n2 = edge[rb][warp + 1][1];
        }
      }
      // every thread has used chunk c-1 (the shuffles above wait for the
      // warp, the barrier of the step before for the block): refill its
      // slot with chunk c + kRingChunks - 1
      if (d == 0 && tid == 0) copy_in(c + kRingChunks - 1);
      float diag[K], skip[K];  // of step i-1, as lse3's second and third arguments
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int s = s0 + k;
        if (!kBeta) {
          diag[k] = k >= 1 ? a[k >= 1 ? k - 1 : 0] : (s >= 1 ? n1 : kNeg);
          const float p2 = k >= 2 ? a[k >= 2 ? k - 2 : 0] : (k == 1 ? n1 : n2);
          skip[k] = s >= 2 ? p2 + ((skip_ok >> k) & 1u ? 0.0f : kNeg) : kNeg;
        } else {
          diag[k] = s + 1 < S ? (k + 1 < K ? a[k + 1 < K ? k + 1 : 0] : n1) : kNeg;
          const float q2 = k + 2 < K ? a[k + 2 < K ? k + 2 : 0] : (k + 2 == K ? n1 : n2);
          skip[k] = s + 2 < S ? q2 + ((skip_ok >> k) & 1u ? 0.0f : kNeg) : kNeg;
        }
      }
      lse3_lanes<K>(a, a, diag, skip, lz);
      if (kRows) {  // the stage row of frame f, lanes below Sp only
        float* o = out + (f - lo) * Sp + s0;
        if (s0 + K <= Sp) {
          store_lanes<K>(o, a);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (s0 + k < Sp) o[k] = a[k];
        }
      }
      if (multi) {
        const int wb = i & 1;
        if (!kBeta && lane == 31) {
          edge[wb][warp][0] = a[K - 1];
          edge[wb][warp][1] = a[K >= 2 ? K - 2 : 0];
        }
        if (kBeta && lane == 0) {
          edge[wb][warp][0] = a[0];
          edge[wb][warp][1] = a[K >= 2 ? 1 : 0];
        }
        chain_sync(nthr);
      }
    }
    if (kRows) {
      // the chunk's n new rows (frames lo .. lo + n - 1, in order in the
      // stage: a beta chunk's last rows run down to frame 0) go out in one
      // bulk store, issued after the barrier. Before it, thread 0 waits
      // until the store of chunk c-1 has read its stage slot, the one that
      // chunk c+1 fills: no thread of any warp passes the barrier, and so
      // none writes that slot, before the slot is free.
      fence_to_bulk();
      if (tid == 0) bulk_wait_read();
      if (multi)
        chain_sync(nthr);
      else
        __syncwarp();
      if (tid == 0) bulk_store(rows + (size_t)lo * Sp, out, n * Sp * sizeof(float));
    }
  }
  if (kRows && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");

  if constexpr (!kBeta) {
    // ---- loss: -logsumexp(alpha[t_last, 2U], alpha[t_last, 2U-1])
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = s0 + k;
      if (s == 2 * ul) ends[0] = a[k];
      if (ul > 0 && s == 2 * ul - 1) ends[1] = a[k];
    }
    if (multi)
      chain_sync(nthr);
    else
      __syncwarp();
    if (tid == 0) {
      const float e1 = ends[0];
      const float e2 = ul > 0 ? ends[1] : kNeg;
      const float m = fmaxf(e1, e2);
      const float logp = m + logf(expf(e1 - m) + expf(e2 - m));
      *loss_b = -logp;
    }
  }
  // the ring's last kRingChunks - 1 copies are past the last step: let them
  // land before the block's shared memory goes
  if (tid == 0)
    for (int c = chunks; c < chunks + kRingChunks - 1; ++c)
      mbar_wait(&full[c % kRingChunks], (c / kRingChunks) & 1);
}

// One chain too wide for the registers of kMaxChainWarps warps: the running
// rows double-buffered in ws [2, S], threads looping over lanes, a named
// barrier per step.
template <bool kBeta, bool kRows>
__device__ __forceinline__ void walk_global(const float* __restrict__ lp,
                                            const int* __restrict__ lab,
                                            float* __restrict__ rows, float* ws,
                                            float* __restrict__ loss_b, int S, int Sp, int tl,
                                            int ul, int blank) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int t_last = max(tl - 1, 0);
  const int steps = tl - 1;
  {
    const int f = kBeta ? t_last : 0;
    for (int s = tid; s < S; s += nthr) {
      const bool seed = kBeta ? (s == 2 * ul || (ul > 0 && s == 2 * ul - 1))
                              : (s == 0 || (s == 1 && ul > 0));
      const float v = seed ? lp[(size_t)f * Sp + s] : kNeg;
      ws[s] = v;
      if (kRows) rows[(size_t)f * Sp + s] = v;
    }
  }
  chain_sync(nthr);
  for (int i = 1; i <= steps; ++i) {
    const int f = frame_of<kBeta>(i, t_last);
    const float* prev = ws + ((i - 1) & 1) * S;
    float* cur = ws + (i & 1) * S;
    for (int s = tid; s < S; s += nthr) {
      float diag, skip;
      if (!kBeta) {
        diag = s >= 1 ? prev[s - 1] : kNeg;
        skip = s >= 2 ? prev[s - 2] + (skip_allowed(lab, s, ul, blank) ? 0.0f : kNeg) : kNeg;
      } else {
        diag = s + 1 < S ? prev[s + 1] : kNeg;
        skip = s + 2 < S ? prev[s + 2] + (skip_allowed(lab, s + 2, ul, blank) ? 0.0f : kNeg)
                         : kNeg;
      }
      const float v = fmaxf(lse3(prev[s], diag, skip) + lp[(size_t)f * Sp + s], kNeg);
      cur[s] = v;
      if (kRows) rows[(size_t)f * Sp + s] = v;
    }
    chain_sync(nthr);
  }
  if (kBeta || tid != 0) return;
  const float* last = ws + (max(steps, 0) & 1) * S;
  const float e1 = last[2 * ul];
  const float e2 = ul > 0 ? last[2 * ul - 1] : kNeg;
  const float m = fmaxf(e1, e2);
  const float logp = m + logf(expf(e1 - m) + expf(e2 - m));
  *loss_b = -logp;
}

// blockIdx.x: utterance; blockIdx.y: 0 alpha, 1 beta (training). K = 0 is
// the global route.
template <int K, bool kGrad>
__global__ void __launch_bounds__(kMaxChainWarps * 32)
    ctc_chains(const float* __restrict__ lpz, const int* __restrict__ labels,
               const int* __restrict__ logit_len, const int* __restrict__ label_len,
               float* __restrict__ loss, float* __restrict__ rows, float* __restrict__ ws, int T,
               int U, int Sp, int blank, int warps, int D) {
  const int b = blockIdx.x, B = gridDim.x;
  const bool beta = kGrad && blockIdx.y == 1;
  const int S = 2 * U + 1;
  const int tl = min(max(logit_len[b], 0), T);
  const int ul = min(max(label_len[b], 0), U);
  const float* lp = lpz + (size_t)b * T * Sp;
  const int* lab = labels + (size_t)b * U;
  float* r = kGrad ? rows + ((size_t)blockIdx.y * B + b) * T * Sp : nullptr;
  if constexpr (K == 0) {
    float* w = ws + ((size_t)b * 2 + blockIdx.y) * 2 * S;
    if (beta)
      walk_global<true, true>(lp, lab, r, w, nullptr, S, Sp, tl, ul, blank);
    else
      walk_global<false, kGrad>(lp, lab, r, w, loss + b, S, Sp, tl, ul, blank);
  } else {
    if (beta)
      walk_regs<K, true, true>(lp, lab, r, nullptr, T, S, Sp, tl, ul, blank, warps, D);
    else
      walk_regs<K, false, kGrad>(lp, lab, r, loss + b, T, S, Sp, tl, ul, blank, warps, D);
  }
}

// ---- 3. gamma and the gradient

// grid (B, frame tiles), a tile of up to kMaxGradFrames frames of one
// utterance: the block's warps form exp(min(gamma, 40)) of every (frame,
// lane) of the tile's valid frames in shared memory (coalesced over
// lanes); then lane j of every warp takes frame j, and warp w the classes
// w, w + 8, ..., each summed over its lanes from the utterance's list in
// ascending s (the same lanes for every frame, at a stride of S floats
// between threads: no bank conflicts).
__global__ void __launch_bounds__(kGradThreads)
    ctc_grad(const float* __restrict__ logits, const int* __restrict__ logit_len,
             const float* __restrict__ loss, const float* __restrict__ stats,
             const float* __restrict__ lpz, const float* __restrict__ rows,
             const int* __restrict__ lanes, const int* __restrict__ offs,
             float* __restrict__ grad, int B, int T, int C, int U, int Sp, int frames) {
  extern __shared__ float post[];  // [frames, S]: exp(min(gamma, 40)); then the list [S]
  const int b = blockIdx.x, t0 = blockIdx.y * frames;
  const int S = 2 * U + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kGradThreads / 32;
  const int valid = min(max(min(max(logit_len[b], 0), T) - t0, 0), frames);
  int* ln = reinterpret_cast<int*>(post + (size_t)frames * S);
  for (int j = tid; j < S; j += kGradThreads) ln[j] = lanes[(size_t)b * S + j];
  const float logp = -loss[b];
  for (int j = warp; j < valid; j += kWarps) {
    const long long f = (long long)b * T + t0 + j;
    const float* lz = lpz + f * Sp;
    const float* at = rows + f * Sp;
    const float* bt = rows + ((long long)B * T + f) * Sp;
    float* pj = post + (size_t)j * S;
#pragma unroll 4
    for (int s = lane; s < S; s += 32) {
      const float g = fmaxf(((at[s] + bt[s]) - lz[s]) - logp, kNeg);
      pj[s] = expf(fminf(g, 40.0f));
    }
  }
  __syncthreads();
  if (lane >= frames || t0 + lane >= T) return;
  const long long f = (long long)b * T + t0 + lane;
  float* gt = grad + f * C;
  if (lane >= valid) {  // a pad frame
    for (int c = warp; c < C; c += kWarps) gt[c] = 0.0f;
    return;
  }
  const float* xt = logits + f * C;
  const float m = stats[2 * f], ls = stats[2 * f + 1];
  const float* pj = post + (size_t)lane * S;
  const int* off = offs + (size_t)b * (C + 1);
  for (int c = warp; c < C; c += kWarps) {
    const int end = off[c + 1];
    float acc = 0.0f;  // the class's lanes in ascending s
#pragma unroll 4
    for (int j = off[c]; j < end; ++j) acc += pj[ln[j]];
    gt[c] = expf((__ldg(xt + c) - m) - ls) - acc;
  }
}

template <bool kGrad>
using ChainKernel = decltype(&ctc_chains<1, kGrad>);

template <bool kGrad>
ChainKernel<kGrad> chain_kernel(int K) {
  switch (K) {
    case 0: return ctc_chains<0, kGrad>;
    case 1: return ctc_chains<1, kGrad>;
    case 2: return ctc_chains<2, kGrad>;
    case 3: return ctc_chains<3, kGrad>;
    case 4: return ctc_chains<4, kGrad>;
    case 6: return ctc_chains<6, kGrad>;
    case 8: return ctc_chains<8, kGrad>;
    default: return nullptr;
  }
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The launch plan of ops/ctc.ctc_plan: lanes per thread K, chain warps,
// chunk D, row stride Sp, a chain block's shared memory and the grids, and
// for training the gradient pass's frames per block, shared memory and
// grid. run computes each from the shape and refuses a plan that differs.
struct Plan {
  int K, warps, D, Sp, chain_smem, frame_blocks, chain_blocks;
  int grad_frames, grad_smem, grad_blocks;
};

template <bool kGrad>
int run(const float* logits, const int* labels, const int* logit_len, const int* label_len,
        float* loss, float* grad, float* rows, float* stats, float* lpz, int* lanes, int* offs,
        float* ws, int B, int T, int C, int U, int blank, const Plan& p, void* stream) {
  const int S = 2 * U + 1, Sp = (S + 3) / 4 * 4;
  const int K = p.K, warps = p.warps, D = p.D;
  const ChainKernel<kGrad> chains = chain_kernel<kGrad>(K);
  if (B <= 0 || T <= 0 || C <= 0 || U < 0 || blank < 0 || blank >= C || chains == nullptr ||
      warps < 1 || warps > kMaxChainWarps || (K > 0 && 32 * warps * K < Sp) ||
      (K == 1 && warps != 1) || (K > 0 && (D < 1 || D > kMaxChunk)) || (K == 0 && D != 0))
    return (int)cudaErrorInvalidValue;
  // a chain's rings: chunks of lpz rows and (training) of staged new rows,
  // each with the slack of one row of every thread's lanes
  const size_t W = (size_t)32 * warps * K;
  const size_t ring_smem =
      K > 0 ? ((kRingChunks + (kGrad ? kStageChunks : 0)) * (size_t)D * Sp + 2 * W) *
                  sizeof(float)
            : 0;
  const int frame_blocks = (int)(((long long)B * T + kFrameWarps - 1) / kFrameWarps);
  const size_t list_smem = kGrad ? (size_t)C * sizeof(int) : 0;
  const int grad_frames = kGrad ? p.grad_frames : 0;
  const size_t grad_smem = kGrad ? ((size_t)grad_frames * S + S) * sizeof(float) : 0;
  const int grad_tiles = kGrad && grad_frames > 0 ? (T + grad_frames - 1) / grad_frames : 0;
  if (p.Sp != Sp || (size_t)p.chain_smem != ring_smem ||
      ring_smem > (size_t)kMaxSmem - kStaticSmem ||
      p.frame_blocks != frame_blocks + (kGrad ? B : 0) || p.chain_blocks != B * (kGrad ? 2 : 1) ||
      list_smem > (size_t)kMaxSmem ||
      (kGrad && (grad_frames < 1 || grad_frames > kMaxGradFrames ||
                 (size_t)p.grad_smem != grad_smem || grad_smem > (size_t)kMaxSmem ||
                 p.grad_blocks != B * grad_tiles)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 1. frame statistics and lpz rows (and the lists)
  cudaError_t err = allow_smem((const void*)ctc_frames, list_smem);
  if (err != cudaSuccess) return (int)err;
  ctc_frames<<<p.frame_blocks, kFrameWarps * 32, list_smem, s>>>(
      logits, labels, logit_len, stats, lpz, lanes, offs, B, T, C, U, Sp, blank, frame_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. the chains
  err = allow_smem((const void*)chains, ring_smem);
  if (err != cudaSuccess) return (int)err;
  chains<<<dim3(B, kGrad ? 2 : 1), 32 * warps, ring_smem, s>>>(
      lpz, labels, logit_len, label_len, loss, rows, ws, T, U, Sp, blank, warps, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kGrad) return (int)err;
  // 3. the gradient
  err = allow_smem((const void*)ctc_grad, grad_smem);
  if (err != cudaSuccess) return (int)err;
  ctc_grad<<<dim3(B, grad_tiles), kGradThreads, grad_smem, s>>>(
      logits, logit_len, loss, stats, lpz, rows, lanes, offs, grad, B, T, C, U, Sp, grad_frames);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Device pointers of contiguous tensors: logits [B, T, C] float32; labels
// [B, U] int32 (-1 padded); logit_len, label_len [B] int32; loss [B]; with
// Sp = 2U+1 rounded up to a multiple of 4, float32 scratch stats [B, T, 2],
// lpz [B, T, Sp] (16-byte aligned) and ws [B, 2, 2, 2U+1] (the global
// route's, K = 0; unused otherwise). Then the plan of ops/ctc.ctc_plan: K
// (lanes per thread), warps (chain warps), D (lpz rows of a chain's bulk
// copy), Sp, chain_smem (bytes of a chain block's rings), frame_blocks and
// chain_blocks (the grids of the frame pass and the chains). Launches on
// `stream`; returns the first CUDA error of the launches (0 when all were
// accepted), cudaErrorInvalidValue for a plan that is not the shape's.

// Training: also grad [B, T, C] (written in full), rows [2, B, T, Sp]
// float32 scratch (alpha, beta; 16-byte aligned), the int32 class lane
// lists lanes [B, 2U+1] and offs [B, C+1], and the gradient pass's plan:
// grad_frames (frames per block), grad_smem (its bytes), grad_blocks.
int ctc_loss_fwd_bwd(const float* logits, const int* labels, const int* logit_len,
                     const int* label_len, float* loss, float* grad, float* rows, float* stats,
                     float* lpz, int* lanes, int* offs, float* ws, int B, int T, int C, int U,
                     int blank, int K, int warps, int D, int Sp, int chain_smem,
                     int frame_blocks, int chain_blocks, int grad_frames, int grad_smem,
                     int grad_blocks, void* stream) {
  const Plan p{K, warps, D, Sp, chain_smem, frame_blocks, chain_blocks,
               grad_frames, grad_smem, grad_blocks};
  return run<true>(logits, labels, logit_len, label_len, loss, grad, rows, stats, lpz, lanes,
                   offs, ws, B, T, C, U, blank, p, stream);
}

// Eval: the loss alone (the frame pass and the alpha chain).
int ctc_loss_fwd_only(const float* logits, const int* labels, const int* logit_len,
                      const int* label_len, float* loss, float* stats, float* lpz, float* ws,
                      int B, int T, int C, int U, int blank, int K, int warps, int D, int Sp,
                      int chain_smem, int frame_blocks, int chain_blocks, void* stream) {
  const Plan p{K, warps, D, Sp, chain_smem, frame_blocks, chain_blocks, 0, 0, 0};
  return run<false>(logits, labels, logit_len, label_len, loss, nullptr, nullptr, stats, lpz,
                    nullptr, nullptr, ws, B, T, C, U, blank, p, stream);
}

}  // extern "C"
