// The LSTM kernels shared by the bidirectional layer (lstm_bidi_fwd.cu,
// lstm_bidi_bwd.cu: two directions, blockIdx.y picks one) and the
// unidirectional layer (lstm_layer_fwd.cu, lstm_layer_bwd.cu: one direction,
// a grid of depth 1 and null second pointers), for Hopper (sm_90a), over
// hoisted input projections: the forward and the backward each one
// persistent cooperative launch per call.
// ops/build.py hashes this header with the sources that include it.
//
// Stream types. Every walk is a template on S, the type of its streams:
// float, or __nv_bfloat16 under compute_dtype: bfloat16 (the Pallas
// kernels' bf16 streams, ops/pallas/lstm_kernel.py _fwd_call / _bwd_call,
// where the stream dtype is xproj's). S types xproj, ys, cs, the cotangent
// gys and dxproj; Wh, the mask, the carried h and c, the h exchange, the dh
// partials and all gate math stay float32. A bf16 value is upcast exactly
// where it is loaded (the backward's ys[t-1] rows as they enter its gate
// product), and a result is rounded to nearest even only where it is
// stored: ys = h * m and cs in the forward, dxproj in the backward. The
// forward's h_{t-1} comes from the float32 exchange, never from the bf16
// ys, and the backward's dh = dgates @ Wh^T from the float32 dgates, as
// the reference carries both in float32. The recurrent products are
// float32-accurate 3xTF32 on the tensor cores (below), or float32 FFMA on
// the forward's path for a launch of up to 8 rows: Wh and h are float32 in
// the reference.
//
// The bf16-product walk (kBf16Product, lstm_layer_fwd_carry_bf16). A
// streaming chunk at compute_dtype bfloat16 leaves the Pallas kernel for the
// scan branch of rnn_scan (models/rnn.py _lstm_step), whose step is
// xproj[t] + bf16(h_{t-1}) @ bf16(Wh) with float32 accumulation, float32
// streams and float32 carries. The carried walk takes that step with one
// more template flag: Wh is rounded to bf16 as it is staged (load_wc<true>,
// stage_wc<.., true>, or as it is read when not resident) and h_{t-1} (h0 at
// step 0) as it is read from the exchange buffer; the products of two bf16
// values are exact in float32 (a bf16 value is a TF32 one: one tensor-core
// pass), and every sum stays float32, so the walk differs from XLA's dot only
// in the order of its float32 sums. Everything else is the float32 carried
// walk.
//
// Gates i, f, g, o of xproj[t] + h_{t-1} @ Wh, with forget_bias added to f.
// A masked (pad) step carries h and c through and emits 0. The forward is
// exact for any mask; the backward's h_{t-1} = ys[t-1] read relies on a
// monotone length mask.
//
// Both walks replace TPU kernels (ops/pallas/lstm_kernel.py _fwd_kernel,
// _bidi_fwd_kernel, _bwd_kernel, _bidi_bwd_kernel) that keep Wh resident in
// VMEM for all T steps. One direction's Wh does not fit one SM (227 KB),
// but a slice of it fits each SM: a block owns u hidden units of one
// direction for every batch row, and at its start copies into shared memory
// the Wh columns of its units' four gates, Wc [H, 4u]: at H = 512, 64 KB for
// u = 8 (the bidirectional calls: 64 x 2 = 128 blocks) and 32 KB for u = 4
// (one direction: 128 blocks), twice that as TF32 hi and lo parts. Where Wc
// does not fit shared memory (H = 1536) the same kernels read it through L2
// (kResident false). The launch is cooperative, so all blocks
// are resident at once (one per SM) or the launch is refused; the blocks of
// a direction meet at a split arrive / wait barrier (a global counter per
// direction: atomic add after a fence on arrival, an acquire-load spin on
// wait) once per step. A thread keeps the carries of at most kBwdMaxPairs
// (row, unit) pairs in registers, so one launch takes B x u <= 2048;
// ops/lstm.py (fwd_plan, bwd_plan) lays out the launches and splits a larger
// batch into launches over contiguous rows, which are independent.
//
// Forward design (fwd_walk, run_fwd_walk). Per step t = 0 .. T-1:
//  - each thread loads xproj[t] and mask[t] of its pairs, which depend on
//    no other block, and only then waits at its direction's barrier for
//    step t-1: the h exchange alone is on the step's critical path;
//  - the gate product h_{t-1} @ Wc (ops/lstm.py fwd_plan picks the path by
//    the launch's rows): past 8 rows, every row in one pass on the tensor
//    cores, 3xTF32 (one pass for the bf16-product walk; gates_mma, as the
//    backward's gate product): each warp stages its 16 rows of h_{t-1}
//    through a ring in shared memory with cp.async (whole 128-byte lines),
//    its B the resident Wc^T (as TF32 hi and lo where both fit); from the
//    plan's cluster rows on, blocks pair in clusters of 2 that split the
//    product's k: each forms both blocks' columns over its half and sends its
//    partner the partner's sums through distributed shared memory, so that a
//    block reads half of h_{t-1} and splits each A fragment for twice the
//    products. Up to 8 rows (the serving batch, the streaming chunks), FFMA
//    on a chunk of the rows staged through shared memory (gate_product): the
//    tensor cores are 5-16 % faster there, but a streamed chunk's xproj comes
//    from cuBLAS a few ulps off the whole utterance's, and with other rounding
//    in the recurrence the streamed fused beam pruned a hypothesis the offline
//    beam kept (PERF.md), so these shapes keep the FFMA path's numerics;
//  - epilogue, one thread per (row, unit): gate math and the mask carry,
//    h and c kept in registers; ys[t] = h * m, cs[t] = c when asked, and
//    the carried h_t into the exchange buffer hbuf [2 (step parity), dirs,
//    B, H] (the carried h, not ys: exact for any mask);
//  - arrive.
// hbuf is written and read inside the launch, so h_{t-1} is read with
// ld.global.cg (L2), never __ldg. Training also writes the cell-state stream
// cs[b, t] = c_t (the carried value on a masked step), which the backward
// reads; serving passes null. A streaming chunk (lstm_layer_fwd_carry)
// resumes from a carried (h0, c0): c0 goes into the register carries and
// step 0's gate product reads h0 in place, where it would read h_{-1} = 0;
// after the last step each thread writes its pairs' carried (h, c) to
// (hT, cT). Both are loaded and written for every row, so a row that no step
// unmasks (a paused stream) gets back h0 and c0 bit for bit.
//
// What bounds the forward on this card. Each step needs 2 B H 4H float
// operations per direction, three TF32 passes on the tensor cores: at
// B = 128, H = 512, u = 8 about 6,100 mma.sync per block (about 5 us at 1.5
// cycles each), and every block reads all of h_{t-1}, 256 KB, from L2 (half
// of it in a cluster of 2). The step is a chain (barrier, L2 read, product,
// epilogue, fence): its latency sets the pace at a small batch, the
// product's k steps (each a few hundred cycles a warp: splits, fragment
// loads, three dependent passes) at B = 128 (PERF.md; probes/lstm_fwd_time.py
// reads each phase from the kernel's own trace).
//
// Backward design (bwd_walk, run_bwd_walk). A block owns u units of one
// direction for every batch row, as in the forward; the blocks of a direction
// form thread-block clusters of C (1, 2, 4 or 8: ops/lstm.py bwd_plan) and
// meet at the split barrier once per step. Per step t = T-1 .. 0, every row
// of the launch in one pass:
//  before the wait, nothing that another block writes:
//  - each thread loads xproj[t], gys[t], cs[t-1] and mask[t] of its (row,
//    unit) pairs into registers (cs[t] and mask[t+1] are the last step's);
//  - (b) the gates at t for every row: ys[t-1] @ Wc, [B, H] x [H, 4u], the
//    ys rows read straight from global memory into the product's registers;
//  after the wait, only the chain:
//  - (a) dh_t of the thread's pairs: the sum, in cluster order, of the
//    per-cluster partials that step t+1 wrote for this block;
//  - (c) gate derivatives, one thread per (row, unit): the four dxproj[t]
//    entries of the unit (zero on a masked step, which carries dh and dc
//    through), the dh and dc carries in registers, and the float32 dgates
//    into shared memory;
//  - each block copies its dgates into every block of its cluster through
//    distributed shared memory; a cluster barrier; then (p) the cluster's
//    share of dh_{t-1} = dgates_t @ Wh^T for 1/C of the units: rank m of
//    cluster k multiplies the cluster's dgates by Wr, the rows of Wh for its
//    units and the columns of its cluster's 4Cu gates, [B, 4Cu] x [4Cu,
//    H / C]; each unit's result goes to its reader block's slot for cluster
//    k, then the block arrives. The slots alternate by the step's parity:
//    step t's overwrite step t+2's, which every block summed before it
//    arrived in step t+1, so the wait is the step's only grid-wide one.
// The partials thus leave the SM once per cluster, not once per block: per
// block and step B H / C floats written and B u (H / u) / C read through L2,
// where summing per block moved B H each way (256 KB at B = 128, H = 512).
// A block holds two slices of Wh for all T steps: Wc [H, 4u] for (b) and Wr
// [H / C, 4Cu] for (p), each about H 4u floats; where neither fits (H = 1536)
// both are read through L2 (kResident false).
//
// Products. The backward's two and the forward's gate product (its
// tensor-core path) run on the tensor cores, mma.sync m16n8k8 in TF32, each
// warp a 16-row tile of the batch against up to 64 columns over a k range,
// split 3xTF32 for float32 accuracy: x = hi + lo with hi TF32 (rounded to
// nearest) and lo the rest, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, each
// 16-wide k step's products summed on the tensor cores and added to the
// float32 accumulator, the dropped terms within a few 2^-22 of a b. The reference forms
// the products in float32 (lstm_kernel.py: float32 operands and
// preferred_element_type), which one TF32 pass would not match. A bf16 ys row
// is TF32-exact, so (b) takes two passes under bf16 streams; the forward's h
// is float32 under either stream type (three passes). Wh is split into
// hi and lo as it is staged where both copies fit shared memory (kSplit),
// else as it is read. Inside each 16-wide k step a lane holds four adjacent
// k of its two rows (one 16-byte load), and both operands index k the same
// way, so the sum is the product's. Every sum has a fixed order (k steps,
// then k slices, then clusters): two calls give equal bits. dWh is one [T*B]
// contraction outside (ops/lstm.py), as on the TPU.
//
// What bounds the backward on this card. Each step needs 2 x 2 B H 4H float
// operations per direction (gates recomputed, dh product), three TF32
// passes each: at B = 128, H = 512, 2 x 25 MFLOP per block, about 6.7 us at
// 495 TFLOP/s over 132 SMs; mma.sync m16n8k8 TF32 issues at about 1.5
// cycles per SM (24 cycles of latency), cvt.rna.tf32 at about 1.3, so the
// split is two integer operations (probes/mma_tf32_rate.py). The step is a
// chain (gates, barrier, dh sum, derivatives, cluster barrier, dh product
// and the partials' L2 write, arrive), and on an H100 a 128-block launch
// takes clusters of 2 only: the partials move B H / 2 floats per block and
// step each way, and L2 traffic, not the tensor rate, sets the pace at
// B = 128 (PERF.md; probes/lstm_bwd_time.py reads each phase from the
// kernel's own trace). The code of a step is kept small (the pairs' loop is
// the only long unrolled body): a larger one lost time to instruction fetch.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>


// Internal linkage: each source that includes this header gets its own copy
// of the kernels it instantiates, registered with its own module.
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // 256 threads a block
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block may use

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Stream loads (read-only within the launch: the non-coherent path) and
// stores, float or bf16; a bf16 value widens exactly (its bits are the top
// half of the float's) and a store rounds to nearest even.
__device__ __forceinline__ float ld_stream(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_stream(const __nv_bfloat16* p) {
  return __uint_as_float((unsigned int)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void st_stream(float* p, float v) { *p = v; }

// A stream value loaded before a barrier and used after it: a volatile load,
// which the compiler issues where it stands instead of moving it to its use.
// ld_early_raw keeps a bf16 value's bits as loaded, so that the load stays in
// flight until widen() first uses it.
__device__ __forceinline__ float ld_early_raw(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short ld_early_raw(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float((unsigned int)v << 16);
}
template <typename S>
__device__ __forceinline__ float ld_early(const S* p) {
  return widen(ld_early_raw(p));
}
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to bf16 (nearest even) and widened back: an operand of the
// bf16-product walk (kBf16Product), whose products of two such values are
// exact in float32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBwdRows = 32;            // batch rows of the FFMA gate product's largest chunk
constexpr int kBwdKC = 256;             // k per staged chunk of the FFMA gate product
constexpr int kBwdStride = kBwdKC + 4;  // floats per staged row: rows 4 banks apart
constexpr int kBwdMaxCols = 128;        // columns of one FFMA gate-product pass: 8 x 32 tiles
constexpr int kBwdMaxPairs = 8;         // (row, unit) carries a thread keeps in registers
constexpr int kBwdRed = kThreads * 16;  // FFMA partial sums: one 4 x 4 tile per thread

// The checks both launchers make: u a power of two up to kBwdMaxCols (every
// product's tiles divide kThreads), and B x u within the register carries.
inline bool walk_takes(int B, int T, int H, int u) {
  if (B <= 0 || T <= 0 || H <= 0) return false;
  if (u < 1 || u > kBwdMaxCols || (u & (u - 1)) != 0) return false;
  return (long long)B * u <= (long long)kThreads * kBwdMaxPairs;
}

// Copy the block's Wc [hp, ldw] (column c = g u + uu is Wh[:, g H + j0 + uu];
// zero past H) into shared memory at wsm, each value rounded to bf16 when
// kRound (the bf16-product walk).
template <bool kRound = false>
__device__ __forceinline__ void load_wc(float* wsm, const float* __restrict__ wh, int H, int u,
                                        int j0, int hp, int nb, int ldw) {
  const int G = 4 * H;
  for (int i = threadIdx.x; i < hp * nb; i += kThreads) {
    const int k = i / nb;
    const int c = i - k * nb;
    const int g = c / u;
    const int j = j0 + c - g * u;
    const float w = k < H && j < H ? __ldg(wh + (size_t)k * G + g * H + j) : 0.0f;
    wsm[k * ldw + c] = kRound ? round_bf16(w) : w;
  }
  __syncthreads();
}

// The block has written its step's outputs and exchange entries (bar.sync);
// one thread makes them visible device-wide and counts the block in.
__device__ __forceinline__ void step_arrive(unsigned int* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

// Wait until `target` blocks have arrived: one thread spins on acquire loads.
__device__ __forceinline__ void step_wait(const unsigned int* counter, unsigned int target) {
  if (threadIdx.x == 0) {
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

// Loads of the gate product's source rows. kCoherent: rows written by other
// blocks inside this launch (the forward's h exchange), read through L2
// (ld.global.cg); otherwise rows written by an earlier launch, read through
// the non-coherent path (ld_stream: a bf16 row value widened). The exchange
// is float32.
template <bool kCoherent>
__device__ __forceinline__ float4 src_load4(const float* p) {
  return kCoherent ? __ldcg(reinterpret_cast<const float4*>(p))
                   : __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kCoherent, typename S>
__device__ __forceinline__ float src_load(const S* p) {
  if constexpr (kCoherent) {
    return __ldcg(p);  // S float
  } else {
    return ld_stream(p);
  }
}

// The gate product for a chunk's rows:
// out[r][c0 + c] = sum_k h[b0 + r][k] Wc[k][c0 + c], r < kRows, c < n <=
// kBwdMaxCols, with h row b at src + b * src_row and Wc[k][g u + uu] =
// Wh[k, g H + j0 + uu], resident at wsm [hp, ldw]. The h rows are staged
// through shared memory in chunks of kBwdKC. A thread owns one 4 x 4 tile of
// out, rows rt + i kRows / 4 for i < 4 (at kRows = 32 the 8 lanes of a
// quarter warp read 8 rows on distinct banks) and 4 adjacent columns, in
// one of kThreads / tiles slices of every chunk: fewer rows, more slices.
// The slices' sums are added in slice order. Src is float (the forward's h
// exchange). kRound (the bf16-product walk): every staged h value is
// rounded to bf16 as it is written to shared memory, and a Wc value read
// from Wh itself (kResident false) as it is read; a resident Wc was rounded
// when it was loaded (load_wc<true>). Products and sums stay float32.
template <bool kResident, int kRows = kBwdRows, bool kCoherent = false, typename Src = float,
          bool kRound = false>
__device__ void gate_product(const Src* src, size_t src_row, const float* wsm,
                             const float* __restrict__ wh, int c0, int n, int ldw, int j0, int u,
                             int b0, int rows, int H, int hp, float* stage, float* red,
                             float* out, int ldo) {
  constexpr int kTiles = kRows / 4;  // 4-row tiles of a chunk
  static_assert(kRows % 4 == 0 && kRows <= kBwdRows, "rows a chunk takes");
  const int tid = threadIdx.x;
  const int nct = n / 4;
  const int tiles = kTiles * nct;
  const int ksplit = kThreads / tiles;
  const int s = tid / tiles;
  const int tile = tid - s * tiles;
  const int rt = tile / nct;
  const int ct = tile - rt * nct;
  const bool live = rt < rows;
  const int nq = (hp + kBwdKC - 1) / kBwdKC;
  const int G = 4 * H;
  const bool vec = (H & 3) == 0;

  // kResident false: Wc[k][c] of this thread's columns read from Wh itself
  size_t off[4];
  bool ok[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = c0 + ct * 4 + e;
    const int g = c / u;
    const int j = j0 + c - g * u;
    ok[e] = j < H;
    off[e] = (size_t)g * H + j;
  }

  // Chunk q is staged in two halves: load() issues its global loads into
  // registers (kLoads float4 per thread, all in flight at once), store()
  // writes them to shared memory. Chunk q+1 is loaded while q is computed.
  constexpr int kLoads = kRows * kBwdKC / 4 / kThreads;
  float4 v[kLoads];
  auto load = [&](int q) {
    const int k0 = q * kBwdKC;
    const int len4 = min(kBwdKC, hp - k0) / 4;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / len4;
      v[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vec && r < rows)
        v[l] = src_load4<kCoherent>(src + (size_t)(b0 + r) * src_row + k0 + 4 * (i - r * len4));
    }
  };
  auto store = [&](int q) {
    float* buf = stage + (q & 1) * (kRows * kBwdStride);
    const int k0 = q * kBwdKC;
    const int len4 = min(kBwdKC, hp - k0) / 4;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / len4;
      if (r >= kRows) continue;
      const int k = k0 + 4 * (i - r * len4);
      float* dst = buf + r * kBwdStride + (k - k0);
      if (vec || r >= rows) {
        float4 x = v[l];
        if (kRound) x = make_float4(round_bf16(x.x), round_bf16(x.y), round_bf16(x.z),
                                    round_bf16(x.w));
        *reinterpret_cast<float4*>(dst) = x;
      } else {  // H % 4 != 0: rows are not 16-byte (bf16: 8-byte) aligned
        const Src* p = src + (size_t)(b0 + r) * src_row + k;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = k + e < H ? src_load<kCoherent>(p + e) : 0.0f;
          dst[e] = kRound ? round_bf16(x) : x;
        }
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  load(0);
  store(0);
  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) load(q + 1);
    __syncthreads();  // chunk q is staged; chunk q-1's buffer is free
    if (live) {
      const float* a0 = stage + (q & 1) * (kRows * kBwdStride) + rt * kBwdStride;
      const int k0 = q * kBwdKC;
      const int ng = min(kBwdKC, hp - k0) / 4;
      const int per = (ng + ksplit - 1) / ksplit;
      const int hi = min(ng, (s + 1) * per);
      for (int gi = s * per; gi < hi; ++gi) {
        const int kk = 4 * gi;
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(a0 + i * kTiles * kBwdStride + kk);
          a[i][0] = av.x, a[i][1] = av.y, a[i][2] = av.z, a[i][3] = av.w;
        }
        float w[4][4];
        if (kResident) {
          const float* wp = wsm + (size_t)(k0 + kk) * ldw + c0 + ct * 4;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 wv = *reinterpret_cast<const float4*>(wp + e * ldw);
            w[e][0] = wv.x, w[e][1] = wv.y, w[e][2] = wv.z, w[e][3] = wv.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = k0 + kk + e;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float x = ok[c] && k < H ? __ldg(wh + off[c] + (size_t)k * G) : 0.0f;
              w[e][c] = kRound ? round_bf16(x) : x;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i][e], w[e][c], acc[i][c]);
      }
    }
    if (q + 1 < nq) store(q + 1);
  }

  float* mine = red + tid * 16;  // tid == s * tiles + tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(mine + 4 * i) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                           acc[i][3]);
  __syncthreads();
  for (int o = tid; o < kRows * n; o += kThreads) {
    const int r = o / n;
    const int c = o - r * n;
    const float* part = red + ((r % kTiles) * nct + c / 4) * 16 + (r / kTiles) * 4 + (c & 3);
    float sum = 0.0f;
    for (int k = 0; k < ksplit; ++k) sum += part[k * tiles * 16];
    out[r * ldo + c0 + c] = sum;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The step trace of either walk (lstm_*_fwd_trace, lstm_*_bwd_trace): when
// walk_trace_on is set, thread 0 of block (0, 0) writes clock64() at the
// walk's points of each of its first kTraceSteps steps (the forward's
// kFwdTracePoints: top of the step, stream loads issued, wait passed, product
// done, epilogue done; the backward's kTracePoints: top of the step, gates
// formed, wait passed, dh summed, derivatives done, dgates copied to the
// cluster, cluster barrier passed, partials written, arrived), and at the
// launch's start and end clock64() and the global timer (ns), so that cycles
// convert to time. Some marks sit behind a block barrier, so that they time
// the block's work and not thread 0's. Off, it costs one load of the flag per
// launch. Each source has its own copy (the namespace below is anonymous).
constexpr int kTraceSteps = 64, kTracePoints = 9, kFwdTracePoints = 5;
constexpr int kTraceFloats = kTraceSteps * kTracePoints + 4;
__device__ int walk_trace_on;
__device__ long long walk_trace[kTraceFloats];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Set the trace on (on != 0) or off (out null), or copy the last traced
// launch's values (kTraceFloats long longs) to host memory at out. Returns
// the CUDA error.
inline int walk_trace_ctl(int on, long long* out) {
  const cudaError_t e = out == nullptr
                            ? cudaMemcpyToSymbol(walk_trace_on, &on, sizeof(int))
                            : cudaMemcpyFromSymbol(out, walk_trace, sizeof(walk_trace));
  return (int)e;
}

// ---------------------------------------------------------------------------
// Products on the tensor cores (both walks; the design at the top, "Products").

// n (a multiple of 16) padded to 16 mod 32 floats: the row stride of an
// operand that lanes read 16 bytes at a time, two rows a quarter warp, so
// that the two rows fall on the two halves of the banks.
__host__ __device__ inline int mma_ld(int n) { return n % 32 == 0 ? n + 16 : n; }

// Slices of a product's k steps: the most (a power of two) that keep every
// warp of the block on its own (row tile, column chunk, k slice), with at
// least one k step each.
__host__ __device__ inline int mma_ksplit(int items, int ksteps) {
  int ks = 1;
  while (2 * ks * items <= kWarps && 2 * ks <= ksteps) ks *= 2;
  return ks;
}

// x as a TF32 value, rounded to nearest (ties away from zero), in a float's
// bits: what cvt.rna.tf32.f32 gives for the finite values here, in two
// integer operations, where the conversion takes about as long on this card
// as an mma.sync (probes/mma_tf32_rate.py).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The 3xTF32 split: x = hi + lo exactly, hi TF32 (rounded to nearest) and
// |lo| <= 2^-11 |x|; the tensor cores read lo's top 19 bits (its low 13
// truncated), within 2^-22 |x| of x - hi.
__device__ __forceinline__ void split1(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split1(v.x, hi[0], lo[0]), split1(v.y, hi[1], lo[1]);
  split1(v.z, hi[2], lo[2]), split1(v.w, hi[3], lo[3]);
}

__device__ __forceinline__ void bits4(float4 v, uint32_t (&b)[4]) {
  b[0] = __float_as_uint(v.x), b[1] = __float_as_uint(v.y);
  b[2] = __float_as_uint(v.z), b[3] = __float_as_uint(v.w);
}

// d += a b: one m16n8k8 TF32 product, float32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of one 16-row tile over one 16-wide k step: row gid holds
// k 4 tig .. 4 tig + 3 in p0, row gid + 8 in p1 (lane = 4 gid + tig). The
// step is two k8 products; product s takes k 4 tig + 2 s for the fragment's
// column tig and 4 tig + 2 s + 1 for tig + 4, and the B operand (bfrag) the
// same k, so together they sum all 16. kExact: the values are TF32 already
// (bf16 rows), lo is zero and not formed.
struct AFrag {
  uint32_t hi[2][4], lo[2][4];
};

template <bool kExact>
__device__ __forceinline__ void afrag(AFrag& f, float4 p0, float4 p1) {
  const float v[2][4] = {{p0.x, p1.x, p0.y, p1.y}, {p0.z, p1.z, p0.w, p1.w}};
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (kExact) {
        f.hi[s][e] = __float_as_uint(v[s][e]);
      } else {
        split1(v[s][e], f.hi[s][e], f.lo[s][e]);
      }
    }
}

// acc[g + j] += A B_j over one 16-wide k step for the kG n-tiles j of a
// group starting at tile g, B_j's four k of column gid in bh[j] / bl[j]:
// kPasses 3 (float32 A and B) a_lo b_hi + a_hi b_lo + a_hi b_hi, the small
// terms first; 2 (A TF32 already: bf16 rows) without the first; 1 (A and B
// TF32 already: the bf16-product walk's bf16 values) a_hi b_hi alone. The
// products are issued round by round across the group's tiles, so that their
// chains through the accumulators overlap. The step's products meet in
// accumulators of their own, added to acc in float32 (round to nearest): the
// tensor cores' own accumulation does not round to nearest, and over a long k
// its error would grow with the number of steps.
template <int kPasses, int kG, int kN>
__device__ __forceinline__ void mma3(float (&acc)[kN][4], int g, const AFrag& a,
                                     const uint32_t (&bh)[kG][4], const uint32_t (&bl)[kG][4]) {
  float p[kG][4];
#pragma unroll
  for (int j = 0; j < kG; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
  if (kPasses > 2) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kG; ++j) mma_tf32(p[j], a.lo[s], bh[j][2 * s], bh[j][2 * s + 1]);
  }
  if (kPasses > 1) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < kG; ++j) mma_tf32(p[j], a.hi[s], bl[j][2 * s], bl[j][2 * s + 1]);
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < kG; ++j) mma_tf32(p[j], a.hi[s], bh[j][2 * s], bh[j][2 * s + 1]);
#pragma unroll
  for (int j = 0; j < kG; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g + j][e] += p[j][e];
}

// B operand of one n-tile from a resident [n, k] array (k contiguous) at
// float offset o: one 16-byte load, two when split (lo at lo_off).
template <bool kSplit>
__device__ __forceinline__ void bfrag_smem(const float* w, int o, int lo_off, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(w + o);
  if (kSplit) {
    bits4(v, hi);
    bits4(*reinterpret_cast<const float4*>(w + lo_off + o), lo);
  } else {
    split4(v, hi, lo);
  }
}

// Four values of a source row at k .. k + 3 one at a time (H % 4 != 0: rows
// not aligned), zero past H.
template <bool kCoherent, typename S>
__device__ __forceinline__ float4 row4(const S* p, int k, int H) {
  return make_float4(k < H ? src_load<kCoherent>(p + k) : 0.0f,
                     k + 1 < H ? src_load<kCoherent>(p + k + 1) : 0.0f,
                     k + 2 < H ? src_load<kCoherent>(p + k + 2) : 0.0f,
                     k + 3 < H ? src_load<kCoherent>(p + k + 3) : 0.0f);
}

// The A rows' loads of the gate product: Raw as loaded, four values at k of
// row p (zero where !ok), widened to float at use. kVec (H % 4 == 0): one
// 16-byte load, or for bf16 one 8-byte load kept packed; else value by value.
// kCoherent: rows written inside the launch (src_load).
template <typename S, bool kVec, bool kCoherent = false>
struct RowLoad {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const S* p, int k, int H, bool ok) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (kVec) {
      return ok ? src_load4<kCoherent>(p + k) : z;  // S float
    } else {
      return ok ? row4<kCoherent>(p, k, H) : z;
    }
  }
  __device__ __forceinline__ static float4 widen(Raw v) { return v; }
};

template <>
struct RowLoad<__nv_bfloat16, true, false> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p, int k, int, bool ok) {
    return ok ? __ldg(reinterpret_cast<const uint2*>(p + k)) : make_uint2(0u, 0u);
  }
  __device__ __forceinline__ static float4 widen(Raw v) {
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};

// Wh's column of the block's gate column n < 4u (g u + uu -> g H + j0 + uu),
// or -1 for a pad column or a unit past H.
__device__ __forceinline__ int own_col(int n, int u, int j0, int H) {
  const int g = n >> (31 - __clz(u));  // u is a power of two
  const int j = j0 + n - g * u;
  return n < 4 * u && j < H ? g * H + j : -1;
}

// w at base[o], or split into TF32 hi at base[o] and lo at base[lo_off + o]
// when kSplit.
template <bool kSplit>
__device__ __forceinline__ void put_w(float* base, int o, int lo_off, float w) {
  if (kSplit) {
    uint32_t hi, lo;
    split1(w, hi, lo);
    base[o] = __uint_as_float(hi);
    base[lo_off + o] = __uint_as_float(lo);
  } else {
    base[o] = w;
  }
}

// Wh's column of the gate product's column n: block s = n / nbp of the
// blocks whose columns the product forms (one, or a forward cluster's two),
// its gate column n - s nbp; j0 the first unit of the first of them.
__device__ __forceinline__ int gate_col(int n, int nbp, int u, int j0, int H) {
  const int s = n / nbp;
  return own_col(n - s * nbp, u, j0 + s * u, H);
}

// Stage the gate product's Wc^T[n][k] = Wh[gk0 + k][gate_col(n)] at wc [gn,
// ldk] for all T steps, zero past H and in the pads: split into TF32 hi and
// lo (lo at gn ldk) when kSplit, each value rounded to bf16 when kRound (the
// bf16-product walk). Lay: the walk's layout (kp, nbp, gn, gk0, ldk).
template <bool kSplit, bool kRound, typename Lay>
__device__ void stage_wc(float* wc, const Lay& L, const float* __restrict__ wh, int H, int u,
                         int j0) {
  const int G = 4 * H;
  for (int e = threadIdx.x; e < L.kp * L.gn; e += kThreads) {
    const int k = e / L.gn;
    const int n = e - k * L.gn;
    const int col = gate_col(n, L.nbp, u, j0, H);
    const int kg = L.gk0 + k;
    const float w = col >= 0 && kg < H ? __ldg(wh + (size_t)kg * G + col) : 0.0f;
    put_w<kSplit>(wc, n * L.ldk + k, L.gn * L.ldk, kRound ? round_bf16(w) : w);
  }
}

// The gate pre-activations of every row, src @ Wc ([B, H] rows of stride
// src_row times [H, 4u]), into the k slices scr[sl][row][n] (row stride
// ldo_g, slice stride mp ldo_g). Work items (16-row tile, kNT n-tiles: all of
// them up to 8) times ks_g k slices go round the warps. The A rows come from
// global memory straight into registers, kDepth k steps ahead of their
// product, 16 (bf16: 8) bytes a row when kVec (H % 4 == 0); kCoherent: rows
// written inside the launch (the forward's h exchange), read through L2. B is
// the resident Wc^T (stage_wc), or Wh itself through L2. kPasses: 3 (float32
// rows and Wh, 3xTF32), 2 (bf16 rows: TF32 values), 1 (the bf16-product walk:
// each row value rounded to bf16 as it is widened, Wc rounded as it was staged
// or is read, so that A and B are TF32 values and each product is exact). Lay:
// the walk's layout (kp, nbp, ldk, mp, ldo_g, ks_g, wc).
template <int kNT, bool kVec, bool kResident, bool kSplit, int kPasses, bool kCoherent,
          typename S, typename Lay>
__device__ void gates_mma_nt(const S* src, size_t src_row, const float* smem, const Lay& L,
                             const float* __restrict__ wh, int B, int H, int u, int j0,
                             float* scr) {
  constexpr int kG = kNT < 4 ? kNT : 4;  // n-tiles whose B fragments are held at once
  using Load = RowLoad<S, kVec, kCoherent>;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int G = 4 * H;
  const int ksteps = L.kp / 16, nch = L.gn / 8 / kNT;
  const int items = L.mp / 16 * nch, ks = L.ks_g, per = (ksteps + ks - 1) / ks;
  const float* wc = smem + L.wc;
  for (int w = threadIdx.x / 32; w < items * ks; w += kWarps) {
    const int item = w / ks, sl = w - item * ks;
    const int mt = item / nch, t0 = (item - mt * nch) * kNT;
    const int kb = sl * per, kn = min(ksteps, kb + per) - kb;
    // every block of the direction reads the same rows: each starts its k
    // steps at its own offset (a fixed one, so two calls sum alike), lest
    // they all ask L2 for the same lines at once
    const int rot = kn > 0 ? (blockIdx.x * 5) % kn : 0;
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    const S* s0 = src + (size_t)min(r0, B - 1) * src_row;  // the lane's two rows
    const S* s1 = src + (size_t)min(r1, B - 1) * src_row;
    const bool ok0 = r0 < B, ok1 = r1 < B;
    // the k step of the q-th product
    auto step = [&](int q) { return kb + (q + rot < kn ? q + rot : q + rot - kn); };
    // the A rows of product q as loaded (bf16 packed, widened at use), kDepth
    // products ahead: a ring indexed statically, the loop unrolled by it
    using Raw = typename Load::Raw;
    constexpr int kDepth = sizeof(Raw) == 8 ? 6 : 3;
    auto lda = [&](int q, Raw& q0, Raw& q1) {
      const int k = L.gk0 + step(q) * 16 + 4 * tig;
      const bool in = q < kn && (!kVec || k < H);
      q0 = Load::load(s0, k, H, in && ok0);
      q1 = Load::load(s1, k, H, in && ok1);
    };
    auto operand = [](float4 v) {
      return kPasses == 1 ? make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                                        round_bf16(v.w))
                          : v;
    };
    // this lane's Wc^T row of each tile, at its four k
    const float* wb = wc + ((size_t)t0 * 8 + gid) * L.ldk + 4 * tig;
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    Raw ring[kDepth][2];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) lda(d, ring[d][0], ring[d][1]);
    for (int q0 = 0; q0 < kn; q0 += kDepth) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const int q = q0 + d;
        if (q >= kn) continue;
        AFrag a;
        afrag<(kPasses < 3)>(a, operand(Load::widen(ring[d][0])),
                             operand(Load::widen(ring[d][1])));
        lda(q + kDepth, ring[d][0], ring[d][1]);
        const int kst = step(q);
        const int k = L.gk0 + kst * 16 + 4 * tig;
#pragma unroll
        for (int g = 0; g < kNT; g += kG) {
          uint32_t bh[kG][4], bl[kG][4];
#pragma unroll
          for (int j = 0; j < kG; ++j) {
            if (kResident) {
              bfrag_smem<kSplit>(wb, (g + j) * 8 * L.ldk + kst * 16, L.gn * L.ldk, bh[j],
                                 bl[j]);
            } else {
              const int col = gate_col((t0 + g + j) * 8 + gid, L.nbp, u, j0, H);
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[e] = col >= 0 && k + e < H ? __ldg(wh + (size_t)(k + e) * G + col) : 0.0f;
              split4(operand(make_float4(v[0], v[1], v[2], v[3])), bh[j], bl[j]);
            }
          }
          mma3<kPasses, kG, kNT>(acc, g, a, bh, bl);
        }
      }
    }
    float* o = scr + (size_t)sl * L.mp * L.ldo_g + (size_t)t0 * 8 + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      *reinterpret_cast<float2*>(o + r0 * L.ldo_g + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + r1 * L.ldo_g + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// cp.async of 16 bytes from global memory (L2 only: coherent for rows written
// inside the launch, as ld.global.cg) into shared memory, zeros where !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The per-warp staging of gates_mma_staged: kStages stages in flight, each
// two k steps of a 16-row tile, rows kStageLd floats apart (32 k padded to 16
// mod 32: the two rows of a quarter warp's fragment loads on the two halves
// of the banks).
constexpr int kStages = 3, kStageLd = 48;
constexpr int kStageFloats = kWarps * kStages * 16 * kStageLd;  // a block's rings

// gates_mma_nt for float32 rows written inside the launch (the forward's h
// exchange), 16-byte aligned (H % 4 == 0): each warp stages its A rows
// through its own ring of kStages stages in shared memory at L.ring with
// cp.async.cg, a stage two k steps of its 16 rows, 128 bytes a row (whole L2
// lines). The rows in flight take no registers, which the walk's carries and
// early stream loads need: with gates_mma_nt's register ring the forward
// spilled, and its steps took 0.5-0.7 us longer at B = 32 and 128 (PERF.md).
// The stages go round from a fixed offset per block (two calls sum alike); a
// k slice's odd last stage has a zero second half.
template <int kNT, bool kResident, bool kSplit, int kPasses, typename Lay>
__device__ void gates_mma_staged(const float* src, size_t src_row, float* smem, const Lay& L,
                                 const float* __restrict__ wh, int B, int H, int u, int j0,
                                 float* scr) {
  constexpr int kG = kNT < 4 ? kNT : 4;  // n-tiles whose B fragments are held at once
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int warp = threadIdx.x / 32;
  const int G = 4 * H;
  const int ksteps = L.kp / 16, nch = L.gn / 8 / kNT;
  const int items = L.mp / 16 * nch, ks = L.ks_g, per = (ksteps + ks - 1) / ks;
  const float* wc = smem + L.wc;
  float* ring = smem + L.ring + warp * (kStages * 16 * kStageLd);
  const int lr = lane / 8, lc = lane % 8;  // the lane's copies: rows 4 i + lr, 16 bytes at 4 lc
  for (int w = warp; w < items * ks; w += kWarps) {
    const int item = w / ks, sl = w - item * ks;
    const int mt = item / nch, t0 = (item - mt * nch) * kNT;
    const int kb = sl * per, kn = min(ksteps, kb + per) - kb;
    const int ns = (kn + 1) / 2;  // stages of two k steps
    const int rot = ns > 0 ? (blockIdx.x * 5) % ns : 0;
    auto stage = [&](int q) { return q + rot < ns ? q + rot : q + rot - ns; };
    // stage q into slot q % kStages (an empty group past the last stage)
    auto load = [&](int q) {
      if (q < ns) {
        const int k0 = kb + 2 * stage(q);  // the stage's first k step
        const int k = L.gk0 + k0 * 16 + 4 * lc;
        const bool kin = k0 + lc / 4 < kb + kn && k < H;
        float* slot = ring + (q % kStages) * (16 * kStageLd) + 4 * lc;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * i + lr;
          const bool ok = kin && mt * 16 + r < B;
          cp_async16(slot + r * kStageLd, ok ? src + (size_t)(mt * 16 + r) * src_row + k : src,
                     ok);
        }
      }
      cp_async_commit();
    };
    // this lane's Wc^T row of each tile, at its four k
    const float* wb = wc + ((size_t)t0 * 8 + gid) * L.ldk + 4 * tig;
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) load(q);
    for (int q = 0; q < ns; ++q) {
      load(q + kStages - 1);  // into the slot that stage q - 1 freed
      cp_async_wait<kStages - 1>();  // stage q is in, this lane's copies
      __syncwarp();                  // and every lane's
      const float* slot = ring + (q % kStages) * (16 * kStageLd) + 4 * tig;
      const int k0 = kb + 2 * stage(q);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kst = k0 + j;
        if (kst >= kb + kn) break;
        float4 p0 = *reinterpret_cast<const float4*>(slot + gid * kStageLd + 16 * j);
        float4 p1 = *reinterpret_cast<const float4*>(slot + (gid + 8) * kStageLd + 16 * j);
        if (kPasses == 1) {
          p0 = make_float4(round_bf16(p0.x), round_bf16(p0.y), round_bf16(p0.z), round_bf16(p0.w));
          p1 = make_float4(round_bf16(p1.x), round_bf16(p1.y), round_bf16(p1.z), round_bf16(p1.w));
        }
        AFrag a;
        afrag<(kPasses < 3)>(a, p0, p1);
        const int k = L.gk0 + kst * 16 + 4 * tig;
#pragma unroll
        for (int g = 0; g < kNT; g += kG) {
          uint32_t bh[kG][4], bl[kG][4];
#pragma unroll
          for (int jj = 0; jj < kG; ++jj) {
            if (kResident) {
              bfrag_smem<kSplit>(wb, (g + jj) * 8 * L.ldk + kst * 16, L.gn * L.ldk, bh[jj],
                                 bl[jj]);
            } else {
              const int col = gate_col((t0 + g + jj) * 8 + gid, L.nbp, u, j0, H);
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                v[e] = col >= 0 && k + e < H ? __ldg(wh + (size_t)(k + e) * G + col) : 0.0f;
                if (kPasses == 1) v[e] = round_bf16(v[e]);
              }
              split4(make_float4(v[0], v[1], v[2], v[3]), bh[jj], bl[jj]);
            }
          }
          mma3<kPasses, kG, kNT>(acc, g, a, bh, bl);
        }
      }
      __syncwarp();  // every lane has read the slot before it is refilled
    }
    cp_async_wait<0>();
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    float* o = scr + (size_t)sl * L.mp * L.ldo_g + (size_t)t0 * 8 + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      *reinterpret_cast<float2*>(o + r0 * L.ldo_g + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + r1 * L.ldo_g + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// The gate product of gates_mma_nt, or for rows written inside the launch and
// 16-byte aligned gates_mma_staged, with the n-tiles of a work item for the
// block's 4u columns: 2, 4 or 8 (two when the rows are not aligned).
template <bool kResident, bool kSplit, int kPasses, bool kCoherent, typename S, typename Lay>
__device__ __forceinline__ void gates_mma(const S* src, size_t src_row, float* smem,
                                          const Lay& L, const float* __restrict__ wh, int B,
                                          int H, int u, int j0, float* scr) {
  const int nct = L.gn / 8;  // 2, 4, 8 or more (a multiple of 8)
  if ((H & 3) != 0) {
    gates_mma_nt<2, false, kResident, kSplit, kPasses, kCoherent>(src, src_row, smem, L, wh, B,
                                                                   H, u, j0, scr);
  } else if constexpr (kCoherent) {
    if (nct == 2) {
      gates_mma_staged<2, kResident, kSplit, kPasses>(src, src_row, smem, L, wh, B, H, u, j0,
                                                      scr);
    } else if (nct == 4) {
      gates_mma_staged<4, kResident, kSplit, kPasses>(src, src_row, smem, L, wh, B, H, u, j0,
                                                      scr);
    } else {
      gates_mma_staged<8, kResident, kSplit, kPasses>(src, src_row, smem, L, wh, B, H, u, j0,
                                                      scr);
    }
  } else if (nct == 2) {
    gates_mma_nt<2, true, kResident, kSplit, kPasses, false>(src, src_row, smem, L, wh, B, H, u,
                                                             j0, scr);
  } else if (nct == 4) {
    gates_mma_nt<4, true, kResident, kSplit, kPasses, false>(src, src_row, smem, L, wh, B, H, u,
                                                             j0, scr);
  } else {
    gates_mma_nt<8, true, kResident, kSplit, kPasses, false>(src, src_row, smem, L, wh, B, H, u,
                                                             j0, scr);
  }
}

namespace cg = cooperative_groups;

// A cooperative launch of kThreads-thread blocks in clusters of `cluster`
// (no cluster attribute at 1); attrs holds the attributes cfg points at.
inline cudaLaunchConfig_t walk_config(dim3 grid, int cluster, int smem_bytes, void* stream,
                                     cudaLaunchAttribute (&attrs)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = (unsigned int)cluster;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  return cfg;
}

// ---------------------------------------------------------------------------
// Forward: one persistent cooperative launch per call (design at the top).

template <typename S>
struct FwdArgs {
  const S* x[2];       // [B, T, 4H] per direction
  const float* wh[2];  // [H, 4H]
  S* ys[2];            // [B, T, H]
  S* cs[2];            // [B, T, H], or null: no cell-state stream
  const float* mask;   // [B, T]
  unsigned int* sync;  // [dirs] arrival counters, zeroed by the caller
  float* hbuf;         // h exchange [2 (step parity), dirs, B, H]: written and read inside
                       //   the launch
  int B, T, H, units;
  float forget_bias;
  // the carried state of a streaming chunk (lstm_layer_fwd_carry); the other
  // entry points leave them null: h and c start at 0 and the final state is
  // not written
  const float* h0[2];  // [B, H] h before step 0, or null: zeros
  const float* c0[2];  // [B, H] c before step 0, or null: zeros
  float* hT[2];        // [B, H] the carried h after step T-1, or null: not written
  float* cT[2];        // [B, H] the carried c after step T-1, or null: not written
};

// The plan's rows: kFfmaRows, the FFMA product's chunk (a launch of up to
// that many rows: the serving batch and the streaming chunks), or the tensor
// cores' row tile times the blocks of a cluster that split its k (kMmaRows:
// none; 2 kMmaRows: clusters of 2).
constexpr int kFfmaRows = 8, kMmaRows = 16;

// Dynamic shared memory of one forward block, offsets and size in floats.
// FFMA (rows kFfmaRows): Wc [hp, ldw] (hp = H padded to 4, nb = 4u columns,
// ldw = nb + 4), the staged chunk stage [2, rows, kBwdStride], the k slices'
// partial sums red [kBwdRed] and the chunk's gates gpre [rows, nb]. Tensor
// cores (rows kMmaRows C, B the launch's rows, rank the block's in its
// cluster; the names of bwd_layout's gate product): the product's columns
// gn = the 4u of each of the C blocks of the cluster (each padded to nbp) and
// its k the rank's share of H, gk0 .. gk0 + kp; Wc^T [gn, ldk] (twice, hi then
// lo, when split), the gates' k slices scr [ks_g, mp, ldo_g], with a cluster
// of 2 the partner's sums for this block's columns xch [mp, nbp], and the
// warps' staging rings ring [kStageFloats] (gates_mma_staged). The Wh slice
// only when resident.
struct FwdLayout {
  int hp, nb, ldw;                            // FFMA
  int nbp, gn, kp, gk0, ldk, mp, ldo_g, ks_g;  // tensor cores
  int wc, stage, red, gpre, scr, xch, ring, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int u, int rows, int B, bool resident,
                                                bool split, int rank = 0) {
  FwdLayout l = {};
  l.wc = 0;
  if (rows == kFfmaRows) {
    l.hp = (H + 3) / 4 * 4;
    l.nb = 4 * u;
    l.ldw = l.nb + 4;
    l.stage = l.wc + (resident ? l.hp * l.ldw : 0);
    l.red = l.stage + 2 * rows * kBwdStride;
    l.gpre = l.red + kBwdRed;
    l.total = l.gpre + rows * l.nb;
    return l;
  }
  const int C = rows / kMmaRows;
  const int ksteps = ((H + 15) / 16 + C - 1) / C;  // k steps of each rank's share
  l.nbp = (4 * u + 15) / 16 * 16;
  l.gn = C * l.nbp;
  l.kp = 16 * ksteps;
  l.gk0 = rank * l.kp;
  l.ldk = mma_ld(l.kp);
  l.mp = (B + 15) / 16 * 16;
  l.ldo_g = l.gn + 8;  // 8 mod 32: the 8-byte stores of a half warp on distinct banks
  l.ks_g = mma_ksplit(l.mp / 16 * ((l.gn / 8 + 7) / 8), ksteps);
  l.scr = l.wc + (resident ? (split ? 2 : 1) * l.gn * l.ldk : 0);
  l.xch = l.scr + l.ks_g * l.mp * l.ldo_g;
  l.ring = l.xch + (C > 1 ? l.mp * l.nbp : 0);
  l.total = l.ring + kStageFloats;
  return l;
}

// One (row, unit) pair's step: gates i, f, g, o from xproj xv and the
// recurrent pre-activations gp (forget_bias fb on f), the mask carry of h and
// c, and the stores: ys = h * m, cs = c where cs is not null, and the carried
// h into the exchange at hx.
template <typename S>
__device__ __forceinline__ void fwd_pair(const float (&xv)[4], const float (&gp)[4], float m,
                                         float fb, float& h, float& c, S* ys, S* cs,
                                         float* hx) {
  const float ig = sigmoid(xv[0] + gp[0]);
  const float fg = sigmoid(xv[1] + gp[1] + fb);
  const float gg = tanhf(xv[2] + gp[2]);
  const float og = sigmoid(xv[3] + gp[3]);
  const float c_new = fg * c + ig * gg;
  const float h_new = og * tanhf(c_new);
  if (m > 0.0f) {
    h = h_new;
    c = c_new;
  }
  st_stream(ys, h * m);
  if (cs != nullptr) st_stream(cs, c);
  *hx = h;
}

// kRows: the product path, kFfmaRows (FFMA: chunks of that many rows, h_{t-1}
// staged through shared memory, gate_product) or kMmaRows C (the tensor
// cores: every row in one pass, gates_mma; with C = 2 the blocks pair in
// clusters along x, each forms the pair's 8u columns over its half of k and
// sends its partner the sums of the partner's columns through distributed
// shared memory, so that each block reads half of h_{t-1} from L2 and splits
// each A fragment for twice the products). kSplit (tensor cores, kResident):
// Wc held as TF32 hi and lo parts. kCarry: the walk resumes from a.h0 / a.c0
// and writes a.hT / a.cT (any of them may be null); the walks that start from
// zeros are compiled without it. kBf16Product: the gate product takes bf16
// operands, h_{t-1} (h0 at step 0) and Wh each rounded to bf16, with float32
// sums (lstm_layer_fwd_carry_bf16: the bf16 branch of the reference's
// _lstm_step, which a streaming chunk at compute_dtype bfloat16 runs);
// streams, carries and gate math stay float32.
template <bool kResident, int kRows, bool kCarry, typename S, bool kBf16Product = false,
          bool kSplit = false>
__global__ void __launch_bounds__(kThreads, 1) fwd_walk(const FwdArgs<S> a) {
  constexpr bool kMma = kRows != kFfmaRows;
  constexpr int kCluster = kMma ? kRows / kMmaRows : 1;
  extern __shared__ float4 fwd_smem4[];
  float* smem = reinterpret_cast<float*>(fwd_smem4);
  const cg::cluster_group cl = cg::this_cluster();
  const int dir = blockIdx.y;
  const int B = a.B, T = a.T, H = a.H, u = a.units, G = 4 * H;
  const int j0 = blockIdx.x * u;
  const int rank = blockIdx.x % kCluster;  // in the cluster, along x
  const int jc = j0 - rank * u;            // the cluster's first unit
  const int tid = threadIdx.x;
  const int ush = 31 - __clz(u);  // u is a power of two (walk_takes)
  const FwdLayout L = fwd_layout(H, u, kRows, B, kResident, kSplit, rank);

  const S* __restrict__ x = dir ? a.x[1] : a.x[0];
  const float* __restrict__ wh = dir ? a.wh[1] : a.wh[0];
  const float* __restrict__ mask = a.mask;
  S* ys = dir ? a.ys[1] : a.ys[0];
  S* cs = dir ? a.cs[1] : a.cs[0];
  unsigned int* counter = a.sync + dir;
  const int blocks = gridDim.x;
  const size_t state = (size_t)gridDim.y * B * H;  // one step parity of hbuf
  float* hdir = a.hbuf + (size_t)dir * B * H;

  const bool tracing = walk_trace_on != 0;  // the same for every thread of the launch
  const bool tracer = tracing && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;
  // a trace point of step t; `sync`: after a barrier of the whole block
  auto mark = [&](int t, int point, bool sync) {
    if (!tracing) return;
    if (sync) __syncthreads();
    if (tracer && t < kTraceSteps) walk_trace[t * kFwdTracePoints + point] = clock64();
  };
  if (tracer) {
    walk_trace[kTraceSteps * kTracePoints] = clock64();
    walk_trace[kTraceSteps * kTracePoints + 1] = global_ns();
  }

  if (kResident) {  // for all T steps
    if constexpr (kMma) {
      stage_wc<kSplit, kBf16Product>(smem + L.wc, L, wh, H, u, jc);
      __syncthreads();
    } else {
      load_wc<kBf16Product>(smem + L.wc, wh, H, u, j0, L.hp, L.nb, L.ldw);
    }
  }

  // the pairs p = tid + i kThreads: row p / u, unit j0 + p % u; their carries
  // start from h0 / c0 (zeros when null), loaded for every row: a row that no
  // step unmasks hands them back unchanged, bit for bit
  const float* __restrict__ h0 = kCarry ? (dir ? a.h0[1] : a.h0[0]) : nullptr;
  float h[kBwdMaxPairs], c[kBwdMaxPairs];
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) h[i] = c[i] = 0.0f;
  if constexpr (kCarry) {
    const float* __restrict__ c0 = dir ? a.c0[1] : a.c0[0];
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p >> ush;
      const int j = j0 + (p & (u - 1));
      if (b < B && j < H) {
        if (h0 != nullptr) h[i] = __ldg(h0 + (size_t)b * H + j);
        if (c0 != nullptr) c[i] = __ldg(c0 + (size_t)b * H + j);
      }
    }
  }

  for (int t = 0; t < T; ++t) {
    mark(t, 0, false);
    // xproj[t] and mask[t] of the thread's pairs: no other block writes them,
    // so they are issued before the wait, and xproj stays as loaded (a bf16
    // value's bits) until the epilogue widens it
    decltype(ld_early_raw(x)) xv[kBwdMaxPairs][4];
    float mv[kBwdMaxPairs];
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p >> ush;
      const int j = j0 + (p & (u - 1));
      xv[i][0] = xv[i][1] = xv[i][2] = xv[i][3] = 0;
      mv[i] = 0.0f;
      if (b < B && j < H) {
        const size_t bt = (size_t)b * T + t;
        const S* xt = x + bt * G + j;
        xv[i][0] = ld_early_raw(xt), xv[i][1] = ld_early_raw(xt + H);
        xv[i][2] = ld_early_raw(xt + 2 * H), xv[i][3] = ld_early_raw(xt + 3 * H);
        mv[i] = ld_early(mask + bt);
      }
    }
    mark(t, 1, true);
    const float* hprev = hdir + (size_t)(t & 1) * state;  // h_{t-1}, written in step t-1
    float* hnext = hdir + (size_t)((t + 1) & 1) * state;
    // every block of the direction has written h_{t-1}; h_{-1} is h0, an
    // input that every block reads in place (no exchange, no barrier), or 0
    if (t > 0) step_wait(counter, blocks * (unsigned int)t);
    mark(t, 2, false);
    const float* hsrc = t > 0 ? hprev : h0;
    const bool product = kCarry ? hsrc != nullptr : t > 0;
    if constexpr (kMma) {
      // every row's gates in one pass, then the epilogue of every pair
      float* scr = smem + L.scr;
      const int own = rank * L.nbp;  // this block's columns in scr
      if (product)
        gates_mma<kResident, kSplit, kBf16Product ? 1 : 3, true>(hsrc, (size_t)H, smem, L, wh,
                                                                 B, H, u, jc, scr);
      __syncthreads();
      if (kCluster > 1 && product) {
        // the partner's columns over this block's k: its k slices summed in
        // order, into the partner's xch; the cluster barrier makes them seen
        float* xch = cl.map_shared_rank(smem + L.xch, rank ^ 1);
        const int other = (rank ^ 1) * L.nbp;
        for (int e = tid; e < B * 4 * u; e += kThreads) {
          const int b = e >> (ush + 2);  // 4u columns a row
          const int c = e & (4 * u - 1);
          const float* gs = scr + (size_t)b * L.ldo_g + other + c;
          float v = 0.0f;
          for (int sl = 0; sl < L.ks_g; ++sl, gs += (size_t)L.mp * L.ldo_g) v += *gs;
          xch[b * L.nbp + c] = v;
        }
        cl.sync();
      }
      mark(t, 3, false);
  #pragma unroll
      for (int i = 0; i < kBwdMaxPairs; ++i) {
        const int p = tid + i * kThreads;
        const int b = p >> ush;
        const int uu = p & (u - 1);
        const int j = j0 + uu;
        if (b >= B || j >= H) continue;
        float gp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (product) {  // the k slices in order, then the partner's k
          const float* gs = scr + (size_t)b * L.ldo_g + own + uu;
  #pragma unroll 1
          for (int sl = 0; sl < L.ks_g; ++sl, gs += (size_t)L.mp * L.ldo_g) {
  #pragma unroll
            for (int g = 0; g < 4; ++g) gp[g] += gs[g * u];
          }
          if (kCluster > 1) {
            const float* xs = smem + L.xch + b * L.nbp + uu;
  #pragma unroll
            for (int g = 0; g < 4; ++g) gp[g] += xs[g * u];
          }
        }
        const size_t bt = (size_t)b * T + t;
        const float x4[4] = {widen(xv[i][0]), widen(xv[i][1]), widen(xv[i][2]), widen(xv[i][3])};
        fwd_pair(x4, gp, mv[i], a.forget_bias, h[i], c[i], ys + bt * H + j,
                 cs != nullptr ? cs + bt * H + j : nullptr, hnext + (size_t)b * H + j);
      }
    } else {
      // per chunk of kRows rows: the product staged through shared memory,
      // then the chunk's epilogue (with several chunks the trace's product
      // phase holds all but the last chunk's epilogue)
      float* gpre = smem + L.gpre;
      for (int b0 = 0; b0 < B; b0 += kRows) {
        const int rows = min(kRows, B - b0);
        if (product) {
          for (int k0 = 0; k0 < L.nb; k0 += kBwdMaxCols)
            gate_product<kResident, kRows, true, float, kBf16Product>(
                hsrc, (size_t)H, smem + L.wc, wh, k0, min(kBwdMaxCols, L.nb - k0), L.ldw, j0,
                u, b0, rows, H, L.hp, smem + L.stage, smem + L.red, gpre, L.nb);
        } else {
          for (int i = tid; i < kRows * L.nb; i += kThreads) gpre[i] = 0.0f;
          __syncthreads();
        }
        mark(t, 3, false);
#pragma unroll
        for (int i = 0; i < kBwdMaxPairs; ++i) {
          const int p = tid + i * kThreads;
          const int b = p >> ush;
          const int uu = p & (u - 1);
          const int j = j0 + uu;
          if (b < b0 || b >= b0 + rows || j >= H) continue;
          const float* gq = gpre + (b - b0) * L.nb + uu;
          const float gp[4] = {gq[0], gq[u], gq[2 * u], gq[3 * u]};
          const size_t bt = (size_t)b * T + t;
          const float x4[4] = {widen(xv[i][0]), widen(xv[i][1]), widen(xv[i][2]),
                               widen(xv[i][3])};
          fwd_pair(x4, gp, mv[i], a.forget_bias, h[i], c[i], ys + bt * H + j,
                   cs != nullptr ? cs + bt * H + j : nullptr, hnext + (size_t)b * H + j);
        }
        __syncthreads();  // gpre is consumed
      }
    }
    mark(t, 4, true);
    step_arrive(counter);
  }
  if (tracer) {
    walk_trace[kTraceSteps * kTracePoints + 2] = clock64();
    walk_trace[kTraceSteps * kTracePoints + 3] = global_ns();
  }

  if constexpr (kCarry) {
    // the carried state after the last step (a masked step carried it through)
    float* hT = dir ? a.hT[1] : a.hT[0];
    float* cT = dir ? a.cT[1] : a.cT[0];
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p >> ush;
      const int j = j0 + (p & (u - 1));
      if (b >= B || j >= H) continue;
      if (hT != nullptr) hT[(size_t)b * H + j] = h[i];
      if (cT != nullptr) cT[(size_t)b * H + j] = c[i];
    }
  }
}

// The forward walk's kernel for a plan's rows (product path, cluster),
// resident and split. The bf16-product walk and FFMA have no split
// instantiation: a Wc rounded to bf16 is TF32 already, and FFMA takes it
// whole.
template <bool kCarry, typename S, bool kBf16Product, int kRows>
const void* fwd_kernel(bool resident, bool split) {
  if (!resident)
    return reinterpret_cast<const void*>(fwd_walk<false, kRows, kCarry, S, kBf16Product>);
  if constexpr (kRows != kFfmaRows && !kBf16Product) {
    if (split)
      return reinterpret_cast<const void*>(fwd_walk<true, kRows, kCarry, S, kBf16Product, true>);
  }
  return reinterpret_cast<const void*>(fwd_walk<true, kRows, kCarry, S, kBf16Product>);
}

// Launch the forward walk of kDirs directions (1 or 2) as one cooperative
// kernel on `stream`: grid (ceil(H / a.units), kDirs), kThreads threads and
// smem_bytes of dynamic shared memory per block. rows: the product path,
// kFfmaRows (FFMA, that many batch rows a chunk) or kMmaRows C (the tensor
// cores, every row in one pass; C = 2: clusters of 2 blocks along x that
// split its k, which takes an even count of blocks a direction). resident:
// 0, the Wh slice read through L2; 1, held in shared memory; 2 (tensor
// cores), held as TF32 hi and lo parts (the bf16-product walk holds it whole:
// its rounded Wc has no lo part). a.sync
// holds kDirs zeroed counters, a.hbuf hbuf_floats floats. kCarry: the walk
// that resumes from a.h0 / a.c0 and writes a.hT / a.cT
// (lstm_layer_fwd_carry); the others read none of them. S: the stream type.
// kBf16Product: bf16 operands of the gate product (lstm_layer_fwd_carry_bf16).
// ops/lstm.py fwd_plan picks units, resident, rows and smem_bytes. Returns
// the CUDA error: cudaErrorCooperativeLaunchTooLarge when the blocks cannot
// all be resident at once (the kernel then never runs), cudaErrorInvalidValue
// for a plan this kernel does not take, and for an exchange buffer of
// another size than the kernel indexes. Does not synchronise.
template <int kDirs, bool kCarry = false, typename S = float, bool kBf16Product = false>
int run_fwd_walk(const FwdArgs<S>& a, int hbuf_floats, int resident, int rows, int smem_bytes,
                 void* stream) {
  static_assert(kDirs == 1 || kDirs == 2, "one or two directions");
  if (!walk_takes(a.B, a.T, a.H, a.units)) return (int)cudaErrorInvalidValue;
  const int blocks = (a.H + a.units - 1) / a.units;  // of a direction
  const bool mma = rows == kMmaRows || rows == 2 * kMmaRows;
  if (!mma && rows != kFfmaRows) return (int)cudaErrorInvalidValue;
  const int cluster = mma ? rows / kMmaRows : 1;
  if (blocks % cluster != 0) return (int)cudaErrorInvalidValue;
  if (resident < 0 || resident > (mma ? 2 : 1)) return (int)cudaErrorInvalidValue;
  const bool split = resident == 2 && !kBf16Product;
  const FwdLayout l = fwd_layout(a.H, a.units, rows, a.B, resident != 0, split);
  if ((size_t)l.total * sizeof(float) > (size_t)smem_bytes || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the exchange fwd_walk indexes: [2, kDirs, B, H]
  if (hbuf_floats < 0 || (size_t)hbuf_floats != 2 * (size_t)kDirs * a.B * a.H)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      !mma           ? fwd_kernel<kCarry, S, kBf16Product, kFfmaRows>(resident != 0, split)
      : cluster == 1 ? fwd_kernel<kCarry, S, kBf16Product, kMmaRows>(resident != 0, split)
                     : fwd_kernel<kCarry, S, kBf16Product, 2 * kMmaRows>(resident != 0, split);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      walk_config(dim3((unsigned int)blocks, kDirs), cluster, smem_bytes, stream, attrs);
  void* params[] = {const_cast<FwdArgs<S>*>(&a)};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, params);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error for the next one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: one persistent cooperative launch per call (design at the top).

template <typename S>
struct BwdArgs {
  const S* x[2];        // [B, T, 4H] per direction
  const float* wh[2];   // [H, 4H]
  const S* ys[2];       // [B, T, H]
  const S* cs[2];       // [B, T, H]
  const S* gys[2];      // [B, T, H]
  S* dx[2];             // [B, T, 4H]
  const float* mask;    // [B, T]
  unsigned int* sync;   // [dirs] arrival counters, zeroed by the caller
  float* part;          // dh partials [2 (step parity), dirs, blocks (reader), blocks / cluster,
                        //   B, u]: written and read inside the launch
  int B, T, H, units, cluster;
  float forget_bias;
};

// Slices of the dh sum: a reader's partials are ncl planes (one per cluster)
// of P = B u values; items (value, slice of the planes) go round the
// threads, as many slices (a power of two up to ncl) as keep the items
// within the threads' kBwdMaxPairs each.
__host__ __device__ inline int bwd_dh_slices(int P, int ncl) {
  int s = 1;
  while (2 * s <= ncl && 2 * s * P <= kThreads * kBwdMaxPairs) s *= 2;
  return s;
}

// Dynamic shared memory of one backward block, offsets and size in floats.
// nbp: the block's 4u gate columns padded to 16; kp: H padded to 16 (the gate
// product's k); rpb readers per cluster rank, whose ni = rpb u units the rank
// forms the partials of (nip padded to 8); kc = C nbp the partial product's
// k; mp: B padded to 16 (row tiles). wc: Wc^T [nbp, ldk] (column n of Wc,
// k contiguous); wr: Wr [nip, ldr] (unit i, the cluster's gate columns
// contiguous); each twice (hi, then lo) when split, neither when streamed.
// dg: the cluster's dgates [mp, ldg], block s of the cluster in columns
// s nbp .. s nbp + 4u (every block writes its own into all of them); scr:
// the gate product's k slices [ks_g, mp, ldo_g]; red: the dh sum's slices
// [dhs, B u].
struct BwdLayout {
  int nb4, nbp, kp, ldk, rpb, ni, nip, kc, ldr, mp, ldg, ldo_g, ks_g, ncl, dhs;
  int gn, gk0;  // the gate product's columns and first k (gates_mma): nbp, 0
  int wc, wr, dg, scr, red, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int H, int u, int B, int cluster, bool resident,
                                                bool split) {
  BwdLayout l;
  const int per_dir = (H + u - 1) / u;
  l.nb4 = 4 * u;
  l.nbp = (l.nb4 + 15) / 16 * 16;
  l.kp = (H + 15) / 16 * 16;
  l.ldk = mma_ld(l.kp);
  l.rpb = per_dir / cluster;
  l.ni = l.rpb * u;
  l.nip = (l.ni + 7) / 8 * 8;
  l.kc = cluster * l.nbp;
  l.ldr = mma_ld(l.kc);
  l.mp = (B + 15) / 16 * 16;
  l.ldg = mma_ld(l.kc);
  l.ldo_g = l.nbp + 8;  // 8 mod 32: the 8-byte stores of a half warp on distinct banks
  l.ks_g = mma_ksplit(l.mp / 16 * ((l.nbp / 8 + 7) / 8), l.kp / 16);
  l.gn = l.nbp;
  l.gk0 = 0;
  l.ncl = per_dir / cluster;
  l.dhs = bwd_dh_slices(B * u, l.ncl);
  const int copies = split ? 2 : 1;
  l.wc = 0;
  l.wr = l.wc + (resident ? copies * l.nbp * l.ldk : 0);
  l.dg = l.wr + (resident ? copies * l.nip * l.ldr : 0);
  l.scr = l.dg + l.mp * l.ldg;
  l.red = l.scr + l.ks_g * l.mp * l.ldo_g;
  l.total = l.red + l.dhs * B * u;
  return l;
}

// Stage the block's slices of Wh (kResident): Wc^T (stage_wc) and
// Wr[i][s nbp + c] = Wh[i0 + i][gate column c of cluster block s], zero past
// H and in the pads; each value split into TF32 hi and lo when kSplit.
template <bool kSplit>
__device__ void stage_bwd_w(float* smem, const BwdLayout& L, const float* __restrict__ wh, int H,
                            int u, int j0, int i0, int jc) {
  const int G = 4 * H;
  stage_wc<kSplit, false>(smem + L.wc, L, wh, H, u, j0);
  float* wr = smem + L.wr;
  for (int e = threadIdx.x; e < L.nip * L.kc; e += kThreads) {
    const int i = e / L.kc;
    const int c = e - i * L.kc;
    const int s = c / L.nbp;
    const int col = own_col(c - s * L.nbp, u, jc + s * u, H);
    put_w<kSplit>(wr, i * L.ldr + c, L.nip * L.ldr,
                  col >= 0 && i < L.ni && i0 + i < H ? __ldg(wh + (size_t)(i0 + i) * G + col)
                                                     : 0.0f);
  }
}

// (p) Rank `rank` of cluster ck: Q[b][i] = sum over the cluster's blocks s and
// their gate columns c of dg_s[b][c] Wh[i0 + i][column c of s] for its ni
// units i, the dgates of every block of the cluster read from this block's
// copy (each block wrote its own there through distributed shared memory),
// written to reader r = (i0 + i) / u at part_t + ((r ncl + ck) B + b) u +
// (i0 + i) % u. Work items (16-row tile, kNT n-tiles: the largest power of
// two up to 8 that divides nip / 8) go round the warps, each over the whole
// k, its result stored from the accumulators (splitting k over warps cost
// a block barrier and a pass through shared memory, more than it saved).
template <int kNT, bool kResident, bool kSplit>
__device__ void bwd_partials(const float* dgs, const float* smem, const BwdLayout& L,
                             const float* __restrict__ wh, int B, int H, int u, int ck, int i0,
                             int jc, int ncl, float* part_t) {
  constexpr int kG = kNT < 4 ? kNT : 4;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int G = 4 * H;
  const int ksteps = L.kc / 16, nch = L.nip / 8 / kNT;
  const int items = L.mp / 16 * nch;
  const float* wr = smem + L.wr;
  const int ush = 31 - __clz(u);  // u is a power of two
  // one value of Q, unit n of the rank's, row b
  auto put = [&](int b, int n, float v) {
    if (b >= B || n >= L.ni) return;
    const int i = i0 + n;
    const int r = i >> ush;
    part_t[((size_t)(r * ncl + ck) * B + b) * u + (i & (u - 1))] = v;
  };
  // units n, n + 1 (n even) of row b: one 8-byte store when u is even (both
  // in one reader's run, n + 1 < ni as ni = rpb u is even)
  auto put2 = [&](int b, int n, float v0, float v1) {
    if (u == 1) {
      put(b, n, v0), put(b, n + 1, v1);
      return;
    }
    if (b >= B || n >= L.ni) return;
    const int i = i0 + n;
    const int r = i >> ush;
    *reinterpret_cast<float2*>(part_t + ((size_t)(r * ncl + ck) * B + b) * u + (i & (u - 1))) =
        make_float2(v0, v1);
  };
  for (int item = threadIdx.x / 32; item < items; item += kWarps) {
    const int mt = item / nch, t0 = (item - mt * nch) * kNT;
    const int r0 = mt * 16 + gid, r1 = r0 + 8;
    const float* a0 = dgs + r0 * L.ldg + 4 * tig;
    const float* a1 = dgs + r1 * L.ldg + 4 * tig;
    const float* wb = wr + ((size_t)t0 * 8 + gid) * L.ldr + 4 * tig;
    float acc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
    for (int kst = 0; kst < ksteps; ++kst) {
      AFrag a;
      afrag<false>(a, *reinterpret_cast<const float4*>(a0 + kst * 16),
                   *reinterpret_cast<const float4*>(a1 + kst * 16));
      const int k = kst * 16 + 4 * tig;
#pragma unroll
      for (int g = 0; g < kNT; g += kG) {
        uint32_t bh[kG][4], bl[kG][4];
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          if (kResident) {
            bfrag_smem<kSplit>(wb, (g + j) * 8 * L.ldr + kst * 16, L.nip * L.ldr, bh[j], bl[j]);
          } else {
            const int n = (t0 + g + j) * 8 + gid;
            const int s = k / L.nbp;
            const bool row_ok = n < L.ni && i0 + n < H;
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = own_col(k + e - s * L.nbp, u, jc + s * u, H);
              v[e] = row_ok && col >= 0 ? __ldg(wh + (size_t)(i0 + n) * G + col) : 0.0f;
            }
            split4(make_float4(v[0], v[1], v[2], v[3]), bh[j], bl[j]);
          }
        }
        mma3<3, kG, kNT>(acc, g, a, bh, bl);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = (t0 + nt) * 8 + 2 * tig;
      put2(r0, n, acc[nt][0], acc[nt][1]);
      put2(r1, n, acc[nt][2], acc[nt][3]);
    }
  }
}

template <bool kResident, bool kSplit, typename S>
__global__ void __launch_bounds__(kThreads, 1) bwd_walk(const BwdArgs<S> a) {
  extern __shared__ float4 bwd_smem4[];
  float* smem = reinterpret_cast<float*>(bwd_smem4);
  const cg::cluster_group cl = cg::this_cluster();
  const int dir = blockIdx.y;
  const int B = a.B, T = a.T, H = a.H, u = a.units, G = 4 * H, C = a.cluster;
  const int tid = threadIdx.x;
  const int blocks = gridDim.x;   // of the direction
  const int ncl = blocks / C;     // clusters of the direction
  const int ck = blockIdx.x / C;  // this block's cluster and its rank there
  const int rank = blockIdx.x - ck * C;
  const int j0 = blockIdx.x * u;  // the block's first unit
  const int jc = ck * C * u;      // the cluster's first unit
  const BwdLayout L = bwd_layout(H, u, B, C, kResident, kSplit);
  const int i0 = rank * L.ni;  // the first unit of the rank's dh partials
  const int ush = 31 - __clz(u);  // u is a power of two (walk_takes)
  float* dgs = smem + L.dg;
  float* scr = smem + L.scr;
  float* red = smem + L.red;

  const S* __restrict__ x = dir ? a.x[1] : a.x[0];
  const float* __restrict__ wh = dir ? a.wh[1] : a.wh[0];
  const S* __restrict__ ys = dir ? a.ys[1] : a.ys[0];
  const S* __restrict__ cs = dir ? a.cs[1] : a.cs[0];
  const S* __restrict__ gys = dir ? a.gys[1] : a.gys[0];
  const float* __restrict__ mask = a.mask;
  S* dx = dir ? a.dx[1] : a.dx[0];
  unsigned int* counter = a.sync + dir;  // blocks that wrote their partials
  const size_t slot = (size_t)ncl * B * u;  // one reader block's partials of one step
  // this direction's partials of step t: [blocks (reader), ncl, B, u] at
  // t's parity. Step t writes them after its wait, by which every block has
  // arrived in step t+1, so has summed step t+2's, the last ones there.
  auto part_at = [&](int t) {
    return a.part + ((size_t)(t & 1) * gridDim.y + dir) * blocks * slot;
  };
  auto cluster_sync = [&]() {
    if (C > 1) {
      cl.sync();
    } else {
      __syncthreads();
    }
  };
  const bool tracing = walk_trace_on != 0;  // the same for every thread of the launch
  const bool tracer = tracing && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;
  // a trace point of step t; `sync`: after a barrier of the whole block, so
  // that it marks the block's work and not thread 0's
  auto mark = [&](int t, int point, bool sync) {
    if (!tracing) return;
    if (sync) __syncthreads();
    const int step = T - 1 - t;
    if (tracer && step < kTraceSteps) walk_trace[step * kTracePoints + point] = clock64();
  };
  if (tracer) {
    walk_trace[kTraceSteps * kTracePoints] = clock64();
    walk_trace[kTraceSteps * kTracePoints + 1] = global_ns();
  }

  if (kResident) stage_bwd_w<kSplit>(smem, L, wh, H, u, j0, i0, jc);  // for all T steps
  for (int e = tid; e < L.mp * L.ldg; e += kThreads) dgs[e] = 0.0f;    // pads stay zero
  cluster_sync();  // staged, and every block of the cluster running

  // the pairs p = tid + i kThreads: row p / u, unit j0 + p % u; carries dh,
  // dc, c_t = cs[t] and m_next = mask[t+1] of step t
  float dh[kBwdMaxPairs], dc[kBwdMaxPairs], ct[kBwdMaxPairs], m_next[kBwdMaxPairs];
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) {
    const int p = tid + i * kThreads;
    const int b = p >> ush;
    const int j = j0 + (p & (u - 1));
    dh[i] = dc[i] = m_next[i] = 0.0f;
    ct[i] = b < B && j < H ? ld_stream(cs + ((size_t)b * T + T - 1) * H + j) : 0.0f;
  }

  const int P = B * u;  // the values of one plane of a reader's partials
  for (int t = T - 1; t >= 0; --t) {
    mark(t, 0, false);
    // next step's ys rows into L2: each block a share of the lines
    if (t > 1) {
      const int es = (int)sizeof(S), lines = (H * es + 127) / 128;
      for (int e = blockIdx.x * kThreads + tid; e < B * lines; e += blocks * kThreads) {
        const int b = e / lines;
        const char* p = reinterpret_cast<const char*>(ys + ((size_t)b * T + t - 2) * H) +
                        (size_t)(e - b * lines) * 128;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
      }
    }
    // (b) gate pre-activations at t; h_{-1} = 0
    if (t > 0) {
      const S* rows = ys + (size_t)(t - 1) * H;
      const size_t stride = (size_t)T * H;
      // bf16 ys rows are TF32 values: two passes
      gates_mma<kResident, kSplit, sizeof(S) == 2 ? 2 : 3, false>(rows, stride, smem, L, wh, B,
                                                                   H, u, j0, scr);
    }
    __syncthreads();
    mark(t, 1, false);
    // the step's streams of the thread's pairs: no other block writes them
    float xv[kBwdMaxPairs][4], gy[kBwdMaxPairs], cp[kBwdMaxPairs], mv[kBwdMaxPairs];
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p >> ush;
      const int j = j0 + (p & (u - 1));
      xv[i][0] = xv[i][1] = xv[i][2] = xv[i][3] = gy[i] = cp[i] = mv[i] = 0.0f;
      if (b < B && j < H) {
        const size_t bt = (size_t)b * T + t;
        const S* xt = x + bt * G + j;
        xv[i][0] = ld_early(xt), xv[i][1] = ld_early(xt + H);
        xv[i][2] = ld_early(xt + 2 * H), xv[i][3] = ld_early(xt + 3 * H);
        gy[i] = ld_early(gys + bt * H + j);
        if (t > 0) cp[i] = ld_early(cs + (bt - 1) * H + j);
        mv[i] = ld_early(mask + bt);
      }
    }
    // every block of the direction has written its partials of step t+1
    if (t + 1 < T) step_wait(counter, blocks * (unsigned int)(T - 1 - t));
    mark(t, 2, false);
    // (a) dh_t: this block's slot of step t+1's partials, [ncl planes, P];
    // items (value p, slice s of the planes) go round the threads, each
    // summing its slice's planes in order into red[s][p], every load of a
    // round of four planes in flight at once; (c) adds the slices in order
    if (t + 1 < T) {
      const float* pr = part_at(t + 1) + (size_t)blockIdx.x * slot;
      const int per = (ncl + L.dhs - 1) / L.dhs;
      if ((P & 3) == 0) {  // four values an item, one 16-byte load a plane
        const int Q = P / 4;
        float4 acc[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int q0 = 0; q0 < per; q0 += 8) {
          float4 v[2][8];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int it = tid + j * kThreads;
            const int s = it / Q;
            const int q = it - s * Q;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int k = s * per + q0 + e;
              v[j][e] = s < L.dhs && q0 + e < per && k < ncl
                            ? __ldcg(reinterpret_cast<const float4*>(pr + (size_t)k * P) + q)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              acc[j].x += v[j][e].x, acc[j].y += v[j][e].y;
              acc[j].z += v[j][e].z, acc[j].w += v[j][e].w;
            }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (tid + j * kThreads < Q * L.dhs)
            reinterpret_cast<float4*>(red)[tid + j * kThreads] = acc[j];
      } else {
        float acc[kBwdMaxPairs];
#pragma unroll
        for (int j = 0; j < kBwdMaxPairs; ++j) acc[j] = 0.0f;
        for (int q0 = 0; q0 < per; q0 += 4) {
          float v[kBwdMaxPairs][4];
#pragma unroll
          for (int j = 0; j < kBwdMaxPairs; ++j) {
            const int it = tid + j * kThreads;
            const int s = it / P;
            const int p = it - s * P;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int k = s * per + q0 + q;
              v[j][q] = s < L.dhs && q0 + q < per && k < ncl ? __ldcg(pr + (size_t)k * P + p)
                                                             : 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < kBwdMaxPairs; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[j] += v[j][q];
        }
#pragma unroll
        for (int j = 0; j < kBwdMaxPairs; ++j)
          if (tid + j * kThreads < L.dhs * P) red[tid + j * kThreads] = acc[j];
      }
    }
    __syncthreads();
    mark(t, 3, false);
    // (c) gate derivatives, one thread per (row, unit)
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p >> ush;
      const int uu = p & (u - 1);
      const int j = j0 + uu;
      if (b >= B || j >= H) continue;
      // (the slice loops stay rolled: this body is unrolled once per pair, and
      // its code, not its work, is what grows)
      float dn = 0.0f;
      if (t + 1 < T) {
#pragma unroll 1
        for (int s = 0; s < L.dhs; ++s) dn += red[s * P + p];
      }
      float gp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (t > 0) {
        const float* gs = scr + (size_t)b * L.ldo_g + uu;
#pragma unroll 1
        for (int sl = 0; sl < L.ks_g; ++sl, gs += (size_t)L.mp * L.ldo_g) {
#pragma unroll
          for (int g = 0; g < 4; ++g) gp[g] += gs[g * u];
        }
      }
      const float ig = sigmoid(xv[i][0] + gp[0]);
      const float fg = sigmoid(xv[i][1] + gp[1] + a.forget_bias);
      const float gg = tanhf(xv[i][2] + gp[2]);
      const float og = sigmoid(xv[i][3] + gp[3]);
      const float m = mv[i];
      const bool on = m > 0.0f;
      // dh carried from t+1: dgates_{t+1} @ Wh^T after a real step, else
      // the passed-through total (zero before the first real step)
      const float dh_carry = m_next[i] > 0.0f ? dn : dh[i];
      const float dh_tot = (on ? gy[i] : 0.0f) + dh_carry;
      const float tc = tanhf(ct[i]);
      const float dc_tot = dc[i] + dh_tot * og * (1.0f - tc * tc);
      const float d_o = dh_tot * tc;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (on) {
        d[0] = dc_tot * gg * ig * (1.0f - ig);
        d[1] = dc_tot * cp[i] * fg * (1.0f - fg);
        d[2] = dc_tot * ig * (1.0f - gg * gg);
        d[3] = d_o * og * (1.0f - og);
        dc[i] = dc_tot * fg;
      }
      // the float32 dgates, into this block's columns of its copy
      float* to = dgs + b * L.ldg + rank * L.nbp + uu;
#pragma unroll
      for (int g = 0; g < 4; ++g) to[g * u] = d[g];
      dh[i] = dh_tot;
      ct[i] = cp[i];
      m_next[i] = m;
    }
    mark(t, 4, true);
    if (t > 0 && C > 1) {
      // this block's columns into every other block's copy, 16 bytes a store
      __syncthreads();
      const int n4 = L.nbp / 4;
      for (int e = tid; e < B * n4 * (C - 1); e += kThreads) {
        const int s = e / (B * n4);
        const int b = (e - s * B * n4) / n4;
        const int o = b * L.ldg + rank * L.nbp + 4 * (e - s * B * n4 - b * n4);
        *reinterpret_cast<float4*>(cl.map_shared_rank(dgs, s + (s >= rank)) + o) =
            *reinterpret_cast<const float4*>(dgs + o);
      }
    }
    mark(t, 5, true);
    if (t > 0) {
      // (p) the cluster's share of dh_{t-1}, read by every block in step t-1
      cluster_sync();  // every block of the cluster has its dgates in every copy
      mark(t, 6, false);
      const int nct = L.nip / 8;
      float* pt = part_at(t);
      if (nct % 8 == 0) {
        bwd_partials<8, kResident, kSplit>(dgs, smem, L, wh, B, H, u, ck, i0, jc, ncl, pt);
      } else if (nct % 4 == 0) {
        bwd_partials<4, kResident, kSplit>(dgs, smem, L, wh, B, H, u, ck, i0, jc, ncl, pt);
      } else if (nct % 2 == 0) {
        bwd_partials<2, kResident, kSplit>(dgs, smem, L, wh, B, H, u, ck, i0, jc, ncl, pt);
      } else {
        bwd_partials<1, kResident, kSplit>(dgs, smem, L, wh, B, H, u, ck, i0, jc, ncl, pt);
      }
      mark(t, 7, true);
      step_arrive(counter);
      mark(t, 8, false);
    } else {
      __syncthreads();  // dgs is written
    }
    // dxproj[t] off the chain, from this block's columns of dg: each row's u
    // units of a gate as one run, rounded (bf16) only as it is emitted. The
    // next step's derivatives overwrite them only after its wait, which every
    // block of the cluster passes after its partials have read this step's.
    for (int e = tid; e < B * L.nb4; e += kThreads) {
      const int b = e >> (ush + 2);  // nb4 = 4u
      const int c = e & (L.nb4 - 1);
      const int g = c >> ush;
      const int j = j0 + (c & (u - 1));
      if (j < H)
        st_stream(dx + ((size_t)b * T + t) * G + g * H + j, dgs[b * L.ldg + rank * L.nbp + c]);
    }
  }
  if (tracer) {
    walk_trace[kTraceSteps * kTracePoints + 2] = clock64();
    walk_trace[kTraceSteps * kTracePoints + 3] = global_ns();
  }
  cluster_sync();  // no block leaves while another may read its shared memory
}

// The reverse walk's kernel for a plan's resident and split.
template <typename S>
const void* bwd_kernel(int resident, int split) {
  return resident ? (split ? reinterpret_cast<const void*>(bwd_walk<true, true, S>)
                           : reinterpret_cast<const void*>(bwd_walk<true, false, S>))
                  : reinterpret_cast<const void*>(bwd_walk<false, false, S>);
}


// Launch the reverse walk of kDirs directions (1 or 2) as one cooperative
// kernel on `stream`: grid (ceil(H / a.units), kDirs) in clusters of
// a.cluster blocks (1: no cluster), kThreads threads and smem_bytes of
// dynamic shared memory per block, the Wh slices resident in shared memory
// when `resident` is set, as TF32 hi and lo parts when `split` is. a.sync
// holds kDirs zeroed counters, a.part part_floats floats. ops/lstm.py
// bwd_plan picks units, cluster, resident, split and smem_bytes and sizes
// a.part. Returns the CUDA error: cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident at once (the kernel then never runs),
// cudaErrorInvalidValue for a plan this kernel does not take, and for a.part
// of another size than the kernel indexes. Does not synchronise. A template,
// so that only the sources that launch the backward compile its kernels. S:
// the stream type.
template <int kDirs, typename S = float>
int run_bwd_walk(const BwdArgs<S>& a, int part_floats, int resident, int split, int smem_bytes,
                 void* stream) {
  static_assert(kDirs == 1 || kDirs == 2, "one or two directions");
  const int u = a.units, C = a.cluster;
  if (!walk_takes(a.B, a.T, a.H, u)) return (int)cudaErrorInvalidValue;
  const int blocks = (a.H + u - 1) / u;
  if ((C != 1 && C != 2 && C != 4 && C != 8) || blocks % C != 0 || (split && !resident))
    return (int)cudaErrorInvalidValue;
  const BwdLayout l = bwd_layout(a.H, u, a.B, C, resident != 0, split != 0);
  if ((size_t)l.total * sizeof(float) > (size_t)smem_bytes || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the partials bwd_walk indexes: [2, kDirs, blocks, blocks / C, B, u]
  if (part_floats < 0 ||
      (size_t)part_floats != (size_t)2 * kDirs * blocks * (blocks / C) * a.B * u)
    return (int)cudaErrorInvalidValue;
  const void* kernel = bwd_kernel<S>(resident, split);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg =
      walk_config(dim3((unsigned int)blocks, kDirs), C, smem_bytes, stream, attrs);
  void* params[] = {const_cast<BwdArgs<S>*>(&a)};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, params);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error for the next one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of the reverse walk (grid x `blocks`,
// kDirs directions) can be resident at once with smem_bytes of dynamic
// shared memory each (cudaOccupancyMaxActiveClusters), or minus the CUDA
// error. ops/lstm.py bwd_plan takes the largest cluster at which all of them
// are.
template <int kDirs, typename S = float>
int bwd_max_clusters(int blocks, int cluster, int resident, int split, int smem_bytes) {
  if (cluster < 1 || blocks <= 0 || blocks % cluster != 0 || smem_bytes > kMaxSmem)
    return -(int)cudaErrorInvalidValue;
  const void* kernel = bwd_kernel<S>(resident, split);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t cfg =
      walk_config(dim3((unsigned int)blocks, kDirs), cluster, smem_bytes, nullptr, attrs);
  cfg.attrs = attrs + 1;  // the cluster alone
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return -(int)e;
  }
  return n;
}

}  // namespace
