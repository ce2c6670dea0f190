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
// where it is loaded (the staged ys[t-1] rows of the backward's gate
// product too, so the shared-memory layout and the plans are those of the
// float walks), and a result is rounded to nearest even only where it is
// stored: ys = h * m and cs in the forward, dxproj in the backward. The
// forward's h_{t-1} comes from the float32 exchange, never from the bf16
// ys, and the backward's dh = dgates @ Wh^T from the float32 dgates, as
// the reference carries both in float32. The recurrent products stay
// float32 FFMA: Wh and h are float32 in the reference.
//
// The bf16-product walk (kBf16Product, lstm_layer_fwd_carry_bf16). A
// streaming chunk at compute_dtype bfloat16 leaves the Pallas kernel for the
// scan branch of rnn_scan (models/rnn.py _lstm_step), whose step is
// xproj[t] + bf16(h_{t-1}) @ bf16(Wh) with float32 accumulation, float32
// streams and float32 carries. The carried walk takes that step with one
// more template flag: Wh is rounded to bf16 as it is staged (load_wc<true>,
// or as it is read when not resident) and h_{t-1} (h0 at step 0) as it is
// staged from the exchange buffer; the products of two bf16 values are exact
// in float32, and every sum stays float32, so the walk differs from XLA's dot
// only in the order of its float32 sums. Everything else is the float32
// carried walk.
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
// the Wh columns of its units' four gates, Wc [H, 4u] (rows padded to 4u + 4
// floats). At H = 512 that is 72 KB for u = 8 (the bidirectional calls:
// 64 x 2 = 128 blocks) and 40 KB for u = 4 (one direction: 128 blocks).
// Where Wc does not fit shared memory (H = 1536) the same kernels read it
// through L2 (kResident false). The launch is cooperative, so all blocks
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
//  - per chunk of kRows batch rows (8 for a batch of up to 8, the serving
//    batch, so that no row tile idles: the threads it frees split k
//    further; else 32), h_{t-1} of the chunk, staged through shared memory
//    from the exchange buffer, times Wc (gate_product below);
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
// operations per direction: 1.05 MFLOP per block at B = 32, H = 512, u = 8,
// about 2 us at 67 TFLOP/s over 132 SMs, and 64 KB of h_{t-1} read through
// L2 per block. The step is a chain (barrier, L2 read, product, epilogue,
// fence), so its latency, not either rate, sets the pace (PERF.md).
//
// Backward design (bwd_walk, run_bwd_walk). Per step t = T-1 .. 0 and per
// chunk of 32 batch rows:
//  (b) gates at t: ys[t-1] rows, staged through shared memory, times Wc.
//      This reads only the forward's outputs, so it runs before the wait.
//  (a) dh_t of the block's units: the sum, in block order, of the partials
//      P_{t+1} that every block of the direction wrote in step t+1.
//  (c) gate derivatives, one thread per (row, unit): write the four
//      dxproj[t] entries of the unit (zero on a masked step, which carries
//      dh and dc through); the dh and dc carries stay in registers.
//  (p) this block's share of dh_{t-1} = dgates_t @ Wh^T for all H units:
//      P_t = dgates_t[:, own 4u columns] @ Wc^T, [32, H], which the block
//      has in shared memory; each reader block's u columns go to a scratch
//      buffer (two steps deep, by parity), then the block arrives.
// dh is thus formed where the dgates are, from the columns already resident:
// per block and step 64 KB of partials written and 64 KB read through L2,
// where reading every block's dgates_{t+1} (the TPU kernel's dgates @ Wh^T
// with the rows of Wh resident) moves 256 KB per block and step at B = 32
// through the load/store unit that the products also need. Partials are
// written and read inside the launch, so they are read with ld.global.cg
// (L2), never __ldg.
// Every product is float32 FFMA, each sum in a fixed order (k slices, then
// blocks): two calls give equal bits. dWh is one [T*B] contraction outside
// (ops/lstm.py), as on the TPU.
//
// What bounds the backward on this card. Each step needs 2 x 2 B H 4H float
// operations per direction (gates recomputed, dh product): 1.05 MFLOP per
// block at B = 32, H = 512, about 4 us at 67 TFLOP/s over 132 SMs. The
// products run from shared memory at about 8 (gate product) and 4 (dh
// partials) 16-byte loads per 64 FFMA, so the load/store unit, not the
// FFMA pipe, sets their pace; with the barrier and the L2 round trips of
// the staged rows and partials a step takes 15-20 us (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ void st_stream(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to bf16 (nearest even) and widened back: an operand of the
// bf16-product walk (kBf16Product), whose products of two such values are
// exact in float32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBwdRows = 32;            // batch rows per chunk of the backward
constexpr int kRowTiles = kBwdRows / 4;  // 4-row tiles and float4 row groups of a chunk
constexpr int kBwdKC = 256;             // k per staged chunk of the gate product
constexpr int kBwdStride = kBwdKC + 4;  // floats per staged row: rows 4 banks apart
constexpr int kBwdMaxCols = 128;        // columns of one gate-product pass: 8 x 32 tiles
constexpr int kBwdMaxPairs = 8;         // (row, unit) carries a thread keeps in registers
constexpr int kBwdRed = kThreads * 16;  // partial sums: one 4 x 4 tile per thread

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
// (ld.global.cg); otherwise rows written by an earlier launch (the
// backward's ys), read through the non-coherent path.
// bf16 source rows (the backward's ys under bf16 streams) are never written
// in the launch: 4 values as one 8-byte load, widened to float4.
template <bool kCoherent>
__device__ __forceinline__ float4 src_load4(const float* p) {
  return kCoherent ? __ldcg(reinterpret_cast<const float4*>(p))
                   : __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kCoherent>
__device__ __forceinline__ float4 src_load4(const __nv_bfloat16* p) {
  static_assert(!kCoherent, "bf16 rows come from an earlier launch");
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

template <bool kCoherent>
__device__ __forceinline__ float src_load(const float* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}

template <bool kCoherent>
__device__ __forceinline__ float src_load(const __nv_bfloat16* p) {
  static_assert(!kCoherent, "bf16 rows come from an earlier launch");
  return ld_stream(p);
}

// The gate product for a chunk's rows:
// out[r][c0 + c] = sum_k h[b0 + r][k] Wc[k][c0 + c], r < kRows, c < n <=
// kBwdMaxCols, with h row b at src + b * src_row and Wc[k][g u + uu] =
// Wh[k, g H + j0 + uu], resident at wsm [hp, ldw]. The h rows are staged
// through shared memory in chunks of kBwdKC. A thread owns one 4 x 4 tile of
// out, rows rt + i kRows / 4 for i < 4 (at kRows = 32 the 8 lanes of a
// quarter warp read 8 rows on distinct banks) and 4 adjacent columns, in
// one of kThreads / tiles slices of every chunk: fewer rows, more slices.
// The slices' sums are added in slice order. Src is float (the h exchange,
// the float backward's ys) or __nv_bfloat16 (the bf16 backward's ys, upcast
// as it is staged). kRound (the bf16-product walk): every staged h value is
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

// Dynamic shared memory of one forward block, offsets and size in floats,
// for kRows = rows; hp, nb and ldw as in bwd_layout.
struct FwdLayout {
  int hp, nb, ldw;
  int wc, stage, red, gpre, total;
};

__host__ __device__ inline FwdLayout fwd_layout(int H, int u, int rows, bool resident) {
  FwdLayout l;
  l.hp = (H + 3) / 4 * 4;
  l.nb = 4 * u;
  l.ldw = l.nb + 4;
  l.wc = 0;                                        // [hp, ldw]: Wh columns of the units
  l.stage = l.wc + (resident ? l.hp * l.ldw : 0);  // 2 x [rows, kBwdStride]
  l.red = l.stage + 2 * rows * kBwdStride;         // [kBwdRed]
  l.gpre = l.red + kBwdRed;                        // [rows, nb]: h_{t-1} @ Wc
  l.total = l.gpre + rows * l.nb;
  return l;
}

// kCarry: the walk resumes from a.h0 / a.c0 and writes a.hT / a.cT (any of
// them may be null); the walks that start from zeros are compiled without it.
// kBf16Product: the gate product takes bf16 operands, h_{t-1} (h0 at step 0)
// and Wh each rounded to bf16 as they are staged, with float32 products and
// sums (lstm_layer_fwd_carry_bf16: the bf16 branch of the reference's
// _lstm_step, which a streaming chunk at compute_dtype bfloat16 runs);
// streams, carries and gate math stay float32.
template <bool kResident, int kRows, bool kCarry, typename S, bool kBf16Product = false>
__global__ void __launch_bounds__(kThreads, 1) fwd_walk(const FwdArgs<S> a) {
  extern __shared__ float4 fwd_smem4[];
  float* smem = reinterpret_cast<float*>(fwd_smem4);
  const int dir = blockIdx.y;
  const int B = a.B, T = a.T, H = a.H, u = a.units, G = 4 * H;
  const int j0 = blockIdx.x * u;
  const int tid = threadIdx.x;
  const FwdLayout L = fwd_layout(H, u, kRows, kResident);
  const float* wsm = smem + L.wc;
  float* stage = smem + L.stage;
  float* red = smem + L.red;
  float* gpre = smem + L.gpre;

  const S* __restrict__ x = dir ? a.x[1] : a.x[0];
  const float* __restrict__ wh = dir ? a.wh[1] : a.wh[0];
  const float* __restrict__ mask = a.mask;
  S* ys = dir ? a.ys[1] : a.ys[0];
  S* cs = dir ? a.cs[1] : a.cs[0];
  unsigned int* counter = a.sync + dir;
  const int blocks = gridDim.x;
  const size_t state = (size_t)gridDim.y * B * H;  // one step parity of hbuf
  float* hdir = a.hbuf + (size_t)dir * B * H;

  if (kResident) load_wc<kBf16Product>(smem + L.wc, wh, H, u, j0, L.hp, L.nb, L.ldw);

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
      const int b = p / u;
      const int j = j0 + p - b * u;
      if (b < B && j < H) {
        if (h0 != nullptr) h[i] = __ldg(h0 + (size_t)b * H + j);
        if (c0 != nullptr) c[i] = __ldg(c0 + (size_t)b * H + j);
      }
    }
  }

  for (int t = 0; t < T; ++t) {
    // xproj[t] and mask[t] of the thread's pairs: no other block writes them
    float xv[kBwdMaxPairs][4], mv[kBwdMaxPairs];
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p / u;
      const int j = j0 + p - b * u;
      xv[i][0] = xv[i][1] = xv[i][2] = xv[i][3] = mv[i] = 0.0f;
      if (b < B && j < H) {
        const size_t bt = (size_t)b * T + t;
        const S* xt = x + bt * G + j;
        xv[i][0] = ld_stream(xt), xv[i][1] = ld_stream(xt + H);
        xv[i][2] = ld_stream(xt + 2 * H), xv[i][3] = ld_stream(xt + 3 * H);
        mv[i] = __ldg(mask + bt);
      }
    }
    const float* hprev = hdir + (size_t)(t & 1) * state;  // h_{t-1}, written in step t-1
    float* hnext = hdir + (size_t)((t + 1) & 1) * state;
    // every block of the direction has written h_{t-1}; h_{-1} is h0, an
    // input that every block reads in place (no exchange, no barrier), or 0
    if (t > 0) step_wait(counter, blocks * (unsigned int)t);
    const float* hsrc = t > 0 ? hprev : h0;
    const bool product = kCarry ? hsrc != nullptr : t > 0;
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      if (product) {
        for (int k0 = 0; k0 < L.nb; k0 += kBwdMaxCols)
          gate_product<kResident, kRows, true, float, kBf16Product>(
              hsrc, (size_t)H, wsm, wh, k0, min(kBwdMaxCols, L.nb - k0), L.ldw, j0, u, b0, rows,
              H, L.hp, stage, red, gpre, L.nb);
      } else {
        for (int i = tid; i < kRows * L.nb; i += kThreads) gpre[i] = 0.0f;
        __syncthreads();
      }
      // epilogue, one thread per (row, unit) of the chunk
#pragma unroll
      for (int i = 0; i < kBwdMaxPairs; ++i) {
        const int p = tid + i * kThreads;
        const int b = p / u;
        const int uu = p - b * u;
        const int j = j0 + uu;
        if (b < b0 || b >= b0 + rows || j >= H) continue;
        const float* gp = gpre + (b - b0) * L.nb + uu;
        const float ig = sigmoid(xv[i][0] + gp[0]);
        const float fg = sigmoid(xv[i][1] + gp[u] + a.forget_bias);
        const float gg = tanhf(xv[i][2] + gp[2 * u]);
        const float og = sigmoid(xv[i][3] + gp[3 * u]);
        const float c_new = fg * c[i] + ig * gg;
        const float h_new = og * tanhf(c_new);
        const float m = mv[i];
        if (m > 0.0f) {
          h[i] = h_new;
          c[i] = c_new;
        }
        const size_t bt = (size_t)b * T + t;
        st_stream(ys + bt * H + j, h[i] * m);
        if (cs != nullptr) st_stream(cs + bt * H + j, c[i]);
        hnext[(size_t)b * H + j] = h[i];
      }
      __syncthreads();  // gpre is consumed
    }
    step_arrive(counter);
  }

  if constexpr (kCarry) {
    // the carried state after the last step (a masked step carried it through)
    float* hT = dir ? a.hT[1] : a.hT[0];
    float* cT = dir ? a.cT[1] : a.cT[0];
#pragma unroll
    for (int i = 0; i < kBwdMaxPairs; ++i) {
      const int p = tid + i * kThreads;
      const int b = p / u;
      const int j = j0 + p - b * u;
      if (b >= B || j >= H) continue;
      if (hT != nullptr) hT[(size_t)b * H + j] = h[i];
      if (cT != nullptr) cT[(size_t)b * H + j] = c[i];
    }
  }
}

// Launch the forward walk of kDirs directions (1 or 2) as one cooperative
// kernel on `stream`: grid (ceil(H / a.units), kDirs), kThreads threads,
// `rows` batch rows per chunk (8 or 32) and smem_bytes of dynamic shared
// memory per block, the Wh slice resident in shared memory when `resident`
// is set. a.sync holds kDirs zeroed counters, a.hbuf hbuf_floats floats.
// kCarry: the walk that resumes from a.h0 / a.c0 and writes a.hT / a.cT
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
  if (rows != 8 && rows != 32) return (int)cudaErrorInvalidValue;
  const FwdLayout l = fwd_layout(a.H, a.units, rows, resident != 0);
  if ((size_t)l.total * sizeof(float) > (size_t)smem_bytes || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the exchange fwd_walk indexes: [2, kDirs, B, H]
  if (hbuf_floats < 0 || (size_t)hbuf_floats != 2 * (size_t)kDirs * a.B * a.H)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      rows == 8
          ? (resident ? reinterpret_cast<const void*>(fwd_walk<true, 8, kCarry, S, kBf16Product>)
                      : reinterpret_cast<const void*>(fwd_walk<false, 8, kCarry, S, kBf16Product>))
          : (resident
                 ? reinterpret_cast<const void*>(fwd_walk<true, 32, kCarry, S, kBf16Product>)
                 : reinterpret_cast<const void*>(fwd_walk<false, 32, kCarry, S, kBf16Product>));
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned int)((a.H + a.units - 1) / a.units), kDirs);
  void* params[] = {const_cast<FwdArgs<S>*>(&a)};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, dim3(kThreads), params,
                                                    (size_t)smem_bytes,
                                                    static_cast<cudaStream_t>(stream));
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
  float* part;          // dh partials [2 (step parity), dirs, blocks (reader), blocks (writer),
                        //   u, B rounded up to kBwdRows]: written and read inside the launch
  int B, T, H, units;
  float forget_bias;
};

// Dynamic shared memory of one block, offsets and size in floats. hp is H
// rounded up to 4 (float4 reads; the padding is zero), nb = 4u the columns
// of the block's units' gates, ldw = nb + 4 the row stride of the resident
// Wh columns (rows 4 banks apart for the dh partials' reads).
struct BwdLayout {
  int hp, nb, ldw;
  int wc, stage, red, gpre, dhn, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int H, int u, bool resident) {
  BwdLayout l;
  l.hp = (H + 3) / 4 * 4;
  l.nb = 4 * u;
  l.ldw = l.nb + 4;
  l.wc = 0;                                          // [hp, ldw]: Wh columns of the units
  l.stage = l.wc + (resident ? l.hp * l.ldw : 0);    // 2 x [kBwdRows, kBwdStride]
  l.red = l.stage + 2 * kBwdRows * kBwdStride;       // [kBwdRed]
  l.gpre = l.red + kBwdRed;                          // [kBwdRows, nb]: gates, then dgates
  l.dhn = l.gpre + kBwdRows * l.nb;                  // [kBwdRows, u]: dh from step t+1
  l.total = l.dhn + kBwdRows * u;
  return l;
}

// (p) This block's share of dh_{t-1} = dgates_t @ Wh^T for every unit i of the
// direction: P[r][i] = sum_c dg[r][c] Wc[i][c] over the block's nb gate
// columns c, with dg [kBwdRows, nb] in shared memory. P[r][i] goes to the
// reader block dst = i / u at part + ((dst * blocks + src) * u + i % u) * bc
// + b0 + r. A thread owns 8 rows (two float4 groups of 4, 16 apart) x 8
// units i = 256 cg + ib + 32 m (the lanes of a warp read 32 consecutive Wc
// rows, 4 banks apart): K = nb is short, so there is no k split. The tiles
// of two column groups (512 units) are transposed through pbuf [512,
// kPartStride] so that each unit's 32 rows go out as one 128-byte run.
constexpr int kPartStride = kBwdRows + 4;  // rows 4 banks apart
static_assert(2 * kBwdRows * kBwdStride + kBwdRed >= 512 * kPartStride,
              "pbuf (the staging buffer and red) holds two column groups");

template <bool kResident>
__device__ void dh_partials(const float* dg, const float* wsm, const float* __restrict__ wh,
                            float* part, float* pbuf, int blocks, int src, int j0, int u, int H,
                            int nb, int ldw, int bc, int b0) {
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int groups = (H + 255) / 256;
  for (int cg0 = 0; cg0 < groups; cg0 += 2) {
    if (tid < min(2, groups - cg0) * 128) {
      const int ib = tid % 32;
      const int rb = (tid / 32) % 4;
      const int il0 = (tid / 128) * 256 + ib;  // unit of m = 0 within the pair of groups
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int m = 0; m < 8; ++m) acc[r][m] = 0.0f;
      for (int k = 0; k < nb; k += 4) {
        float w[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int i = cg0 * 256 + il0 + 32 * m;
          if (kResident) {
            const float4 wv = i < H ? *reinterpret_cast<const float4*>(wsm + (size_t)i * ldw + k)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            w[m][0] = wv.x, w[m][1] = wv.y, w[m][2] = wv.z, w[m][3] = wv.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int g = (k + e) / u;
              const int j = j0 + k + e - g * u;
              w[m][e] = i < H && j < H ? __ldg(wh + (size_t)i * G + g * H + j) : 0.0f;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 av = *reinterpret_cast<const float4*>(
              dg + (rb * 4 + (r & 3) + (r >> 2) * 16) * nb + k);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            acc[r][m] = fmaf(av.x, w[m][0], acc[r][m]);
            acc[r][m] = fmaf(av.y, w[m][1], acc[r][m]);
            acc[r][m] = fmaf(av.z, w[m][2], acc[r][m]);
            acc[r][m] = fmaf(av.w, w[m][3], acc[r][m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        float* q = pbuf + (il0 + 32 * m) * kPartStride + rb * 4;
        *reinterpret_cast<float4*>(q) = make_float4(acc[0][m], acc[1][m], acc[2][m], acc[3][m]);
        *reinterpret_cast<float4*>(q + 16) =
            make_float4(acc[4][m], acc[5][m], acc[6][m], acc[7][m]);
      }
    }
    __syncthreads();
    const int units = min(512, H - cg0 * 256);
    for (int w = tid; w < units * kRowTiles; w += kThreads) {
      const int il = w / kRowTiles;
      const int r4 = w - il * kRowTiles;
      const int i = cg0 * 256 + il;
      const int dst = i / u;
      *reinterpret_cast<float4*>(part + ((size_t)(dst * blocks + src) * u + i - dst * u) * bc +
                                 b0 + r4 * 4) =
          *reinterpret_cast<const float4*>(pbuf + il * kPartStride + r4 * 4);
    }
    __syncthreads();
  }
}

// (a) dh_t of the block's units for the chunk's rows: the sum, in block
// order, of every block's partial, part [blocks, u, bc] (this block's reader
// slot; written by other blocks in this launch, so read with ld.global.cg,
// never __ldg). Outputs go by float4 groups (unit, 4 rows); the blocks are
// split into slices across threads, and the slices' sums are added in order.
__device__ void dh_sum(const float* part, int blocks, int u, int bc, int b0, float* red,
                       float* dhn) {
  const int tid = threadIdx.x;
  const int groups = u * kRowTiles;
  const int slices = max(1, kThreads / groups);
  const int per = (blocks + slices - 1) / slices;
  for (int w = tid; w < groups * slices; w += kThreads) {
    const int sl = w / groups;
    const int og = w - sl * groups;
    const int uu = og / kRowTiles;
    const float* p = part + (size_t)uu * bc + b0 + (og - uu * kRowTiles) * 4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int hi = min(blocks, (sl + 1) * per);
    for (int s = sl * per; s < hi; ++s) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + (size_t)s * u * bc));
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    reinterpret_cast<float4*>(red)[w] = acc;
  }
  __syncthreads();
  for (int o = tid; o < groups * 4; o += kThreads) {
    const int og = o / 4;
    const int uu = og / kRowTiles;
    const int r = (og - uu * kRowTiles) * 4 + o % 4;
    float sum = 0.0f;
    for (int sl = 0; sl < slices; ++sl) sum += red[(sl * groups + og) * 4 + o % 4];
    dhn[r * u + uu] = sum;
  }
}

template <bool kResident, typename S>
__global__ void __launch_bounds__(kThreads, 1) bwd_walk(const BwdArgs<S> a) {
  extern __shared__ float4 bwd_smem4[];
  float* smem = reinterpret_cast<float*>(bwd_smem4);
  const int dir = blockIdx.y;
  const int B = a.B, T = a.T, H = a.H, u = a.units, G = 4 * H;
  const int j0 = blockIdx.x * u;
  const int tid = threadIdx.x;
  const BwdLayout L = bwd_layout(H, u, kResident);
  const float* wsm = smem + L.wc;
  float* stage = smem + L.stage;
  float* red = smem + L.red;
  float* gpre = smem + L.gpre;
  float* dhn = smem + L.dhn;

  const S* __restrict__ x = dir ? a.x[1] : a.x[0];
  const float* __restrict__ wh = dir ? a.wh[1] : a.wh[0];
  const S* __restrict__ ys = dir ? a.ys[1] : a.ys[0];
  const S* __restrict__ cs = dir ? a.cs[1] : a.cs[0];
  const S* __restrict__ gys = dir ? a.gys[1] : a.gys[0];
  const float* __restrict__ mask = a.mask;
  S* dx = dir ? a.dx[1] : a.dx[0];
  unsigned int* counter = a.sync + dir;
  const int blocks = gridDim.x;
  const int bc = (B + kBwdRows - 1) / kBwdRows * kBwdRows;
  const size_t slot = (size_t)blocks * u * bc;  // one reader block's partials of one step
  // this direction's partials of step t: [blocks (reader), blocks (writer), u, bc]
  auto partials = [&](int t) {
    return a.part + ((size_t)(t & 1) * gridDim.y + dir) * blocks * slot;
  };

  if (kResident) load_wc(smem + L.wc, wh, H, u, j0, L.hp, L.nb, L.ldw);  // for all T steps

  float dh[kBwdMaxPairs], dc[kBwdMaxPairs];
#pragma unroll
  for (int i = 0; i < kBwdMaxPairs; ++i) dh[i] = dc[i] = 0.0f;

  for (int t = T - 1; t >= 0; --t) {
    for (int b0 = 0; b0 < B; b0 += kBwdRows) {
      const int rows = min(kBwdRows, B - b0);
      // (b) gate pre-activations at t; h_{-1} = 0
      if (t > 0) {
        for (int c0 = 0; c0 < L.nb; c0 += kBwdMaxCols)
          gate_product<kResident, kBwdRows, false, S>(ys + (size_t)(t - 1) * H, (size_t)T * H,
                                                      wsm, wh, c0,
                                  min(kBwdMaxCols, L.nb - c0), L.ldw, j0, u, b0, rows, H, L.hp,
                                  stage, red, gpre, L.nb);
      } else {
        for (int i = tid; i < kBwdRows * L.nb; i += kThreads) gpre[i] = 0.0f;
      }
      // (a) dh_t = dgates_{t+1} @ Wh^T for the block's units: every block's
      // partial, written in step t+1
      if (t + 1 < T) {
        if (b0 == 0) step_wait(counter, blocks * (unsigned int)(T - 1 - t));
        dh_sum(partials(t + 1) + blockIdx.x * slot, blocks, u, bc, b0, red, dhn);
      }
      __syncthreads();
      // (c) gate derivatives, one thread per (row, unit) of the chunk; each
      // unit's four dgates replace its gate pre-activations in gpre
#pragma unroll
      for (int i = 0; i < kBwdMaxPairs; ++i) {
        const int p = tid + i * kThreads;
        const int b = p / u;
        const int uu = p - b * u;
        const int j = j0 + uu;
        if (b < b0 || b >= b0 + rows || j >= H) continue;
        const int r = b - b0;
        const size_t bt = (size_t)b * T + t;
        const S* xt = x + bt * G;
        // every load first, none depending on another: one round trip
        const float xi = ld_stream(xt + j), xf = ld_stream(xt + H + j);
        const float xg = ld_stream(xt + 2 * H + j), xo = ld_stream(xt + 3 * H + j);
        const float m = __ldg(mask + bt);
        const float m_next = t + 1 < T ? __ldg(mask + bt + 1) : 0.0f;
        const float gy = ld_stream(gys + bt * H + j);
        const float c_t = ld_stream(cs + bt * H + j);
        const float c_prev = t > 0 ? ld_stream(cs + (bt - 1) * H + j) : 0.0f;
        float* gp = gpre + r * L.nb + uu;
        const float ig = sigmoid(xi + gp[0]);
        const float fg = sigmoid(xf + gp[u] + a.forget_bias);
        const float gg = tanhf(xg + gp[2 * u]);
        const float og = sigmoid(xo + gp[3 * u]);
        const bool on = m > 0.0f;
        // dh carried from t+1: dgates_{t+1} @ Wh^T after a real step, else
        // the passed-through total (zero before the first real step)
        const float dh_carry = m_next > 0.0f ? dhn[r * u + uu] : dh[i];
        const float dh_tot = (on ? gy : 0.0f) + dh_carry;
        const float tc = tanhf(c_t);
        const float dc_tot = dc[i] + dh_tot * og * (1.0f - tc * tc);
        const float d_o = dh_tot * tc;
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (on) {
          d[0] = dc_tot * gg * ig * (1.0f - ig);
          d[1] = dc_tot * c_prev * fg * (1.0f - fg);
          d[2] = dc_tot * ig * (1.0f - gg * gg);
          d[3] = d_o * og * (1.0f - og);
          dc[i] = dc_tot * fg;
        }
        S* dxt = dx + bt * G;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          st_stream(dxt + g * H + j, d[g]);  // rounded (bf16) only as it is emitted
          gp[g * u] = d[g];                  // the float32 dgates for the dh partials
        }
        dh[i] = dh_tot;
      }
      __syncthreads();
      // (p) this block's share of dh_{t-1}, read by every block in step t-1
      if (t > 0)
        dh_partials<kResident>(gpre, wsm, wh, partials(t), stage, blocks, blockIdx.x, j0, u, H,
                               L.nb, L.ldw, bc, b0);
      __syncthreads();  // gpre and dhn are consumed
    }
    step_arrive(counter);
  }
}

// Launch the reverse walk of kDirs directions (1 or 2) as one cooperative
// kernel on `stream`: grid (ceil(H / a.units), kDirs), kThreads threads and
// smem_bytes of dynamic shared memory per block, the Wh slice resident in
// shared memory when `resident` is set. a.sync holds kDirs zeroed counters,
// a.part part_floats floats. ops/lstm.py bwd_plan picks units, resident and
// smem_bytes and sizes a.part. Returns the CUDA error:
// cudaErrorCooperativeLaunchTooLarge when the blocks cannot all be resident
// at once (the kernel then never runs), cudaErrorInvalidValue for a plan
// this kernel does not take, and for a.part of another size than the
// kernel indexes. Does not synchronise. A template, so that only the
// sources that launch the backward compile its kernels. S: the stream type.
template <int kDirs, typename S = float>
int run_bwd_walk(const BwdArgs<S>& a, int part_floats, int resident, int smem_bytes,
                 void* stream) {
  static_assert(kDirs == 1 || kDirs == 2, "one or two directions");
  const int u = a.units;
  if (!walk_takes(a.B, a.T, a.H, u)) return (int)cudaErrorInvalidValue;
  const BwdLayout l = bwd_layout(a.H, u, resident != 0);
  if ((size_t)l.total * sizeof(float) > (size_t)smem_bytes || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the partials bwd_walk indexes: [2, kDirs, blocks, blocks, u, rows to kBwdRows]
  const size_t blocks = (a.H + u - 1) / u;
  const size_t bc = (size_t)(a.B + kBwdRows - 1) / kBwdRows * kBwdRows;
  if (part_floats < 0 || (size_t)part_floats != 2 * kDirs * blocks * blocks * u * bc)
    return (int)cudaErrorInvalidValue;
  const void* kernel = resident ? reinterpret_cast<const void*>(bwd_walk<true, S>)
                                : reinterpret_cast<const void*>(bwd_walk<false, S>);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned int)blocks, kDirs);
  void* params[] = {const_cast<BwdArgs<S>*>(&a)};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, grid, dim3(kThreads), params,
                                                    (size_t)smem_bytes,
                                                    static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    (void)cudaGetLastError();  // a refused launch leaves no error for the next one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace
