// Bidirectional LSTM layer backward over hoisted input projections, for
// Hopper (sm_90a), with float32 or bf16 streams (lstm_bidi_bwd_bf16).
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
// The kernel, what bounds it and its design are in lstm_step.cuh (bwd_walk):
// one persistent cooperative launch per call, grid (H / u, 2) in clusters of
// C blocks of one direction, each block holding its slices of Wh in shared
// memory for all T steps, both per-step products on the tensor cores
// (3xTF32), the dgates summed into dh partials inside each cluster through
// distributed shared memory and exchanged between clusters through L2, and a
// grid barrier once per step. The two directions never read each other's
// partials, so each has its own barrier counter.
//
// Why one block per SM. A block owns u units of one direction for every
// batch row, so the grid has 2 x H / u blocks and each must be resident for
// the barrier to make progress. On 132 SMs at H = 512 the plan (ops/lstm.py
// bwd_plan) takes u = 8: 128 blocks, in clusters of 2 on an H100 (its
// cudaOccupancyMaxActiveClusters holds 15 clusters of 8 and 30 of 4, 120
// SMs, but 66 of 2), each block with 512 x 32 floats of Wc and 256 x 64 of
// Wr resident (146 KB) and 214 KB of dynamic shared memory in all at
// B = 128, 256 threads: one block per SM.

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// xf, xb [B, T, 4H] (the forward's inputs); whf, whb [H, 4H]; mask [B, T]
// (monotone per row); ysf, ysb, csf, csb [B, T, H] (the forward's outputs);
// gysf, gysb [B, T, H] (cotangents of ys); dxf, dxb [B, T, 4H] (written in
// full); sync [2] unsigned counters, zeroed by the caller; part, scratch of
// part_floats floats for the dh partials. part_floats, units, resident,
// split, cluster and smem_bytes are the launch plan of ops/lstm.py bwd_plan. Launches one
// cooperative kernel on `stream` and returns its CUDA error (0 when it was
// accepted). Does not synchronise.
int lstm_bidi_bwd(const float* xf, const float* xb, const float* whf, const float* whb,
                  const float* mask, const float* ysf, const float* ysb, const float* csf,
                  const float* csb, const float* gysf, const float* gysb, float* dxf, float* dxb,
                  unsigned int* sync, float* part, int part_floats, int B, int T, int H,
                  int units, int resident, int split, int cluster, int smem_bytes,
                  float forget_bias, void* stream) {
  const BwdArgs<float> a{{xf, xb}, {whf, whb}, {ysf, ysb}, {csf, csb}, {gysf, gysb},
                         {dxf, dxb}, mask, sync, part, B, T, H, units, cluster, forget_bias};
  return run_bwd_walk<2>(a, part_floats, resident, split, smem_bytes, stream);
}

// lstm_bidi_bwd with bf16 streams (compute_dtype: bfloat16): xf, xb, ysf,
// ysb, csf, csb, gysf, gysb and dxf, dxb are contiguous bf16; whf, whb,
// mask and part float32. The gates are recomputed from the bf16 ys[t-1]
// and cs upcast, dh and dc carried and dh = dgates @ Wh^T formed in
// float32, and dxproj rounded as it is written. The other arguments as
// lstm_bidi_bwd.
int lstm_bidi_bwd_bf16(const __nv_bfloat16* xf, const __nv_bfloat16* xb, const float* whf,
                       const float* whb, const float* mask, const __nv_bfloat16* ysf,
                       const __nv_bfloat16* ysb, const __nv_bfloat16* csf,
                       const __nv_bfloat16* csb, const __nv_bfloat16* gysf,
                       const __nv_bfloat16* gysb, __nv_bfloat16* dxf, __nv_bfloat16* dxb,
                       unsigned int* sync, float* part, int part_floats, int B, int T, int H,
                       int units, int resident, int split, int cluster, int smem_bytes,
                       float forget_bias, void* stream) {
  const BwdArgs<__nv_bfloat16> a{{xf, xb}, {whf, whb}, {ysf, ysb}, {csf, csb}, {gysf, gysb},
                                 {dxf, dxb}, mask, sync, part, B, T, H, units, cluster,
                                 forget_bias};
  return run_bwd_walk<2>(a, part_floats, resident, split, smem_bytes, stream);
}

// How many clusters of `cluster` blocks of lstm_bidi_bwd (bf16 != 0:
// lstm_bidi_bwd_bf16), grid (blocks, 2), can be resident at once with the
// plan's resident, split and smem_bytes; minus the CUDA error on a failure.
int lstm_bidi_bwd_max_clusters(int blocks, int cluster, int resident, int split,
                               int smem_bytes, int bf16) {
  return bf16 ? bwd_max_clusters<2, __nv_bfloat16>(blocks, cluster, resident, split, smem_bytes)
              : bwd_max_clusters<2, float>(blocks, cluster, resident, split, smem_bytes);
}

// The step trace of lstm_bidi_bwd (lstm_step.cuh bwd_walk): on != 0 turns it on
// for the following launches, 0 off; with out non-null, copies the last
// traced launch's values (kTraceFloats long longs) to host memory at out.
// Returns the CUDA error.
int lstm_bidi_bwd_trace(int on, long long* out) { return walk_trace_ctl(on, out); }

}  // extern "C"
