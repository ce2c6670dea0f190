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
// one persistent cooperative launch per call, grid (H / u, 2), each block
// holding its units' Wh columns in shared memory for all T steps, exchanging
// dh partials with the other blocks of its direction through L2, and meeting
// them at a grid barrier once per step. The two directions never read each
// other's partials, so each has its own barrier counter.
//
// Why one block per SM. A block owns u units of one direction for every
// batch row, so the grid has 2 x H / u blocks and each must be resident for
// the barrier to make progress. On 132 SMs at H = 512 the plan (ops/lstm.py
// bwd_plan) takes u = 8: 128 blocks, each with 512 x (32 + 4) floats = 72 KB
// of Wh resident and 158 KB (161792 B) of dynamic shared memory in all, at
// 207 registers a thread (ptxas -v, sm_90a, CUDA 12.8; 255 and 16 bytes of
// spill in the kResident = false variant), 256 threads: one block per SM.

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// xf, xb [B, T, 4H] (the forward's inputs); whf, whb [H, 4H]; mask [B, T]
// (monotone per row); ysf, ysb, csf, csb [B, T, H] (the forward's outputs);
// gysf, gysb [B, T, H] (cotangents of ys); dxf, dxb [B, T, 4H] (written in
// full); sync [2] unsigned counters, zeroed by the caller; part, scratch of
// part_floats floats for the dh partials. part_floats, units, resident and
// smem_bytes are the launch plan of ops/lstm.py bwd_plan. Launches one
// cooperative kernel on `stream` and returns its CUDA error (0 when it was
// accepted). Does not synchronise.
int lstm_bidi_bwd(const float* xf, const float* xb, const float* whf, const float* whb,
                  const float* mask, const float* ysf, const float* ysb, const float* csf,
                  const float* csb, const float* gysf, const float* gysb, float* dxf, float* dxb,
                  unsigned int* sync, float* part, int part_floats, int B, int T, int H,
                  int units, int resident, int smem_bytes, float forget_bias, void* stream) {
  const BwdArgs<float> a{{xf, xb}, {whf, whb}, {ysf, ysb}, {csf, csb}, {gysf, gysb},
                         {dxf, dxb}, mask, sync, part, B, T, H, units, forget_bias};
  return run_bwd_walk<2>(a, part_floats, resident, smem_bytes, stream);
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
                       int units, int resident, int smem_bytes, float forget_bias,
                       void* stream) {
  const BwdArgs<__nv_bfloat16> a{{xf, xb}, {whf, whb}, {ysf, ysb}, {csf, csb}, {gysf, gysb},
                                 {dxf, dxb}, mask, sync, part, B, T, H, units, forget_bias};
  return run_bwd_walk<2>(a, part_floats, resident, smem_bytes, stream);
}

}  // extern "C"
