// Bidirectional LSTM layer forward over hoisted input projections, for
// Hopper (sm_90a), with float32 or bf16 streams (lstm_bidi_fwd_bf16).
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _bidi_fwd_kernel (called by lstm_bidi_pallas): both directions of one
// BLSTM layer advance in one time walk; gates i,f,g,o with forget_bias
// added to f; a masked (pad) step carries h and c through and emits 0.
// The backward direction's xproj arrives already reversed over each row's
// valid prefix, so both directions walk t = 0..T-1 under one mask.
//
// The kernel, what bounds it and its design are in lstm_step.cuh (fwd_walk):
// one persistent cooperative launch per call, grid (H / u, 2), each block
// holding its units' Wh columns in shared memory for all T steps, taking
// h_{t-1} of every batch row from the exchange buffer its direction's blocks
// write, and meeting them at a grid barrier once per step. The two
// directions never read each other's h, so each has its own barrier counter.
// At H = 512 the plan (ops/lstm.py fwd_plan) takes u = 8: 128 blocks on 132
// SMs, one block per SM, each with its Wh columns resident for the tensor
// cores' product of every row of a step in one pass (132 KB as TF32 hi and
// lo parts).

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// xf, xb [B, T, 4H]; whf, whb [H, 4H]; mask [B, T]; ysf, ysb [B, T, H]
// (written in full); csf, csb [B, T, H] written in full, or both null to
// skip the cell-state stream (serving); sync [2] unsigned counters, zeroed
// by the caller; hbuf, the h exchange of hbuf_floats floats ([2, 2, B, H],
// no need to zero it). hbuf_floats, units, resident, rows and smem_bytes are
// the launch plan of ops/lstm.py fwd_plan. Launches one cooperative kernel
// on `stream` and returns its CUDA error (0 when it was accepted). Does not
// synchronise.
int lstm_bidi_fwd(const float* xf, const float* xb, const float* whf, const float* whb,
                  const float* mask, float* ysf, float* ysb, float* csf, float* csb,
                  unsigned int* sync, float* hbuf, int hbuf_floats, int B, int T, int H,
                  int units, int resident, int rows, int smem_bytes, float forget_bias,
                  void* stream) {
  if ((csf == nullptr) != (csb == nullptr)) return (int)cudaErrorInvalidValue;
  const FwdArgs<float> a{{xf, xb}, {whf, whb}, {ysf, ysb}, {csf, csb}, mask, sync, hbuf,
                         B, T, H, units, forget_bias};
  return run_fwd_walk<2>(a, hbuf_floats, resident, rows, smem_bytes, stream);
}

// lstm_bidi_fwd with bf16 streams (compute_dtype: bfloat16; the Pallas
// kernel's stream dtype): xf, xb, ysf, ysb, csf, csb are contiguous bf16;
// whf, whb, mask and hbuf float32, and the walk itself float32 (the bf16
// xproj upcast as it is read, ys = h * m and cs rounded as they are
// written). The other arguments as lstm_bidi_fwd.
int lstm_bidi_fwd_bf16(const __nv_bfloat16* xf, const __nv_bfloat16* xb, const float* whf,
                       const float* whb, const float* mask, __nv_bfloat16* ysf,
                       __nv_bfloat16* ysb, __nv_bfloat16* csf, __nv_bfloat16* csb,
                       unsigned int* sync, float* hbuf, int hbuf_floats, int B, int T, int H,
                       int units, int resident, int rows, int smem_bytes, float forget_bias,
                       void* stream) {
  if ((csf == nullptr) != (csb == nullptr)) return (int)cudaErrorInvalidValue;
  const FwdArgs<__nv_bfloat16> a{{xf, xb}, {whf, whb}, {ysf, ysb}, {csf, csb}, mask, sync,
                                 hbuf, B, T, H, units, forget_bias};
  return run_fwd_walk<2>(a, hbuf_floats, resident, rows, smem_bytes, stream);
}

// The step trace of this source's forward walks (lstm_step.cuh fwd_walk):
// on != 0 turns it on for the following launches, 0 off; with out non-null,
// copies the last traced launch's values (kTraceFloats long longs) to host
// memory at out. Returns the CUDA error.
int lstm_bidi_fwd_trace(int on, long long* out) { return walk_trace_ctl(on, out); }

const char* asr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
