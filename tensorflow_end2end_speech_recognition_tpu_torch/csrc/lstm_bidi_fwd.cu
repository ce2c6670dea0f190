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
// The step kernel, what bounds it and its design are in lstm_step.cuh. Here
// a block owns kUnits = 8 hidden units of one direction for 8 batch rows:
// grid (H / 8, 2, ceil(B / 8)), 128 blocks at H = 512, B = 8. A layer is T
// launches (about 5 x T per utterance batch for a 5-layer encoder).

#include "lstm_step.cuh"

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
  if ((csf == nullptr) != (csb == nullptr)) return (int)cudaErrorInvalidValue;
  return run_fwd<8>(xf, xb, whf, whb, mask, ysf, ysb, csf, csb, hbuf, cbuf, 2, B, T, H,
                    forget_bias, stream);
}

const char* asr_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
