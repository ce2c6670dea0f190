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
// The step kernel, what bounds it and its design are in lstm_step.cuh: one
// launch per reverse step, grid (H / 8, 2, ceil(B / 8)), each step needing
// Wh twice per direction (its columns for the gates, its rows for
// dh_{t-1} = dgates_t @ Wh^T) through L2. Shared memory is
// (8 * H + kRed + 64) floats: about 25 KB at H = 512.

#include "lstm_step.cuh"

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
  return run_bwd<8>(xf, xb, whf, whb, mask, ysf, ysb, csf, csb, gysf, gysb, dxf, dxb, dhbuf,
                    dcbuf, 2, B, T, H, forget_bias, stream);
}

}  // extern "C"
