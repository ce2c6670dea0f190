// Unidirectional LSTM layer forward over hoisted input projections, for
// Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _fwd_kernel (called by lstm_layer_pallas through _fwd_call): one LSTM
// direction over xproj [B, T, 4H] = x @ Wx + b; gates i,f,g,o with
// forget_bias added to f; a masked (pad) step carries h and c through and
// writes ys[t] = h * m = 0; cs[t] holds the carried c when the caller asks
// for it (training).
//
// The step kernel, what bounds it and its design are in lstm_step.cuh; this
// is its one-direction launch (grid depth 1, no dummy second direction).
// Bound at B = 8, T = 400, H = 512: 2 B H 4H T float32 operations, 0.10 ms
// at 67 TFLOP/s, far below one launch per step.
//
// Tile choice. One direction has half the blocks of the bidirectional
// kernel, so the 8-unit tile of lstm_bidi_fwd.cu would give 64 blocks at
// H = 512, B = 8 and leave half of the 132 SMs idle on a latency-bound
// chain. Here a block owns kUnits = 4 units (8 lanes split k inside a
// warp): 128 blocks at B = 8 and 512 at B = 32, each with half the
// per-step work of a bidirectional block. ptxas (-Xptxas -v, sm_90a, CUDA
// 12.8) for fwd_step<4>: 74 registers, no spills, no static shared memory;
// dynamic shared memory (8 H + 1024) floats, 20 KB at H = 512. At 74
// registers x 256 threads three blocks fit an SM, so 512 blocks (B = 32)
// run in about 1.3 waves and 128 blocks (B = 8) in one.

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// x [B, T, 4H]; wh [H, 4H]; mask [B, T]; ys [B, T, H] (written in full);
// cs [B, T, H] written in full, or null to skip the cell-state stream
// (serving); hbuf [2, B, H] and cbuf [B, H], zeroed by the caller.
// Launches T kernels on `stream` and returns the first CUDA error (0 when
// every launch was accepted). Does not synchronise.
int lstm_layer_fwd(const float* x, const float* wh, const float* mask, float* ys, float* cs,
                   float* hbuf, float* cbuf, int B, int T, int H, float forget_bias,
                   void* stream) {
  return run_fwd<4>(x, nullptr, wh, nullptr, mask, ys, nullptr, cs, nullptr, hbuf, cbuf, 1, B,
                    T, H, forget_bias, stream);
}

}  // extern "C"
