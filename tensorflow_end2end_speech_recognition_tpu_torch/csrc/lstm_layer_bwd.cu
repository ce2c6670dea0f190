// Unidirectional LSTM layer backward over hoisted input projections, for
// Hopper (sm_90a), float32.
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _bwd_kernel (the VJP of lstm_layer_pallas, called through _bwd_call): a
// reverse walk t = T-1 .. 0 that recomputes the gates at t from xproj[t]
// and h_{t-1} = ys[t-1], carries dh and dc, and emits dgates_t as
// dxproj[t] (zero on a masked step, where dh and dc pass straight through).
// dh_{t-1} = dgates_t @ Wh^T is inside the step; dWh is one contraction
// over [T*B] outside (ops/lstm.py), as _bwd_call forms it.
//
// The step kernel, what bounds it and its design are in lstm_step.cuh; this
// is its one-direction launch. Bound at B = 32, T = 400, H = 512:
// 4 B H 4H T float32 operations, 0.80 ms at 67 TFLOP/s.
//
// Tile choice. The backward runs at the train step's batch (B = 32), where
// the 8-unit tile gives (512 / 8) x 4 = 256 blocks. ptxas (-Xptxas -v,
// sm_90a, CUDA 12.8) for bwd_step<8>: 113 registers, no spills, no static
// shared memory; dynamic shared memory (8 H + 2048 + 64) floats, 24.3 KB at
// H = 512. At 113 registers x 256 threads two blocks fit an SM (264 slots
// on 132 SMs), so the 256 blocks run in one wave. A 4-unit tile would give
// 512 blocks, two waves of half the work.

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// x [B, T, 4H] (the forward's input); wh [H, 4H]; mask [B, T] (monotone per
// row); ys, cs [B, T, H] (the forward's outputs); gys [B, T, H] (cotangent
// of ys); dx [B, T, 4H] (written in full); dhbuf, dcbuf [B, H], zeroed by
// the caller. Launches T kernels on `stream`, t = T-1 down to 0, and
// returns the first CUDA error (0 when every launch was accepted). Does not
// synchronise.
int lstm_layer_bwd(const float* x, const float* wh, const float* mask, const float* ys,
                   const float* cs, const float* gys, float* dx, float* dhbuf, float* dcbuf,
                   int B, int T, int H, float forget_bias, void* stream) {
  return run_bwd<8>(x, nullptr, wh, nullptr, mask, ys, nullptr, cs, nullptr, gys, nullptr, dx,
                    nullptr, dhbuf, dcbuf, 1, B, T, H, forget_bias, stream);
}

}  // extern "C"
