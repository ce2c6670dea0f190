// Unidirectional LSTM layer backward over hoisted input projections, for
// Hopper (sm_90a), with float32 or bf16 streams (lstm_layer_bwd_bf16).
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _bwd_kernel (the VJP of lstm_layer_pallas, called through _bwd_call): a
// reverse walk t = T-1 .. 0 that recomputes the gates at t from xproj[t]
// and h_{t-1} = ys[t-1], carries dh and dc, and emits dgates_t as
// dxproj[t] (zero on a masked step, where dh and dc pass straight through).
// dh_{t-1} = dgates_t @ Wh^T is inside the walk; dWh is one contraction
// over [T*B] outside (ops/lstm.py), as _bwd_call forms it.
//
// The kernel, what bounds it and its design are in lstm_step.cuh (bwd_walk);
// this is its one-direction launch: one persistent cooperative kernel per
// call, grid (H / u, 1), each block's Wh columns resident in shared memory
// for all T steps, one grid barrier per step. Bound at B = 32, T = 400,
// H = 512: 4 B H 4H T float32 operations, 0.80 ms at 67 TFLOP/s.
//
// Why one block per SM. One direction has half the blocks of the
// bidirectional call at the same tile, so the plan (ops/lstm.py bwd_plan)
// halves the tile: u = 4 at H = 512 gives 128 blocks on 132 SMs, each with
// 512 x (16 + 4) floats = 40 KB of Wh resident and 124 KB (126464 B) of
// dynamic shared memory in all, at the same 207 registers a thread.

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// x [B, T, 4H] (the forward's input); wh [H, 4H]; mask [B, T] (monotone per
// row); ys, cs [B, T, H] (the forward's outputs); gys [B, T, H] (cotangent
// of ys); dx [B, T, 4H] (written in full); sync [1] unsigned counter, zeroed
// by the caller; part, scratch of part_floats floats for the dh partials.
// part_floats, units, resident and smem_bytes are the launch plan of
// ops/lstm.py bwd_plan. Launches one cooperative kernel on `stream` and
// returns its CUDA error (0 when it was accepted). Does not synchronise.
int lstm_layer_bwd(const float* x, const float* wh, const float* mask, const float* ys,
                   const float* cs, const float* gys, float* dx, unsigned int* sync,
                   float* part, int part_floats, int B, int T, int H, int units, int resident,
                   int smem_bytes, float forget_bias, void* stream) {
  const BwdArgs<float> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr},
                         {gys, nullptr}, {dx, nullptr}, mask, sync, part, B, T, H, units,
                         forget_bias};
  return run_bwd_walk<1>(a, part_floats, resident, smem_bytes, stream);
}

// lstm_layer_bwd with bf16 streams (compute_dtype: bfloat16): x, ys, cs,
// gys and dx are contiguous bf16; wh, mask and part float32, the walk
// float32 (dxproj rounded as it is written). The other arguments as
// lstm_layer_bwd.
int lstm_layer_bwd_bf16(const __nv_bfloat16* x, const float* wh, const float* mask,
                        const __nv_bfloat16* ys, const __nv_bfloat16* cs,
                        const __nv_bfloat16* gys, __nv_bfloat16* dx, unsigned int* sync,
                        float* part, int part_floats, int B, int T, int H, int units,
                        int resident, int smem_bytes, float forget_bias, void* stream) {
  const BwdArgs<__nv_bfloat16> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr},
                                 {gys, nullptr}, {dx, nullptr}, mask, sync, part, B, T, H,
                                 units, forget_bias};
  return run_bwd_walk<1>(a, part_floats, resident, smem_bytes, stream);
}

}  // extern "C"
