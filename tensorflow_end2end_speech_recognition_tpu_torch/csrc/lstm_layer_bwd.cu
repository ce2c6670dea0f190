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
// call, grid (H / u, 1) in clusters of C blocks, each block's two slices of
// Wh resident in shared memory for all T steps, both per-step products on
// the tensor cores (3xTF32), one grid barrier per step. Bound at B = 128,
// T = 400, H = 512: 4 B H 4H T float operations, 1.31 ms as three TF32
// passes at 495 TFLOP/s (3.2 ms as float32 FFMA at 67 TFLOP/s).
//
// Why one block per SM. One direction has half the blocks of the
// bidirectional call at the same tile, so the plan (ops/lstm.py bwd_plan)
// halves the tile: u = 4 at H = 512 gives 128 blocks on 132 SMs (in clusters
// of 2 on an H100), each with 512 x 16 floats of Wc and 256 x 32 of Wr
// resident, small enough to hold as TF32 hi and lo parts (162 KB; 206 KB of
// dynamic shared memory in all at B = 128).

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// x [B, T, 4H] (the forward's input); wh [H, 4H]; mask [B, T] (monotone per
// row); ys, cs [B, T, H] (the forward's outputs); gys [B, T, H] (cotangent
// of ys); dx [B, T, 4H] (written in full); sync [1] unsigned counter, zeroed
// by the caller; part, scratch of part_floats floats for the dh partials.
// part_floats, units, resident, split, cluster and smem_bytes are the launch
// plan of ops/lstm.py bwd_plan. Launches one cooperative kernel on `stream` and
// returns its CUDA error (0 when it was accepted). Does not synchronise.
int lstm_layer_bwd(const float* x, const float* wh, const float* mask, const float* ys,
                   const float* cs, const float* gys, float* dx, unsigned int* sync,
                   float* part, int part_floats, int B, int T, int H, int units, int resident,
                   int split, int cluster, int smem_bytes, float forget_bias, void* stream) {
  const BwdArgs<float> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr},
                         {gys, nullptr}, {dx, nullptr}, mask, sync, part, B, T, H, units,
                         cluster, forget_bias};
  return run_bwd_walk<1>(a, part_floats, resident, split, smem_bytes, stream);
}

// lstm_layer_bwd with bf16 streams (compute_dtype: bfloat16): x, ys, cs,
// gys and dx are contiguous bf16; wh, mask and part float32, the walk
// float32 (dxproj rounded as it is written). The other arguments as
// lstm_layer_bwd.
int lstm_layer_bwd_bf16(const __nv_bfloat16* x, const float* wh, const float* mask,
                        const __nv_bfloat16* ys, const __nv_bfloat16* cs,
                        const __nv_bfloat16* gys, __nv_bfloat16* dx, unsigned int* sync,
                        float* part, int part_floats, int B, int T, int H, int units,
                        int resident, int split, int cluster, int smem_bytes, float forget_bias,
                        void* stream) {
  const BwdArgs<__nv_bfloat16> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr},
                                 {gys, nullptr}, {dx, nullptr}, mask, sync, part, B, T, H,
                                 units, cluster, forget_bias};
  return run_bwd_walk<1>(a, part_floats, resident, split, smem_bytes, stream);
}

// lstm_bidi_bwd_max_clusters for lstm_layer_bwd (bf16 != 0:
// lstm_layer_bwd_bf16), grid (blocks, 1).
int lstm_layer_bwd_max_clusters(int blocks, int cluster, int resident, int split,
                                int smem_bytes, int bf16) {
  return bf16 ? bwd_max_clusters<1, __nv_bfloat16>(blocks, cluster, resident, split, smem_bytes)
              : bwd_max_clusters<1, float>(blocks, cluster, resident, split, smem_bytes);
}

// The step trace of lstm_layer_bwd (lstm_step.cuh bwd_walk): on != 0 turns it on
// for the following launches, 0 off; with out non-null, copies the last
// traced launch's values (kTraceFloats long longs) to host memory at out.
// Returns the CUDA error.
int lstm_layer_bwd_trace(int on, long long* out) { return walk_trace_ctl(on, out); }

}  // extern "C"
