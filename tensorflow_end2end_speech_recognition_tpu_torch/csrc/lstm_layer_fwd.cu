// Unidirectional LSTM layer forward over hoisted input projections, for
// Hopper (sm_90a), with float32 or bf16 streams (lstm_layer_fwd_bf16).
//
// Replaces the TPU kernel
// tensorflow_end2end_speech_recognition_tpu/ops/pallas/lstm_kernel.py
// _fwd_kernel (called by lstm_layer_pallas through _fwd_call): one LSTM
// direction over xproj [B, T, 4H] = x @ Wx + b; gates i,f,g,o with
// forget_bias added to f; a masked (pad) step carries h and c through and
// writes ys[t] = h * m = 0; cs[t] holds the carried c when the caller asks
// for it (training). lstm_layer_fwd_carry resumes from a carried (h, c) and
// returns the final one: a streaming chunk, where the reference's rnn_scan
// leaves the Pallas kernel for its scan branch (models/rnn.py:188);
// lstm_layer_fwd_carry_bf16 takes that branch's compute_dtype bfloat16 step
// (bf16 operands of h @ Wh, float32 sums, streams and carries).
//
// The kernel, what bounds it and its design are in lstm_step.cuh
// (fwd_walk); this is its one-direction launch: one persistent cooperative
// kernel per call, grid (H / u, 1), each block's Wh columns resident in
// shared memory for all T steps, one grid barrier per step. One direction
// has half the blocks of the bidirectional call at the same tile, so the
// plan (ops/lstm.py fwd_plan) halves the tile: u = 4 at H = 512 gives 128
// blocks on 132 SMs, each with its Wh columns resident as TF32 hi and lo
// parts (66 KB); from 64 rows the blocks pair in clusters of 2 that split
// the product's k (each holds the pair's columns over half of k, 68 KB as hi
// and lo parts). Bound at B = 128, T = 400, H = 512:
// 2 B H 4H T float operations, 1.6 ms as float32 FFMA at 67 TFLOP/s, 0.65 ms
// as three TF32 passes at 495 TFLOP/s; every block reads all of h_{t-1}
// from L2 each step. At a streaming chunk (B = 8, T = 5-10) the work is 1-2
// us at either rate; the launch and the T step barriers set the time
// (PERF.md).

#include "lstm_step.cuh"

extern "C" {

// All pointers are device pointers of contiguous float32 tensors:
// x [B, T, 4H]; wh [H, 4H]; mask [B, T]; ys [B, T, H] (written in full);
// cs [B, T, H] written in full, or null to skip the cell-state stream
// (serving); sync [1] unsigned counter, zeroed by the caller; hbuf, the h
// exchange of hbuf_floats floats ([2, 1, B, H], no need to zero it).
// hbuf_floats, units, resident, rows and smem_bytes are the launch plan of
// ops/lstm.py fwd_plan. Launches one cooperative kernel on `stream` and
// returns its CUDA error (0 when it was accepted). Does not synchronise.
int lstm_layer_fwd(const float* x, const float* wh, const float* mask, float* ys, float* cs,
                   unsigned int* sync, float* hbuf, int hbuf_floats, int B, int T, int H,
                   int units, int resident, int rows, int smem_bytes, float forget_bias,
                   void* stream) {
  const FwdArgs<float> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr}, mask, sync,
                         hbuf, B, T, H, units, forget_bias};
  return run_fwd_walk<1>(a, hbuf_floats, resident, rows, smem_bytes, stream);
}

// lstm_layer_fwd with bf16 streams (compute_dtype: bfloat16): x, ys and cs
// are contiguous bf16; wh, mask and hbuf float32, the walk float32. The
// other arguments as lstm_layer_fwd.
int lstm_layer_fwd_bf16(const __nv_bfloat16* x, const float* wh, const float* mask,
                        __nv_bfloat16* ys, __nv_bfloat16* cs, unsigned int* sync, float* hbuf,
                        int hbuf_floats, int B, int T, int H, int units, int resident, int rows,
                        int smem_bytes, float forget_bias, void* stream) {
  const FwdArgs<__nv_bfloat16> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr},
                                 mask, sync, hbuf, B, T, H, units, forget_bias};
  return run_fwd_walk<1>(a, hbuf_floats, resident, rows, smem_bytes, stream);
}

// lstm_layer_fwd resuming from a carried state, for a streaming chunk
// (streaming.py runs every causal LSTM layer through it once per chunk):
// h0, c0 [B, H] the state before step 0; hT, cT [B, H] the carried state
// after step T-1, which must not alias h0 or c0; any of the four may be
// null (zeros in, nothing written out). A row whose mask is 0 at every step
// gets back h0 and c0 bit for bit. The other arguments as lstm_layer_fwd.
int lstm_layer_fwd_carry(const float* x, const float* wh, const float* mask, const float* h0,
                         const float* c0, float* ys, float* cs, float* hT, float* cT,
                         unsigned int* sync, float* hbuf, int hbuf_floats, int B, int T, int H,
                         int units, int resident, int rows, int smem_bytes, float forget_bias,
                         void* stream) {
  FwdArgs<float> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr}, mask, sync, hbuf,
                   B, T, H, units, forget_bias};
  a.h0[0] = h0;
  a.c0[0] = c0;
  a.hT[0] = hT;
  a.cT[0] = cT;
  return run_fwd_walk<1, true>(a, hbuf_floats, resident, rows, smem_bytes, stream);
}

// lstm_layer_fwd_carry with bf16 products (a streaming chunk at compute_dtype
// bfloat16): each step's gate product rounds h_{t-1} (h0 at step 0) and Wh to
// bf16 and sums the exact products in float32, as the bf16 branch of the
// reference's _lstm_step; x, ys, cs, the carries and the gate math stay
// float32. The arguments as lstm_layer_fwd_carry.
int lstm_layer_fwd_carry_bf16(const float* x, const float* wh, const float* mask,
                              const float* h0, const float* c0, float* ys, float* cs, float* hT,
                              float* cT, unsigned int* sync, float* hbuf, int hbuf_floats, int B,
                              int T, int H, int units, int resident, int rows, int smem_bytes,
                              float forget_bias, void* stream) {
  FwdArgs<float> a{{x, nullptr}, {wh, nullptr}, {ys, nullptr}, {cs, nullptr}, mask, sync, hbuf,
                   B, T, H, units, forget_bias};
  a.h0[0] = h0;
  a.c0[0] = c0;
  a.hT[0] = hT;
  a.cT[0] = cT;
  return run_fwd_walk<1, true, float, true>(a, hbuf_floats, resident, rows, smem_bytes, stream);
}

// The step trace of this source's forward walks (lstm_step.cuh fwd_walk):
// on != 0 turns it on for the following launches, 0 off; with out non-null,
// copies the last traced launch's values (kTraceFloats long longs) to host
// memory at out. Returns the CUDA error.
int lstm_layer_fwd_trace(int on, long long* out) { return walk_trace_ctl(on, out); }

}  // extern "C"
