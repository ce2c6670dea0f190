// Host runtime of the PyTorch port: the C++ side of data/native.py.
//
// A copy of the JAX package's native/asr_native.cpp, built for the machine
// it runs on by data/native.py (g++, at first use, into the package's
// _build/):
//
//  - batch_assemble: multithreaded zero-pad + gather of utterance buffers
//    into one contiguous [B, T_pad(, D)] batch (memory-bound; threads beat
//    the Python loop on wide batches);
//  - levenshtein_batch: batched token-sequence edit distance with
//    substitution/insertion/deletion counts for corpus-level PER/CER/WER.
//
// C ABI only (consumed via ctypes); no Python.h dependency.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Assemble a padded batch from `b` utterance buffers.
//  srcs:     array of b pointers, each to a float32 buffer of lens[i]*dim
//  lens:     per-utterance frame/sample counts
//  dim:      inner feature dim (1 for raw waveforms)
//  t_pad:    padded outer length of the output
//  out:      float32 [b, t_pad, dim], fully overwritten (pad region zeroed)
//  n_threads: worker threads (<=0 -> hardware_concurrency)
void batch_assemble(const float** srcs, const int32_t* lens, int32_t b,
                    int32_t dim, int32_t t_pad, float* out,
                    int32_t n_threads) {
  const int64_t row = static_cast<int64_t>(t_pad) * dim;
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min<int>(nt, b));
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= b) return;
      float* dst = out + i * row;
      const int64_t n = static_cast<int64_t>(lens[i]) * dim;
      std::memcpy(dst, srcs[i], n * sizeof(float));
      std::memset(dst + n, 0, (row - n) * sizeof(float));
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
}

// Batched Levenshtein over int32 token sequences (padded, -1 terminated by
// length args). Outputs per pair: [distance, subs, ins, dels].
//  refs/hyps: int32 [n, max_len]; ref_lens/hyp_lens: [n]
//  out: int32 [n, 4]
void levenshtein_batch(const int32_t* refs, const int32_t* ref_lens,
                       const int32_t* hyps, const int32_t* hyp_lens,
                       int32_t n, int32_t max_len, int32_t* out,
                       int32_t n_threads) {
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  nt = std::max(1, std::min<int>(nt, n));
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    // DP matrices sized to the worst case once per thread
    std::vector<int32_t> dp;
    for (;;) {
      int32_t idx = next.fetch_add(1);
      if (idx >= n) return;
      const int32_t* r = refs + static_cast<int64_t>(idx) * max_len;
      const int32_t* h = hyps + static_cast<int64_t>(idx) * max_len;
      const int32_t rl = ref_lens[idx], hl = hyp_lens[idx];
      const int32_t w = hl + 1;
      dp.assign(static_cast<size_t>(rl + 1) * w, 0);
      for (int32_t j = 0; j <= hl; ++j) dp[j] = j;
      for (int32_t i = 1; i <= rl; ++i) {
        dp[i * w] = i;
        for (int32_t j = 1; j <= hl; ++j) {
          const int32_t sub = dp[(i - 1) * w + (j - 1)] + (r[i - 1] != h[j - 1]);
          const int32_t del = dp[(i - 1) * w + j] + 1;
          const int32_t ins = dp[i * w + (j - 1)] + 1;
          dp[i * w + j] = std::min(sub, std::min(del, ins));
        }
      }
      // backtrack for S/I/D counts
      int32_t i = rl, j = hl, subs = 0, ins = 0, dels = 0;
      while (i > 0 || j > 0) {
        if (i > 0 && j > 0 &&
            dp[i * w + j] == dp[(i - 1) * w + (j - 1)] + (r[i - 1] != h[j - 1])) {
          subs += (r[i - 1] != h[j - 1]);
          --i;
          --j;
        } else if (i > 0 && dp[i * w + j] == dp[(i - 1) * w + j] + 1) {
          ++dels;
          --i;
        } else {
          ++ins;
          --j;
        }
      }
      int32_t* o = out + idx * 4;
      o[0] = dp[rl * w + hl];
      o[1] = subs;
      o[2] = ins;
      o[3] = dels;
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
}

int32_t asr_native_abi_version() { return 1; }

}  // extern "C"
