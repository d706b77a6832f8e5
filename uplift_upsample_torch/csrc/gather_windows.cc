// The host's window gather for the batchers (uplift_upsample_torch/data/native.py),
// the port's copy of native/gather_windows.cc with the same C signature.
//
// The sequence generators decide *which* frames form each window (numpy,
// RNG-faithful); this materializes a batch: gathering (B, N) frame rows of
// (K, C) floats from the concatenated pose store, zero-filling padded rows and
// applying the left/right flip (joint permutation + x negation), on n_threads
// threads. Built with g++ at first use into uplift_upsample_torch/_build/.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// src:       (total_frames, K, C) row-major float32
// indices:   (B, N) absolute frame indices into src
// zero_mask: (B, N) nonzero -> write zeros instead of the gathered row (or null)
// do_flip:   (B) nonzero -> apply flip to that example (or null)
// flip_perm: (K) joint permutation for flipped examples (or null)
// dst:       (B, N, K, C)
void gather_windows_f32(const float* src, const int64_t* indices,
                        const uint8_t* zero_mask, const uint8_t* do_flip,
                        const int32_t* flip_perm, float* dst, int64_t B,
                        int64_t N, int64_t K, int64_t C, int n_threads) {
  const int64_t row = K * C;
  const int64_t window = N * row;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > B) n_threads = static_cast<int>(B);

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    int64_t b;
    while ((b = next.fetch_add(1)) < B) {
      float* out = dst + b * window;
      const int64_t* idx = indices + b * N;
      const uint8_t* zm = zero_mask ? zero_mask + b * N : nullptr;
      const bool flip = do_flip && do_flip[b] && flip_perm;
      for (int64_t n = 0; n < N; ++n) {
        float* orow = out + n * row;
        if (zm && zm[n]) {
          std::memset(orow, 0, sizeof(float) * row);
          continue;
        }
        const float* srow = src + idx[n] * row;
        if (!flip) {
          std::memcpy(orow, srow, sizeof(float) * row);
        } else {
          for (int64_t k = 0; k < K; ++k) {
            const float* j = srow + flip_perm[k] * C;
            float* o = orow + k * C;
            o[0] = -j[0];
            for (int64_t c = 1; c < C; ++c) o[c] = j[c];
          }
        }
      }
    }
  };

  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
