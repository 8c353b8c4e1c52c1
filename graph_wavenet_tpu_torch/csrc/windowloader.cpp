// Host-side batch assembly for graph_wavenet_tpu_torch's data pipeline.
//
// Shuffled window batches are assembled on demand from the raw (T, N, F)
// series instead of materializing every stride-1 window: each window is
// one contiguous memcpy of K rows, parallelized over the batch with
// std::thread; the feature-0 standardization runs threaded in place.
// Python binds it via ctypes (graph_wavenet_tpu_torch/data/native_loader.py,
// which builds it with g++ at first use); from the first #include on this
// file is the JAX package's native/windowloader.cpp unchanged.
//
// Build by hand: g++ -O3 -shared -fPIC -std=c++17 -pthread windowloader.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Worker over a contiguous range of batch slots.
template <typename Fn>
void parallel_for(int64_t n, int n_threads, Fn&& fn) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Gather stride-1 windows from a row-major (T, R) series.
//   src     : T x R float32 (R = num_nodes * num_features flattened)
//   anchors : B window start rows (each in [0, T - K])
//   out     : B x K x R float32
// Each window is one memcpy of K*R floats (rows are contiguous).
void gather_windows_f32(const float* src, int64_t T, int64_t R,
                        const int64_t* anchors, int64_t B, int64_t K,
                        float* out, int n_threads) {
  (void)T;
  const size_t window_bytes = static_cast<size_t>(K) * R * sizeof(float);
  parallel_for(B, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      std::memcpy(out + b * K * R, src + anchors[b] * R, window_bytes);
    }
  });
}

// Shuffled batch gather of materialized samples:
//   src : S x sample_elems float32, idx : B sample indices,
//   out : B x sample_elems float32
void gather_batch_f32(const float* src, int64_t sample_elems,
                      const int64_t* idx, int64_t B, float* out,
                      int n_threads) {
  const size_t bytes = static_cast<size_t>(sample_elems) * sizeof(float);
  parallel_for(B, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      std::memcpy(out + b * sample_elems, src + idx[b] * sample_elems,
                  bytes);
    }
  });
}

// Standardize feature 0 of a (rows, F) view in place: x0 = (x0 - mean)/std.
// Divides (not multiply-by-reciprocal) so results are bit-identical to the
// numpy fallback `(x - mean) / std`.
void standardize_feature0_f32(float* data, int64_t rows, int64_t F,
                              float mean, float std, int n_threads) {
  parallel_for(rows, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      float* v = data + r * F;
      v[0] = (v[0] - mean) / std;
    }
  });
}

}  // extern "C"
