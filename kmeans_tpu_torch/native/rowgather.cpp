// Threaded host-side batch loader: row gather + dtype convert.
//
// The port's copy of kmeans_tpu/native/rowgather.cpp: everything from the
// first #include on is the reference's source byte for byte (the tests hold
// it to that).  The streamed minibatch path samples `batch_size` random rows
// per step from a host/disk-resident (n, d) matrix; in numpy that gather
// (`data[idx]`) runs single-threaded under the GIL and dominates host time at
// large d.  Here it is a plain per-row memcpy fanned across std::threads,
// called through ctypes, which releases the GIL, so the gather for batch t+1
// overlaps the device compute of batch t.
//
// Also provides fused gather+f32->bf16 conversion (round-to-nearest-even,
// the semantics of torch's .to(torch.bfloat16)) so hosts can halve PCIe
// bytes when the device compute dtype is bf16 anyway.
//
// C ABI only, bound via ctypes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Split [0, m) into nearly-equal contiguous chunks, one per worker.
template <typename Fn>
void parallel_rows(int64_t m, int n_threads, Fn&& fn) {
  if (n_threads <= 1 || m < 2 * n_threads) {
    fn(int64_t{0}, m);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  int64_t chunk = (m + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < m ? lo + chunk : m;
    if (lo >= hi) break;
    workers.emplace_back([lo, hi, &fn] { fn(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, sizeof(x));
  if ((x & 0x7fffffffu) > 0x7f800000u) {
    // NaN: truncate mantissa but keep it quiet/non-zero.
    return static_cast<uint16_t>((x >> 16) | 0x0040u);
  }
  uint32_t rounding_bias = 0x7fffu + ((x >> 16) & 1u);  // round-to-nearest-even
  return static_cast<uint16_t>((x + rounding_bias) >> 16);
}

}  // namespace

extern "C" {

// Gather rows of `row_bytes` bytes each: dst[i, :] = src[idx[i], :].
// Dtype-agnostic (memcpy); callers pass row_bytes = d * itemsize.
// idx values must be in [0, n_src_rows) — validated Python-side.
void kt_gather_rows(const char* src, const int64_t* idx, int64_t m,
                    int64_t row_bytes, char* dst, int n_threads) {
  parallel_rows(m, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_bytes, src + idx[i] * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  });
}

// Fused gather + f32 -> bf16 convert: dst[i, j] = bf16(src[idx[i], j]).
void kt_gather_rows_f32_to_bf16(const float* src, const int64_t* idx,
                                int64_t m, int64_t d, uint16_t* dst,
                                int n_threads) {
  parallel_rows(m, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* s = src + idx[i] * d;
      uint16_t* o = dst + i * d;
      for (int64_t j = 0; j < d; ++j) o[j] = f32_to_bf16(s[j]);
    }
  });
}

// Plain f32 -> bf16 convert of a contiguous buffer (no gather).
void kt_f32_to_bf16(const float* src, int64_t count, uint16_t* dst,
                    int n_threads) {
  parallel_rows(count, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = f32_to_bf16(src[i]);
  });
}

}  // extern "C"
