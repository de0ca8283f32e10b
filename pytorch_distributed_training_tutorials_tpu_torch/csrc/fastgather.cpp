// fastgather: multithreaded host-side batch assembly for the input pipeline.
//
// The port's own copy of the JAX package's csrc/fastgather.cpp (the same
// code): one row gather per dataset array at batch assembly (data/loader.py,
// the twin of the reference DataLoader's collate). numpy's fancy indexing is
// single-threaded; this library splits the row copies across threads, which
// matters once row_bytes * rows approaches tens of MB per step (ImageNet-size
// batches), keeping the host from becoming the bottleneck that pin_memory
// workers address in the reference's stack (ddp_gpus.py:75).
//
// Pure C ABI (loaded via ctypes, see data/native.py) — no Python.h, no numpy
// headers, so it builds with a bare g++ anywhere.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// dst[i, :] = src[indices[i], :] for i in [0, n_rows).
// row_bytes is the byte size of one row; indices must be in-range (the
// Python wrapper validates). n_threads <= 0 selects hardware concurrency.
void fg_gather_rows(const char* src, const int64_t* indices, char* dst,
                    int64_t n_rows, int64_t row_bytes, int32_t n_threads) {
  if (n_rows <= 0 || row_bytes <= 0) return;
  int nt = n_threads > 0
               ? n_threads
               : static_cast<int>(std::thread::hardware_concurrency());
  const int64_t total_bytes = n_rows * row_bytes;
  // below ~4MB thread spawn overhead beats the memcpy win
  if (nt <= 1 || total_bytes < (4LL << 20)) {
    for (int64_t i = 0; i < n_rows; ++i)
      std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes,
                  row_bytes);
    return;
  }
  nt = static_cast<int>(std::min<int64_t>(nt, n_rows));
  const int64_t chunk = (n_rows + nt - 1) / nt;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n_rows, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([src, indices, dst, row_bytes, lo, hi] {
      for (int64_t i = lo; i < hi; ++i)
        std::memcpy(dst + i * row_bytes, src + indices[i] * row_bytes,
                    row_bytes);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
