// Shared worker-pool helper for the native library's translation units.
#ifndef SAV_TPU_NATIVE_PARALLEL_FOR_H_
#define SAV_TPU_NATIVE_PARALLEL_FOR_H_

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace sav {

// Run fn(i) for i in [0, n) over `threads` workers.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace sav

#endif  // SAV_TPU_NATIVE_PARALLEL_FOR_H_
