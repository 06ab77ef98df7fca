// Frame prefetcher: background file readahead for the SLAM data pipeline
// (the port's copy of simpleslam_tpu/native/prefetch.cpp).
//
// A reader thread walks the upcoming file list and pulls the bytes through
// the page cache (readahead) before the decoder asks for them; decode and
// the device upload overlap tracking on the Python side
// (simpleslam_tpu_torch/data/dataloader.py Prefetcher).
//
// Exposed C ABI (ctypes, see simpleslam_tpu_torch/native.py):
//   slam_prefetch_start(paths, n)  -> handle   (begin readahead of n files)
//   slam_prefetch_stop(handle)                 (cancel + join)
//   slam_read_file(path, buf, cap) -> n_bytes  (plain read, 0 on error)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#if defined(__unix__) || defined(__APPLE__)
#include <fcntl.h>
#include <unistd.h>
#endif

namespace {

struct PrefetchJob {
  std::vector<std::string> paths;
  std::atomic<bool> cancel{false};
  std::thread worker;
};

void run_readahead(PrefetchJob* job) {
  std::vector<char> scratch(1 << 20);
  for (const std::string& p : job->paths) {
    if (job->cancel.load(std::memory_order_relaxed)) break;
#if defined(__unix__) || defined(__APPLE__)
    int fd = ::open(p.c_str(), O_RDONLY);
    if (fd < 0) continue;
#if defined(POSIX_FADV_WILLNEED)
    ::posix_fadvise(fd, 0, 0, POSIX_FADV_WILLNEED);
#endif
    // touch every page so the data is cache-hot for the decoder
    ssize_t n;
    while ((n = ::read(fd, scratch.data(), scratch.size())) > 0) {
      if (job->cancel.load(std::memory_order_relaxed)) break;
    }
    ::close(fd);
#else
    FILE* f = std::fopen(p.c_str(), "rb");
    if (!f) continue;
    size_t n;
    while ((n = std::fread(scratch.data(), 1, scratch.size(), f)) > 0) {
      if (job->cancel.load(std::memory_order_relaxed)) break;
    }
    std::fclose(f);
#endif
  }
}

}  // namespace

extern "C" {

void* slam_prefetch_start(const char** paths, int n) {
  if (!paths || n <= 0) return nullptr;
  auto* job = new PrefetchJob();
  job->paths.reserve(n);
  for (int i = 0; i < n; ++i) {
    if (paths[i]) job->paths.emplace_back(paths[i]);
  }
  job->worker = std::thread(run_readahead, job);
  return job;
}

void slam_prefetch_stop(void* handle) {
  if (!handle) return;
  auto* job = static_cast<PrefetchJob*>(handle);
  job->cancel.store(true);
  if (job->worker.joinable()) job->worker.join();
  delete job;
}

size_t slam_read_file(const char* path, char* buf, size_t cap) {
  if (!path || !buf) return 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;
  size_t total = 0;
  while (total < cap) {
    size_t n = std::fread(buf + total, 1, cap - total, f);
    if (n == 0) break;
    total += n;
  }
  std::fclose(f);
  return total;
}

}  // extern "C"
