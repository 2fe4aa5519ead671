// Native packed-dataset reader: mmap + multithreaded random gather.
//
// The counterpart of the reference's DataLoader worker processes
// (`utils/DataProvider.py` + num_workers=4 forked workers): instead of
// IPC-ing decoded samples between processes, the dataset is a packed
// uint8 file and a batch is a random gather of fixed-size records. This
// runs outside the Python GIL with a small thread pool, so the host can
// assemble the next batch while the card runs the current step.
//
// Exposed C ABI (consumed via ctypes in
// renderih_tpu_torch/data/native_reader.py):
//   pr_open(path)                  -> handle (mmaps the file, MADV_RANDOM)
//   pr_close(handle)
//   pr_size(handle)                -> file size in bytes
//   pr_gather(handle, record_bytes, indices, n, out, n_threads)
//        copies records indices[i] into out[i * record_bytes]

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapping {
  const uint8_t* base = nullptr;
  size_t size = 0;
  int fd = -1;
};

}  // namespace

extern "C" {

void* pr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  ::madvise(base, st.st_size, MADV_RANDOM);
  auto* m = new Mapping;
  m->base = static_cast<const uint8_t*>(base);
  m->size = static_cast<size_t>(st.st_size);
  m->fd = fd;
  return m;
}

void pr_close(void* handle) {
  auto* m = static_cast<Mapping*>(handle);
  if (!m) return;
  ::munmap(const_cast<uint8_t*>(m->base), m->size);
  ::close(m->fd);
  delete m;
}

int64_t pr_size(void* handle) {
  auto* m = static_cast<Mapping*>(handle);
  return m ? static_cast<int64_t>(m->size) : -1;
}

// Returns 0 on success, -1 on out-of-bounds record.
int pr_gather(void* handle, int64_t record_bytes, const int64_t* indices,
              int64_t n, uint8_t* out, int n_threads) {
  auto* m = static_cast<Mapping*>(handle);
  if (!m || record_bytes <= 0 || n < 0) return -1;
  // bounds check up front so worker threads can copy unconditionally
  for (int64_t i = 0; i < n; ++i) {
    if (indices[i] < 0 ||
        (static_cast<size_t>(indices[i]) + 1) *
                static_cast<size_t>(record_bytes) >
            m->size) {
      return -1;
    }
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = static_cast<int>(n > 0 ? n : 1);

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      std::memcpy(out + i * record_bytes,
                  m->base + indices[i] * record_bytes,
                  static_cast<size_t>(record_bytes));
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // extern "C"
