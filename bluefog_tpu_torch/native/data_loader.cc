// Native data-loading pipeline: worker threads fill a bounded ring of
// pre-allocated host buffers (synthetic xorshift data or slices of a
// binary file), overlapping batch production with device compute — the
// TPU-native sibling of the reference's reliance on torch DataLoader
// worker processes [U] (SURVEY.md: IO belongs to the native runtime).
//
// C ABI (ctypes, see data_native.py):
//   bf_loader_create(batch_bytes, depth, workers, mode, seed, path) -> handle
//       mode 0: synthetic float32 in [0,1); mode 1: wrap-around slices of
//       the file at `path`.
//   bf_loader_next(handle) -> const uint8_t*   (blocks until a batch is ready)
//   bf_loader_release(handle, ptr)             (return the buffer to the pool)
//   bf_loader_stats(handle, uint64 out[3])     (produced, consumed, stalls)
//   bf_loader_destroy(handle)
//
// Batch content is a pure function of (seed, batch_index); with one worker
// batches arrive in index order, with several the order is unspecified
// (exactly torch DataLoader's worker semantics).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
  uint64_t index = 0;
};

struct Loader {
  uint64_t batch_bytes = 0;
  int mode = 0;
  uint64_t seed = 0;
  int fd = -1;                // mode 1: dataset file, read via pread
  uint64_t file_batches = 0;  // whole batches in the file
  std::vector<Buffer*> pool;  // free buffers
  std::queue<Buffer*> ready;
  std::unordered_map<const uint8_t*, Buffer*> by_ptr;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::vector<std::thread> workers;
  bool stop = false;  // guarded by mu
  std::atomic<uint64_t> produced{0}, consumed{0}, stalls{0};
  uint64_t next_index = 0;  // guarded by mu
};

uint64_t splitmix(uint64_t& s) {
  s += 0x9e3779b97f4a7c15ULL;
  uint64_t z = s;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

void fill(Loader* L, Buffer* b) {
  if (L->mode == 0) {
    uint64_t s = L->seed ^ (b->index * 0x9e3779b97f4a7c15ULL + 1);
    float* f = reinterpret_cast<float*>(b->data.data());
    size_t n = L->batch_bytes / sizeof(float);
    for (size_t i = 0; i < n; ++i)
      f[i] = static_cast<float>(splitmix(s) >> 40) * (1.0f / 16777216.0f);
  } else {
    // wrap on whole batches so offsets stay batch- (and element-) aligned;
    // a trailing partial batch is dropped, as dataset epochs usually do.
    // pread: O(batch) memory, thread-safe on a shared fd.
    off_t off = static_cast<off_t>((b->index % L->file_batches) *
                                   L->batch_bytes);
    size_t done = 0;
    while (done < L->batch_bytes) {
      ssize_t r = pread(L->fd, b->data.data() + done, L->batch_bytes - done,
                        off + static_cast<off_t>(done));
      if (r <= 0) {  // IO error: surface as an obviously-poisoned batch
        std::memset(b->data.data() + done, 0xFF, L->batch_bytes - done);
        break;
      }
      done += static_cast<size_t>(r);
    }
  }
}

void worker_loop(Loader* L) {
  for (;;) {
    Buffer* b = nullptr;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] { return L->stop || !L->pool.empty(); });
      if (L->stop) return;
      b = L->pool.back();
      L->pool.pop_back();
      b->index = L->next_index++;
    }
    fill(L, b);
    {
      std::lock_guard<std::mutex> lk(L->mu);
      L->produced.fetch_add(1);  // before push: stats never show consumed>produced
      L->ready.push(b);
    }
    L->cv_ready.notify_one();
  }
}

}  // namespace

extern "C" {

void* bf_loader_create(int64_t batch_bytes, int64_t depth, int64_t workers,
                       int64_t mode, uint64_t seed, const char* path) {
  if (batch_bytes <= 0 || depth <= 0 || workers <= 0) return nullptr;
  auto* L = new Loader();
  L->batch_bytes = static_cast<uint64_t>(batch_bytes);
  L->mode = static_cast<int>(mode);
  L->seed = seed;
  if (mode == 1) {
    L->fd = open(path ? path : "", O_RDONLY);
    struct stat st;
    if (L->fd < 0 || fstat(L->fd, &st) != 0 ||
        static_cast<uint64_t>(st.st_size) < L->batch_bytes) {
      if (L->fd >= 0) close(L->fd);
      delete L;
      return nullptr;
    }
    L->file_batches = static_cast<uint64_t>(st.st_size) / L->batch_bytes;
  }
  for (int64_t i = 0; i < depth; ++i) {
    auto* b = new Buffer();
    b->data.resize(L->batch_bytes);
    L->by_ptr[b->data.data()] = b;
    L->pool.push_back(b);
  }
  for (int64_t i = 0; i < workers; ++i)
    L->workers.emplace_back(worker_loop, L);
  return L;
}

const uint8_t* bf_loader_next(void* h) {
  auto* L = static_cast<Loader*>(h);
  Buffer* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->ready.empty()) L->stalls.fetch_add(1);
    L->cv_ready.wait(lk, [&] { return L->stop || !L->ready.empty(); });
    if (L->ready.empty()) return nullptr;  // loader shut down
    b = L->ready.front();
    L->ready.pop();
  }
  return b->data.data();
}

void bf_loader_release(void* h, const uint8_t* ptr) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    auto it = L->by_ptr.find(ptr);
    if (it == L->by_ptr.end()) return;
    L->pool.push_back(it->second);
  }
  L->consumed.fetch_add(1);
  L->cv_free.notify_one();
}

void bf_loader_stats(void* h, uint64_t out[3]) {
  auto* L = static_cast<Loader*>(h);
  out[0] = L->produced.load();
  out[1] = L->consumed.load();
  out[2] = L->stalls.load();
}

void bf_loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();  // wake any consumer blocked in next()
  for (auto& t : L->workers) t.join();
  for (auto& kv : L->by_ptr) delete kv.second;
  if (L->fd >= 0) close(L->fd);
  delete L;
}

}  // extern "C"
