// Shared-memory mailbox transport for asynchronous "island" window ops.
//
// TPU-native sibling of the reference's passive-target MPI RMA layer
// (MPI_Win_create / MPI_Put / MPI_Accumulate / MPI_Win_lock in
// bluefog/common/mpi_controller.cc and mpi_context.cc [U]; SURVEY.md §2.4,
// §3.4).  The single-controller emulation in bluefog_tpu/windows.py realizes
// the synchronous schedule of asynchronous algorithms; THIS module supplies
// the missing piece — true one-sided deposits between independently-stepping
// OS processes ("islands"), each of which owns its own JAX controller and
// device set.  A writer deposits into its dedicated slot at the destination
// with NO participation by the receiver, exactly the reference's window
// model: one registered buffer per in-neighbor per named window, so
// concurrent writers never collide.
//
// Memory layout of a window segment (POSIX shm, /dev/shm):
//
//   Header  { magic, nranks, maxd, nbytes, dtype, chunk_bytes, nchunks, .. }
//   Exposed [nranks]        — each rank's currently-exposed tensor
//   Mail    [nranks][maxd]  — slot (d, k): last deposit from d's k-th
//                             in-neighbor (ascending rank order)
//
// Every slot is a small header + a per-chunk seqlock array + 64-byte-aligned
// payload:
//
//   Slot { lock, wseq, version, drained, p, chunk_seq[nchunks],
//          payload[nbytes] }
//
// Chunked protocol (v2) — the chunk-ring transport:
//   - the payload is divided into fixed-size chunks (``chunk_bytes``), each
//     guarded by its OWN seqlock ``chunk_seq[c]``; a writer commits chunks
//     in ascending order (odd → mutate → release-fence → even), so a
//     pipelined consumer can follow the commit frontier: observing chunk c
//     committed at episode E implies every chunk < c is also at episode E
//     ("no reordered chunk commit" — model-checked);
//   - ``wseq`` is the slot-level seqlock bracketing whole-payload atomicity
//     for plain readers (same odd/even discipline as v1, now wrapping the
//     per-chunk commits);
//   - ``drained`` records the ``version`` at the last collect/reset.  When
//     ``drained == version`` the slot is LOGICALLY zero without any memset:
//     collect becomes a single copy-out pass + an O(1) marker store
//     (v1 paid a third full zeroing pass here), reset is O(1), and an
//     accumulate into a drained slot degrades to a plain scaled copy —
//     mass conservation is preserved because drained/version only move
//     under the slot lock (model-checked: no lost deposit);
//   - deposits take a ``scale`` factor applied in the copy loop (a put of
//     ``w * x`` is one pass, not a temporary + two);
//   - ``bf_shm_win_combine`` fuses the reader side the same way:
//     ``acc += weight * payload`` in one pass under the slot lock, so the
//     island win_update's weighted combine never materializes the payload;
//   - ``bf_shm_win_probe`` is the pipelined self-edge: it streams the
//     payload through a bounded ring of ``ring_depth`` chunk slots with the
//     full per-chunk seqlock protocol, writer deposit and reader drain
//     interleaved per chunk.  The ring stays cache-resident, so the
//     measured protocol ceiling approaches the single-pass memcpy bound
//     instead of v1's 1/3-of-memcpy three-pass floor.
//
// A tiny per-job segment provides a sense-reversing barrier (init/teardown
// and tests only — the async hot loop never barriers) and per-rank mutexes
// implementing a REAL bf.win_mutex for island mode.
//
// C++17, no external deps; C-linkage ABI consumed by ctypes
// (bluefog_tpu/native/shm_native.py).  ``bf_shm_abi_version`` returns 2;
// its absence from a stale .so triggers the loader's rebuild path.

#include <atomic>
#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x42464d41494c4232ull;  // "BFMAILB2"
constexpr int64_t kDefaultChunkBytes = 64 * 1024;

inline int64_t align_up(int64_t v, int64_t a) { return (v + a - 1) / a * a; }

inline void cpu_relax() { sched_yield(); }

// ---------------------------------------------------------------------------
// shm segment plumbing
// ---------------------------------------------------------------------------

struct Segment {
  void* base = nullptr;
  int64_t bytes = 0;
  char name[256];
};

// Open-or-create a named segment of exactly `bytes`.  The winner of the
// O_EXCL race sizes + zeroes it and must later publish readiness itself via
// publish_init() — AFTER writing any header fields — so no attacher ever
// observes a half-initialized header; losers attach and spin on the flag at
// offset `init_off`.
bool segment_open(Segment* seg, const char* name, int64_t bytes,
                  int64_t init_off, bool* creator_out) {
  std::snprintf(seg->name, sizeof(seg->name), "%s", name);
  bool creator = false;
  int fd = shm_open(name, O_RDWR | O_CREAT | O_EXCL, 0600);
  if (fd >= 0) {
    creator = true;
    if (ftruncate(fd, bytes) != 0) {
      close(fd);
      shm_unlink(name);
      return false;
    }
  } else {
    if (errno != EEXIST) return false;
    // attach; the creator may still be mid-ftruncate, so wait for full size
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return false;
    struct stat st;
    for (int spin = 0; ; ++spin) {
      if (fstat(fd, &st) != 0) { close(fd); return false; }
      if (st.st_size >= bytes) break;
      if (spin > 2000000) { close(fd); return false; }
      cpu_relax();
    }
  }
  void* base = mmap(nullptr, static_cast<size_t>(bytes),
                    PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return false;
  seg->base = base;
  seg->bytes = bytes;
  auto* flag = reinterpret_cast<std::atomic<uint64_t>*>(
      static_cast<char*>(base) + init_off);
  if (!creator) {
    for (int spin = 0; flag->load(std::memory_order_acquire) != 1; ++spin) {
      if (spin > 2000000) { munmap(base, bytes); return false; }
      cpu_relax();
    }
  }
  // creator: mapping of a fresh shm object is zero-filled; caller fills the
  // header then calls publish_init
  if (creator_out) *creator_out = creator;
  return true;
}

void publish_init(void* base, int64_t init_off) {
  reinterpret_cast<std::atomic<uint64_t>*>(static_cast<char*>(base) +
                                           init_off)
      ->store(1, std::memory_order_release);
}

void segment_close(Segment* seg, bool unlink_seg) {
  if (seg->base) munmap(seg->base, static_cast<size_t>(seg->bytes));
  if (unlink_seg) shm_unlink(seg->name);
  seg->base = nullptr;
}

// ---------------------------------------------------------------------------
// job segment: barrier + per-rank mutexes
// ---------------------------------------------------------------------------

struct JobHeader {
  std::atomic<uint64_t> init_done;
  int64_t nranks;
  std::atomic<uint64_t> arrived;
  std::atomic<uint64_t> generation;
  // nranks mutexes follow (one cache line each)
};

struct JobMutex {
  std::atomic<uint32_t> locked;
  char pad[60];
};

// Per-rank liveness word (one cache line each, after the mutex array).
// Each rank heartbeats its own word with a caller-supplied epoch stamp
// (CLOCK_MONOTONIC milliseconds — system-wide on Linux, so peers can
// compare a stamp against their own clock); a detector reads peers'
// words and declares any rank whose stamp is older than its timeout
// dead.  Plain shared-memory stores/loads with release/acquire — the
// detector only ever needs "stamp visible, eventually", not ordering
// against the mailbox payloads.
struct LiveWord {
  std::atomic<uint64_t> beat;
  char pad[56];
};

struct Job {
  Segment seg;
  int64_t rank = 0;
  int64_t nranks = 0;
  JobHeader* hdr() { return static_cast<JobHeader*>(seg.base); }
  JobMutex* mutexes() {
    return reinterpret_cast<JobMutex*>(static_cast<char*>(seg.base) +
                                       align_up(sizeof(JobHeader), 64));
  }
  LiveWord* live() {
    return reinterpret_cast<LiveWord*>(
        static_cast<char*>(seg.base) + align_up(sizeof(JobHeader), 64) +
        nranks * static_cast<int64_t>(sizeof(JobMutex)));
  }
};

int64_t monotonic_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

// ---------------------------------------------------------------------------
// window segment
// ---------------------------------------------------------------------------

struct WinHeader {
  uint64_t magic;
  std::atomic<uint64_t> init_done;
  int64_t nranks;
  int64_t maxd;
  int64_t nbytes;
  int32_t dtype;  // 0 raw bytes, 1 float32, 2 float64
  int32_t pad0;
  int64_t chunk_bytes;
  int64_t nchunks;
};

struct SlotHeader {
  std::atomic<uint32_t> lock;   // writer spinlock
  uint32_t pad0;
  std::atomic<uint64_t> wseq;   // slot seqlock: odd while a writer mutates
  uint64_t version;             // deposit count
  uint64_t drained;             // version at last collect/reset (O(1) drain)
  double p;                     // push-sum associated scalar
};

struct Window {
  Segment seg;
  int64_t rank = 0;
  int64_t nranks = 0;
  int64_t maxd = 0;
  int64_t nbytes = 0;
  int32_t dtype = 0;
  int64_t chunk_bytes = 0;
  int64_t nchunks = 0;
  int64_t payload_off = 0;  // within a slot: after header + chunk_seq array
  int64_t slot_stride = 0;
  int64_t slots_off = 0;  // exposed slots start; mail follows

  char* slot_at(int64_t index) {
    return static_cast<char*>(seg.base) + slots_off + index * slot_stride;
  }
  // exposed slot of rank r
  char* exposed(int64_t r) { return slot_at(r); }
  // mailbox slot (dst d, in-neighbor position k)
  char* mail(int64_t d, int64_t k) {
    return slot_at(nranks + d * maxd + k);
  }
  std::atomic<uint64_t>* chunk_seqs(char* slot) {
    return reinterpret_cast<std::atomic<uint64_t>*>(
        slot + align_up(sizeof(SlotHeader), 64));
  }
  char* payload(char* slot) { return slot + payload_off; }
  int64_t chunk_len(int64_t c) {
    int64_t off = c * chunk_bytes;
    int64_t n = nbytes - off;
    return n < chunk_bytes ? (n < 0 ? 0 : n) : chunk_bytes;
  }
};

void slot_lock(SlotHeader* s) {
  uint32_t expected = 0;
  while (!s->lock.compare_exchange_weak(expected, 1,
                                        std::memory_order_acquire,
                                        std::memory_order_relaxed)) {
    expected = 0;
    cpu_relax();
  }
}

void slot_unlock(SlotHeader* s) {
  s->lock.store(0, std::memory_order_release);
}

// One chunk of the deposit pass: scaled copy or scaled add, dtype-aware.
// ``scale`` is only meaningful for float payloads (dtype 1/2); the Python
// veneer rejects scale != 1 / add for raw windows.
void chunk_apply(char* dst, const char* src, int64_t n, int32_t dtype,
                 double scale, bool add) {
  if (dtype == 1) {
    auto* d = reinterpret_cast<float*>(dst);
    auto* s = reinterpret_cast<const float*>(src);
    int64_t k = n / static_cast<int64_t>(sizeof(float));
    float f = static_cast<float>(scale);
    if (add) {
      for (int64_t i = 0; i < k; ++i) d[i] += f * s[i];
    } else if (scale == 1.0) {
      std::memcpy(dst, src, static_cast<size_t>(n));
    } else {
      for (int64_t i = 0; i < k; ++i) d[i] = f * s[i];
    }
  } else if (dtype == 2) {
    auto* d = reinterpret_cast<double*>(dst);
    auto* s = reinterpret_cast<const double*>(src);
    int64_t k = n / static_cast<int64_t>(sizeof(double));
    if (add) {
      for (int64_t i = 0; i < k; ++i) d[i] += scale * s[i];
    } else if (scale == 1.0) {
      std::memcpy(dst, src, static_cast<size_t>(n));
    } else {
      for (int64_t i = 0; i < k; ++i) d[i] = scale * s[i];
    }
  } else {
    std::memcpy(dst, src, static_cast<size_t>(n));  // raw: overwrite
  }
}

// Chunked deposit under lock + slot seqlock.  ``mode`` 0 = put (scaled
// overwrite), 1 = accumulate (scaled add; degrades to a scaled copy when
// the slot is drained — the logical-zero fast path that replaces v1's
// eager memset).  Chunks commit IN ASCENDING ORDER, each bracketed by its
// own chunk_seq odd/even publish (the pipelined-consumer contract).
void slot_deposit(Window* win, char* slot, const char* data, double p,
                  int32_t mode, double scale) {
  auto* s = reinterpret_cast<SlotHeader*>(slot);
  slot_lock(s);
  bool add = (mode == 1) && (s->drained != s->version);
  uint64_t w = s->wseq.load(std::memory_order_relaxed);
  s->wseq.store(w + 1, std::memory_order_relaxed);  // odd: in progress
  // full fence: the payload stores must not become visible before the odd
  // seq store (store-store barrier — smp_wmb in the kernel's seqlock; a
  // release fence would NOT order the later plain stores on ARM)
  std::atomic_thread_fence(std::memory_order_seq_cst);
  auto* cs = win->chunk_seqs(slot);
  char* pay = win->payload(slot);
  for (int64_t c = 0; c < win->nchunks; ++c) {
    int64_t off = c * win->chunk_bytes;
    int64_t n = win->chunk_len(c);
    uint64_t q = cs[c].load(std::memory_order_relaxed);
    cs[c].store(q + 1, std::memory_order_relaxed);  // chunk odd
    std::atomic_thread_fence(std::memory_order_seq_cst);
    chunk_apply(pay + off, data + off, n, win->dtype, scale, add);
    // the commit fence: every chunk store is visible before the even
    // publish — dropping it is the seeded-bug fixture the verifier's
    // chunk-ring model must catch
    std::atomic_thread_fence(std::memory_order_release);
    cs[c].store(q + 2, std::memory_order_release);  // chunk even: committed
  }
  if (mode == 1) {
    s->p = add ? s->p + p : p;
  } else {
    s->p = p;
  }
  s->version += 1;
  std::atomic_thread_fence(std::memory_order_release);
  s->wseq.store(w + 2, std::memory_order_release);
  slot_unlock(s);
}

// Wait-free plain read: retry until a stable even wseq brackets the copy.
// A drained slot (drained == version) is LOGICALLY zero: the payload bytes
// are stale garbage by contract, so the copy-out is a memset and p reads 0.
int64_t slot_read(Window* win, char* slot, void* out, double* p_out) {
  auto* s = reinterpret_cast<SlotHeader*>(slot);
  for (;;) {
    uint64_t before = s->wseq.load(std::memory_order_acquire);
    if (before & 1) { cpu_relax(); continue; }
    uint64_t version = s->version;
    bool empty = (s->drained == version);
    double p = empty ? 0.0 : s->p;
    if (out) {
      if (empty) {
        std::memset(out, 0, static_cast<size_t>(win->nbytes));
      } else {
        std::memcpy(out, win->payload(slot),
                    static_cast<size_t>(win->nbytes));
      }
    }
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t after = s->wseq.load(std::memory_order_acquire);
    if (before == after) {
      if (p_out) *p_out = p;
      return static_cast<int64_t>(version);
    }
    cpu_relax();
  }
}

// Metadata-only mutation under lock + slot seqlock (collect's marker
// store, reset).  The payload is untouched — O(1), no zeroing pass.
template <typename F>
void slot_mark(char* slot, F&& mutate) {
  auto* s = reinterpret_cast<SlotHeader*>(slot);
  slot_lock(s);
  uint64_t w = s->wseq.load(std::memory_order_relaxed);
  s->wseq.store(w + 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  mutate(s);
  std::atomic_thread_fence(std::memory_order_release);
  s->wseq.store(w + 2, std::memory_order_release);
  slot_unlock(s);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Protocol revision of this library.  The ctypes loader references this
// symbol while declaring the ABI, so a stale v1 .so (whole-payload
// protocol, narrower signatures) raises AttributeError and is rebuilt
// instead of being called with mismatched arguments.
int32_t bf_shm_abi_version(void) { return 2; }

void* bf_shm_job_create(const char* name, int64_t rank, int64_t nranks) {
  auto* job = new Job;
  job->rank = rank;
  job->nranks = nranks;
  int64_t bytes = align_up(sizeof(JobHeader), 64) +
                  nranks * static_cast<int64_t>(sizeof(JobMutex)) +
                  nranks * static_cast<int64_t>(sizeof(LiveWord));
  bool creator = false;
  if (!segment_open(&job->seg, name, bytes,
                    offsetof(JobHeader, init_done), &creator)) {
    delete job;
    return nullptr;
  }
  if (creator) {
    job->hdr()->nranks = nranks;
    publish_init(job->seg.base, offsetof(JobHeader, init_done));
  }
  return job;
}

void bf_shm_job_barrier(void* h) {
  auto* job = static_cast<Job*>(h);
  auto* hdr = job->hdr();
  uint64_t gen = hdr->generation.load(std::memory_order_acquire);
  uint64_t arrived = hdr->arrived.fetch_add(1, std::memory_order_acq_rel) + 1;
  if (arrived == static_cast<uint64_t>(job->nranks)) {
    hdr->arrived.store(0, std::memory_order_relaxed);
    hdr->generation.fetch_add(1, std::memory_order_acq_rel);
  } else {
    while (hdr->generation.load(std::memory_order_acquire) == gen) cpu_relax();
  }
}

// Timed sense-reversing barrier.  Returns 0 on release, -1 on timeout.
// On timeout the caller's arrival is RETRACTED (CAS decrement) so later
// barrier episodes are not corrupted; if the release races the retract,
// the retract is abandoned and the call reports success.  timeout_ms < 0
// waits forever (identical to bf_shm_job_barrier).
int32_t bf_shm_job_barrier_timeout(void* h, int64_t timeout_ms) {
  auto* job = static_cast<Job*>(h);
  auto* hdr = job->hdr();
  int64_t deadline = timeout_ms < 0 ? -1 : monotonic_ms() + timeout_ms;
  uint64_t gen = hdr->generation.load(std::memory_order_acquire);
  uint64_t arrived = hdr->arrived.fetch_add(1, std::memory_order_acq_rel) + 1;
  if (arrived == static_cast<uint64_t>(job->nranks)) {
    hdr->arrived.store(0, std::memory_order_relaxed);
    hdr->generation.fetch_add(1, std::memory_order_acq_rel);
    return 0;
  }
  while (hdr->generation.load(std::memory_order_acquire) == gen) {
    if (deadline >= 0 && monotonic_ms() > deadline) {
      // retract our arrival — unless the barrier released meanwhile, in
      // which case arrived may already have been reset (observing 0 with
      // gen unchanged means the last arriver is between its reset and its
      // bump: the release is imminent, keep waiting for it)
      uint64_t a = hdr->arrived.load(std::memory_order_relaxed);
      for (;;) {
        if (hdr->generation.load(std::memory_order_acquire) != gen) return 0;
        if (a == 0) {
          cpu_relax();
          a = hdr->arrived.load(std::memory_order_relaxed);
          continue;
        }
        if (hdr->arrived.compare_exchange_weak(a, a - 1,
                                               std::memory_order_acq_rel,
                                               std::memory_order_relaxed)) {
          return -1;
        }
      }
    }
    cpu_relax();
  }
  return 0;
}

// Stamp my liveness word.  epoch_ms should be CLOCK_MONOTONIC milliseconds
// (pass 0 to let the library stamp it).
void bf_shm_job_heartbeat(void* h, int64_t epoch_ms) {
  auto* job = static_cast<Job*>(h);
  uint64_t stamp = epoch_ms > 0 ? static_cast<uint64_t>(epoch_ms)
                                : static_cast<uint64_t>(monotonic_ms());
  job->live()[job->rank].beat.store(stamp, std::memory_order_release);
}

// Read a rank's last heartbeat stamp (0 if it never beat).
int64_t bf_shm_job_liveness(void* h, int64_t rank) {
  auto* job = static_cast<Job*>(h);
  return static_cast<int64_t>(
      job->live()[rank].beat.load(std::memory_order_acquire));
}

// Current CLOCK_MONOTONIC milliseconds — the clock heartbeats are stamped
// with, exported so the Python detector compares stamps against the same
// system-wide timebase.
int64_t bf_shm_monotonic_ms(void) { return monotonic_ms(); }

void bf_shm_job_mutex_acquire(void* h, int64_t target_rank) {
  auto* job = static_cast<Job*>(h);
  auto& m = job->mutexes()[target_rank].locked;
  uint32_t expected = 0;
  while (!m.compare_exchange_weak(expected, 1, std::memory_order_acquire,
                                  std::memory_order_relaxed)) {
    expected = 0;
    cpu_relax();
  }
}

// Timed mutex acquire: 0 on success, -1 on timeout.  timeout_ms < 0 waits
// forever.  A mutex held by a dead rank can be reclaimed by the detector
// via bf_shm_job_mutex_break.
int32_t bf_shm_job_mutex_acquire_timeout(void* h, int64_t target_rank,
                                         int64_t timeout_ms) {
  auto* job = static_cast<Job*>(h);
  auto& m = job->mutexes()[target_rank].locked;
  int64_t deadline = timeout_ms < 0 ? -1 : monotonic_ms() + timeout_ms;
  uint32_t expected = 0;
  while (!m.compare_exchange_weak(expected, 1, std::memory_order_acquire,
                                  std::memory_order_relaxed)) {
    expected = 0;
    if (deadline >= 0 && monotonic_ms() > deadline) return -1;
    cpu_relax();
  }
  return 0;
}

// Forcibly release a mutex (dead-holder recovery; caller must have
// established via the failure detector that the holder is gone).
void bf_shm_job_mutex_break(void* h, int64_t target_rank) {
  auto* job = static_cast<Job*>(h);
  job->mutexes()[target_rank].locked.store(0, std::memory_order_release);
}

void bf_shm_job_mutex_release(void* h, int64_t target_rank) {
  auto* job = static_cast<Job*>(h);
  job->mutexes()[target_rank].locked.store(0, std::memory_order_release);
}

void bf_shm_job_destroy(void* h, int32_t unlink_seg) {
  auto* job = static_cast<Job*>(h);
  segment_close(&job->seg, unlink_seg != 0);
  delete job;
}

void* bf_shm_win_create(const char* name, int64_t rank, int64_t nranks,
                        int64_t maxd, int64_t nbytes, int32_t dtype,
                        int64_t chunk_bytes) {
  auto* win = new Window;
  win->rank = rank;
  win->nranks = nranks;
  win->maxd = maxd < 1 ? 1 : maxd;
  win->nbytes = nbytes;
  win->dtype = dtype;
  win->chunk_bytes = chunk_bytes < 1 ? kDefaultChunkBytes : chunk_bytes;
  win->nchunks = (nbytes + win->chunk_bytes - 1) / win->chunk_bytes;
  if (win->nchunks < 1) win->nchunks = 1;
  win->payload_off = align_up(sizeof(SlotHeader), 64) +
                     align_up(win->nchunks * 8, 64);
  win->slot_stride = win->payload_off + align_up(nbytes, 64);
  win->slots_off = align_up(sizeof(WinHeader), 64);
  int64_t nslots = nranks + nranks * win->maxd;
  int64_t bytes = win->slots_off + nslots * win->slot_stride;
  bool creator = false;
  if (!segment_open(&win->seg, name, bytes,
                    offsetof(WinHeader, init_done), &creator)) {
    delete win;
    return nullptr;
  }
  auto* hdr = static_cast<WinHeader*>(win->seg.base);
  if (creator) {
    hdr->magic = kMagic;
    hdr->nranks = nranks;
    hdr->maxd = win->maxd;
    hdr->nbytes = nbytes;
    hdr->dtype = dtype;
    hdr->chunk_bytes = win->chunk_bytes;
    hdr->nchunks = win->nchunks;
    publish_init(win->seg.base, offsetof(WinHeader, init_done));
  } else if (hdr->magic != kMagic || hdr->nranks != nranks ||
             hdr->maxd != win->maxd || hdr->nbytes != nbytes ||
             hdr->dtype != dtype || hdr->chunk_bytes != win->chunk_bytes ||
             hdr->nchunks != win->nchunks) {
    segment_close(&win->seg, false);
    delete win;
    return nullptr;
  }
  return win;
}

// Deposit into (dst, slot).  mode 0 = put (overwrite), 1 = accumulate.
// ``scale`` multiplies the payload inside the copy loop (float dtypes; a
// scaled put is ONE pass, not a caller-side temporary + copy); p rides
// along (overwritten or accumulated to match).
void bf_shm_win_write(void* h, int64_t dst, int64_t slot, const void* data,
                      double p, int32_t mode, double scale) {
  auto* win = static_cast<Window*>(h);
  slot_deposit(win, win->mail(dst, slot), static_cast<const char*>(data),
               p, mode, scale);
}

// Read my own mailbox slot `slot`.  collect != 0 drains it atomically —
// ONE copy-out pass plus an O(1) ``drained = version`` marker store in the
// same critical section (v1 paid a full memset pass here; a drained slot
// reads back as zeros by contract).  Returns the deposit count observed.
int64_t bf_shm_win_read(void* h, int64_t slot, void* out, double* p,
                        int32_t collect) {
  auto* win = static_cast<Window*>(h);
  char* sl = win->mail(win->rank, slot);
  if (!collect) return slot_read(win, sl, out, p);
  auto* s = reinterpret_cast<SlotHeader*>(sl);
  int64_t version = 0;
  slot_mark(sl, [&](SlotHeader* sh) {
    bool empty = (sh->drained == sh->version);
    if (out) {
      if (empty) {
        std::memset(out, 0, static_cast<size_t>(win->nbytes));
      } else {
        std::memcpy(out, win->payload(sl),
                    static_cast<size_t>(win->nbytes));
      }
    }
    if (p) *p = empty ? 0.0 : sh->p;
    version = static_cast<int64_t>(sh->version);
    sh->drained = sh->version;  // the drain: no memset, just the marker
    sh->p = 0.0;
  });
  (void)s;
  return version;
}

// Fused weighted combine: acc += weight * slot_payload in ONE pass under
// the slot lock (float windows only; the caller's ``acc`` must match the
// window dtype).  ``collect`` drains the slot in the same critical section
// (atomic with respect to accumulating writers — mass conservation).  A
// drained slot contributes nothing and p_out = 0.  Returns the version.
int64_t bf_shm_win_combine(void* h, int64_t slot, void* acc, double weight,
                           int32_t collect, double* p_out) {
  auto* win = static_cast<Window*>(h);
  char* sl = win->mail(win->rank, slot);
  auto* s = reinterpret_cast<SlotHeader*>(sl);
  slot_lock(s);
  bool empty = (s->drained == s->version);
  if (!empty && acc) {
    const char* pay = win->payload(sl);
    if (win->dtype == 1) {
      auto* a = static_cast<float*>(acc);
      auto* v = reinterpret_cast<const float*>(pay);
      int64_t k = win->nbytes / static_cast<int64_t>(sizeof(float));
      float f = static_cast<float>(weight);
      for (int64_t i = 0; i < k; ++i) a[i] += f * v[i];
    } else if (win->dtype == 2) {
      auto* a = static_cast<double*>(acc);
      auto* v = reinterpret_cast<const double*>(pay);
      int64_t k = win->nbytes / static_cast<int64_t>(sizeof(double));
      for (int64_t i = 0; i < k; ++i) a[i] += weight * v[i];
    }
  }
  if (p_out) *p_out = empty ? 0.0 : s->p;
  int64_t version = static_cast<int64_t>(s->version);
  if (collect) {
    // marker ordering matters for concurrent lock-free readers: a reader
    // that observes the new ``drained`` reports the slot empty (p forced
    // to 0), one that observes the old value gets the intact pre-drain
    // payload — both are linearizable outcomes
    s->drained = s->version;
    s->p = 0.0;
  }
  slot_unlock(s);
  return version;
}

// Drain marker without reading — the owner-side reset (reference
// win_update(reset=True) zeroing its buffers).  O(1): no payload pass.
void bf_shm_win_reset(void* h, int64_t slot) {
  auto* win = static_cast<Window*>(h);
  slot_mark(win->mail(win->rank, slot), [&](SlotHeader* s) {
    s->drained = s->version;
    s->p = 0.0;
  });
}

// Dead-writer recovery: force mailbox slot ``slot`` (of MY rank) into a
// consistent drained state even if its writer died mid-deposit, leaving
// the slot lock held and the wseq / per-chunk seqlocks odd.  Safe to call
// ONLY after the failure detector has established the writer rank is gone
// (no live writer will ever touch this slot again — each mailbox slot has
// exactly one writer by construction).
//
// Mass conservation: ``slot_deposit`` advances ``p``/``version`` only
// AFTER every chunk write, under the slot lock — so a writer that died
// mid-deposit has committed ZERO mass; discarding the torn payload and
// storing ``drained = version`` conserves the committed-mass ledger
// exactly (model-checked: dead_writer_drain_model in
// analysis/seqlock_model.py).
void bf_shm_win_force_drain(void* h, int64_t slot) {
  auto* win = static_cast<Window*>(h);
  char* sl = win->mail(win->rank, slot);
  auto* s = reinterpret_cast<SlotHeader*>(sl);
  auto* cs = win->chunk_seqs(sl);
  for (int64_t c = 0; c < win->nchunks; ++c) {
    uint64_t q = cs[c].load(std::memory_order_relaxed);
    if (q & 1) cs[c].store(q + 1, std::memory_order_release);
  }
  s->drained = s->version;
  s->p = 0.0;
  std::atomic_thread_fence(std::memory_order_release);
  // even-ize the slot seqlock, advancing past any torn bracket so a
  // reader that sampled the odd value retries and sees the drained state
  uint64_t w = s->wseq.load(std::memory_order_relaxed);
  s->wseq.store((w | 1) + 1, std::memory_order_release);
  s->lock.store(0, std::memory_order_release);
}

// Publish my exposed tensor (what win_get by a neighbor observes).
void bf_shm_win_expose(void* h, const void* data, double p) {
  auto* win = static_cast<Window*>(h);
  slot_deposit(win, win->exposed(win->rank),
               static_cast<const char*>(data), p, 0, 1.0);
}

// One-sided read of any rank's exposed tensor (the MPI_Get path).
int64_t bf_shm_win_read_exposed(void* h, int64_t src, void* out, double* p) {
  auto* win = static_cast<Window*>(h);
  return slot_read(win, win->exposed(src), out, p);
}

// Pipelined self-edge probe: stream the window payload from ``src`` to
// ``dst`` through a bounded ring of ``ring_depth`` chunk slots of mailbox
// slot ``slot``, exercising the FULL per-chunk seqlock protocol — writer
// commit (odd / mutate / release-fence / even) immediately followed by the
// bracketed reader drain of the same chunk, per chunk.  The ring stays
// cache-resident, so this measures the chunk-ring transport's pipelined
// steady state (deposit overlapping drain) with no per-chunk ctypes
// overhead.  Returns 0 on success, -1 if any reader bracket failed
// (impossible single-threaded; checked anyway).
int32_t bf_shm_win_probe(void* h, int64_t slot, const void* src, void* dst,
                         int64_t ring_depth) {
  auto* win = static_cast<Window*>(h);
  char* sl = win->mail(win->rank, slot);
  auto* s = reinterpret_cast<SlotHeader*>(sl);
  if (ring_depth < 1) ring_depth = 1;
  if (ring_depth > win->nchunks) ring_depth = win->nchunks;
  auto* cs = win->chunk_seqs(sl);
  char* pay = win->payload(sl);
  const char* in = static_cast<const char*>(src);
  char* out = static_cast<char*>(dst);
  int32_t rc = 0;
  slot_lock(s);
  uint64_t w = s->wseq.load(std::memory_order_relaxed);
  s->wseq.store(w + 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  for (int64_t c = 0; c < win->nchunks; ++c) {
    int64_t ring = c % ring_depth;
    int64_t off = c * win->chunk_bytes;
    int64_t n = win->chunk_len(c);
    char* chunk = pay + ring * win->chunk_bytes;
    // writer leg: commit chunk c into ring slot `ring`
    uint64_t q = cs[ring].load(std::memory_order_relaxed);
    cs[ring].store(q + 1, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    std::memcpy(chunk, in + off, static_cast<size_t>(n));
    std::atomic_thread_fence(std::memory_order_release);
    cs[ring].store(q + 2, std::memory_order_release);
    // reader leg: bracketed drain of the chunk just committed
    uint64_t before = cs[ring].load(std::memory_order_acquire);
    std::memcpy(out + off, chunk, static_cast<size_t>(n));
    std::atomic_thread_fence(std::memory_order_acquire);
    if ((before & 1) || cs[ring].load(std::memory_order_acquire) != before) {
      rc = -1;
    }
  }
  // the ring overwrote the slot payload with the stream's tail: mark the
  // slot drained so subsequent reads see a logical zero, not garbage
  s->version += 1;
  s->drained = s->version;
  s->p = 0.0;
  std::atomic_thread_fence(std::memory_order_release);
  s->wseq.store(w + 2, std::memory_order_release);
  slot_unlock(s);
  return rc;
}

// Fused dual-target deposit: ONE read of ``data`` feeds BOTH my exposed
// slot (the win_put contract of refreshing the window tensor) and the
// mailbox slot at (dst, slot), chunk-interleaved so the source chunk is
// still cache-hot for its second store.  Replaces expose() + write() —
// two full passes over ``data`` — with one.  Lock order: my exposed lock,
// then the remote slot lock; exposed locks are only ever taken by their
// owner rank, so every wait chain terminates (no cycle).
void bf_shm_win_put_dual(void* h, int64_t dst, int64_t slot,
                         const void* data, double p, int32_t mode,
                         double scale, double expose_p) {
  auto* win = static_cast<Window*>(h);
  char* ex = win->exposed(win->rank);
  char* ml = win->mail(dst, slot);
  auto* es = reinterpret_cast<SlotHeader*>(ex);
  auto* ms = reinterpret_cast<SlotHeader*>(ml);
  const char* in = static_cast<const char*>(data);
  slot_lock(es);
  slot_lock(ms);
  bool add = (mode == 1) && (ms->drained != ms->version);
  uint64_t we = es->wseq.load(std::memory_order_relaxed);
  uint64_t wm = ms->wseq.load(std::memory_order_relaxed);
  es->wseq.store(we + 1, std::memory_order_relaxed);
  ms->wseq.store(wm + 1, std::memory_order_relaxed);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  auto* ecs = win->chunk_seqs(ex);
  auto* mcs = win->chunk_seqs(ml);
  char* epay = win->payload(ex);
  char* mpay = win->payload(ml);
  for (int64_t c = 0; c < win->nchunks; ++c) {
    int64_t off = c * win->chunk_bytes;
    int64_t n = win->chunk_len(c);
    uint64_t q = ecs[c].load(std::memory_order_relaxed);
    ecs[c].store(q + 1, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    std::memcpy(epay + off, in + off, static_cast<size_t>(n));
    std::atomic_thread_fence(std::memory_order_release);
    ecs[c].store(q + 2, std::memory_order_release);
    q = mcs[c].load(std::memory_order_relaxed);
    mcs[c].store(q + 1, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    chunk_apply(mpay + off, in + off, n, win->dtype, scale, add);
    std::atomic_thread_fence(std::memory_order_release);
    mcs[c].store(q + 2, std::memory_order_release);
  }
  es->p = expose_p;
  es->version += 1;
  es->drained = 0;  // an exposed slot is never logically empty once set
  if (mode == 1) {
    ms->p = add ? ms->p + p : p;
  } else {
    ms->p = p;
  }
  ms->version += 1;
  std::atomic_thread_fence(std::memory_order_release);
  es->wseq.store(we + 2, std::memory_order_release);
  ms->wseq.store(wm + 2, std::memory_order_release);
  slot_unlock(ms);
  slot_unlock(es);
}

// Fully fused win_update: out = self_weight * self_data + Σ w_i * slot_i
// in ONE chunked sweep, with the per-chunk partial staying cache-resident
// across the per-slot sub-passes; optionally drains the slots (atomic
// with accumulating writers — every slot lock is held for the whole
// combine) and republishes ``out`` as the exposed tensor chunk-by-chunk
// inside the same sweep (the expose pass rides the combine's cache
// locality instead of being a fourth full traversal).  Float windows
// only.  ``expose``: 0 = don't republish, 1 = republish with p = self_p
// (associated-p off: the exposed mass is untouched), 2 = republish with
// p = the combined mass (associated-p on).  Returns the combined scalar
// mass ``self_weight * self_p + Σ w_i * p_i`` (drained slots contribute 0).
// Locks are acquired in ascending slot index, exposed lock first —
// the same no-cycle argument as put_dual.
double bf_shm_win_update_fused(void* h, int64_t nslots,
                               const int64_t* slots, const double* weights,
                               const void* self_data, double self_weight,
                               double self_p, void* out, int32_t collect,
                               int32_t expose) {
  auto* win = static_cast<Window*>(h);
  if (nslots > 64) return 0.0;  // maxd ceiling; callers never exceed it
  char* ex = win->exposed(win->rank);
  auto* es = reinterpret_cast<SlotHeader*>(ex);
  // ascending-index lock order (slots may arrive in neighbor-rank order,
  // which is already ascending in practice; sort defensively)
  int64_t order[64];
  for (int64_t i = 0; i < nslots; ++i) order[i] = i;
  for (int64_t i = 1; i < nslots; ++i)
    for (int64_t j = i; j > 0 && slots[order[j]] < slots[order[j - 1]]; --j) {
      int64_t t = order[j]; order[j] = order[j - 1]; order[j - 1] = t;
    }
  char* epay = win->payload(ex);
  // out == nullptr selects the IN-PLACE form: the combine's destination
  // IS the exposed payload (the reference's window-buffer semantics —
  // win_update writes the memory neighbors read), eliminating both the
  // separate result buffer and the republish copy; the per-chunk seqlock
  // then brackets the whole chunk computation instead of a memcpy.
  char* dst = out ? static_cast<char*>(out) : epay;
  bool in_place = (dst == epay);
  if (in_place && !expose) expose = 1;
  if (expose) slot_lock(es);
  char* ml[64];
  SlotHeader* ms[64];
  bool empty[64];
  for (int64_t i = 0; i < nslots; ++i) {
    ml[i] = win->mail(win->rank, slots[i]);
    ms[i] = reinterpret_cast<SlotHeader*>(ml[i]);
  }
  for (int64_t i = 0; i < nslots; ++i) slot_lock(ms[order[i]]);
  double p_acc = self_weight * self_p;
  for (int64_t i = 0; i < nslots; ++i) {
    empty[i] = (ms[i]->drained == ms[i]->version);
    if (!empty[i]) p_acc += weights[i] * ms[i]->p;
  }
  uint64_t we = 0;
  auto* ecs = win->chunk_seqs(ex);
  if (expose) {
    we = es->wseq.load(std::memory_order_relaxed);
    es->wseq.store(we + 1, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_seq_cst);
  }
  const char* self_in = static_cast<const char*>(self_data);
  for (int64_t c = 0; c < win->nchunks; ++c) {
    int64_t off = c * win->chunk_bytes;
    int64_t n = win->chunk_len(c);
    if (expose) {
      uint64_t q = ecs[c].load(std::memory_order_relaxed);
      ecs[c].store(q + 1, std::memory_order_relaxed);
      std::atomic_thread_fence(std::memory_order_seq_cst);
    }
    // self term first (alias-safe even when dst == self_data, including
    // the coherent-second-mapping case — full exact overlap means every
    // element/lane is read before it is overwritten)
    chunk_apply(dst + off, self_in + off, n, win->dtype, self_weight,
                /*add=*/false);
    for (int64_t i = 0; i < nslots; ++i) {
      if (empty[i]) continue;
      chunk_apply(dst + off, win->payload(ml[i]) + off, n, win->dtype,
                  weights[i], /*add=*/true);
    }
    if (expose) {
      if (!in_place)
        std::memcpy(epay + off, dst + off, static_cast<size_t>(n));
      std::atomic_thread_fence(std::memory_order_release);
      uint64_t q = ecs[c].load(std::memory_order_relaxed);
      ecs[c].store(q + 1, std::memory_order_release);
    }
  }
  if (collect) {
    for (int64_t i = 0; i < nslots; ++i) {
      ms[i]->drained = ms[i]->version;
      ms[i]->p = 0.0;
    }
  }
  if (expose) {
    es->p = (expose == 2) ? p_acc : self_p;
    es->version += 1;
    es->drained = 0;
    std::atomic_thread_fence(std::memory_order_release);
    es->wseq.store(we + 2, std::memory_order_release);
  }
  for (int64_t i = nslots - 1; i >= 0; --i) slot_unlock(ms[order[i]]);
  if (expose) slot_unlock(es);
  return p_acc;
}

// Byte offset of this rank's exposed payload within the segment file.
// Lets Python establish an independent coherent mapping of the exposed
// tensor (np view over its own mmap), so views returned to users stay
// valid after the window's native mapping is unmapped by win_destroy.
int64_t bf_shm_win_exposed_offset(void* h) {
  auto* win = static_cast<Window*>(h);
  return win->slots_off + win->rank * win->slot_stride + win->payload_off;
}

void bf_shm_win_destroy(void* h, int32_t unlink_seg) {
  auto* win = static_cast<Window*>(h);
  segment_close(&win->seg, unlink_seg != 0);
  delete win;
}

void bf_shm_unlink(const char* name) { shm_unlink(name); }

}  // extern "C"
