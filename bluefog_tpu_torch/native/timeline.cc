// Native chrome-trace timeline writer.
//
// TPU-native sibling of the reference's C++ timeline component
// (bluefog/common/timeline.h/.cc [U], SURVEY.md §5.1): a low-overhead,
// thread-safe span recorder with a background flush thread writing
// Chrome-tracing JSON.  The reference stamps per-tensor activity spans from
// its background communication loop; here spans come from the Python op
// veneers (dispatch-side timing; device-side timing lives in jax.profiler).
//
// C ABI (used from Python via ctypes — the environment has no pybind11):
//   bf_timeline_create(path) -> handle
//   bf_timeline_record(handle, name, ts_us, dur_us, tid)
//   bf_timeline_counter(handle, name, ts_us, value)
//   bf_timeline_flush(handle)
//   bf_timeline_destroy(handle)

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Event {
  std::string name;
  double ts_us;
  double dur_us;
  int64_t tid;
  bool is_counter;
  double value;
};

std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

class TimelineWriter {
 public:
  explicit TimelineWriter(const char* path)
      : path_(path), stop_(false), dirty_(false) {
    flusher_ = std::thread([this] { this->Loop(); });
  }

  ~TimelineWriter() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    if (flusher_.joinable()) flusher_.join();
    WriteFile();
  }

  void Record(const char* name, double ts_us, double dur_us, int64_t tid) {
    std::lock_guard<std::mutex> lk(mu_);
    events_.push_back(Event{name, ts_us, dur_us, tid, false, 0.0});
    dirty_ = true;
    cv_.notify_all();
  }

  void Counter(const char* name, double ts_us, double value) {
    std::lock_guard<std::mutex> lk(mu_);
    events_.push_back(Event{name, ts_us, 0.0, 0, true, value});
    dirty_ = true;
    cv_.notify_all();
  }

  void Flush() { WriteFile(); }

 private:
  void Loop() {
    // Periodic background flush, like the reference's writer thread [U]:
    // the trace survives a crashed run without per-event file I/O.
    std::unique_lock<std::mutex> lk(mu_);
    while (!stop_) {
      cv_.wait_for(lk, std::chrono::seconds(2),
                   [this] { return stop_ || dirty_; });
      if (stop_) break;
      if (!dirty_) continue;
      dirty_ = false;
      lk.unlock();
      WriteFile();
      lk.lock();
    }
  }

  void WriteFile() {
    // one writer at a time: the flusher thread and Flush() share the tmp
    // path, and two interleaved writers leave a torn or empty file behind
    std::lock_guard<std::mutex> write_lk(write_mu_);
    std::vector<Event> snapshot;
    {
      std::lock_guard<std::mutex> lk(mu_);
      snapshot = events_;
    }
    std::string tmp = path_ + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "w");
    if (!f) return;
    std::fputs("{\"traceEvents\":[", f);
    bool first = true;
    char buf[512];
    for (const auto& e : snapshot) {
      if (!first) std::fputc(',', f);
      first = false;
      if (e.is_counter) {
        std::snprintf(buf, sizeof(buf),
                      "{\"name\":\"%s\",\"ph\":\"C\",\"ts\":%.3f,\"pid\":0,"
                      "\"args\":{\"value\":%.6g}}",
                      JsonEscape(e.name).c_str(), e.ts_us, e.value);
      } else {
        std::snprintf(buf, sizeof(buf),
                      "{\"name\":\"%s\",\"ph\":\"X\",\"ts\":%.3f,"
                      "\"dur\":%.3f,\"pid\":0,\"tid\":%lld}",
                      JsonEscape(e.name).c_str(), e.ts_us, e.dur_us,
                      static_cast<long long>(e.tid));
      }
      std::fputs(buf, f);
    }
    std::fputs("]}", f);
    std::fclose(f);
    std::rename(tmp.c_str(), path_.c_str());
  }

  std::string path_;
  std::mutex mu_;
  std::mutex write_mu_;
  std::condition_variable cv_;
  std::thread flusher_;
  std::vector<Event> events_;
  bool stop_;
  bool dirty_;
};

}  // namespace

extern "C" {

void* bf_timeline_create(const char* path) { return new TimelineWriter(path); }

void bf_timeline_record(void* h, const char* name, double ts_us, double dur_us,
                        int64_t tid) {
  static_cast<TimelineWriter*>(h)->Record(name, ts_us, dur_us, tid);
}

void bf_timeline_counter(void* h, const char* name, double ts_us,
                         double value) {
  static_cast<TimelineWriter*>(h)->Counter(name, ts_us, value);
}

void bf_timeline_flush(void* h) { static_cast<TimelineWriter*>(h)->Flush(); }

void bf_timeline_destroy(void* h) { delete static_cast<TimelineWriter*>(h); }

}  // extern "C"
