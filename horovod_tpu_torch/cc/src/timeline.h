// Chrome-tracing timeline writer.
//
// Native equivalent of the reference Timeline/TimelineWriter
// (horovod/common/timeline.{cc,h}): every tensor-state transition emits an
// event into a bounded queue drained by a dedicated writer thread
// (timeline.cc:120-146). The reference uses a boost lock-free SPSC queue of
// capacity 1M; a mutexed deque with the same capacity bound keeps the
// dependency surface zero and the enqueue cost irrelevant next to socket IO.
// Output format: catapult JSON (docs/timeline.md), one pid per tensor lane.
#ifndef HVD_TIMELINE_H
#define HVD_TIMELINE_H

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>

namespace hvd {

class Timeline {
 public:
  Timeline() = default;
  ~Timeline() { shutdown(); }

  void init(const std::string& path, bool mark_cycles) {
    std::lock_guard<std::mutex> g(mu_);
    if (file_) return;
    if (writer_.joinable()) writer_.join();  // previous trace fully retired
    file_ = std::fopen(path.c_str(), "w");
    if (!file_) return;
    std::fputs("[\n", file_);
    first_ = true;
    pids_.clear();  // fresh lane map per trace file
    mark_cycles_ = mark_cycles;
    start_ = now_us();
    healthy_ = true;
    writer_ = std::thread([this] { writer_loop(); });
  }

  bool healthy() const { return healthy_; }

  // Negotiation phases (reference timeline.h:83-89).
  void negotiate_start(const std::string& tensor, const char* op) {
    emit(tensor, 'B', std::string("NEGOTIATE_") + op, "");
  }
  void negotiate_rank_ready(const std::string& tensor, int rank) {
    emit(tensor, 'i', std::to_string(rank), "");
  }
  void negotiate_end(const std::string& tensor) { emit(tensor, 'E', "", ""); }

  // Processing phases (reference timeline.h:90-93).
  void start(const std::string& tensor, const char* op) { emit(tensor, 'B', op, ""); }
  void activity_start(const std::string& tensor, const char* activity) {
    emit(tensor, 'B', activity, "");
  }
  void activity_end(const std::string& tensor) { emit(tensor, 'E', "", ""); }
  void end(const std::string& tensor) { emit(tensor, 'E', "", ""); }

  void mark_cycle_start() {
    if (healthy_.load(std::memory_order_relaxed) &&
        mark_cycles_.load(std::memory_order_relaxed))
      emit("CYCLE", 'i', "CYCLE_START", "");
  }

  void shutdown() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (!healthy_) return;
      healthy_ = false;
      cv_.notify_all();
    }
    if (writer_.joinable()) writer_.join();
    if (file_) {
      std::fputs("\n]\n", file_);
      std::fclose(file_);
      file_ = nullptr;
    }
  }

  // Events dropped because the writer queue was full (exposed through the
  // c_api as the `timeline_dropped` metric): the hot path NEVER blocks on
  // file IO — under backpressure it sheds events and counts the shed.
  uint64_t dropped() const {
    return dropped_.load(std::memory_order_relaxed);
  }

 private:
  struct Event {
    char phase;         // B / E / i
    std::string tensor;
    std::string name;
    int64_t ts_us;
  };

  static int64_t now_us() {
    return std::chrono::duration_cast<std::chrono::microseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
  }

  void emit(const std::string& tensor, char phase, const std::string& name,
            const std::string&) {
    if (!healthy_.load(std::memory_order_relaxed)) return;  // cheap fast-out
    std::lock_guard<std::mutex> g(mu_);
    // Re-check under the lock: timeline_start/stop may now run from a user
    // thread (hvd.timeline.trace) concurrently with engine emits, and an
    // event enqueued after shutdown drained the queue would leak into the
    // NEXT trace file with a stale start_ baseline.
    if (!healthy_) return;
    if (queue_.size() >= kCapacity) {  // drop, like a full SPSC queue
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return;
    }
    queue_.push_back(Event{phase, tensor, name, now_us() - start_});
    cv_.notify_one();
  }

  void writer_loop() {
    std::unique_lock<std::mutex> lk(mu_);
    while (healthy_ || !queue_.empty()) {
      if (queue_.empty()) {
        cv_.wait_for(lk, std::chrono::milliseconds(50));
        continue;
      }
      Event e = std::move(queue_.front());
      queue_.pop_front();
      lk.unlock();
      write_event(e);
      lk.lock();
    }
  }

  // Tensor names come from user code: escape them so a quote or backslash
  // cannot corrupt the trace JSON.
  static std::string json_escape(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (char c : s) {
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\n': out += "\\n"; break;
        case '\t': out += "\\t"; break;
        case '\r': out += "\\r"; break;
        default:
          if ((unsigned char)c < 0x20) {
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

  // Comma BEFORE each record (except the first) keeps the file valid JSON
  // at close — a trailing comma between the last event and "]" breaks
  // strict parsers (ci.sh validates the shape), even though Chrome's own
  // loader tolerates it.
  void begin_record() {
    if (!first_) std::fputs(",\n", file_);
    first_ = false;
  }

  void write_event(const Event& e) {
    int pid = pid_for(e.tensor);
    begin_record();
    if (e.phase == 'E') {
      std::fprintf(file_, "{\"ph\":\"E\",\"pid\":%d,\"ts\":%lld}", pid,
                   (long long)e.ts_us);
    } else {
      std::fprintf(file_,
                   "{\"ph\":\"%c\",\"pid\":%d,\"ts\":%lld,\"name\":\"%s\"%s}",
                   e.phase, pid, (long long)e.ts_us,
                   json_escape(e.name).c_str(),
                   e.phase == 'i' ? ",\"s\":\"p\"" : "");
    }
    std::fflush(file_);
  }

  int pid_for(const std::string& tensor) {
    auto it = pids_.find(tensor);
    if (it != pids_.end()) return it->second;
    int pid = (int)pids_.size() + 1;
    pids_[tensor] = pid;
    // metadata record naming the lane (reference timeline.cc WriteAtFileStart)
    begin_record();
    std::fprintf(file_,
                 "{\"ph\":\"M\",\"pid\":%d,\"name\":\"process_name\","
                 "\"args\":{\"name\":\"%s\"}}",
                 pid, json_escape(tensor).c_str());
    return pid;
  }

  static constexpr size_t kCapacity = 1 << 20;  // reference timeline.h:66
  std::FILE* file_ = nullptr;
  bool first_ = true;                 // writer thread only (after init)
  std::atomic<uint64_t> dropped_{0};  // survives across trace files
  // atomics: read lock-free on the emit fast path, written by runtime
  // attach/detach (timeline_start/stop) from another thread
  std::atomic<bool> healthy_{false};
  std::atomic<bool> mark_cycles_{false};
  int64_t start_ = 0;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Event> queue_;
  std::thread writer_;
  std::unordered_map<std::string, int> pids_;
};

}  // namespace hvd

#endif  // HVD_TIMELINE_H
