// The native eager engine: background thread + coordinator negotiation +
// peer-to-peer ring data plane.
//
// This is the TPU-host re-design of the reference's core runtime
// (horovod/common/operations.cc): a tensor table + message queue drained by a
// background thread every cycle (RunLoopOnce, operations.cc:2030-2380), a
// rank-0 coordinator that matches named tensors across ranks and validates
// cross-rank consistency (IncrementTensorCount/ConstructResponse,
// operations.cc:287-523), fusion of small same-dtype tensors
// (operations.cc:2154-2266), a handle table for async callers
// (torch/handle_manager.{cc,h}), stall detection with missing-rank lists
// (CheckForStalledTensors, operations.cc:1625-1672), cross-rank autotuner
// synchronization (ParameterManager::SyncParams, parameter_manager.cc:213-233)
// and a timeline.
//
// Architecture (mirrors the reference's control/data-plane split):
// - control plane: every rank sends a METADATA-ONLY request list to the
//   rank-0 coordinator each tick and receives the identical ResponseList —
//   the socket analog of the per-tick MPI_Gatherv + MPI_Bcast
//   (operations.cc:2088-2109, 2282-2287). The response carries execution
//   order, fusion assignments, autotuner knobs and stall warnings.
// - data plane: tensor bytes move only between ring neighbours (ring.h) —
//   reduce-scatter + allgather for allreduce, exactly the shape of the
//   reference's NCCL ring (operations.cc:1221-1446). Rank 0 carries O(bytes),
//   not O(N·bytes), as a rank-0 star relay would.
// - the compiled JAX path bypasses all of this (XLA collectives).
#ifndef HVD_ENGINE_H
#define HVD_ENGINE_H

#include <atomic>
#include <cctype>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "autotuner.h"
#include "cache.h"
#include "fusion.h"
#include "hvd_common.h"
#include "ring.h"
#include "timeline.h"
#include "wire.h"

namespace hvd {

struct Topology {
  int rank = 0, size = 1, local_rank = 0, local_size = 1, cross_rank = 0,
      cross_size = 1;
};

// Always-on engine telemetry: exported through the c_api
// (hvd_metric) and mirrored into the Python metrics registry by
// native_engine.py's collector. Atomics only — the increments sit on the
// executor's hot path and must never take a lock.
struct EngineMetrics {
  std::atomic<uint64_t> allreduce_count{0};
  std::atomic<uint64_t> allgather_count{0};
  std::atomic<uint64_t> broadcast_count{0};
  std::atomic<uint64_t> reducescatter_count{0};
  std::atomic<uint64_t> alltoall_count{0};
  std::atomic<uint64_t> collective_bytes{0};   // input tensor bytes completed
  std::atomic<uint64_t> collective_errors{0};  // entries finished with error
  std::atomic<uint64_t> negotiation_us{0};     // enqueue -> execution-start
  std::atomic<uint64_t> execution_us{0};       // execution wall time
  std::atomic<uint64_t> stall_warnings{0};     // coordinator stall reports seen
  std::atomic<uint64_t> cycles{0};             // negotiation ticks
  // Response cache (cache.h): negotiations sent as a cache bit vs a full
  // request list. hits/(hits+misses) is the steady-state health signal the
  // eager smoke asserts on.
  std::atomic<uint64_t> cache_hits{0};
  std::atomic<uint64_t> cache_misses{0};
  // On-the-wire compression: payload bytes enqueued at the wire
  // dtype, and the bytes the cast avoided vs the caller dtype. Mirrored by
  // native_engine.py into horovod_wire_bytes_{,saved_}total{plane="native"}.
  std::atomic<uint64_t> wire_bytes{0};
  std::atomic<uint64_t> wire_bytes_saved{0};
  // Sparse (topk) subset of the wire counters: frame bytes the
  // sparse hops shipped and the bytes they avoided vs dense f32 hops.
  // native_engine.py feeds these to the SAME method="topk"-labeled
  // horovod_wire_bytes_saved_total series the Python engine increments.
  std::atomic<uint64_t> topk_wire_bytes{0};
  std::atomic<uint64_t> topk_wire_bytes_saved{0};
};

// HOROVOD_COMPRESSION={none,fp16,bf16} -> the 16-bit wire dtype allreduce
// payloads are cast to at enqueue, or -1 for none/unknown. Read from the
// env like the cache capacity (native_engine.py exports the Config value
// right before hvd_init).
inline int wire_dtype_from_env() {
  const char* v = std::getenv("HOROVOD_COMPRESSION");
  if (!v || !*v) return -1;
  std::string s(v);
  for (auto& c : s) c = (char)std::tolower((unsigned char)c);
  if (s == "fp16") return (int)DataType::F16;
  if (s == "bf16") return (int)DataType::BF16;
  return -1;
}

// HOROVOD_COMPRESSION sparse/adaptive half (the native topk
// plane). Mirrors compression.py parse_spec + topk_ratio_from_env: `topk`
// and `topk@<ratio>` are first-class, `adaptive` hands the per-tensor
// format choice to the deterministic (size, dtype, topology) table that
// common/policy.py defines — evaluated identically on every rank, so the
// coordinator's cross-rank wire validation holds with zero negotiation.
struct SparseSpec {
  bool topk = false;      // explicit topk[@ratio]
  bool adaptive = false;  // per-tensor policy table
  double ratio = 0.01;    // DEFAULT_TOPK_RATIO, clamped to (0, 0.5]
};

inline SparseSpec sparse_spec_from_env() {
  SparseSpec out;
  const char* r = std::getenv("HOROVOD_TOPK_RATIO");
  if (r && *r) {
    double v = std::atof(r);
    if (v > 0) out.ratio = v < 0.5 ? v : 0.5;
  }
  const char* c = std::getenv("HOROVOD_COMPRESSION");
  if (!c || !*c) return out;
  std::string s(c);
  for (auto& ch : s) ch = (char)std::tolower((unsigned char)ch);
  if (s == "adaptive") {
    out.adaptive = true;
  } else if (s == "topk") {
    out.topk = true;
  } else if (s.rfind("topk@", 0) == 0) {
    double v = std::atof(s.c_str() + 5);
    if (v > 0) {
      out.topk = true;
      out.ratio = v < 0.5 ? v : 0.5;  // @ratio overrides the env knob
    }
  }
  return out;
}

// One rank's registration record: ring endpoints plus its host coordinates.
// The coordinator gathers these in hello and broadcasts the full map, which
// is what lets every rank build the two-level (intra-host / cross-host)
// rings without any side channel — the reference gets the same information
// from its local_comm / cross_comm MPI splits (operations.cc:1684-1721).
struct PeerInfo {
  std::string host;
  int port = 0;        // flat-ring listener (always present)
  int local_port = 0;  // intra-host ring listener (0 = not offered)
  int cross_port = 0;  // cross-host ring listener (0 = not offered)
  int local_rank = 0, local_size = 1, cross_rank = 0, cross_size = 1;
};

// The two-level ring plan derived from the registered PeerInfo map.
// `capable` requires a homogeneous grid: every rank offers sub-ring ports,
// local_size/cross_size agree everywhere, and each (cross_rank, local_rank)
// cell is occupied exactly once (the reference gates its hierarchical ops on
// the same homogeneity check, operations.cc:1712-1721). `blocked` addition-
// ally requires global rank == cross_rank*local_size + local_rank, which the
// two-stage allgather needs so host blocks are contiguous in rank order.
struct HierPlan {
  bool capable = false;
  bool blocked = false;
  std::vector<int> local_group;  // global ranks on my host, by local_rank
  std::vector<int> cross_group;  // global ranks sharing my local_rank, by cross_rank
};
HierPlan analyze_hier(const std::vector<PeerInfo>& peers, int my_rank);

struct EngineConfig {
  double cycle_time_ms = 5.0;            // HOROVOD_CYCLE_TIME
  size_t fusion_threshold = 64u << 20;   // HOROVOD_FUSION_THRESHOLD
  std::string timeline_path;             // HOROVOD_TIMELINE
  bool timeline_mark_cycles = false;     // HOROVOD_TIMELINE_MARK_CYCLES
  bool stall_check_disable = false;      // HOROVOD_STALL_CHECK_DISABLE
  double stall_warning_s = 60.0;         // STALL_WARNING_TIME
  bool autotune = false;                 // HOROVOD_AUTOTUNE
  std::string autotune_log;              // HOROVOD_AUTOTUNE_LOG
  bool threshold_pinned = false;         // env pinned HOROVOD_FUSION_THRESHOLD
  bool cycle_pinned = false;             // env pinned HOROVOD_CYCLE_TIME
  bool hierarchical_allreduce = false;   // HOROVOD_HIERARCHICAL_ALLREDUCE
  bool hierarchical_allgather = false;   // HOROVOD_HIERARCHICAL_ALLGATHER
  bool hier_allreduce_pinned = false;    // env pinned the allreduce flag
  bool hier_allgather_pinned = false;    // env pinned the allgather flag
  std::string coord_host;
  int coord_port = 0;
  // A listening socket bound before init (hvd_coord_listen), whose port the
  // caller published to the other ranks; the coordinator adopts it instead
  // of binding coord_port itself. -1: bind coord_port.
  int coord_listen_fd = -1;
};

// int handle -> result map (reference torch/handle_manager.{cc,h}).
class HandleManager {
 public:
  int64_t allocate();
  void mark_done(int64_t h, Status status, Response result);
  bool poll(int64_t h);
  // timeout_s < 0: wait forever; == 0: immediate poll. Timeout returns
  // IN_PROGRESS WITHOUT consuming the handle (the op is still in flight and
  // its result must stay claimable — a later wait/release owns it).
  Status wait(int64_t h, double timeout_s);   // leaves result in place
  const Response* peek(int64_t h);
  void release(int64_t h);

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  int64_t next_ = 0;
  std::map<int64_t, std::pair<Status, Response>> done_;
};

class Coordinator;  // rank-0 control-plane server
class Client;       // per-rank connection to the coordinator

class Engine {
 public:
  Engine(const Topology& topo, const EngineConfig& cfg);
  ~Engine();

  // Async enqueue (reference EnqueueTensorAllreduce/..., operations.cc:2472-2591).
  int64_t enqueue(OpType op, const std::string& name, DataType dtype,
                  const std::vector<int64_t>& shape, const void* data,
                  int root_rank, bool average);
  bool poll(int64_t handle) { return handles_.poll(handle); }
  Status wait(int64_t handle, double timeout_s) {
    return handles_.wait(handle, timeout_s);
  }
  const Response* peek(int64_t handle) { return handles_.peek(handle); }
  void release(int64_t handle) { handles_.release(handle); }

  void shutdown();
  const Topology& topology() const { return topo_; }
  // Live knob values (the coordinator's autotuner broadcasts these; every
  // rank applies the same values on the same tick).
  double cycle_time_ms() const { return cycle_time_ms_; }
  int64_t fusion_threshold() const { return fusion_threshold_; }
  uint32_t knob_version() const { return applied_knob_version_; }
  const RingStats& stats() const { return stats_; }
  const RingStats& cross_stats() const { return cross_stats_; }
  bool hierarchical_allreduce_on() const { return hier_allreduce_.load(); }
  bool hierarchical_allgather_on() const { return hier_allgather_.load(); }
  bool hierarchical_capable() const { return hier_.capable; }
  // Links riding the shared-memory plane (0..6: next/prev on each of the
  // flat/local/cross rings). Tests assert same-host links really upgraded.
  int shm_links() const {
    int n = 0;
    for (const RingLinks* r : {&ring_, &local_ring_, &cross_ring_}) {
      n += r->shm_next_active() ? 1 : 0;
      n += r->shm_prev_active() ? 1 : 0;
    }
    return n;
  }

  // Scoped timeline attach for hvd.timeline.trace(): start a timeline at
  // runtime when none was configured via HOROVOD_TIMELINE. Returns 1 if
  // THIS call opened it (the caller must stop it), 0 if one is already
  // running or this rank doesn't write (rank 0 only, like the reference).
  int timeline_start(const std::string& path, bool mark_cycles) {
    if (topo_.rank != 0 || timeline_.healthy()) return 0;
    timeline_.init(path, mark_cycles);
    return timeline_.healthy() ? 1 : 0;
  }
  void timeline_stop() { timeline_.shutdown(); }

  // Response-cache surface: live mirror size and an explicit flush (used
  // on elastic resets/membership changes; the mirror self-heals because
  // the coordinator re-announces an assignment whenever a full request
  // arrives for an already-bound signature).
  int cache_size() {
    std::lock_guard<std::mutex> g(cache_mu_);
    return (int)cache_key_to_bit_.size();
  }
  void cache_flush() {
    {
      std::lock_guard<std::mutex> g(cache_mu_);
      cache_key_to_bit_.clear();
      cache_bit_to_key_.clear();
    }
    // Error-feedback residuals drop with the cached negotiations (elastic
    // reset / membership change), matching the Python engine: a stale
    // residual folded into a fresh world would skew the first step.
    std::lock_guard<std::mutex> g(residual_mu_);
    residuals_.clear();
  }

  // Live wire-compression dtype: (int)DataType of the 16-bit wire format,
  // or -1 when HOROVOD_COMPRESSION is none (c_api hvd_compression).
  int wire_dtype() const {
    std::lock_guard<std::mutex> g(wire_knob_mu_);
    return wire_dtype_;
  }

  // Live wire-format retune (runtime controller): re-parses a
  // HOROVOD_COMPRESSION-style spec ("none"/"bf16"/"fp16"/"topk[@r]"/
  // "adaptive") and swaps it in under the knob mutex — later enqueues
  // quantize under the new table; already-enqueued entries keep the bytes
  // they framed. topk_ratio > 0 overrides the spec's @ratio. Bitwise
  // safety across ranks is the caller's job: land it inside a coordinator
  // knob epoch (Python engine set_knobs) so every rank switches on the
  // same collective boundary.
  void set_wire_format(const std::string& spec, double topk_ratio);

  // Engine telemetry counters (c_api hvd_metric / hvd_last_stall).
  const EngineMetrics& op_metrics() const { return metrics_; }
  uint64_t timeline_dropped() const { return timeline_.dropped(); }
  std::string last_stall() const {
    std::lock_guard<std::mutex> g(stall_mu_);
    return last_stall_;
  }

  // ---- distributed tracing (docs/tracing.md) ----
  // Span records accumulate as pre-formatted JSON lines (the same schema
  // the Python recorder writes) in a bounded queue; the Python binding
  // drains them through hvd_trace_drain into this rank's span file, so ONE
  // writer owns the file whichever engine produced the span. Enabled by
  // HOROVOD_TRACE_DIR (read once at construction, like the wire dtype).
  bool trace_enabled() const { return trace_enabled_; }
  // Copy up to cap-1 bytes of whole drained lines into buf (NUL-
  // terminated); returns bytes written (0 = nothing pending).
  long long trace_drain(char* buf, long long cap);

 private:
  struct Entry {
    Request req;
    Buffer data;  // this rank's contribution (host bytes; owned)
    // Zero-copy enqueue: uncompressed allreduce contributions
    // are BORROWED from the caller (read-only; the ctypes binding pins
    // the numpy buffer until the handle completes) instead of copied —
    // `data` stays empty and the fold writes a fresh output buffer.
    const uint8_t* borrow = nullptr;
    size_t borrow_bytes = 0;
    int64_t handle = 0;
    std::chrono::steady_clock::time_point enqueued;
  };

  void loop();                       // reference BackgroundThreadLoop/RunLoopOnce
  // Adaptive cycle: sleep until enqueue()/shutdown() wakes us, at most the
  // cycle time while work is in flight, backing off exponentially (capped)
  // when fully idle — small eager ops skip the half-cycle latency tax and
  // idle workers stop spinning empty barrier rounds.
  void wait_for_work();
  void complete_local(Entry& e);     // size==1 fast path
  // One cycle of the multi-process path: exchange metadata, execute the
  // broadcast list over the ring. Returns false when the loop must exit.
  bool tick_multiprocess(bool shutting);
  void execute_list(const ResponseList& list);
  void execute_entry(const ResponseEntry& re);
  void execute_allreduce(const ResponseEntry& re, std::vector<Entry>& ents);
  // Sparse (topk) allreduce over the entry's own enqueue-sparsified dense
  // f32 buffer: flat sparse ring, or the two-level sparse ladder.
  void execute_sparse_allreduce(const ResponseEntry& re, Entry& ent);
  // One allreduce pass over `count` elements in `buf`: flat ring, or the
  // two-level ladder when the hierarchical knob is on and topology allows.
  void allreduce_buffer(uint8_t* buf, size_t count, size_t esize, DataType d,
                        bool average);
  // Same pass with a READ-ONLY input and separate output (the zero-copy
  // borrowed-enqueue path): reduce-scatter folds in+incoming into out,
  // the rest of the ladder runs in place on out.
  void allreduce_buffer_into(const uint8_t* in, uint8_t* out, size_t count,
                             size_t esize, DataType d, bool average);
  void execute_allgather(const ResponseEntry& re, Entry& ent);
  void execute_broadcast(const ResponseEntry& re, Entry& ent);
  void execute_reducescatter(const ResponseEntry& re, Entry& ent);
  void execute_alltoall(const ResponseEntry& re, Entry& ent);
  void finish(Entry& e, Status st, Response res);  // mark done + release name
  void fail_everything(const std::string& reason);

  // Tracing internals: record one span (JSON line) under the bounded cap.
  static uint64_t now_ns();
  std::string trace_tid(const Request& req) const;
  void trace_span(const std::string& tid, const std::string& name,
                  OpType op, const char* phase, uint64_t t0_ns,
                  uint64_t t1_ns, uint64_t bytes);
  bool trace_enabled_ = false;
  std::mutex trace_mu_;
  std::deque<std::string> trace_q_;           // pending JSON lines
  uint64_t trace_dropped_ = 0;                // shed past the cap
  std::unordered_map<std::string, uint32_t> trace_seq_;  // loop/enqueue under qmu_

  // Non-empty after a ring transport failure: the peer streams may be
  // desynced (no per-chunk framing), so every later collective fails fast
  // and the loop departs the job instead of risking silent corruption.
  std::string ring_error_;

  Topology topo_;
  EngineConfig cfg_;
  HandleManager handles_;
  Timeline timeline_;
  std::mutex qmu_;
  std::condition_variable qcv_;  // wake-on-enqueue (adaptive cycle)
  int idle_streak_ = 0;          // loop-thread only
  std::deque<Entry> queue_;  // newly enqueued, not yet negotiated
  // Per-rank response-cache mirror (cache.h): follows the coordinator's
  // broadcast assign/evict announcements. Touched by the loop thread;
  // cache_mu_ covers the API-thread flush/size calls.
  std::mutex cache_mu_;
  std::unordered_map<std::string, uint32_t> cache_key_to_bit_;
  std::unordered_map<uint32_t, std::string> cache_bit_to_key_;
  // Sent to the coordinator, awaiting a ResponseList entry. Owned by the
  // loop thread exclusively — no lock (reference tensor_table is the same
  // idea guarded by its global mutex; here single ownership replaces it).
  std::map<std::string, Entry> table_;
  // Names queued or in flight: a second enqueue of a live name is a caller
  // bug the reference rejects loudly (test_torch.py:356 duplicate-name test).
  std::set<std::string> inflight_;
  std::atomic<bool> shutdown_{false};
  std::thread bg_;
  std::unique_ptr<Coordinator> coord_;
  std::unique_ptr<Client> client_;
  RingLinks ring_;
  // Two-level data plane (hierarchical collectives): a ring among the ranks
  // of this host, and a ring among the ranks sharing this local_rank across
  // hosts. Established only when the registered topology is a homogeneous
  // multi-host grid (analyze_hier).
  RingLinks local_ring_;
  RingLinks cross_ring_;
  HierPlan hier_;
  std::atomic<bool> hier_allreduce_{false};
  std::atomic<bool> hier_allgather_{false};
  RingStats stats_;
  RingStats cross_stats_;  // bytes whose next hop crosses a host boundary
  EngineMetrics metrics_;
  mutable std::mutex stall_mu_;
  std::string last_stall_;  // latest stall warning text (diagnostics)
  FusionBuffer fusion_buf_;
  // (The old receive-bounce scratch arena is gone: the reduce-scatter now
  // folds incoming bytes straight into the accumulator chunk —
  // ring.h transfer_apply + ReduceCursor.)
  std::unique_ptr<ParameterManager> pm_;  // single-process tuning only
  // HOROVOD_COMPRESSION wire dtype ((int)DataType, -1 = none): allreduce
  // payloads are cast to it at enqueue (cast-on-send) and restored to the
  // caller dtype at completion; the ring then moves and reduces 2-byte
  // elements natively (add_chunk accumulates each add in f32, ring.h).
  int wire_dtype_ = -1;
  // Sparse/adaptive wire config: parsed at construction from
  // the same env knobs the Python engine reads; retunable live through
  // set_wire_format — every read copies under wire_knob_mu_.
  mutable std::mutex wire_knob_mu_;
  SparseSpec sparse_;
  int64_t topk_min_bytes_ = 1 << 16;        // HOROVOD_TOPK_MIN_BYTES
  int64_t compression_min_bytes_ = 4096;    // HOROVOD_COMPRESSION_MIN_BYTES
  bool ef_cast_ = false;   // EF for bf16/fp16 casts (env "1")
  bool ef_topk_ = true;    // EF for topk (defaults ON; env "0" disables)
  bool flat_next_cross_ = false;  // flat ring's next link crosses hosts
  // Per-tensor error-feedback residuals (orig-dtype bytes), claimed at
  // enqueue and re-stored with the un-sent mass (DGC). Guarded: enqueue
  // runs on API threads, cache_flush may race from another thread.
  std::mutex residual_mu_;
  std::unordered_map<std::string, std::pair<DataType, std::vector<uint8_t>>>
      residuals_;
  std::atomic<double> cycle_time_ms_{5.0};
  std::atomic<int64_t> fusion_threshold_{64 << 20};
  std::atomic<uint32_t> applied_knob_version_{0};
};

// ---------------------------------------------------------------- coordinator

// Rank-0 control-plane server. Per tick it gathers every rank's request
// list, matches names across ranks in arrival order, validates
// (ConstructResponse semantics: mismatched op/dtype/shape/root across ranks
// produce an ERROR response for every rank instead of a deadlock,
// operations.cc:321-523), plans fusion buckets, tunes knobs, detects stalls
// with missing-rank lists, and broadcasts one identical ResponseList to all
// ranks. It never sees tensor bytes.
class Coordinator {
 public:
  Coordinator(int world, const std::string& host, int port, Timeline* timeline,
              const EngineConfig& cfg);
  ~Coordinator();
  void stop();

  // Registration: blocks until every rank reported its ring endpoints and
  // host coordinates, then returns the full rank-indexed peer map.
  std::vector<PeerInfo> hello(int rank, const PeerInfo& info);
  // One tick: contribute this rank's request list, block on the generation
  // barrier, return the broadcast ResponseList. In-process for rank 0,
  // called from serve threads for the rest.
  ResponseList tick(int rank, const TickRequest& req);
  // A rank's connection dropped or it sent shutdown: stop waiting for it.
  void mark_departed(int rank);
  // Grace for Engine::shutdown: wait until all ranks departed (or timeout)
  // so the final ResponseLists get delivered before the listener dies.
  void await_departure(double timeout_s);

 private:
  void accept_loop();
  void serve(int fd);
  bool barrier_complete() const;         // callers hold mu_
  void build_response_list();            // callers hold mu_
  // Scan the message table for tensors stalled past the warning window and
  // collect fresh warnings (callers hold mu_). Runs both at barrier
  // completion and from the 1 s wakeups of waiting ticks, so a rank that
  // stops ticking entirely still produces diagnostics on rank 0.
  std::vector<std::string> scan_stalls(std::chrono::steady_clock::time_point now);
  // Validation; returns an ERROR entry or fills `ok`.
  bool validate(const std::string& name,
                const std::map<int, Request>& contribs, ResponseEntry* entry);

  struct PendingTensor {
    std::map<int, Request> contribs;     // rank -> metadata
    std::chrono::steady_clock::time_point first_seen;
    std::chrono::steady_clock::time_point last_warned;
    bool warned = false;
  };

  int world_;
  int listen_fd_ = -1;
  Timeline* timeline_;
  EngineConfig cfg_;
  std::string secret_;
  std::atomic<bool> stop_{false};
  std::thread accept_thread_;
  std::vector<std::thread> serve_threads_;
  std::vector<int> client_fds_;  // live client sockets, unblocked on stop()
  std::mutex mu_;
  std::condition_variable cv_;
  // hello stage
  std::vector<PeerInfo> peers_;
  int hello_count_ = 0;
  // tick stage
  uint64_t gen_ = 0;
  std::set<int> contributed_;
  std::set<int> departed_;
  // Ranks whose connection dropped WITHOUT the clean shutdown flag (crash,
  // SIGKILL, network loss). Their tensors can never become ready and the
  // ring through them is dead, so every pending and future collective is
  // failed with an error naming them — survivors get a clean error + the
  // checkpoint/resume story instead of the reference's indefinite stall.
  std::set<int> dead_ranks_;
  bool shutdown_seen_ = false;
  ResponseList current_;
  std::map<std::string, PendingTensor> pending_;   // the message table
  std::vector<std::string> arrival_order_;
  // Response-cache authority (cache.h). Announcements produced outside
  // build_response_list (shape-change invalidation, mirror re-heal seen at
  // tick arrival) buffer here and ride the next broadcast.
  CacheAuthority cache_;
  ResponseList cache_announce_;  // only cache_evict/cache_assign used
  // Warnings produced by timer-driven scans while the barrier is stuck;
  // drained into the next ResponseList so every rank eventually sees them.
  std::vector<std::string> deferred_warnings_;
  // knobs (reference ParameterManager::SyncParams: tuned once, applied
  // everywhere on the same tick — here the tick IS the broadcast)
  std::unique_ptr<ParameterManager> pm_;
  uint32_t knob_version_ = 0;
  int64_t knob_threshold_;
  double knob_cycle_ms_;
  bool knob_hier_allreduce_ = false;
  bool knob_hier_allgather_ = false;
  std::chrono::steady_clock::time_point last_barrier_;
};

class Client {
 public:
  Client(const std::string& host, int port, int rank, double timeout_s);
  ~Client();
  // Registration round-trip; returns the rank-indexed peer map.
  std::vector<PeerInfo> hello(const PeerInfo& info);
  ResponseList tick(const TickRequest& req);
  // Local address of the control connection — the interface that routes to
  // the coordinator, advertised for this rank's ring listener.
  std::string local_host() const;

 private:
  int fd_ = -1;
  int rank_;
  std::mutex mu_;
};

}  // namespace hvd

#endif  // HVD_ENGINE_H
