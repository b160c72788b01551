// C ABI over the native engine, consumed from Python via ctypes.
//
// The reference exposes horovod_init/_rank/_size/... as a C ABI wrapped by
// the ctypes HorovodBasics (reference horovod/common/operations.h:76-106,
// horovod/common/__init__.py:51-154) and per-framework enqueue entry points
// (EnqueueTensorAllreduce etc). pybind11 isn't available in this image, so
// the whole native surface is C functions; horovod_tpu/cc/native_engine.py
// is the HorovodBasics analog.
#include <cstring>
#include <memory>
#include <mutex>
#include <string>

#include "engine.h"

using namespace hvd;

namespace {
// shared_ptr so data-path calls hold the engine alive across a concurrent
// hvd_shutdown (ctypes releases the GIL, so hvd_wait can be blocked in one
// thread while another shuts down).
std::shared_ptr<Engine> g_engine;
std::mutex g_mu;
// The coordinator's listener bound by hvd_coord_listen, adopted by the next
// hvd_init of rank 0 (and closed by any other init, so it never leaks).
int g_coord_fd = -1;

std::shared_ptr<Engine> engine() {
  std::lock_guard<std::mutex> g(g_mu);
  return g_engine;
}
}  // namespace

#include <malloc.h>

extern "C" {

// Returns 0 on success. coord_host may be "" for single-process worlds.
int hvd_init(int rank, int size, int local_rank, int local_size, int cross_rank,
             int cross_size, const char* coord_host, int coord_port,
             double cycle_time_ms, long long fusion_threshold,
             const char* timeline_path, int timeline_mark_cycles,
             int stall_check_disable, double stall_warning_s, int autotune,
             const char* autotune_log, int threshold_pinned, int cycle_pinned,
             int hierarchical_allreduce, int hierarchical_allgather,
             int hier_allreduce_pinned, int hier_allgather_pinned,
             char* err, int errcap) {
  std::lock_guard<std::mutex> g(g_mu);
  if (g_engine) return 0;  // idempotent (reference InitializeHorovodOnce)
  try {
    // Keep gradient-sized allocations in the brk arena instead of fresh
    // mmaps: glibc hands every >128 KiB allocation its own mmap and returns
    // it to the kernel on free, so each collective's tensor-table entry,
    // response vector, and numpy result re-faults ~25k pages per 100 MB —
    // measured at roughly a memcpy's cost per buffer on this class of host.
    // Raising M_MMAP_THRESHOLD makes the allocator RE-USE those pages
    // across iterations (process-wide, numpy included — the eager path's
    // analog of the reference's fusion-buffer reuse). M_TRIM_THRESHOLD
    // stays moderate: a 512 MiB trim threshold pinned every
    // freed gradient-sized block in the arena process-wide for the life of
    // the job; 64 MiB keeps steady-state reuse (the hot path frees and
    // re-allocates same-sized buffers well under a trim window) while
    // letting genuinely idle memory drain back to the kernel. Shutdown
    // malloc_trim()s whatever is left (hvd_shutdown below). Footprint
    // stays bounded by peak live bytes; HOROVOD_NO_MALLOC_TUNING=1 opts
    // out.
    const char* no_tune = std::getenv("HOROVOD_NO_MALLOC_TUNING");
    if (!(no_tune && std::string(no_tune) == "1")) {
      ::mallopt(M_MMAP_THRESHOLD, 512 << 20);
      ::mallopt(M_TRIM_THRESHOLD, 64 << 20);
    }
    Topology t{rank, size, local_rank, local_size, cross_rank, cross_size};
    EngineConfig c;
    c.cycle_time_ms = cycle_time_ms;
    c.fusion_threshold = (size_t)fusion_threshold;
    c.timeline_path = timeline_path ? timeline_path : "";
    c.timeline_mark_cycles = timeline_mark_cycles != 0;
    c.stall_check_disable = stall_check_disable != 0;
    if (stall_warning_s > 0) c.stall_warning_s = stall_warning_s;
    c.autotune = autotune != 0;
    c.autotune_log = autotune_log ? autotune_log : "";
    c.threshold_pinned = threshold_pinned != 0;
    c.cycle_pinned = cycle_pinned != 0;
    c.hierarchical_allreduce = hierarchical_allreduce != 0;
    c.hierarchical_allgather = hierarchical_allgather != 0;
    c.hier_allreduce_pinned = hier_allreduce_pinned != 0;
    c.hier_allgather_pinned = hier_allgather_pinned != 0;
    c.coord_host = coord_host ? coord_host : "";
    c.coord_port = coord_port;
    if (g_coord_fd >= 0) {
      if (rank == 0 && size > 1) {
        c.coord_listen_fd = g_coord_fd;
      } else {
        ::close(g_coord_fd);
      }
      g_coord_fd = -1;
    }
    g_engine = std::make_shared<Engine>(t, c);
    return 0;
  } catch (const std::exception& ex) {
    if (err && errcap > 0) std::snprintf(err, (size_t)errcap, "%s", ex.what());
    return 1;
  }
}

// Binds the coordinator's listener on `host` at a port the kernel picks and
// keeps it for the next hvd_init, so that rank 0 can publish the port to the
// other ranks before its init blocks waiting for them. Returns the port, or
// -1 with the reason in `err`.
int hvd_coord_listen(const char* host, int backlog, char* err, int errcap) {
  std::lock_guard<std::mutex> g(g_mu);
  try {
    if (g_coord_fd >= 0) ::close(g_coord_fd);
    g_coord_fd = listen_on(host ? host : "", 0, backlog);
    return bound_port(g_coord_fd);
  } catch (const std::exception& ex) {
    g_coord_fd = -1;
    if (err && errcap > 0) std::snprintf(err, (size_t)errcap, "%s", ex.what());
    return -1;
  }
}

void hvd_shutdown() {
  std::shared_ptr<Engine> eng;
  {
    std::lock_guard<std::mutex> g(g_mu);
    eng = std::move(g_engine);
    g_engine.reset();
  }
  if (eng) {
    eng->shutdown();  // destructor runs when the last caller drops it
    eng.reset();
    // Return the arena's dead pages to the kernel now that the engine's
    // buffers are gone (the counterpart of the raised M_MMAP_THRESHOLD in
    // hvd_init — re-init re-tunes, so trimming here is always safe).
    ::malloc_trim(0);
  }
}

int hvd_is_initialized() { return engine() ? 1 : 0; }
int hvd_rank() { auto e = engine(); return e ? e->topology().rank : -1; }
int hvd_size() { auto e = engine(); return e ? e->topology().size : -1; }
int hvd_local_rank() { auto e = engine(); return e ? e->topology().local_rank : -1; }
int hvd_local_size() { auto e = engine(); return e ? e->topology().local_size : -1; }

// op / dtype use the enum orders in hvd_common.h. Returns handle >= 0, or -1.
long long hvd_enqueue(int op, const char* name, int dtype,
                      const long long* shape, int ndim, const void* data,
                      int root_rank, int average, char* err, int errcap) {
  auto eng = engine();
  if (!eng) return -1;
  try {
    std::vector<int64_t> s(shape, shape + ndim);
    return eng->enqueue((OpType)op, name, (DataType)dtype, s, data,
                        root_rank, average != 0);
  } catch (const std::exception& ex) {
    if (err && errcap > 0) std::snprintf(err, (size_t)errcap, "%s", ex.what());
    return -1;
  }
}

int hvd_poll(long long handle) {
  auto eng = engine();
  return eng && eng->poll(handle) ? 1 : 0;
}

// Blocks until done. Returns StatusType as int; fills result metadata on OK.
int hvd_wait(long long handle, double timeout_s, int* dtype_out,
             long long* shape_out, int shape_cap, int* ndim_out,
             long long* nbytes_out, char* err, int errcap) {
  auto eng = engine();
  if (!eng) return (int)StatusType::ABORTED;
  Status st = eng->wait(handle, timeout_s);
  if (!st.ok()) {
    if (err && errcap > 0) std::snprintf(err, (size_t)errcap, "%s", st.reason.c_str());
    // Timeout (IN_PROGRESS): the op is still in flight — keep the handle so
    // the eventual result stays claimable. Real errors consume the handle.
    if (st.type != StatusType::IN_PROGRESS) eng->release(handle);
    return (int)st.type;
  }
  const Response* res = eng->peek(handle);
  if (!res) return (int)StatusType::UNKNOWN_ERROR;
  if (dtype_out) *dtype_out = (int)res->dtype;
  if (ndim_out) *ndim_out = (int)res->shape.size();
  for (int i = 0; i < (int)res->shape.size() && i < shape_cap; i++) {
    shape_out[i] = res->shape[(size_t)i];
  }
  if (nbytes_out) *nbytes_out = (long long)res->data.size();
  return 0;
}

// Copies the result bytes out and releases the handle.
int hvd_fetch(long long handle, void* out, long long cap) {
  auto eng = engine();
  if (!eng) return 1;
  const Response* res = eng->peek(handle);
  if (!res) return 1;
  if ((long long)res->data.size() > cap) return 2;
  std::memcpy(out, res->data.data(), res->data.size());
  eng->release(handle);
  return 0;
}

void hvd_release(long long handle) {
  auto eng = engine();
  if (eng) eng->release(handle);
}

// Live knob values (the coordinator's autotuner broadcasts them; every rank
// applies the same values on the same tick).
double hvd_cycle_time_ms() {
  auto eng = engine();
  return eng ? eng->cycle_time_ms() : -1.0;
}
long long hvd_fusion_threshold() {
  auto eng = engine();
  return eng ? (long long)eng->fusion_threshold() : -1;
}
long long hvd_knob_version() {
  auto eng = engine();
  return eng ? (long long)eng->knob_version() : -1;
}

// Ring data-plane counters (tests prove fusion reduces ring passes and that
// bytes move peer-to-peer, not through a rank-0 relay).
long long hvd_ring_passes() {
  auto eng = engine();
  return eng ? (long long)eng->stats().passes.load() : -1;
}
long long hvd_ring_bytes_sent() {
  auto eng = engine();
  return eng ? (long long)eng->stats().bytes_sent.load() : -1;
}
// Bytes whose next hop crosses a host boundary (hierarchical-collective
// tests and the scaling harness read this to prove the two-level ladder
// shrinks inter-host traffic).
long long hvd_ring_cross_bytes_sent() {
  auto eng = engine();
  return eng ? (long long)eng->cross_stats().bytes_sent.load() : -1;
}
// Live hierarchical state: 1 = the two-level algorithm runs for the op,
// 0 = flat ring, -1 = no engine.
int hvd_hier_allreduce_on() {
  auto eng = engine();
  return eng ? (eng->hierarchical_allreduce_on() ? 1 : 0) : -1;
}
int hvd_hier_allgather_on() {
  auto eng = engine();
  return eng ? (eng->hierarchical_allgather_on() ? 1 : 0) : -1;
}
int hvd_hier_capable() {
  auto eng = engine();
  return eng ? (eng->hierarchical_capable() ? 1 : 0) : -1;
}
// Same-host links upgraded to the shared-memory plane (shm_ring.h); -1 = no
// engine. The scaling harness and tests read this to prove the upgrade.
int hvd_shm_links() {
  auto eng = engine();
  return eng ? eng->shm_links() : -1;
}

// ---- engine telemetry (exported to the metrics registry) ----
//
// One generic named getter keeps the ABI small as counters accrue; unknown
// names and no-engine return -1 (valid counters are never negative).
long long hvd_metric(const char* name) {
  auto eng = engine();
  if (!eng || !name) return -1;
  const EngineMetrics& m = eng->op_metrics();
  const std::string k(name);
  if (k == "allreduce_count") return (long long)m.allreduce_count.load();
  if (k == "allgather_count") return (long long)m.allgather_count.load();
  if (k == "broadcast_count") return (long long)m.broadcast_count.load();
  if (k == "reducescatter_count")
    return (long long)m.reducescatter_count.load();
  if (k == "alltoall_count") return (long long)m.alltoall_count.load();
  if (k == "collective_bytes") return (long long)m.collective_bytes.load();
  if (k == "collective_errors") return (long long)m.collective_errors.load();
  if (k == "negotiation_us") return (long long)m.negotiation_us.load();
  if (k == "execution_us") return (long long)m.execution_us.load();
  if (k == "stall_warnings") return (long long)m.stall_warnings.load();
  if (k == "cycles") return (long long)m.cycles.load();
  if (k == "timeline_dropped") return (long long)eng->timeline_dropped();
  if (k == "cache_hits") return (long long)m.cache_hits.load();
  if (k == "cache_misses") return (long long)m.cache_misses.load();
  if (k == "wire_bytes") return (long long)m.wire_bytes.load();
  if (k == "wire_bytes_saved") return (long long)m.wire_bytes_saved.load();
  if (k == "topk_wire_bytes") return (long long)m.topk_wire_bytes.load();
  if (k == "topk_wire_bytes_saved")
    return (long long)m.topk_wire_bytes_saved.load();
  return -1;
}

// Live HOROVOD_COMPRESSION wire dtype: the DataType id (hvd_common.h order,
// same table as native_engine.py DTYPES) payloads are cast to at enqueue,
// or -1 when compression is off / no engine.
int hvd_compression() {
  auto eng = engine();
  return eng ? eng->wire_dtype() : -1;
}

// Live wire-format retune (runtime controller): swap the
// enqueue-time compression table to a HOROVOD_COMPRESSION-style spec
// ("none"/"bf16"/"fp16"/"topk[@r]"/"adaptive"); topk_ratio > 0 overrides
// the spec's ratio. Cross-rank atomicity is the caller's job (land it
// inside a coordinator knob epoch). Returns 1 on apply, 0 w/o engine.
int hvd_set_wire_format(const char* spec, double topk_ratio) {
  auto eng = engine();
  if (!eng) return 0;
  eng->set_wire_format(spec ? spec : "", topk_ratio);
  return 1;
}

// ---- response cache (this PR: the steady-state fast path) ----

// Live entries in this rank's cache mirror; -1 = no engine.
int hvd_cache_size() {
  auto eng = engine();
  return eng ? eng->cache_size() : -1;
}

// Drop every cached negotiation on this rank (elastic reset/membership
// change: a stale cached response must never be servable). Safe per rank:
// the coordinator re-announces assignments when a full request arrives for
// an already-bound signature, so a flushed mirror self-heals.
void hvd_cache_flush() {
  auto eng = engine();
  if (eng) eng->cache_flush();
}

// ---- distributed tracing (spans drained into the rank's file) ----

// 1 when HOROVOD_TRACE_DIR was set at engine construction, 0/-1 otherwise.
int hvd_trace_enabled() {
  auto eng = engine();
  return eng ? (eng->trace_enabled() ? 1 : 0) : -1;
}

// Drain pending span records as newline-separated JSON objects (the span
// schema of horovod_tpu/tracing/recorder.py) into buf. Returns bytes
// written (0 = none pending, -1 = no engine); whole lines only, so a short
// buffer just means "call again". The Python binding appends them to this
// rank's spans-rank<k>.jsonl.
long long hvd_trace_drain(char* buf, long long cap) {
  auto eng = engine();
  if (!eng) return -1;
  return eng->trace_drain(buf, cap);
}

// Latest stall-warning text (empty when none). Returns the full text
// length, so a short buffer is detectable; fills up to cap-1 bytes.
int hvd_last_stall(char* buf, int cap) {
  auto eng = engine();
  if (!eng || !buf || cap <= 0) return 0;
  std::string s = eng->last_stall();
  std::snprintf(buf, (size_t)cap, "%s", s.c_str());
  return (int)s.size();
}

// Scoped timeline attach (hvd.timeline.trace): returns 1 when this call
// opened the timeline (caller owns the stop), 0 when one was already
// configured (HOROVOD_TIMELINE) or this rank doesn't write.
int hvd_timeline_start(const char* path, int mark_cycles) {
  auto eng = engine();
  return eng ? eng->timeline_start(path ? path : "", mark_cycles != 0) : 0;
}
void hvd_timeline_stop() {
  auto eng = engine();
  if (eng) eng->timeline_stop();
}

// ---- standalone autotuner objects (tests + compiled-path tuning) ----

void* hvd_pm_create(long long fusion_threshold, double cycle_time_ms,
                    int threshold_pinned, int cycle_pinned) {
  return new ParameterManager(fusion_threshold, cycle_time_ms,
                              threshold_pinned != 0, cycle_pinned != 0);
}
void hvd_pm_destroy(void* pm) { delete (ParameterManager*)pm; }
int hvd_pm_update(void* pm, long long bytes, double seconds) {
  return ((ParameterManager*)pm)->update(bytes, seconds) ? 1 : 0;
}
int hvd_pm_active(void* pm) { return ((ParameterManager*)pm)->active() ? 1 : 0; }
long long hvd_pm_fusion_threshold(void* pm) {
  return ((ParameterManager*)pm)->knobs().fusion_threshold;
}
double hvd_pm_cycle_time_ms(void* pm) {
  return ((ParameterManager*)pm)->knobs().cycle_time_ms;
}
void hvd_pm_set_log(void* pm, const char* path) {
  ((ParameterManager*)pm)->set_log_path(path ? path : "");
}
void hvd_pm_set_hierarchy(void* pm, int allreduce_on, int allgather_on,
                          int allreduce_pinned, int allgather_pinned) {
  ((ParameterManager*)pm)->set_hierarchy(allreduce_on != 0, allgather_on != 0,
                                         allreduce_pinned != 0,
                                         allgather_pinned != 0);
}
void hvd_pm_enable_hierarchy(void* pm, int allreduce_capable,
                             int allgather_capable) {
  ((ParameterManager*)pm)->enable_hierarchy_tuning(allreduce_capable != 0,
                                                   allgather_capable != 0);
}
int hvd_pm_hier_allreduce(void* pm) {
  return ((ParameterManager*)pm)->knobs().hier_allreduce ? 1 : 0;
}
int hvd_pm_hier_allgather(void* pm) {
  return ((ParameterManager*)pm)->knobs().hier_allgather ? 1 : 0;
}
// Bucket-count knob of the overlap scheduler: seed + open (pinned=0) or pin
// (pinned=1) the joint (threshold, num_buckets) search dimension.
void hvd_pm_set_num_buckets(void* pm, int num_buckets, int pinned) {
  ((ParameterManager*)pm)->set_num_buckets(num_buckets, pinned != 0);
}
int hvd_pm_num_buckets(void* pm) {
  return ((ParameterManager*)pm)->knobs().num_buckets;
}

// One-shot GP fit/predict (n samples of dimension dims, row-major X).
int hvd_gp_fit_predict(int n, int dims, const double* X, const double* y,
                       const double* xstar, double* mu, double* sigma) {
  std::vector<std::vector<double>> xs((size_t)n);
  for (int i = 0; i < n; i++) {
    xs[(size_t)i].assign(X + (size_t)i * dims, X + (size_t)(i + 1) * dims);
  }
  std::vector<double> ys(y, y + n);
  GaussianProcess gp;
  if (!gp.fit(xs, ys)) return 1;
  std::vector<double> q(xstar, xstar + dims);
  gp.predict(q, mu, sigma);
  return 0;
}

}  // extern "C"
