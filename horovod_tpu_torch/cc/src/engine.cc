#include "engine.h"

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <system_error>

#include <unistd.h>

#include "net.h"

namespace hvd {

// ------------------------------------------------------------------- logging

// LOG macro analog (reference horovod/common/logging.{cc,h}: levels
// trace..fatal from HOROVOD_LOG_LEVEL, stderr sink).
static int log_level() {
  static int level = [] {
    const char* env = std::getenv("HOROVOD_LOG_LEVEL");
    std::string s = env ? env : "warning";
    if (s == "trace") return 0;
    if (s == "debug") return 1;
    if (s == "info") return 2;
    if (s == "warning") return 3;
    if (s == "error") return 4;
    return 3;
  }();
  return level;
}

static void log_msg(int level, const char* tag, const std::string& msg) {
  if (level < log_level()) return;
  std::fprintf(stderr, "[horovod_tpu/%s] %s\n", tag, msg.c_str());
}

#define HVD_WARN(msg) log_msg(3, "warning", (msg))
#define HVD_DEBUG(msg) log_msg(1, "debug", (msg))

// ------------------------------------------------------------- HandleManager

int64_t HandleManager::allocate() {
  std::lock_guard<std::mutex> g(mu_);
  return next_++;
}

void HandleManager::mark_done(int64_t h, Status status, Response result) {
  std::lock_guard<std::mutex> g(mu_);
  done_[h] = {std::move(status), std::move(result)};
  cv_.notify_all();
}

bool HandleManager::poll(int64_t h) {
  std::lock_guard<std::mutex> g(mu_);
  return done_.count(h) > 0;
}

Status HandleManager::wait(int64_t h, double timeout_s) {
  std::unique_lock<std::mutex> lk(mu_);
  auto pred = [&] { return done_.count(h) > 0; };
  if (timeout_s < 0) {
    cv_.wait(lk, pred);
  } else if (timeout_s == 0) {
    if (!pred()) return Status{StatusType::IN_PROGRESS, "timeout waiting for handle"};
  } else if (!cv_.wait_for(lk, std::chrono::duration<double>(timeout_s), pred)) {
    return Status{StatusType::IN_PROGRESS, "timeout waiting for handle"};
  }
  return done_[h].first;
}

const Response* HandleManager::peek(int64_t h) {
  std::lock_guard<std::mutex> g(mu_);
  auto it = done_.find(h);
  return it == done_.end() ? nullptr : &it->second.second;
}

void HandleManager::release(int64_t h) {
  std::lock_guard<std::mutex> g(mu_);
  done_.erase(h);
}

// --------------------------------------------------- wire compression casts
// HOROVOD_COMPRESSION: f32/f64 allreduce payloads are cast to the
// 16-bit wire dtype HERE, once, at enqueue — after that the whole pipeline
// (tensor table, fusion buffer, ring hops) moves and reduces 2-byte
// elements natively, with f32 arithmetic per add inside the ring's
// add_chunk (ring.h; reference analog half.h:135 float16_sum). The result
// is cast back to the caller dtype at completion (finish()).

static uint16_t to_wire_one(DataType wire, float v) {
  return wire == DataType::BF16 ? float_to_bf16(v) : float_to_half(v);
}

static float from_wire_one(DataType wire, uint16_t v) {
  return wire == DataType::BF16 ? bf16_to_float(v) : half_to_float(v);
}

// Cast `n` elements of `from`-typed `src` into `wire`-typed `out`.
static void cast_to_wire(DataType from, DataType wire, const void* src,
                         size_t n, Buffer& out) {
  out.resize(n * dtype_size(wire));
  uint16_t* dst = (uint16_t*)out.data();
  if (from == DataType::F32) {
    const float* s = (const float*)src;
    for (size_t i = 0; i < n; i++) dst[i] = to_wire_one(wire, s[i]);
  } else {  // F64: via float — bf16/f16 carry < f32 precision anyway
    const double* s = (const double*)src;
    for (size_t i = 0; i < n; i++) dst[i] = to_wire_one(wire, (float)s[i]);
  }
}

// Cast `n` wire-typed elements back to the caller dtype.
static void cast_from_wire(DataType wire, DataType to, const void* src,
                           size_t n, Buffer& out) {
  out.resize(n * dtype_size(to));
  const uint16_t* s = (const uint16_t*)src;
  if (to == DataType::F32) {
    float* dst = (float*)out.data();
    for (size_t i = 0; i < n; i++) dst[i] = from_wire_one(wire, s[i]);
  } else {
    double* dst = (double*)out.data();
    for (size_t i = 0; i < n; i++) dst[i] = (double)from_wire_one(wire, s[i]);
  }
}

// ------------------------------------------------------------------- Engine
// dtype note: f16/bf16 reduce at NATIVE width end to end — 2 bytes/element
// on the wire and in buffers, f32 arithmetic per add inside the ring's
// add_chunk (ring.h; reference analog half.h:135 float16_sum). Round 2
// widened whole buffers to f32 first, doubling DRAM and wire traffic for
// exactly the dtypes a TPU shop uses.

// ------------------------------------------------------- distributed tracing
// Span records in the SAME JSON-lines schema the Python recorder
// writes (tracing/recorder.py): the binding drains them via hvd_trace_drain
// into the rank's span file. Timestamps are steady_clock ns — on Linux the
// same CLOCK_MONOTONIC Python's time.monotonic_ns() reads, so spans from
// both layers of one process share an axis with no conversion.

uint64_t Engine::now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

std::string Engine::trace_tid(const Request& req) const {
  return req.name + "#" + std::to_string(req.trace_seq);
}

static void json_escape_into(std::string& out, const std::string& s) {
  for (char c : s) {
    if (c == '"' || c == '\\') {
      out.push_back('\\');
      out.push_back(c);
    } else if ((unsigned char)c < 0x20) {
      out += "\\u0020";  // control bytes in tensor names: blank them
    } else {
      out.push_back(c);
    }
  }
}

void Engine::trace_span(const std::string& tid, const std::string& name,
                        OpType op, const char* phase, uint64_t t0_ns,
                        uint64_t t1_ns, uint64_t bytes) {
  if (!trace_enabled_) return;
  std::string line = "{\"tid\": \"";
  json_escape_into(line, tid);
  line += "\", \"rank\": " + std::to_string(topo_.rank);
  line += ", \"name\": \"";
  json_escape_into(line, name);
  line += "\", \"op\": \"";
  line += op_name(op);
  line += "\", \"phase\": \"";
  line += phase;
  line += "\", \"t0\": " + std::to_string(t0_ns);
  line += ", \"t1\": " + std::to_string(t1_ns);
  if (bytes) line += ", \"bytes\": " + std::to_string(bytes);
  line += ", \"engine\": \"native\"}";
  std::lock_guard<std::mutex> g(trace_mu_);
  // Bounded: a job that never drains (tracing enabled but no Python
  // binding polling) must not grow without limit.
  if (trace_q_.size() >= (1u << 16)) {
    trace_dropped_++;
    return;
  }
  trace_q_.push_back(std::move(line));
}

long long Engine::trace_drain(char* buf, long long cap) {
  if (!buf || cap <= 1) return 0;
  long long off = 0;
  std::lock_guard<std::mutex> g(trace_mu_);
  while (!trace_q_.empty()) {
    const std::string& line = trace_q_.front();
    if (off + (long long)line.size() + 2 > cap) break;
    std::memcpy(buf + off, line.data(), line.size());
    off += (long long)line.size();
    buf[off++] = '\n';
    trace_q_.pop_front();
  }
  buf[off] = '\0';
  return off;
}

Engine::Engine(const Topology& topo, const EngineConfig& cfg)
    : topo_(topo), cfg_(cfg) {
  // The listener hvd_coord_listen bound belongs to this engine from here
  // until its Coordinator adopts it: a throw before that closes it.
  struct ListenerGuard {
    int fd;
    ~ListenerGuard() {
      if (fd >= 0) ::close(fd);
    }
  } listener{cfg_.coord_listen_fd};
  cycle_time_ms_ = cfg_.cycle_time_ms;
  fusion_threshold_ = (int64_t)cfg_.fusion_threshold;
  wire_dtype_ = wire_dtype_from_env();
  // Sparse/adaptive wire knobs — same env surface as the
  // Python engine (compression.py / common/policy.py).
  sparse_ = sparse_spec_from_env();
  const char* tmb = std::getenv("HOROVOD_TOPK_MIN_BYTES");
  topk_min_bytes_ = (tmb && *tmb) ? std::atoll(tmb) : (64 << 10);
  const char* cmb = std::getenv("HOROVOD_COMPRESSION_MIN_BYTES");
  compression_min_bytes_ = (cmb && *cmb) ? std::atoll(cmb) : 4096;
  // Error feedback: OFF for the dtype casts unless explicitly enabled, ON
  // for topk unless explicitly disabled (topk without EF drops ~99% of the
  // gradient mass per step — a bias, not a compression; DGC).
  const char* ef = std::getenv("HOROVOD_COMPRESSION_ERROR_FEEDBACK");
  ef_cast_ = ef && std::string(ef) == "1";
  ef_topk_ = ef_cast_ || !ef || !*ef;
  {
    const char* td = std::getenv("HOROVOD_TRACE_DIR");
    trace_enabled_ = td && *td;
  }
  if (!cfg_.timeline_path.empty() && topo_.rank == 0) {
    timeline_.init(cfg_.timeline_path, cfg_.timeline_mark_cycles);
  }
  if (topo_.size > 1) {
    if (cfg_.coord_host.empty() || cfg_.coord_port == 0) {
      throw std::runtime_error(
          "multi-process engine needs HOROVOD_COORD_ADDR (set by the launcher)");
    }
    std::string secret = job_secret();
    if (secret.empty()) {
      // Same policy as the Python engine: multi-process collectives move
      // over the network, so they require the launcher-distributed secret.
      // Running unauthenticated would let any peer claim a rank and inject
      // gradients.
      throw std::runtime_error(
          "multi-process collectives authenticate with HOROVOD_SECRET, which "
          "is unset; launch through the horovod_tpu runner (which "
          "distributes it) or export the same secret on every rank");
    }
    ring_.open_listener();
    // Offer the two-level rings whenever this rank's own coordinates say the
    // world spans multiple hosts with multiple ranks per host; whether they
    // are actually established depends on the full registered map below.
    bool offer_sub = topo_.local_size > 1 && topo_.cross_size > 1;
    if (offer_sub) {
      local_ring_.open_listener();
      cross_ring_.open_listener();
    }
    PeerInfo me;
    me.port = ring_.port();
    me.local_port = offer_sub ? local_ring_.port() : 0;
    me.cross_port = offer_sub ? cross_ring_.port() : 0;
    me.local_rank = topo_.local_rank;
    me.local_size = topo_.local_size;
    me.cross_rank = topo_.cross_rank;
    me.cross_size = topo_.cross_size;
    std::vector<PeerInfo> peers;
    if (topo_.rank == 0) {
      coord_ = std::make_unique<Coordinator>(topo_.size, cfg_.coord_host,
                                             cfg_.coord_port, &timeline_, cfg_);
      listener.fd = -1;
      me.host = cfg_.coord_host;
      peers = coord_->hello(0, me);
    } else {
      client_ = std::make_unique<Client>(cfg_.coord_host, cfg_.coord_port,
                                         topo_.rank, 60.0);
      me.host = client_->local_host();
      peers = client_->hello(me);
    }
    std::vector<std::pair<std::string, int>> flat;
    flat.reserve(peers.size());
    for (auto& p : peers) flat.emplace_back(p.host, p.port);
    // Same-host links are OFFERED the shared-memory plane (shm_ring.h); the
    // nonce handshake inside establish() verifies the peer really shares
    // /dev/shm before any payload moves. Gating on the coordinator-reported
    // cross_rank keeps simulated multi-host tests on TCP for their
    // "cross-host" links, so their byte accounting stays meaningful.
    int next = (topo_.rank + 1) % topo_.size;
    int prev = (topo_.rank - 1 + topo_.size) % topo_.size;
    ring_.establish(topo_.rank, topo_.size, flat, secret, 60.0, "hvd-ring",
                    peers[(size_t)next].cross_rank == topo_.cross_rank,
                    peers[(size_t)prev].cross_rank == topo_.cross_rank);
    hier_ = analyze_hier(peers, topo_.rank);
    if (hier_.capable) {
      // Intra-host ring: position = local_rank among my host's ranks; the
      // cross-host ring: position = cross_rank among the ranks sharing my
      // local_rank. Distinct auth purposes keep a misdirected connection
      // from one ring passing the other's accept check.
      std::vector<std::pair<std::string, int>> lp, xp;
      for (int r : hier_.local_group)
        lp.emplace_back(peers[(size_t)r].host, peers[(size_t)r].local_port);
      for (int r : hier_.cross_group)
        xp.emplace_back(peers[(size_t)r].host, peers[(size_t)r].cross_port);
      // The local ring is same-host by construction: all links shm-eligible.
      local_ring_.establish(topo_.local_rank, topo_.local_size, lp, secret,
                            60.0, "hvd-ring-local", true, true);
      cross_ring_.establish(topo_.cross_rank, topo_.cross_size, xp, secret,
                            60.0, "hvd-ring-cross");
      // Every cross-ring send crosses hosts by construction.
      cross_ring_.set_cross_stats(&cross_stats_);
    } else if (offer_sub) {
      local_ring_.close();
      cross_ring_.close();
    }
    // Inter-host byte accounting on the FLAT ring is independent of
    // hierarchical capability: on any topology (including heterogeneous
    // ones that fail analyze_hier) the outgoing link crosses hosts iff the
    // next rank reported a different cross_rank — the scaling harness needs
    // the flat baseline's cross bytes to be real there too.
    if (peers[(size_t)next].cross_rank != topo_.cross_rank) {
      ring_.set_cross_stats(&cross_stats_);
      // The adaptive policy's flat-ring framing choice: sparse frames pay
      // on links that cross hosts (value-neutral — common/policy.py).
      flat_next_cross_ = true;
    }
    hier_allreduce_ = cfg_.hierarchical_allreduce && hier_.capable;
    hier_allgather_ = cfg_.hierarchical_allgather && hier_.capable &&
                      hier_.blocked;
    if (cfg_.hierarchical_allreduce && !hier_.capable) {
      HVD_WARN(
          "HOROVOD_HIERARCHICAL_ALLREDUCE=1 but the topology is not a "
          "homogeneous multi-host grid (need local_size>1, cross_size>1, "
          "equal local_size on every host); using the flat ring");
    }
    if (cfg_.hierarchical_allgather && !(hier_.capable && hier_.blocked)) {
      HVD_WARN(
          "HOROVOD_HIERARCHICAL_ALLGATHER=1 but the topology is not a "
          "homogeneous blocked multi-host grid (rank == "
          "cross_rank*local_size+local_rank); using the flat ring");
    }
  } else if (cfg_.autotune) {
    // Single-process world: tune locally (multi-process tuning lives in the
    // coordinator so every rank flips knobs on the same tick).
    pm_ = std::make_unique<ParameterManager>(
        fusion_threshold_, cycle_time_ms_, cfg_.threshold_pinned,
        cfg_.cycle_pinned);
    if (!cfg_.autotune_log.empty()) pm_->set_log_path(cfg_.autotune_log);
  }
  bg_ = std::thread([this] { loop(); });
}

Engine::~Engine() { shutdown(); }

void Engine::set_wire_format(const std::string& spec, double topk_ratio) {
  // Same grammar as wire_dtype_from_env / sparse_spec_from_env so a spec
  // string behaves identically whether it arrived via the env at launch
  // or via the runtime controller mid-job.
  std::string s(spec);
  for (auto& c : s) c = (char)std::tolower((unsigned char)c);
  SparseSpec sp;
  {
    std::lock_guard<std::mutex> lk(wire_knob_mu_);
    sp.ratio = sparse_.ratio;  // preserved unless the call overrides it
  }
  if (topk_ratio > 0) sp.ratio = topk_ratio < 0.5 ? topk_ratio : 0.5;
  int wire = -1;
  if (s == "fp16") {
    wire = (int)DataType::F16;
  } else if (s == "bf16") {
    wire = (int)DataType::BF16;
  } else if (s == "adaptive") {
    sp.adaptive = true;
  } else if (s == "topk") {
    sp.topk = true;
  } else if (s.rfind("topk@", 0) == 0) {
    double v = std::atof(s.c_str() + 5);
    sp.topk = true;
    if (topk_ratio <= 0 && v > 0) sp.ratio = v < 0.5 ? v : 0.5;
  }
  // anything else ("none", "") -> dense f32, matching the env parsers
  {
    std::lock_guard<std::mutex> lk(wire_knob_mu_);
    wire_dtype_ = wire;
    sparse_ = sp;
  }
}

int64_t Engine::enqueue(OpType op, const std::string& name, DataType dtype,
                        const std::vector<int64_t>& shape, const void* data,
                        int root_rank, bool average) {
  // Best-effort fast path: skip the tensor copy when already shut down.
  // The authoritative check is under qmu_ below (no lost-entry race).
  if (shutdown_.load()) throw std::runtime_error("Horovod has been shut down");
  if (shape.empty() &&
      (op == OpType::ALLGATHER || op == OpType::REDUCESCATTER ||
       op == OpType::ALLTOALL)) {
    throw std::runtime_error(std::string(op_name(op)) +
                             " requires tensors of rank >= 1 (got a scalar)");
  }
  Entry e;
  e.req.rank = topo_.rank;
  e.req.op = op;
  e.req.dtype = dtype;
  e.req.orig_dtype = dtype;
  e.handle = handles_.allocate();
  // Auto-name by handle like the reference's GetOpName (mpi_ops_v2.cc:44-50):
  // handles increment identically across ranks when op order matches.
  e.req.name = name.empty()
                   ? std::string(op_name(op)) + ".noname." + std::to_string(e.handle)
                   : name;
  e.req.root_rank = root_rank;
  e.req.average = average ? 1 : 0;
  e.req.shape = shape;
  size_t elems = e.req.elements();
  size_t nbytes = elems * dtype_size(dtype);
  // Per-tensor wire resolution: explicit bf16/fp16
  // rides wire_dtype_; `topk` sparsifies the contribution once, HERE, so
  // every downstream stage (tensor table, sparse ring hops) moves frames
  // of the selection; `adaptive` consults the deterministic (size, dtype,
  // topology) table shared with common/policy.py — identical inputs on
  // every rank, so cross-rank wire agreement holds with zero negotiation.
  int wire;
  SparseSpec sp;
  {
    // One coherent snapshot of the live wire table (set_wire_format may
    // swap it between enqueues; a torn read could mix dtype and ratio).
    std::lock_guard<std::mutex> lk(wire_knob_mu_);
    wire = wire_dtype_;
    sp = sparse_;
  }
  bool topk = false;
  if (op == OpType::ALLREDUCE) {
    bool wide_float = dtype == DataType::F32 || dtype == DataType::F64;
    if (sp.adaptive) {
      wire = -1;
      if (topo_.cross_size > 1 && wide_float &&
          (int64_t)nbytes >= compression_min_bytes_) {
        int64_t floor = topk_min_bytes_ > compression_min_bytes_
                            ? topk_min_bytes_
                            : compression_min_bytes_;
        if (dtype == DataType::F32 && (int64_t)nbytes >= floor &&
            topk_eligible(nbytes, sp.ratio, compression_min_bytes_)) {
          topk = true;
        } else {
          wire = (int)DataType::BF16;
        }
      }
    } else if (sp.topk) {
      topk = dtype == DataType::F32 &&
             topk_eligible(nbytes, sp.ratio, compression_min_bytes_);
    }
  }
  // Error-feedback residual claim (DGC): popped BEFORE select/quantize so
  // a redo replay of the already-prepared contribution can never fold it
  // twice; the un-sent mass is re-stored below.
  auto claim_residual = [&](DataType want) -> std::vector<uint8_t> {
    std::lock_guard<std::mutex> g(residual_mu_);
    auto it = residuals_.find(e.req.name);
    if (it == residuals_.end()) return {};
    std::vector<uint8_t> out;
    if (it->second.first == want && it->second.second.size() == nbytes)
      out = std::move(it->second.second);
    residuals_.erase(it);  // claimed either way (shape/dtype change drops)
    return out;
  };
  if (topk) {
    const float* src = (const float*)data;
    std::vector<float> xbuf;
    if (ef_topk_) {
      auto res = claim_residual(DataType::F32);
      if (!res.empty()) {
        xbuf.resize(elems);
        const float* rp = (const float*)res.data();
        for (size_t i = 0; i < elems; i++) xbuf[i] = src[i] + rp[i];
        src = xbuf.data();
      }
    }
    std::vector<int32_t> ti;
    std::vector<float> tv;
    topk_select(src, elems, topk_k(elems, sp.ratio), ti, tv);
    e.data.assign(nbytes, 0);
    float* dst = (float*)e.data.data();
    for (size_t j = 0; j < ti.size(); j++) dst[(size_t)ti[j]] = tv[j];
    if (ef_topk_) {
      std::vector<uint8_t> res(nbytes);
      float* rp = (float*)res.data();
      for (size_t i = 0; i < elems; i++) rp[i] = src[i] - dst[i];
      std::lock_guard<std::mutex> g(residual_mu_);
      residuals_[e.req.name] = {DataType::F32, std::move(res)};
    }
    e.req.wire_fmt = 1;
  } else if (wire >= 0 && op == OpType::ALLREDUCE &&
             (dtype == DataType::F32 || dtype == DataType::F64) &&
             dtype != (DataType)wire) {
    // Cast-on-send: the payload enters the engine already at the 16-bit
    // wire dtype — the tensor table, fusion buffer and every ring hop then
    // move half (f32) or a quarter (f64) of the bytes; add_chunk
    // accumulates each add in f32 (ring.h).
    DataType w = (DataType)wire;
    const void* src = data;
    std::vector<uint8_t> xbuf;
    if (ef_cast_) {
      auto res = claim_residual(dtype);
      if (!res.empty()) {
        xbuf.resize(nbytes);
        if (dtype == DataType::F32) {
          float* x = (float*)xbuf.data();
          const float* a = (const float*)data;
          const float* r = (const float*)res.data();
          for (size_t i = 0; i < elems; i++) x[i] = a[i] + r[i];
        } else {
          double* x = (double*)xbuf.data();
          const double* a = (const double*)data;
          const double* r = (const double*)res.data();
          for (size_t i = 0; i < elems; i++) x[i] = a[i] + r[i];
        }
        src = xbuf.data();
      }
    }
    e.req.dtype = w;
    cast_to_wire(dtype, w, src, elems, e.data);
    if (ef_cast_) {
      // residual = input - dequantized(quantized(input)), at orig width.
      std::vector<uint8_t> res(nbytes);
      const uint16_t* q = (const uint16_t*)e.data.data();
      if (dtype == DataType::F32) {
        float* rp = (float*)res.data();
        const float* a = (const float*)src;
        for (size_t i = 0; i < elems; i++)
          rp[i] = a[i] - from_wire_one(w, q[i]);
      } else {
        double* rp = (double*)res.data();
        const double* a = (const double*)src;
        for (size_t i = 0; i < elems; i++)
          rp[i] = a[i] - (double)from_wire_one(w, q[i]);
      }
      std::lock_guard<std::mutex> g(residual_mu_);
      residuals_[e.req.name] = {dtype, std::move(res)};
    }
    metrics_.wire_bytes += (uint64_t)e.data.size();
    metrics_.wire_bytes_saved +=
        (uint64_t)(elems * dtype_size(dtype) - e.data.size());
  } else if (op == OpType::ALLREDUCE) {
    // Zero-copy enqueue: the binding pins the caller's buffer
    // until the handle completes, so the uncompressed allreduce hot path
    // BORROWS it read-only — the reduce-scatter folds it straight into a
    // fresh output buffer (ring.h ring_reduce_scatter_into) and Python
    // never pays the tensor-table copy.
    e.borrow = (const uint8_t*)data;
    e.borrow_bytes = nbytes;
  } else {
    e.data.assign((const uint8_t*)data, (const uint8_t*)data + nbytes);
  }
  int64_t handle = e.handle;
  e.enqueued = std::chrono::steady_clock::now();
  {
    std::lock_guard<std::mutex> g(qmu_);
    // Checked under qmu_: the loop's final fail_everything sweep swaps
    // queue_ under this lock AFTER shutdown_ is set, so a push here either
    // precedes the sweep (and is swept) or observes shutdown_ and throws —
    // an unlocked check-then-push could slip an entry in after the sweep
    // and leave its handle waiting forever.
    if (shutdown_.load()) throw std::runtime_error("Horovod has been shut down");
    if (!inflight_.insert(e.req.name).second) {
      throw std::runtime_error(
          "Duplicate tensor name " + e.req.name +
          "; a name may only be used once until its collective completes");
    }
    if (trace_enabled_) {
      // Trace ID at first enqueue: the k-th submission of this name —
      // the deterministic counter every rank (and the Python engine)
      // derives identically; trace_seq rides the wire for verification.
      e.req.trace_seq = ++trace_seq_[e.req.name];
      uint64_t t = now_ns();
      trace_span(trace_tid(e.req), e.req.name, op, "enqueue", t, t,
                 (uint64_t)(e.borrow ? e.borrow_bytes : e.data.size()));
    }
    if (timeline_.healthy())
      timeline_.negotiate_start(e.req.name, op_name(op));
    queue_.push_back(std::move(e));
  }
  // Wake the loop immediately (adaptive cycle): a small eager op must not
  // pay the remainder of a cycle sleep, and an idle-backed-off loop must
  // not pay the backoff.
  qcv_.notify_one();
  return handle;
}

void Engine::wait_for_work() {
  std::unique_lock<std::mutex> lk(qmu_);
  double base = cycle_time_ms_.load();
  double timeout_ms = base;
  // HOROVOD_WAKE_ON_ENQUEUE=0 restores the fixed-cycle sleep (debugging /
  // tests that need an enqueue to stay unprocessed for a known window).
  // Read per call, not cached: in-process tests toggle it between engines.
  const char* woe = std::getenv("HOROVOD_WAKE_ON_ENQUEUE");
  if (woe && std::string(woe) == "0") {
    qcv_.wait_for(lk, std::chrono::duration<double, std::milli>(base),
                  [&] { return shutdown_.load(); });
    return;
  }
  if (queue_.empty() && table_.empty()) {
    // Fully idle: back off exponentially, capped. Safe in multi-process
    // worlds because every collective participant wakes on its OWN
    // enqueue — the barrier assembles from wakes, not from polling.
    idle_streak_ = std::min(idle_streak_ + 1, 8);
    static const double cap_ms = [] {
      const char* v = std::getenv("HOROVOD_CYCLE_IDLE_MAX_MS");
      double d = (v && *v) ? std::atof(v) : 100.0;
      // Clamp to a 1 ms floor, exactly like the Python engine's
      // max(value, 1.0) — a sub-millisecond cap must not silently snap
      // back to the 100 ms default on one side of the ctypes bridge only.
      return d > 1.0 ? d : 1.0;
    }();
    timeout_ms = std::min(base * (double)(1 << std::min(idle_streak_, 6)),
                          std::max(cap_ms, base));
  } else {
    idle_streak_ = 0;
  }
  qcv_.wait_for(lk, std::chrono::duration<double, std::milli>(timeout_ms),
                [&] { return !queue_.empty() || shutdown_.load(); });
  if (!queue_.empty()) idle_streak_ = 0;
}

void Engine::finish(Entry& e, Status st, Response res) {
  {
    std::lock_guard<std::mutex> g(qmu_);
    inflight_.erase(e.req.name);
  }
  // Central completion point = central count point: every path (local
  // fast path, fused ring, error/abort sweeps) lands here exactly once.
  if (st.ok()) {
    // Wire decompression: a compressed allreduce finished with wire-dtype
    // bytes; restore the caller dtype exactly here, so every execution
    // path (single-tensor fast path, fused bucket, local world) converts
    // once and the handle always yields the dtype the caller enqueued.
    if (e.req.compressed() && res.kind == Response::OK) {
      Buffer full;
      cast_from_wire(e.req.dtype, e.req.orig_dtype, res.data.data(),
                     res.data.size() / dtype_size(e.req.dtype), full);
      res.data.swap(full);
      res.dtype = e.req.orig_dtype;
    }
    switch (e.req.op) {
      case OpType::ALLREDUCE: metrics_.allreduce_count++; break;
      case OpType::ALLGATHER: metrics_.allgather_count++; break;
      case OpType::BROADCAST: metrics_.broadcast_count++; break;
      case OpType::REDUCESCATTER: metrics_.reducescatter_count++; break;
      case OpType::ALLTOALL: metrics_.alltoall_count++; break;
    }
    // Caller-visible payload size (orig width), matching the Python
    // engine's accounting whether or not the wire was compressed.
    metrics_.collective_bytes +=
        (uint64_t)e.req.elements() * dtype_size(e.req.orig_dtype);
  } else {
    metrics_.collective_errors++;
  }
  handles_.mark_done(e.handle, std::move(st), std::move(res));
}

void Engine::fail_everything(const std::string& reason) {
  std::deque<Entry> rest;
  {
    std::lock_guard<std::mutex> g(qmu_);
    rest.swap(queue_);
  }
  for (auto& e : rest) finish(e, Status::Aborted(reason), Response{});
  for (auto& kv : table_) {
    finish(kv.second, Status::Aborted(reason), Response{});
  }
  table_.clear();
}

void Engine::shutdown() {
  if (shutdown_.exchange(true)) {
    qcv_.notify_all();
    // Second caller: just make sure the thread is gone before returning.
    if (bg_.joinable() && std::this_thread::get_id() != bg_.get_id()) {
      try { bg_.join(); } catch (const std::system_error&) {}
    }
    return;
  }
  qcv_.notify_all();  // unblock an idle-backed-off loop promptly
  if (bg_.joinable()) bg_.join();
  if (coord_) {
    // Keep the control plane alive until every rank has taken its shutdown
    // response (reference: all ranks exit the loop together,
    // operations.cc:2125-2128, 2374-2376).
    coord_->await_departure(15.0);
    coord_.reset();
  }
  client_.reset();
  ring_.close();
  local_ring_.close();
  cross_ring_.close();
  timeline_.shutdown();
}

// Validate the registered topology for two-level collectives and compute
// this rank's intra-host and cross-host ring memberships. Deterministic over
// the identical broadcast map, so every rank reaches the same `capable`
// verdict (an asymmetric verdict would deadlock ring establishment).
HierPlan analyze_hier(const std::vector<PeerInfo>& peers, int my_rank) {
  HierPlan plan;
  if (peers.empty()) return plan;
  const PeerInfo& me = peers[(size_t)my_rank];
  int L = me.local_size, C = me.cross_size;
  if (L <= 1 || C <= 1) return plan;
  if ((size_t)(L * C) != peers.size()) return plan;
  // Homogeneity + exactly-once grid coverage.
  std::vector<int> cell((size_t)L * (size_t)C, -1);
  for (size_t r = 0; r < peers.size(); r++) {
    const PeerInfo& p = peers[r];
    if (p.local_size != L || p.cross_size != C) return plan;
    if (p.local_rank < 0 || p.local_rank >= L || p.cross_rank < 0 ||
        p.cross_rank >= C)
      return plan;
    if (p.local_port == 0 || p.cross_port == 0) return plan;
    int& slot = cell[(size_t)p.cross_rank * (size_t)L + (size_t)p.local_rank];
    if (slot != -1) return plan;
    slot = (int)r;
  }
  plan.capable = true;
  plan.blocked = true;
  for (size_t r = 0; r < peers.size(); r++) {
    if ((int)r != peers[r].cross_rank * L + peers[r].local_rank) {
      plan.blocked = false;
      break;
    }
  }
  plan.local_group.resize((size_t)L);
  for (int l = 0; l < L; l++)
    plan.local_group[(size_t)l] = cell[(size_t)me.cross_rank * (size_t)L + (size_t)l];
  plan.cross_group.resize((size_t)C);
  for (int c = 0; c < C; c++)
    plan.cross_group[(size_t)c] = cell[(size_t)c * (size_t)L + (size_t)me.local_rank];
  return plan;
}

void Engine::loop() {
  while (true) {
    bool shutting = shutdown_.load();
    if (!shutting) {
      wait_for_work();
      shutting = shutdown_.load();
    }
    timeline_.mark_cycle_start();
    metrics_.cycles++;
    if (topo_.size == 1) {
      std::deque<Entry> batch;
      {
        std::lock_guard<std::mutex> g(qmu_);
        batch.swap(queue_);
      }
      auto tick_start = std::chrono::steady_clock::now();
      int64_t tick_bytes = 0;
      for (auto& e : batch)
        tick_bytes += (int64_t)(e.borrow ? e.borrow_bytes : e.data.size());
      for (auto& e : batch) complete_local(e);
      if (pm_ && pm_->active() && !batch.empty()) {
        double secs = std::chrono::duration<double>(
                          std::chrono::steady_clock::now() - tick_start)
                          .count();
        if (pm_->update(tick_bytes, secs)) {
          auto k = pm_->knobs();
          cycle_time_ms_ = k.cycle_time_ms;
          fusion_threshold_ = k.fusion_threshold;
          applied_knob_version_++;
        }
      }
      if (shutting) break;
      continue;
    }
    if (!tick_multiprocess(shutting)) break;
  }
  fail_everything("Horovod has been shut down");
}

bool Engine::tick_multiprocess(bool shutting) {
  TickRequest t;
  t.rank = topo_.rank;
  t.shutdown = shutting ? 1 : 0;
  std::deque<Entry> fresh;
  {
    std::lock_guard<std::mutex> g(qmu_);
    fresh.swap(queue_);
  }
  for (auto& e : fresh) {
    // Response cache: a signature the coordinator has bit-bound rides as
    // one set bit in the tick's bitvector instead of a full Request.
    bool cached = false;
    {
      std::lock_guard<std::mutex> g(cache_mu_);
      auto it = cache_key_to_bit_.find(cache_key(e.req));
      if (it != cache_key_to_bit_.end()) {
        t.set_cache_bit(it->second);
        cached = true;
      }
    }
    if (cached) {
      metrics_.cache_hits++;
    } else {
      metrics_.cache_misses++;
      t.reqs.push_back(e.req);
    }
    std::string name = e.req.name;
    table_.emplace(std::move(name), std::move(e));
  }
  ResponseList out;
  try {
    out = coord_ ? coord_->tick(topo_.rank, t) : client_->tick(t);
  } catch (const std::exception& ex) {
    // Order matters: latch shutdown FIRST so no new enqueue can slip past
    // the sweep (enqueue re-checks under qmu_), then fail everything.
    HVD_DEBUG("rank " + std::to_string(topo_.rank) +
              " control-plane tick failed (shutting=" +
              std::to_string((int)shutting) + "): " + ex.what());
    shutdown_.store(true);
    fail_everything(std::string("control plane failed: ") + ex.what());
    return false;
  }
  // The categorical knobs are applied from EVERY response, not just on a
  // version bump: the algorithm choice must be identical on all ranks for a
  // given collective (a flat rank facing a hierarchical peer deadlocks the
  // data plane), so the coordinator's value is authoritative even when one
  // rank's env disagreed at init. Capability is identical everywhere
  // (analyze_hier over the same broadcast map), so the && is safe.
  hier_allreduce_ = out.hier_allreduce != 0 && hier_.capable;
  hier_allgather_ = out.hier_allgather != 0 && hier_.capable && hier_.blocked;
  if (out.knob_version != applied_knob_version_.load()) {
    applied_knob_version_ = out.knob_version;
    fusion_threshold_ = out.fusion_threshold;
    cycle_time_ms_ = out.cycle_time_ms;
    HVD_DEBUG("autotune sync: fusion_threshold=" +
              std::to_string(out.fusion_threshold) +
              " cycle_time_ms=" + std::to_string(out.cycle_time_ms) +
              " hier_allreduce=" + std::to_string((int)out.hier_allreduce) +
              " hier_allgather=" + std::to_string((int)out.hier_allgather));
  }
  // Response-cache announcements: every rank applies the identical
  // evict/assign stream before its next tick, so the mirrors mutate in
  // lockstep with the coordinator's authority (cache.h).
  if (!out.cache_evict.empty() || !out.cache_assign.empty()) {
    std::lock_guard<std::mutex> g(cache_mu_);
    for (uint32_t bit : out.cache_evict) {
      auto it = cache_bit_to_key_.find(bit);
      if (it == cache_bit_to_key_.end()) continue;
      auto kb = cache_key_to_bit_.find(it->second);
      if (kb != cache_key_to_bit_.end() && kb->second == bit)
        cache_key_to_bit_.erase(kb);
      cache_bit_to_key_.erase(it);
    }
    for (auto& a : out.cache_assign) {
      std::string key = cache_key(a.req);
      auto old = cache_key_to_bit_.find(key);
      if (old != cache_key_to_bit_.end()) cache_bit_to_key_.erase(old->second);
      cache_key_to_bit_[key] = a.bit;
      cache_bit_to_key_[a.bit] = key;
    }
  }
  // Stall warnings: the coordinator process (us, when coord_ is set) already
  // logged them at creation; only worker ranks log on receipt. EVERY rank
  // counts them and keeps the latest text for diagnostics (c_api
  // hvd_last_stall -> the metrics registry's stall_report).
  if (!out.stall_warnings.empty()) {
    metrics_.stall_warnings += out.stall_warnings.size();
    std::lock_guard<std::mutex> g(stall_mu_);
    last_stall_ = out.stall_warnings.back();
  }
  if (!coord_) {
    for (auto& w : out.stall_warnings) HVD_WARN(w);
  }
  execute_list(out);
  if (!ring_error_.empty() && !shutdown_.load()) {
    // Data plane is dead: fail everything queued and leave the job
    // coordinately. Keep looping for one more tick — that tick runs with
    // shutting=true and ships t.shutdown=1, so the coordinator marks this
    // rank departed instead of stalling the tick barrier for the peers.
    // Latch shutdown BEFORE the sweep (same invariant as the control-plane
    // catch): enqueue re-checks under qmu_, so nothing slips in unswept.
    shutdown_.store(true);
    fail_everything(ring_error_);
    return true;
  }
  if (out.shutdown && !shutting) {
    // Another rank initiated shutdown; exit together (reference
    // operations.cc:2125-2128). New enqueues fail from here on. Keep
    // looping for ONE more tick so the departure is announced: that tick
    // runs with shutting=true and ships t.shutdown=1, letting the
    // coordinator record a clean departure — dropping out silently here
    // would make the serve thread see a bare EOF later and warn
    // "rank N lost" on every normal shutdown.
    shutdown_.store(true);
    return true;
  }
  return !shutting;
}

void Engine::complete_local(Entry& e) {
  // Single-process world: every collective is the identity (average of one,
  // gather of one, broadcast from self, scatter of the whole).
  metrics_.negotiation_us += (uint64_t)std::chrono::duration_cast<
      std::chrono::microseconds>(std::chrono::steady_clock::now() -
                                 e.enqueued).count();
  if (timeline_.healthy()) {
    timeline_.negotiate_end(e.req.name);
    timeline_.start(e.req.name, op_name(e.req.op));
  }
  Response res;
  res.kind = Response::OK;
  res.name = e.req.name;
  res.dtype = e.req.dtype;
  res.shape = e.req.shape;
  if (e.borrow) {
    // Single-process identity: the borrowed input IS the result.
    res.data.assign(e.borrow, e.borrow + e.borrow_bytes);
  } else {
    res.data = std::move(e.data);
  }
  if (timeline_.healthy()) timeline_.end(e.req.name);
  finish(e, Status::OK_(), std::move(res));
  if (trace_enabled_) {
    uint64_t t = now_ns();
    trace_span(trace_tid(e.req), e.req.name, e.req.op, "done", t, t, 0);
  }
}

void Engine::execute_list(const ResponseList& list) {
  for (auto& re : list.entries) execute_entry(re);
}

void Engine::execute_entry(const ResponseEntry& re) {
  // Pull this rank's contributions out of the tensor table. For OK entries
  // the coordinator only emits when every rank (including us) contributed,
  // so a miss is an engine bug. ERROR entries are different: a dead-rank
  // failure covers tensors this rank may not have submitted yet, and a miss
  // is expected.
  std::vector<Entry> ents;
  ents.reserve(re.names.size());
  for (auto& name : re.names) {
    auto it = table_.find(name);
    if (it == table_.end()) {
      if (re.kind != ResponseEntry::ERROR) {
        HVD_WARN("response for unknown tensor " + name + " (engine bug)");
      }
      continue;
    }
    ents.push_back(std::move(it->second));
    table_.erase(it);
  }
  if (ents.empty()) return;
  auto exec_start = std::chrono::steady_clock::now();
  uint64_t exec_start_ns = now_ns();
  for (auto& e : ents) {
    metrics_.negotiation_us += (uint64_t)std::chrono::duration_cast<
        std::chrono::microseconds>(exec_start - e.enqueued).count();
    if (trace_enabled_ && re.kind != ResponseEntry::ERROR) {
      // Negotiate span: enqueue -> execution directive. Finer wire/reduce
      // splits live in the Python engine; here the execution span below
      // covers the whole ring pass, which is the attribution the
      // analyzer needs from the native plane.
      uint64_t enq_ns = (uint64_t)std::chrono::duration_cast<
          std::chrono::nanoseconds>(e.enqueued.time_since_epoch()).count();
      trace_span(trace_tid(e.req), e.req.name, e.req.op, "negotiate",
                 enq_ns, exec_start_ns, 0);
    }
  }
  // Once a ring transport error happened, the peer byte streams may be
  // mid-message (ring.h carries no per-chunk framing by design): executing
  // anything further over those sockets could silently deliver one entry's
  // bytes as another's payload. Fail fast instead.
  if (!ring_error_.empty() && re.kind != ResponseEntry::ERROR) {
    for (auto& e : ents) finish(e, Status::Aborted(ring_error_), Response{});
    return;
  }
  if (timeline_.healthy()) {
    for (auto& e : ents) {
      timeline_.negotiate_end(e.req.name);
      timeline_.start(e.req.name, op_name(re.op));
    }
  }
  try {
    if (re.kind == ResponseEntry::ERROR) {
      for (auto& e : ents) {
        finish(e, Status::Precondition(re.error), Response{});
      }
    } else {
      switch (re.op) {
        case OpType::ALLREDUCE: execute_allreduce(re, ents); break;
        case OpType::ALLGATHER: execute_allgather(re, ents[0]); break;
        case OpType::BROADCAST: execute_broadcast(re, ents[0]); break;
        case OpType::REDUCESCATTER: execute_reducescatter(re, ents[0]); break;
        case OpType::ALLTOALL: execute_alltoall(re, ents[0]); break;
      }
    }
  } catch (const std::exception& ex) {
    // Transport failure mid-collective: the ring is desynced and cannot be
    // trusted for any later collective. Latch the error; the tick loop
    // fails every outstanding tensor and departs the job (the reference
    // likewise treats a data-plane error as fatal to the rank rather than
    // recoverable — a half-written NCCL/MPI stream has no resync point).
    ring_error_ = std::string("ring data plane failed: ") + ex.what();
    for (auto& e : ents) {
      finish(e, Status::Aborted(ring_error_), Response{});
    }
  }
  if (timeline_.healthy()) {
    for (auto& e : ents) timeline_.end(e.req.name);
  }
  if (trace_enabled_ && re.kind != ResponseEntry::ERROR) {
    // The entries were finish()ed above but remain valid in `ents` (only
    // their data/result bytes moved): wire span = the ring execution,
    // done point = completion, both keyed by the shared trace ID.
    uint64_t t = now_ns();
    for (auto& e : ents) {
      trace_span(trace_tid(e.req), e.req.name, e.req.op, "wire",
                 exec_start_ns, t, (uint64_t)e.req.nbytes());
      trace_span(trace_tid(e.req), e.req.name, e.req.op, "done", t, t, 0);
    }
  }
  metrics_.execution_us += (uint64_t)std::chrono::duration_cast<
      std::chrono::microseconds>(std::chrono::steady_clock::now() -
                                 exec_start).count();
}

// One allreduce pass over a contiguous buffer. Flat: ring reduce-scatter +
// allgather over all N ranks. Hierarchical (two-level ladder, the TCP
// re-design of the reference's NCCL-ReduceScatter → cross-node-MPI-allreduce
// → NCCL-Allgather ladder, operations.cc:1284-1446):
//   1. intra-host ring reduce-scatter — local_rank l ends holding chunk l
//      reduced across this host (loopback traffic only);
//   2. cross-host ring allreduce of chunk l among the ranks sharing
//      local_rank l — local_size rings run in parallel, each carrying
//      1/local_size of the payload over the inter-host links;
//   3. intra-host ring allgather redistributes the fully reduced chunks.
// Inter-host bytes per rank drop from 2·B·(N-1)/N (the flat boundary rank)
// to 2·(B/L)·(C-1)/C — the 1/local_size reduction the per-rank cross-byte
// counters measure.
// The borrowed-input variant: reduce-scatter folds the
// read-only `in` plus the incoming partials into `out` (3-operand
// FoldCursor, ring.h); the cross stage, average scale and allgather run
// in place on `out`. Bitwise identical to allreduce_buffer over a copy.
void Engine::allreduce_buffer_into(const uint8_t* in, uint8_t* out,
                                   size_t count, size_t esize, DataType d,
                                   bool average) {
  if (!(hier_allreduce_.load() && hier_.capable)) {
    stats_.passes++;
    auto counts = split_counts(count, topo_.size);
    auto offs = offsets_of(counts);
    ring_reduce_scatter_into(ring_, topo_.rank, topo_.size, in, out, counts,
                             offs, esize, d, &stats_);
    if (average) {
      scale_chunk(d, out + offs[(size_t)topo_.rank] * esize,
                  counts[(size_t)topo_.rank], topo_.size);
    }
    ring_allgather(ring_, topo_.rank, topo_.size, out, counts, offs, esize,
                   &stats_);
    return;
  }
  int L = topo_.local_size, C = topo_.cross_size;
  auto counts = split_counts(count, L);
  auto offs = offsets_of(counts);
  stats_.passes++;
  ring_reduce_scatter_into(local_ring_, topo_.local_rank, L, in, out,
                           counts, offs, esize, d, &stats_);
  uint8_t* mine = out + offs[(size_t)topo_.local_rank] * esize;
  size_t mine_n = counts[(size_t)topo_.local_rank];
  ring_allreduce(cross_ring_, topo_.cross_rank, C, mine, mine_n, esize, d,
                 false, &stats_);
  stats_.passes--;  // the cross pass is a stage of this allreduce
  if (average) scale_chunk(d, mine, mine_n, topo_.size);
  ring_allgather(local_ring_, topo_.local_rank, L, out, counts, offs, esize,
                 &stats_);
}

void Engine::allreduce_buffer(uint8_t* buf, size_t count, size_t esize,
                              DataType d, bool average) {
  if (!(hier_allreduce_.load() && hier_.capable)) {
    ring_allreduce(ring_, topo_.rank, topo_.size, buf, count, esize, d,
                   average, &stats_);
    return;
  }
  int L = topo_.local_size, C = topo_.cross_size;
  auto counts = split_counts(count, L);
  auto offs = offsets_of(counts);
  stats_.passes++;
  ring_reduce_scatter(local_ring_, topo_.local_rank, L, buf, counts, offs,
                      esize, d, &stats_);
  uint8_t* mine = buf + offs[(size_t)topo_.local_rank] * esize;
  size_t mine_n = counts[(size_t)topo_.local_rank];
  // average=false here: the division is by the full world size, applied once
  // below (the cross ring's own world is only cross_size).
  ring_allreduce(cross_ring_, topo_.cross_rank, C, mine, mine_n, esize, d,
                 false, &stats_);
  stats_.passes--;  // the cross pass is a stage of this allreduce, not its own
  if (average) scale_chunk(d, mine, mine_n, topo_.size);
  ring_allgather(local_ring_, topo_.local_rank, L, buf, counts, offs, esize,
                 &stats_);
}

// One fused bucket: memcpy every tensor into the fusion buffer (at native
// width — f16/bf16 reduce 2 bytes/element, ring.h), one ring allreduce over
// the whole buffer, memcpy back out. This is the executed analog of the
// reference's fused MPI path (operations.cc:798-814, 1491-1586).
void Engine::execute_allreduce(const ResponseEntry& re,
                               std::vector<Entry>& ents) {
  // Sparse entries never fuse (coordinator excludes them from the fusion
  // plan), so a topk allreduce always arrives alone.
  if (ents.size() == 1 && ents[0].req.wire_fmt == 1) {
    execute_sparse_allreduce(re, ents[0]);
    return;
  }
  DataType d = re.dtype;
  size_t wes = dtype_size(d);
  const char* act =
      hier_allreduce_.load() ? "HIER_ALLREDUCE" : "RING_ALLREDUCE";
  // Fast path: a single tensor ring-reduces in place over its own
  // contribution buffer and moves it into the response — no fusion-buffer
  // round trip (2x full-size memcpy) on the big-gradient hot path.
  if (ents.size() == 1) {
    Entry& e = ents[0];
    size_t n = e.req.elements();
    if (timeline_.healthy())
      timeline_.activity_start(e.req.name, act);
    Response res;
    res.kind = Response::OK;
    res.name = e.req.name;
    res.dtype = d;
    res.shape = e.req.shape;
    if (e.borrow) {
      // Zero-copy hot path: fold the borrowed caller buffer + incoming
      // partials straight into the (uninitialized) result buffer — no
      // tensor-table copy ever happened for this entry.
      res.data.resize(n * wes);
      allreduce_buffer_into(e.borrow, res.data.data(), n, wes, d,
                            re.average != 0);
    } else {
      allreduce_buffer(e.data.data(), n, wes, d, re.average != 0);
      res.data = std::move(e.data);
    }
    if (timeline_.healthy()) timeline_.activity_end(e.req.name);
    finish(e, Status::OK_(), std::move(res));
    return;
  }
  size_t total = 0;
  for (auto& e : ents) total += e.req.elements();
  uint8_t* buf = fusion_buf_.get(total * wes);
  size_t off = 0;
  for (auto& e : ents) {
    size_t n = e.req.elements();
    if (timeline_.healthy())
      timeline_.activity_start(e.req.name, "MEMCPY_IN_FUSION_BUFFER");
    std::memcpy(buf + off * wes,
                e.borrow ? e.borrow : e.data.data(), n * wes);
    if (timeline_.healthy()) timeline_.activity_end(e.req.name);
    off += n;
  }
  if (timeline_.healthy()) {
    for (auto& e : ents) timeline_.activity_start(e.req.name, act);
  }
  allreduce_buffer(buf, total, wes, d, re.average != 0);
  if (timeline_.healthy()) {
    for (auto& e : ents) timeline_.activity_end(e.req.name);
  }
  off = 0;
  for (auto& e : ents) {
    size_t n = e.req.elements();
    Response res;
    res.kind = Response::OK;
    res.name = e.req.name;
    res.dtype = d;
    res.shape = e.req.shape;
    res.data.resize(n * wes);
    if (timeline_.healthy())
      timeline_.activity_start(e.req.name, "MEMCPY_OUT_FUSION_BUFFER");
    std::memcpy(res.data.data(), buf + off * wes, n * wes);
    if (timeline_.healthy()) timeline_.activity_end(e.req.name);
    off += n;
    finish(e, Status::OK_(), std::move(res));
  }
}

// Sparse (topk) allreduce : the
// entry's buffer holds the enqueue-sparsified dense f32 contribution; the
// ring hops carry indices+values frames index-merged in canonical fold
// order (ring.h ring_sparse_allreduce / grid_sparse_allreduce), bitwise
// identical to the Python engine's sparse planes and the topk oracle.
void Engine::execute_sparse_allreduce(const ResponseEntry& re, Entry& e) {
  size_t n = e.req.elements();
  bool hier = hier_allreduce_.load() && hier_.capable;
  if (timeline_.healthy())
    timeline_.activity_start(e.req.name,
                             hier ? "HIER_ALLREDUCE" : "RING_ALLREDUCE");
  SparseWire sw;
  bool adaptive;
  {
    std::lock_guard<std::mutex> lk(wire_knob_mu_);
    adaptive = sparse_.adaptive;
  }
  if (hier) {
    // Per-fabric framing (value-neutral): explicit topk prefers sparse on
    // both fabrics; adaptive ships sparse on the cross-host leaders rings
    // only (loopback moves dense f32 faster than it selects/merges).
    grid_sparse_allreduce(local_ring_, cross_ring_, topo_.local_rank,
                          topo_.local_size, topo_.cross_rank,
                          topo_.cross_size, (float*)e.data.data(), n,
                          re.average != 0, /*sp_local=*/!adaptive,
                          /*sp_cross=*/true, &stats_, &sw);
  } else {
    ring_sparse_allreduce(ring_, topo_.rank, topo_.size,
                          (float*)e.data.data(), n, re.average != 0,
                          adaptive ? flat_next_cross_ : true,
                          &stats_, &sw);
  }
  if (timeline_.healthy()) timeline_.activity_end(e.req.name);
  metrics_.wire_bytes += sw.wire;
  metrics_.wire_bytes_saved += sw.saved;
  metrics_.topk_wire_bytes += sw.wire;
  metrics_.topk_wire_bytes_saved += sw.saved;
  Response res;
  res.kind = Response::OK;
  res.name = e.req.name;
  res.dtype = e.req.dtype;
  res.shape = e.req.shape;
  res.data = std::move(e.data);
  finish(e, Status::OK_(), std::move(res));
}

void Engine::execute_allgather(const ResponseEntry& re, Entry& ent) {
  size_t esize = dtype_size(ent.req.dtype);
  int64_t dim0 = ent.req.shape[0];
  size_t row_elems = dim0 > 0 ? ent.req.elements() / (size_t)dim0 : 0;
  if (row_elems == 0) {
    // degenerate trailing dims (some dim is 0): recompute from shape tail
    row_elems = 1;
    for (size_t i = 1; i < ent.req.shape.size(); i++)
      row_elems *= (size_t)ent.req.shape[i];
  }
  std::vector<size_t> counts(re.tensor_sizes.size());
  int64_t total0 = 0;
  for (size_t i = 0; i < re.tensor_sizes.size(); i++) {
    counts[i] = (size_t)re.tensor_sizes[i] * row_elems;
    total0 += re.tensor_sizes[i];
  }
  auto offs = offsets_of(counts);
  Response res;
  res.kind = Response::OK;
  res.name = ent.req.name;
  res.dtype = ent.req.dtype;
  res.shape = ent.req.shape;
  res.shape[0] = total0;
  res.data.resize(offs.back() * esize);
  std::memcpy(res.data.data() + offs[(size_t)topo_.rank] * esize,
              ent.data.data(), ent.data.size());
  stats_.passes++;
  if (hier_allgather_.load() && hier_.capable && hier_.blocked) {
    // Two-stage allgather (reference hierarchical allgather: intra-node
    // shared-memory window + cross-node Allgatherv among node roots +
    // local copy-out, operations.cc:929-1034; loopback plays the role of
    // the shared window here):
    //   1. intra-host ring allgather — every rank ends holding its host's
    //      whole contiguous block (blocked layout guarantees contiguity);
    //   2. the host representative (local_rank 0) ring-allgathers the host
    //      blocks across hosts — the only stage that crosses host links,
    //      C-1 steps instead of N-1;
    //   3. the representative pipeline-broadcasts the foreign blocks (the
    //      regions before and after the own-host block) over the local ring.
    int L = topo_.local_size, C = topo_.cross_size;
    uint8_t* base = res.data.data();
    std::vector<size_t> lcounts((size_t)L), loffs((size_t)L);
    for (int l = 0; l < L; l++) {
      int r = topo_.cross_rank * L + l;
      lcounts[(size_t)l] = counts[(size_t)r];
      loffs[(size_t)l] = offs[(size_t)r];
    }
    ring_allgather(local_ring_, topo_.local_rank, L, base, lcounts, loffs,
                   esize, &stats_);
    std::vector<size_t> bcounts((size_t)C), boffs((size_t)C);
    for (int c = 0; c < C; c++) {
      boffs[(size_t)c] = offs[(size_t)c * (size_t)L];
      bcounts[(size_t)c] =
          offs[(size_t)(c + 1) * (size_t)L] - boffs[(size_t)c];
    }
    if (topo_.local_rank == 0) {
      ring_allgather(cross_ring_, topo_.cross_rank, C, base, bcounts, boffs,
                     esize, &stats_);
    }
    size_t pre = boffs[(size_t)topo_.cross_rank] * esize;
    size_t own_end =
        (boffs[(size_t)topo_.cross_rank] + bcounts[(size_t)topo_.cross_rank]) *
        esize;
    size_t post = res.data.size() - own_end;
    ring_broadcast(local_ring_, topo_.local_rank, L, 0, base, pre, &stats_);
    stats_.passes -= pre > 0 ? 1 : 0;  // stages of this allgather, not passes
    ring_broadcast(local_ring_, topo_.local_rank, L, 0, base + own_end, post,
                   &stats_);
    stats_.passes -= post > 0 ? 1 : 0;
  } else {
    ring_allgather(ring_, topo_.rank, topo_.size, res.data.data(), counts,
                   offs, esize, &stats_);
  }
  finish(ent, Status::OK_(), std::move(res));
}

void Engine::execute_broadcast(const ResponseEntry& re, Entry& ent) {
  Response res;
  res.kind = Response::OK;
  res.name = ent.req.name;
  res.dtype = ent.req.dtype;
  res.shape = ent.req.shape;
  res.data = std::move(ent.data);
  ring_broadcast(ring_, topo_.rank, topo_.size, re.root_rank, res.data.data(),
                 res.data.size(), &stats_);
  finish(ent, Status::OK_(), std::move(res));
}

void Engine::execute_reducescatter(const ResponseEntry& re, Entry& ent) {
  DataType d = ent.req.dtype;
  size_t wes = dtype_size(d);
  size_t n = ent.req.elements();
  int64_t dim0 = ent.req.shape[0];
  size_t row_elems = dim0 > 0 ? n / (size_t)dim0 : 0;
  auto rows = split_counts((size_t)dim0, topo_.size);
  std::vector<size_t> counts(rows.size());
  for (size_t i = 0; i < rows.size(); i++) counts[i] = rows[i] * row_elems;
  auto offs = offsets_of(counts);
  // Reduce in place over the entry's own buffer (native width, ring.h).
  stats_.passes++;
  ring_reduce_scatter(ring_, topo_.rank, topo_.size, ent.data.data(), counts,
                      offs, wes, d, &stats_);
  size_t mine = counts[(size_t)topo_.rank];
  uint8_t* my_chunk = ent.data.data() + offs[(size_t)topo_.rank] * wes;
  if (re.average) scale_chunk(d, my_chunk, mine, topo_.size);
  Response res;
  res.kind = Response::OK;
  res.name = ent.req.name;
  res.dtype = d;
  res.shape = ent.req.shape;
  res.shape[0] = (int64_t)rows[(size_t)topo_.rank];
  res.data.assign(my_chunk, my_chunk + mine * wes);
  finish(ent, Status::OK_(), std::move(res));
}

void Engine::execute_alltoall(const ResponseEntry& re, Entry& ent) {
  (void)re;
  int64_t dim0 = ent.req.shape[0];
  size_t row_bytes = dim0 > 0 ? ent.data.size() / (size_t)dim0 : 0;
  auto rows = split_counts((size_t)dim0, topo_.size);
  std::vector<size_t> dest_bytes(rows.size());
  for (size_t i = 0; i < rows.size(); i++) dest_bytes[i] = rows[i] * row_bytes;
  auto dest_offs = offsets_of(dest_bytes);
  size_t my_rows = rows[(size_t)topo_.rank];
  Response res;
  res.kind = Response::OK;
  res.name = ent.req.name;
  res.dtype = ent.req.dtype;
  res.shape = ent.req.shape;
  res.shape[0] = (int64_t)(my_rows * (size_t)topo_.size);
  res.data.resize(my_rows * row_bytes * (size_t)topo_.size);
  ring_alltoall(ring_, topo_.rank, topo_.size, ent.data.data(), dest_bytes,
                dest_offs, res.data.data(), &stats_);
  finish(ent, Status::OK_(), std::move(res));
}

// -------------------------------------------------------------- Coordinator

Coordinator::Coordinator(int world, const std::string& host, int port,
                         Timeline* timeline, const EngineConfig& cfg)
    : world_(world),
      timeline_(timeline),
      cfg_(cfg),
      secret_(job_secret()),
      peers_((size_t)world),
      knob_threshold_((int64_t)cfg.fusion_threshold),
      knob_cycle_ms_(cfg.cycle_time_ms),
      knob_hier_allreduce_(cfg.hierarchical_allreduce),
      knob_hier_allgather_(cfg.hierarchical_allgather) {
  if (cfg_.autotune) {
    pm_ = std::make_unique<ParameterManager>(knob_threshold_, knob_cycle_ms_,
                                             cfg_.threshold_pinned,
                                             cfg_.cycle_pinned);
    pm_->set_hierarchy(cfg_.hierarchical_allreduce, cfg_.hierarchical_allgather,
                       cfg_.hier_allreduce_pinned, cfg_.hier_allgather_pinned);
    if (!cfg_.autotune_log.empty()) pm_->set_log_path(cfg_.autotune_log);
  }
  current_.fusion_threshold = knob_threshold_;
  current_.cycle_time_ms = knob_cycle_ms_;
  current_.hier_allreduce = knob_hier_allreduce_ ? 1 : 0;
  current_.hier_allgather = knob_hier_allgather_ ? 1 : 0;
  listen_fd_ = cfg.coord_listen_fd >= 0 ? cfg.coord_listen_fd
                                       : listen_on(host, port, world + 4);
  last_barrier_ = std::chrono::steady_clock::now();
  accept_thread_ = std::thread([this] { accept_loop(); });
}

Coordinator::~Coordinator() { stop(); }

void Coordinator::stop() {
  if (stop_.exchange(true)) return;
  if (listen_fd_ >= 0) {
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    listen_fd_ = -1;
  }
  {
    // Unblock serve threads parked in recv_frame on healthy sockets (a rank
    // that is alive but wedged would otherwise pin join() forever).
    std::lock_guard<std::mutex> g(mu_);
    for (int fd : client_fds_) ::shutdown(fd, SHUT_RDWR);
  }
  cv_.notify_all();
  if (accept_thread_.joinable()) accept_thread_.join();
  for (auto& t : serve_threads_) {
    if (t.joinable()) t.join();
  }
}

void Coordinator::await_departure(double timeout_s) {
  std::unique_lock<std::mutex> lk(mu_);
  // Every rank announced AND every serve thread has finished its final
  // send and released its socket. Waiting on departed_ alone is a race:
  // tick() marks the announcing rank departed BEFORE serve sends the
  // response, so the caller could tear the coordinator down (closing the
  // client fds) mid-send — the worker then sees a dropped connection and
  // the coordinator logs a spurious "rank lost" on a clean shutdown.
  cv_.wait_for(lk, std::chrono::duration<double>(timeout_s), [&] {
    return (int)departed_.size() >= world_ && client_fds_.empty();
  });
}

void Coordinator::accept_loop() {
  while (!stop_.load()) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return;
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    serve_threads_.emplace_back([this, fd] { serve(fd); });
  }
}

void Coordinator::serve(int fd) {
  int rank = -1;
  {
    std::lock_guard<std::mutex> g(mu_);
    client_fds_.push_back(fd);
  }
  try {
    // Bound the pre-auth handshake (same guard as the ring listener): a
    // connection that sends nothing must not pin this serve thread forever.
    timeval hs{10, 0};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &hs, sizeof(hs));
    ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &hs, sizeof(hs));
    // Authenticate before parsing a single payload byte: an unauthenticated
    // exchange must never be parsed.
    if (!auth_accept(fd, secret_, "hvd-ctrl")) {
      std::lock_guard<std::mutex> g(mu_);
      client_fds_.erase(
          std::remove(client_fds_.begin(), client_fds_.end(), fd),
          client_fds_.end());
      cv_.notify_all();  // await_departure also waits on client_fds_.empty()
      ::close(fd);
      return;
    }
    {
      auto frame = recv_frame(fd);
      Reader r(frame.data(), frame.size());
      if (r.u8() != 0) throw std::runtime_error("expected hello");
      rank = r.i32();
      PeerInfo info;
      info.host = r.str();
      info.port = r.i32();
      info.local_port = r.i32();
      info.cross_port = r.i32();
      info.local_rank = r.i32();
      info.local_size = r.i32();
      info.cross_rank = r.i32();
      info.cross_size = r.i32();
      if (rank <= 0 || rank >= world_)
        throw std::runtime_error("hello from invalid rank");
      auto peers = hello(rank, info);
      Writer w;
      w.u32((uint32_t)peers.size());
      for (auto& p : peers) {
        w.str(p.host);
        w.i32(p.port);
        w.i32(p.local_port);
        w.i32(p.cross_port);
        w.i32(p.local_rank);
        w.i32(p.local_size);
        w.i32(p.cross_rank);
        w.i32(p.cross_size);
      }
      send_frame(fd, w.buf);
    }
    // Handshake done: drop the deadline — an authenticated worker may
    // legitimately go quiet between ticks for longer than the handshake
    // bound (long compute, debugger, GC pause). TCP keepalive covers the
    // silent-loss case instead (host power/network loss sends no FIN/RST;
    // without keepalive the serve thread would block in recv forever and
    // dead-rank detection would never fire): probe after 60s idle, every
    // 10s, give up after 6 misses -> loss detected within ~2 minutes.
    timeval none{0, 0};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &none, sizeof(none));
    ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &none, sizeof(none));
    int ka = 1, idle = 60, intvl = 10, cnt = 6;
    ::setsockopt(fd, SOL_SOCKET, SO_KEEPALIVE, &ka, sizeof(ka));
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPIDLE, &idle, sizeof(idle));
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPINTVL, &intvl, sizeof(intvl));
    ::setsockopt(fd, IPPROTO_TCP, TCP_KEEPCNT, &cnt, sizeof(cnt));
    while (!stop_.load()) {
      auto frame = recv_frame(fd);
      Reader r(frame.data(), frame.size());
      if (r.u8() != 1) throw std::runtime_error("expected tick");
      TickRequest t = TickRequest::read(r);
      if (t.rank != rank) throw std::runtime_error("tick rank mismatch");
      ResponseList out = tick(rank, t);
      Writer w;
      out.write(w);
      send_frame(fd, w.buf);
      if (t.shutdown) break;  // rank departed cleanly
    }
  } catch (const std::exception& ex) {
    if (rank >= 0) {
      HVD_DEBUG("serve(rank " + std::to_string(rank) + ") error: " + ex.what());
      mark_departed(rank);
    }
  }
  {
    std::lock_guard<std::mutex> g(mu_);
    client_fds_.erase(std::remove(client_fds_.begin(), client_fds_.end(), fd),
                      client_fds_.end());
    // await_departure waits for this: a departure is only complete once the
    // serve thread has sent the final response and released the socket.
    cv_.notify_all();
  }
  ::close(fd);
}

std::vector<PeerInfo> Coordinator::hello(int rank, const PeerInfo& info) {
  std::unique_lock<std::mutex> lk(mu_);
  if (peers_[(size_t)rank].port == 0) hello_count_++;
  peers_[(size_t)rank] = info;
  if (hello_count_ >= world_) {
    // Registration complete — the finishing rank opens the autotuner's
    // categorical dimensions iff the registered topology supports the
    // two-level rings (same verdict every engine reaches; ticks cannot
    // arrive before every hello has returned, so this runs before any
    // build_response_list).
    HierPlan plan = analyze_hier(peers_, 0);
    if (!plan.capable) {
      knob_hier_allreduce_ = false;
      knob_hier_allgather_ = false;
      current_.hier_allreduce = 0;
      current_.hier_allgather = 0;
      if (pm_) pm_->set_hierarchy(false, false, true, true);  // pin off
    } else if (!plan.blocked) {
      knob_hier_allgather_ = false;
      current_.hier_allgather = 0;
      if (pm_)
        pm_->set_hierarchy(cfg_.hierarchical_allreduce, false,
                           cfg_.hier_allreduce_pinned, true);
    }
    if (pm_) {
      pm_->enable_hierarchy_tuning(plan.capable, plan.capable && plan.blocked);
    }
  }
  cv_.notify_all();
  cv_.wait(lk, [&] { return hello_count_ >= world_ || stop_.load(); });
  if (hello_count_ < world_)
    throw std::runtime_error("coordinator stopped during registration");
  return peers_;
}

void Coordinator::mark_departed(int rank) {
  std::lock_guard<std::mutex> g(mu_);
  // Only reached from serve()'s error path: a clean departure breaks out of
  // the serve loop via the shutdown flag instead. This rank is dead.
  departed_.insert(rank);
  if (!dead_ranks_.count(rank)) {
    dead_ranks_.insert(rank);
    HVD_WARN("rank " + std::to_string(rank) +
             " lost (connection dropped without shutdown); failing pending "
             "collectives — restart from the last checkpoint");
  }
  // If every live rank is already parked in the tick barrier, complete the
  // cycle now — build_response_list fails the pending tensors (dead_ranks_
  // branch) and the waiters wake with errors instead of stalling. Live
  // ranks that have not ticked yet get their errors on the next cycle.
  if (barrier_complete() && !contributed_.empty()) build_response_list();
  cv_.notify_all();
}

bool Coordinator::barrier_complete() const {
  for (int r = 0; r < world_; r++) {
    if (!contributed_.count(r) && !departed_.count(r)) return false;
  }
  return true;
}

ResponseList Coordinator::tick(int rank, const TickRequest& req) {
  std::unique_lock<std::mutex> lk(mu_);
  auto now = std::chrono::steady_clock::now();
  auto contribute = [&](const Request& q) {
    auto [it, fresh] = pending_.try_emplace(q.name);
    if (fresh) {
      it->second.first_seen = now;
      arrival_order_.push_back(q.name);
    }
    if (timeline_ && timeline_->healthy())
      timeline_->negotiate_rank_ready(q.name, q.rank);
    it->second.contribs[rank] = q;
  };
  for (auto& q : req.reqs) {
    if (cache_.enabled()) {
      bool have = false;
      uint32_t old = cache_.bit_for_name(q.name, &have);
      if (have) {
        uint32_t bound;
        if (cache_.key_bound(cache_key(q), &bound) && bound == old) {
          // Already bound under the SAME signature: a rank with a flushed
          // mirror is re-learning — re-announce on the next broadcast.
          cache_.assign(q, {}, &cache_announce_);
        } else {
          // Shape/dtype change: evict the stale bit everywhere.
          cache_.evict_name(q.name, &cache_announce_);
        }
      }
    }
    contribute(q);
  }
  // Expand the rank's cache bitvector into contributions (steady state:
  // this is the whole tick). Mutation of the authority's LRU is safe here
  // under mu_; assignments/evictions still only happen at barriers.
  for (size_t w = 0; w < req.cache_bits.size(); w++) {
    uint64_t word = req.cache_bits[w];
    while (word) {
      int b = __builtin_ctzll(word);
      word &= word - 1;
      uint32_t bit = (uint32_t)(w * 64 + (size_t)b);
      const Request* tmpl = cache_.lookup(bit);
      if (!tmpl) {
        HVD_WARN("rank " + std::to_string(rank) +
                 " submitted unknown cache bit " + std::to_string(bit));
        continue;
      }
      Request q = *tmpl;
      q.rank = rank;
      contribute(q);
    }
  }
  if (req.shutdown) {
    shutdown_seen_ = true;
    departed_.insert(rank);
  }
  contributed_.insert(rank);
  uint64_t my_gen = gen_;
  if (barrier_complete()) {
    build_response_list();
    cv_.notify_all();
  } else {
    while (gen_ == my_gen && !stop_.load()) {
      cv_.wait_for(lk, std::chrono::seconds(1));
      // Barrier stuck (a rank stopped ticking): run the stall scan on a
      // timer so rank 0 gets diagnostics even though build_response_list
      // can't run; the warnings also ride the next successful broadcast.
      if (gen_ == my_gen && !cfg_.stall_check_disable) {
        auto warns = scan_stalls(std::chrono::steady_clock::now());
        for (auto& w : warns) {
          log_msg(3, "warning", w);
          deferred_warnings_.push_back(w);
        }
      }
    }
    if (gen_ == my_gen) {
      throw std::runtime_error("coordinator stopped mid-tick");
    }
  }
  return current_;
}

std::vector<std::string> Coordinator::scan_stalls(
    std::chrono::steady_clock::time_point now) {
  std::vector<std::string> out;
  for (auto& [name, p] : pending_) {
    double age = std::chrono::duration<double>(now - p.first_seen).count();
    double since_warn =
        p.warned ? std::chrono::duration<double>(now - p.last_warned).count()
                 : 1e9;
    if (age > cfg_.stall_warning_s && since_warn > cfg_.stall_warning_s) {
      std::string missing;
      for (int r = 0; r < world_; r++) {
        if (!p.contribs.count(r))
          missing += (missing.empty() ? "" : ", ") + std::to_string(r);
      }
      out.push_back(
          "One or more tensors were submitted to be reduced, gathered or "
          "broadcasted by subset of ranks and are waiting for remainder of "
          "ranks for more than " +
          std::to_string((int)cfg_.stall_warning_s) + " seconds. Op: " + name +
          ", missing ranks: " + missing);
      p.warned = true;
      p.last_warned = now;
    }
  }
  return out;
}

// Build the per-tick broadcast while holding mu_: ready detection in
// arrival order, validation, fusion planning, stall diagnostics, knob sync.
void Coordinator::build_response_list() {
  auto now = std::chrono::steady_clock::now();
  ResponseList out;
  out.shutdown = shutdown_seen_ ? 1 : 0;

  // 1. ready tensors, in first-arrival order (the coordinator's total order,
  //    reference operations.cc:2071-2129)
  std::vector<std::pair<std::string, ResponseEntry>> ready;
  std::set<std::string> consumed;
  for (auto& name : arrival_order_) {
    auto it = pending_.find(name);
    if (it == pending_.end()) continue;
    if ((int)it->second.contribs.size() < world_ && dead_ranks_.empty())
      continue;
    ResponseEntry entry;
    if (shutdown_seen_) {
      entry.kind = ResponseEntry::ERROR;
      entry.op = it->second.contribs.begin()->second.op;
      entry.names = {name};
      entry.error = "Horovod has been shut down";
    } else if (!dead_ranks_.empty()) {
      // A rank died without shutting down: its contributions will never
      // arrive and the ring through it is gone — no pending collective can
      // complete. Fail them all with the dead ranks named (better than the
      // reference, which stalls forever with warnings).
      std::string who;
      for (int r : dead_ranks_) who += (who.empty() ? "" : ", ") + std::to_string(r);
      entry.kind = ResponseEntry::ERROR;
      entry.op = it->second.contribs.begin()->second.op;
      entry.names = {name};
      entry.error = "rank(s) " + who +
                    " lost (connection dropped without shutdown); collective "
                    "cannot complete — restart from the last checkpoint";
    } else {
      validate(name, it->second.contribs, &entry);
    }
    ready.emplace_back(name, std::move(entry));
    consumed.insert(name);
  }
  int64_t ready_bytes = 0;
  // Freshly-validated signatures become cacheable now (reference
  // response_cache.cc: the cache is populated from responses). Allgather
  // is uncacheable — its first dimension is legitimately rank-divergent,
  // so no single signature matches every rank.
  std::vector<Request> to_assign;
  for (auto& [name, entry] : ready) {
    if (entry.kind == ResponseEntry::OK) {
      ready_bytes += (int64_t)pending_[name].contribs.begin()->second.nbytes();
      if (cache_.enabled() && entry.op != OpType::ALLGATHER)
        to_assign.push_back(pending_[name].contribs.begin()->second);
    }
  }
  for (auto& name : consumed) pending_.erase(name);
  // Announcements buffered since the last barrier (invalidations, mirror
  // re-heals) ride this broadcast, then the new assignments. Bits of
  // tensors still mid-negotiation are protected from LRU eviction.
  out.cache_evict = std::move(cache_announce_.cache_evict);
  out.cache_assign = std::move(cache_announce_.cache_assign);
  cache_announce_.cache_evict.clear();
  cache_announce_.cache_assign.clear();
  {
    std::set<std::string> in_use;
    for (auto& [n, p] : pending_) in_use.insert(n);
    for (auto& q : to_assign) cache_.assign(q, in_use, &out);
  }
  if (!consumed.empty()) {
    std::vector<std::string> keep;
    keep.reserve(arrival_order_.size() - consumed.size());
    for (auto& n : arrival_order_) {
      if (!consumed.count(n)) keep.push_back(n);
    }
    arrival_order_.swap(keep);
  }

  // 2. fusion plan over the ready allreduces (reference fusion negotiation,
  //    operations.cc:2154-2266): same-dtype same-mode buckets under the
  //    live threshold; every rank executes each bucket as one ring pass.
  std::vector<FusionItem> items;
  for (size_t i = 0; i < ready.size(); i++) {
    auto& e = ready[i].second;
    // Sparse (topk) entries never fuse: their payloads are per-tensor
    // frames, and each rank executes them from its own Request anyway.
    if (e.kind == ResponseEntry::OK && e.op == OpType::ALLREDUCE &&
        e.req_wire_fmt == 0) {
      // fused_nbytes (work-dtype payload size) is stashed by validate()
      items.push_back(
          FusionItem{i, e.dtype, e.average, (size_t)e.fused_nbytes});
    }
  }
  auto buckets = plan_fusion(items, (size_t)knob_threshold_);
  std::map<size_t, std::vector<size_t>> bucket_of_leader;  // leader idx -> members
  std::set<size_t> member;
  for (auto& b : buckets) {
    if (b.size() <= 1) continue;
    std::vector<size_t> idxs;
    for (auto& it : b) idxs.push_back(it.index);
    for (size_t k = 1; k < idxs.size(); k++) member.insert(idxs[k]);
    bucket_of_leader[idxs[0]] = std::move(idxs);
  }
  for (size_t i = 0; i < ready.size(); i++) {
    if (member.count(i)) continue;
    auto lead = bucket_of_leader.find(i);
    if (lead == bucket_of_leader.end()) {
      out.entries.push_back(std::move(ready[i].second));
    } else {
      ResponseEntry merged = ready[i].second;
      for (size_t k = 1; k < lead->second.size(); k++) {
        auto& other = ready[lead->second[k]].second;
        merged.names.push_back(other.names[0]);
      }
      out.entries.push_back(std::move(merged));
    }
  }

  // 3. stall diagnostics with missing-rank lists (reference
  //    CheckForStalledTensors, operations.cc:1643-1665; the missing ranks
  //    are the useful part, not the tensor names alone).
  //    Includes any warnings the timer-driven scans collected while the
  //    barrier was stuck, so every rank sees them, not just rank 0.
  out.stall_warnings = std::move(deferred_warnings_);
  deferred_warnings_.clear();
  if (!cfg_.stall_check_disable) {
    for (auto& w : scan_stalls(now)) {
      log_msg(3, "warning", w);  // rank 0 logs at creation; workers on receipt
      out.stall_warnings.push_back(std::move(w));
    }
  }

  // 4. knob sync (reference SyncParams, parameter_manager.cc:213-233): the
  //    coordinator owns the tuner; knobs ride the broadcast so every rank
  //    applies the same values on the same tick.
  if (pm_ && pm_->active() && ready_bytes > 0) {
    double secs =
        std::chrono::duration<double>(now - last_barrier_).count();
    if (pm_->update(ready_bytes, secs)) {
      auto k = pm_->knobs();
      knob_threshold_ = k.fusion_threshold;
      knob_cycle_ms_ = k.cycle_time_ms;
      knob_hier_allreduce_ = k.hier_allreduce;
      knob_hier_allgather_ = k.hier_allgather;
      knob_version_++;
    }
  }
  last_barrier_ = now;
  out.knob_version = knob_version_;
  out.fusion_threshold = knob_threshold_;
  out.cycle_time_ms = knob_cycle_ms_;
  out.hier_allreduce = knob_hier_allreduce_ ? 1 : 0;
  out.hier_allgather = knob_hier_allgather_ ? 1 : 0;

  current_ = std::move(out);
  gen_++;
  contributed_.clear();
}

bool Coordinator::validate(const std::string& name,
                           const std::map<int, Request>& contribs,
                           ResponseEntry* entry) {
  const Request& first = contribs.begin()->second;
  entry->op = first.op;
  entry->names = {name};
  auto fail = [&](const std::string& msg) {
    entry->kind = ResponseEntry::ERROR;
    entry->error = msg;
    return false;
  };
  for (auto& [r, q] : contribs) {
    if (q.op != first.op)
      return fail("Mismatched collective operations for tensor " + name);
    if (q.dtype != first.dtype)
      return fail("Mismatched data types for tensor " + name);
    if (q.orig_dtype != first.orig_dtype)
      // Divergent HOROVOD_COMPRESSION across ranks: half the world would
      // ship 2-byte chunks the other half reads at full width.
      return fail("Mismatched wire compression for tensor " + name);
    if (q.wire_fmt != first.wire_fmt)
      // Same failure class for the sparse wire: a topk rank's frames are
      // unreadable as dense chunks.
      return fail("Mismatched wire compression for tensor " + name);
  }
  if (first.op == OpType::ALLGATHER) {
    if (first.shape.empty())
      return fail("Allgather requires tensors of rank >= 1: " + name);
    for (auto& [r, q] : contribs) {
      if (q.shape.size() != first.shape.size() || q.shape.empty() ||
          !std::equal(q.shape.begin() + 1, q.shape.end(),
                      first.shape.begin() + 1))
        return fail("Mismatched non-first dimensions for allgather " + name);
    }
  } else {
    for (auto& [r, q] : contribs) {
      if (q.shape != first.shape)
        return fail("Mismatched tensor shapes for tensor " + name);
    }
  }
  if (first.op == OpType::BROADCAST) {
    for (auto& [r, q] : contribs) {
      if (q.root_rank != first.root_rank)
        return fail("Mismatched root ranks for broadcast " + name);
    }
  }
  if ((first.op == OpType::REDUCESCATTER || first.op == OpType::ALLTOALL) &&
      first.shape.empty()) {
    return fail(std::string(op_name(first.op)) +
                " requires tensors of rank >= 1: " + name);
  }
  entry->kind = ResponseEntry::OK;
  entry->dtype = first.dtype;
  entry->root_rank = first.root_rank;
  entry->average = first.average;
  entry->req_wire_fmt = first.wire_fmt;
  if (first.op == OpType::ALLGATHER) {
    entry->tensor_sizes.resize((size_t)world_);
    for (auto& [r, q] : contribs) {
      entry->tensor_sizes[(size_t)r] = q.shape.empty() ? 1 : q.shape[0];
    }
  }
  // Stash the per-rank payload size for the fusion planner (native-width
  // bytes; f16/bf16 stay 2 bytes/element end to end).
  size_t elems = first.elements();
  entry->fused_nbytes = (int64_t)(elems * dtype_size(first.dtype));
  return true;
}

// ------------------------------------------------------------------- Client

Client::Client(const std::string& host, int port, int rank, double timeout_s)
    : rank_(rank) {
  fd_ = connect_to(host, port, timeout_s);
  try {
    // Short deadline during the handshake: a secret mismatch (e.g. the
    // server has no secret and never sends a nonce) must error, not hang.
    timeval hs{30, 0};
    ::setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &hs, sizeof(hs));
    ::setsockopt(fd_, SOL_SOCKET, SO_SNDTIMEO, &hs, sizeof(hs));
    auth_connect(fd_, job_secret(), "hvd-ctrl");
  } catch (...) {
    ::close(fd_);
    fd_ = -1;
    throw;
  }
  // Generous receive deadline from here: a barrier stall beyond this means
  // the coordinator or a peer is gone for good.
  timeval tv{600, 0};
  ::setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

Client::~Client() {
  if (fd_ >= 0) ::close(fd_);
}

std::string Client::local_host() const { return local_addr(fd_); }

std::vector<PeerInfo> Client::hello(const PeerInfo& info) {
  std::lock_guard<std::mutex> g(mu_);
  Writer w;
  w.u8(0);
  w.i32(rank_);
  w.str(info.host);
  w.i32(info.port);
  w.i32(info.local_port);
  w.i32(info.cross_port);
  w.i32(info.local_rank);
  w.i32(info.local_size);
  w.i32(info.cross_rank);
  w.i32(info.cross_size);
  send_frame(fd_, w.buf);
  auto frame = recv_frame(fd_);
  Reader r(frame.data(), frame.size());
  uint32_t n = r.u32();
  std::vector<PeerInfo> peers((size_t)n);
  for (uint32_t i = 0; i < n; i++) {
    peers[i].host = r.str();
    peers[i].port = r.i32();
    peers[i].local_port = r.i32();
    peers[i].cross_port = r.i32();
    peers[i].local_rank = r.i32();
    peers[i].local_size = r.i32();
    peers[i].cross_rank = r.i32();
    peers[i].cross_size = r.i32();
  }
  return peers;
}

ResponseList Client::tick(const TickRequest& req) {
  std::lock_guard<std::mutex> g(mu_);
  Writer w;
  w.u8(1);
  req.write(w);
  send_frame(fd_, w.buf);
  auto frame = recv_frame(fd_);
  Reader r(frame.data(), frame.size());
  return ResponseList::read(r);
}

}  // namespace hvd
