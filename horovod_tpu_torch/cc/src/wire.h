// Wire format for control-plane messages.
//
// The reference serializes Request/RequestList/Response/ResponseList with
// FlatBuffers (horovod/common/wire/message.fbs:41-101, message.{cc,h}).
// Here the schema is the same shape — Request{rank, op, dtype, name, root,
// shape}, RequestList{shutdown}, Response{type, tensor_names, error,
// tensor_sizes}, ResponseList{shutdown} — but the encoding is a plain
// length-prefixed little-endian stream: the messages are rank-local,
// version-locked to the build, and never persisted, so a schema compiler
// buys nothing on TPU hosts.
//
// Requests carry METADATA ONLY: tensor bytes never transit
// the coordinator. The data plane is the peer-to-peer ring (ring.h), which
// matches the reference's split between the MPI control plane and the
// MPI/NCCL data plane (operations.cc:2030-2380 vs 1221-1586).
#ifndef HVD_WIRE_H
#define HVD_WIRE_H

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

#include "hvd_common.h"

namespace hvd {

class Writer {
 public:
  std::vector<uint8_t> buf;

  void u8(uint8_t v) { buf.push_back(v); }
  void u32(uint32_t v) { raw(&v, 4); }
  void u64(uint64_t v) { raw(&v, 8); }
  void i32(int32_t v) { raw(&v, 4); }
  void i64(int64_t v) { raw(&v, 8); }
  void f64(double v) { raw(&v, 8); }
  void str(const std::string& s) {
    u32((uint32_t)s.size());
    raw(s.data(), s.size());
  }
  void raw(const void* p, size_t n) {
    const uint8_t* c = (const uint8_t*)p;
    buf.insert(buf.end(), c, c + n);
  }
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), n_(n) {}

  uint8_t u8() { return *take(1); }
  uint32_t u32() { uint32_t v; std::memcpy(&v, take(4), 4); return v; }
  uint64_t u64() { uint64_t v; std::memcpy(&v, take(8), 8); return v; }
  int32_t i32() { int32_t v; std::memcpy(&v, take(4), 4); return v; }
  int64_t i64() { int64_t v; std::memcpy(&v, take(8), 8); return v; }
  double f64() { double v; std::memcpy(&v, take(8), 8); return v; }
  std::string str() {
    uint32_t n = u32();
    const uint8_t* p = take(n);
    return std::string((const char*)p, n);
  }
  bool done() const { return off_ == n_; }

 private:
  const uint8_t* take(size_t n) {
    if (off_ + n > n_) throw std::runtime_error("wire: truncated message");
    const uint8_t* out = p_ + off_;
    off_ += n;
    return out;
  }
  const uint8_t* p_;
  size_t n_;
  size_t off_ = 0;
};

// A collective request from one rank — metadata only (reference
// message.h:44-120). `dtype` is the dtype the engine MOVES AND REDUCES —
// under HOROVOD_COMPRESSION an allreduce's payload is cast to the
// 16-bit wire dtype at enqueue, so dtype names the wire format while
// `orig_dtype` tags the caller's dtype (restored into the Response at
// completion). Uncompressed requests have orig_dtype == dtype. Both are
// part of the signature, so cache.h bits distinguish compressed from
// uncompressed negotiations of the same tensor.
struct Request {
  int32_t rank = 0;
  OpType op = OpType::ALLREDUCE;
  DataType dtype = DataType::F32;       // wire/working dtype
  DataType orig_dtype = DataType::F32;  // caller dtype (== dtype when uncompressed)
  // Sparse wire-format tag (the native topk plane): 0 = dense
  // frames, 1 = topk indices+values frames (topk.h). A dtype cast changes
  // dtype/orig_dtype; topk changes the FRAME of an f32 payload, so it
  // needs its own signature facet — the python engine tags the same fact
  // in its request dict's `wire` field ("topk"). Part of the cache key
  // (cache.h) and of cross-rank validation, like the dtype pair.
  uint8_t wire_fmt = 0;
  std::string name;
  int32_t root_rank = 0;
  uint8_t average = 1;
  // Distributed-tracing tag: the per-name submission counter the
  // enqueueing rank derived this collective's trace ID ("<name>#<seq>")
  // from. Deterministic and identical on every rank (a name is in flight
  // at most once, and every rank submits it the same number of times), so
  // cached ticks need no tag — this field lets the coordinator VERIFY the
  // cross-rank agreement on full requests. Not part of the cache signature
  // (cache.h cache_key): it changes per submission by construction.
  uint32_t trace_seq = 0;
  std::vector<int64_t> shape;

  size_t elements() const {
    size_t n = 1;
    for (auto d : shape) n *= (size_t)d;
    return n;
  }
  size_t nbytes() const { return elements() * dtype_size(dtype); }
  bool compressed() const { return orig_dtype != dtype; }

  void write(Writer& w) const {
    w.i32(rank);
    w.u8((uint8_t)op);
    w.u8((uint8_t)dtype);
    w.u8((uint8_t)orig_dtype);
    w.u8(wire_fmt);
    w.str(name);
    w.i32(root_rank);
    w.u8(average);
    w.u32(trace_seq);
    w.u8((uint8_t)shape.size());
    for (auto d : shape) w.i64(d);
  }
  static Request read(Reader& r) {
    Request q;
    q.rank = r.i32();
    q.op = (OpType)r.u8();
    q.dtype = (DataType)r.u8();
    q.orig_dtype = (DataType)r.u8();
    q.wire_fmt = r.u8();
    q.name = r.str();
    q.root_rank = r.i32();
    q.average = r.u8();
    q.trace_seq = r.u32();
    uint8_t nd = r.u8();
    q.shape.resize(nd);
    for (int i = 0; i < nd; i++) q.shape[i] = r.i64();
    return q;
  }
};

// One rank's per-tick message list (reference RequestList, message.h:122-144:
// requests + shutdown flag + the response-cache bitvector: tensors whose
// signature is already bit-bound ride as set bits in cache_bits instead of
// full Request entries — the steady-state tick frame is a few words).
struct TickRequest {
  int32_t rank = 0;
  uint8_t shutdown = 0;
  std::vector<Request> reqs;
  std::vector<uint64_t> cache_bits;  // packed bitvector of cached submissions

  void set_cache_bit(uint32_t bit) {
    size_t word = bit / 64;
    if (cache_bits.size() <= word) cache_bits.resize(word + 1, 0);
    cache_bits[word] |= (uint64_t)1 << (bit % 64);
  }

  void write(Writer& w) const {
    w.i32(rank);
    w.u8(shutdown);
    w.u32((uint32_t)reqs.size());
    for (auto& q : reqs) q.write(w);
    w.u32((uint32_t)cache_bits.size());
    for (auto v : cache_bits) w.u64(v);
  }
  static TickRequest read(Reader& r) {
    TickRequest t;
    t.rank = r.i32();
    t.shutdown = r.u8();
    uint32_t n = r.u32();
    t.reqs.reserve(n);
    for (uint32_t i = 0; i < n; i++) t.reqs.push_back(Request::read(r));
    uint32_t nw = r.u32();
    t.cache_bits.resize(nw);
    for (uint32_t i = 0; i < nw; i++) t.cache_bits[i] = r.u64();
    return t;
  }
};

// One response-cache bit assignment, broadcast to every rank so the
// per-rank mirrors stay identical (cache.h CacheAuthority).
struct CacheAssign {
  uint32_t bit = 0;
  Request req;  // rank-agnostic signature template

  void write(Writer& w) const {
    w.u32(bit);
    req.write(w);
  }
  static CacheAssign read(Reader& r) {
    CacheAssign a;
    a.bit = r.u32();
    a.req = Request::read(r);
    return a;
  }
};

// One execution order from the coordinator: a single tensor, or a fused
// bucket of same-dtype allreduces (reference Response.tensor_names after the
// fusion loop, operations.cc:2154-2266). Carries no tensor bytes — every
// rank already holds its contribution; this tells it what to run, in what
// order, against the ring.
struct ResponseEntry {
  enum Kind : uint8_t { OK = 0, ERROR = 1 };
  Kind kind = OK;
  OpType op = OpType::ALLREDUCE;
  std::vector<std::string> names;
  std::string error;                 // ERROR only, delivered to every rank
  DataType dtype = DataType::F32;
  int32_t root_rank = 0;             // broadcast
  uint8_t average = 1;               // allreduce / reducescatter
  // allgather: first-dimension size contributed by each rank, in rank order
  // (reference Response.tensor_sizes, message.h:188-195).
  std::vector<int64_t> tensor_sizes;
  // Coordinator-local scratch for the fusion planner (per-rank payload in
  // work-dtype bytes); never serialized.
  int64_t fused_nbytes = 0;
  // Coordinator-local scratch: the validated wire_fmt of the contributions
  // (sparse entries never fuse — every rank executes them from its own
  // Request anyway); never serialized.
  int64_t req_wire_fmt = 0;

  void write(Writer& w) const {
    w.u8((uint8_t)kind);
    w.u8((uint8_t)op);
    w.u32((uint32_t)names.size());
    for (auto& n : names) w.str(n);
    if (kind == ERROR) {
      w.str(error);
      return;
    }
    w.u8((uint8_t)dtype);
    w.i32(root_rank);
    w.u8(average);
    w.u32((uint32_t)tensor_sizes.size());
    for (auto v : tensor_sizes) w.i64(v);
  }
  static ResponseEntry read(Reader& r) {
    ResponseEntry e;
    e.kind = (Kind)r.u8();
    e.op = (OpType)r.u8();
    uint32_t n = r.u32();
    e.names.reserve(n);
    for (uint32_t i = 0; i < n; i++) e.names.push_back(r.str());
    if (e.kind == ERROR) {
      e.error = r.str();
      return e;
    }
    e.dtype = (DataType)r.u8();
    e.root_rank = r.i32();
    e.average = r.u8();
    uint32_t m = r.u32();
    e.tensor_sizes.resize(m);
    for (uint32_t i = 0; i < m; i++) e.tensor_sizes[i] = r.i64();
    return e;
  }
};

// The coordinator's per-tick broadcast (reference ResponseList,
// message.h:211-234, plus the parameter sync the reference does over
// MPI_Bcast in ParameterManager::SyncParams, parameter_manager.cc:213-233,
// and the stall warnings of CheckForStalledTensors, operations.cc:1625-1672
// — here surfaced to every rank, not just the coordinator's stderr).
struct ResponseList {
  uint8_t shutdown = 0;
  uint32_t knob_version = 0;         // bumps when the autotuner moves knobs
  int64_t fusion_threshold = 0;
  double cycle_time_ms = 0.0;
  // Categorical knobs (reference ParameterManager tunes the hierarchical
  // flags alongside the numeric ones, parameter_manager.h:172). Broadcast
  // per tick so every rank flips algorithms on the same cycle.
  uint8_t hier_allreduce = 0;
  uint8_t hier_allgather = 0;
  std::vector<std::string> stall_warnings;
  std::vector<ResponseEntry> entries;
  // Response-cache announcements (cache.h): applied by every rank before
  // its next tick, so mirrors mutate in lockstep with the authority.
  std::vector<uint32_t> cache_evict;
  std::vector<CacheAssign> cache_assign;

  void write(Writer& w) const {
    w.u8(shutdown);
    w.u32(knob_version);
    w.i64(fusion_threshold);
    w.f64(cycle_time_ms);
    w.u8(hier_allreduce);
    w.u8(hier_allgather);
    w.u32((uint32_t)stall_warnings.size());
    for (auto& s : stall_warnings) w.str(s);
    w.u32((uint32_t)entries.size());
    for (auto& e : entries) e.write(w);
    w.u32((uint32_t)cache_evict.size());
    for (auto v : cache_evict) w.u32(v);
    w.u32((uint32_t)cache_assign.size());
    for (auto& a : cache_assign) a.write(w);
  }
  static ResponseList read(Reader& r) {
    ResponseList l;
    l.shutdown = r.u8();
    l.knob_version = r.u32();
    l.fusion_threshold = r.i64();
    l.cycle_time_ms = r.f64();
    l.hier_allreduce = r.u8();
    l.hier_allgather = r.u8();
    uint32_t ns = r.u32();
    l.stall_warnings.reserve(ns);
    for (uint32_t i = 0; i < ns; i++) l.stall_warnings.push_back(r.str());
    uint32_t n = r.u32();
    l.entries.reserve(n);
    for (uint32_t i = 0; i < n; i++) l.entries.push_back(ResponseEntry::read(r));
    uint32_t ne = r.u32();
    l.cache_evict.resize(ne);
    for (uint32_t i = 0; i < ne; i++) l.cache_evict[i] = r.u32();
    uint32_t na = r.u32();
    l.cache_assign.reserve(na);
    for (uint32_t i = 0; i < na; i++)
      l.cache_assign.push_back(CacheAssign::read(r));
    return l;
  }
};

// A completed tensor handed back to the caller through the handle table.
// `data` is a Buffer (hvd_common.h): resize leaves it uninitialized —
// every producer writes the payload in full.
struct Response {
  enum Kind : uint8_t { OK = 0, ERROR = 1 };
  Kind kind = OK;
  std::string name;
  std::string error;
  DataType dtype = DataType::F32;
  std::vector<int64_t> shape;
  Buffer data;
};

}  // namespace hvd

#endif  // HVD_WIRE_H
