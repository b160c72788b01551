// Response cache for the native eager engine — the steady-state fast path.
//
// The reference's biggest eager-path latency win was the response cache
// (horovod/common/response_cache.{cc,h}): after a tensor's first full
// negotiation, its request signature is bound to a small integer *bit* on
// every rank, and steady-state ticks carry a per-rank bitvector instead of
// full request lists — one small fixed-size frame per tick no matter how
// many tensors the training step re-submits.
//
// Two halves, mirroring horovod_tpu/common/response_cache.py:
// - CacheAuthority: owned by the rank-0 coordinator. Assigns bits to
//   validated signatures, bounds the table at HOROVOD_CACHE_CAPACITY with
//   LRU eviction (never a bit whose tensor is mid-negotiation), and emits
//   assign/evict announcements that ride the broadcast ResponseList.
//   Because the native tick is a generation barrier — every mutation
//   happens in build_response_list and every rank receives that exact
//   ResponseList before its next tick — a single announcement reaches all
//   ranks before any next-tick bit use; no tombstones are needed (the
//   Python engine's barrier-less protocol does need them).
// - the per-rank mirror lives as two maps in Engine (engine.h): a pure
//   follower of the announcements, bounded by the authority's capacity.
//
// A key is the full signature (name, op, dtype, shape, root, average): a
// shape or dtype change misses, falls back to a full request, and makes
// the authority evict the stale bit for that name (shape-change
// invalidation). World-size changes and elastic resets rebuild the engine
// and both cache halves with it.
#ifndef HVD_CACHE_H
#define HVD_CACHE_H

#include <cstdint>
#include <cstdlib>
#include <list>
#include <set>
#include <string>
#include <unordered_map>

#include "wire.h"

namespace hvd {

inline size_t cache_capacity_from_env() {
  const char* v = std::getenv("HOROVOD_CACHE_CAPACITY");
  if (!v || !*v) return 1024;
  long n = std::strtol(v, nullptr, 10);
  return n > 0 ? (size_t)n : 0;
}

// Full request signature; rank deliberately excluded (the template is
// rank-agnostic — the coordinator stamps the contributing rank back in).
// orig_dtype is included: a compressed allreduce (dtype = wire
// format, orig_dtype = caller dtype) and its uncompressed twin are
// DIFFERENT signatures, so a wire-dtype change misses, falls back to the
// full-request path, and invalidates the stale bit like a shape change.
// wire_fmt is included the same way: a topk allreduce and its
// dense twin are different signatures — a policy flip invalidates bits.
inline std::string cache_key(const Request& q) {
  std::string k = q.name;
  k.push_back('\0');
  k.push_back((char)q.op);
  k.push_back((char)q.dtype);
  k.push_back((char)q.orig_dtype);
  k.push_back((char)q.wire_fmt);
  k.push_back((char)q.average);
  k.append(std::to_string(q.root_rank));
  for (int64_t d : q.shape) {
    k.push_back(',');
    k.append(std::to_string(d));
  }
  return k;
}

class CacheAuthority {
 public:
  explicit CacheAuthority(size_t capacity = cache_capacity_from_env())
      : capacity_(capacity) {}

  bool enabled() const { return capacity_ > 0; }
  size_t size() const { return bits_.size(); }

  // Resolve a bit a rank submitted; refreshes its LRU position. nullptr =
  // unknown (a protocol bug under the barrier invariant; caller warns).
  const Request* lookup(uint32_t bit) {
    auto it = bits_.find(bit);
    if (it == bits_.end()) return nullptr;
    touch(bit);
    return &it->second.second;
  }

  uint32_t bit_for_name(const std::string& name, bool* found) const {
    auto it = name_to_bit_.find(name);
    *found = it != name_to_bit_.end();
    return *found ? it->second : 0;
  }

  bool key_bound(const std::string& key, uint32_t* bit) const {
    auto it = key_to_bit_.find(key);
    if (it == key_to_bit_.end()) return false;
    *bit = it->second;
    return true;
  }

  // Bind a freshly-validated request's signature to a bit. Announcements
  // (assign + any evictions made for room) are appended to `out` and ride
  // the broadcast. `in_use` holds tensor names still mid-negotiation —
  // their bits are never evicted. Returns false when the table is full of
  // in-use bits (the tensor stays on the full-request path).
  bool assign(const Request& q, const std::set<std::string>& in_use,
              ResponseList* out) {
    if (!enabled()) return false;
    std::string key = cache_key(q);
    bool have = false;
    uint32_t old = bit_for_name(q.name, &have);
    if (have && bits_[old].first != key) {
      drop(old, out);  // stale signature (shape/dtype change)
    } else if (have) {
      // Already bound (a rank with a flushed mirror re-sent the full
      // request): re-announce so the mirror heals.
      push_assign(old, out);
      return true;
    }
    while (bits_.size() >= capacity_) {
      uint32_t victim;
      if (!lru_victim(in_use, &victim)) return false;
      drop(victim, out);
    }
    uint32_t bit = next_bit_++;
    bits_[bit] = {key, q};
    bits_[bit].second.rank = 0;
    key_to_bit_[key] = bit;
    name_to_bit_[q.name] = bit;
    lru_.push_back(bit);
    lru_pos_[bit] = std::prev(lru_.end());
    push_assign(bit, out);
    return true;
  }

  void evict_name(const std::string& name, ResponseList* out) {
    bool have = false;
    uint32_t bit = bit_for_name(name, &have);
    if (have) drop(bit, out);
  }

 private:
  void push_assign(uint32_t bit, ResponseList* out) {
    CacheAssign a;
    a.bit = bit;
    a.req = bits_[bit].second;
    out->cache_assign.push_back(std::move(a));
  }

  void touch(uint32_t bit) {
    auto it = lru_pos_.find(bit);
    if (it == lru_pos_.end()) return;
    lru_.erase(it->second);
    lru_.push_back(bit);
    lru_pos_[bit] = std::prev(lru_.end());
  }

  bool lru_victim(const std::set<std::string>& in_use, uint32_t* victim) {
    for (uint32_t bit : lru_) {  // oldest first
      if (!in_use.count(bits_[bit].second.name)) {
        *victim = bit;
        return true;
      }
    }
    return false;
  }

  void drop(uint32_t bit, ResponseList* out) {
    auto it = bits_.find(bit);
    if (it == bits_.end()) return;
    key_to_bit_.erase(it->second.first);
    auto nb = name_to_bit_.find(it->second.second.name);
    if (nb != name_to_bit_.end() && nb->second == bit) name_to_bit_.erase(nb);
    auto lp = lru_pos_.find(bit);
    if (lp != lru_pos_.end()) {
      lru_.erase(lp->second);
      lru_pos_.erase(lp);
    }
    bits_.erase(it);
    out->cache_evict.push_back(bit);
  }

  size_t capacity_;
  uint32_t next_bit_ = 0;
  std::list<uint32_t> lru_;  // front = oldest
  std::unordered_map<uint32_t, std::list<uint32_t>::iterator> lru_pos_;
  // bit -> (key, request template)
  std::unordered_map<uint32_t, std::pair<std::string, Request>> bits_;
  std::unordered_map<std::string, uint32_t> key_to_bit_;
  std::unordered_map<std::string, uint32_t> name_to_bit_;
};

}  // namespace hvd

#endif  // HVD_CACHE_H
