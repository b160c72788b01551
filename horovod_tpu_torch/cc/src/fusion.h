// Tensor-fusion planner for the eager engine.
//
// Native equivalent of the reference coordinator's greedy fusion loop
// (operations.cc:2154-2266: merge ALLREDUCE responses of matching dtype up to
// the fusion threshold, with look-ahead over skipped entries) plus the fusion
// buffer itself (fusion_buffer_manager.{cc,h}: one cached buffer reused
// across cycles). The compiled JAX path has its own trace-time planner
// (horovod_tpu/parallel/fusion.py); this one serves the host data plane: the
// coordinator plans buckets over the ready list each tick, and every rank
// executes each bucket as one memcpy-in / one ring pass / one memcpy-out
// (Engine::execute_allreduce).
#ifndef HVD_FUSION_H
#define HVD_FUSION_H

#include <cstdint>
#include <map>
#include <vector>

#include "hvd_common.h"

namespace hvd {

struct FusionItem {
  size_t index;     // position in the ready list
  DataType dtype;
  uint8_t average;  // sum and average ops cannot share a bucket
  size_t nbytes;
};

// Greedy bucketing with look-ahead: items are scanned in order; an item
// joins the open bucket of its (dtype, average) key if it fits under the
// threshold, else it opens a new bucket (a single oversize item gets its own
// bucket, like a tensor larger than the threshold going unfused in the
// reference).
inline std::vector<std::vector<FusionItem>> plan_fusion(
    const std::vector<FusionItem>& items, size_t threshold) {
  using Key = std::pair<DataType, uint8_t>;
  std::vector<std::vector<FusionItem>> buckets;
  std::map<Key, size_t> open;  // key -> bucket index
  std::map<Key, size_t> open_bytes;
  for (const auto& it : items) {
    Key key{it.dtype, it.average};
    auto f = open.find(key);
    if (f != open.end() && open_bytes[key] + it.nbytes <= threshold) {
      buckets[f->second].push_back(it);
      open_bytes[key] += it.nbytes;
    } else {
      open[key] = buckets.size();
      open_bytes[key] = it.nbytes;
      buckets.push_back({it});
    }
  }
  return buckets;
}

// Reusable fusion buffer (reference fusion_buffer_manager.h:41-47: one
// persistent buffer per device/framework, reallocated when the threshold
// grows). Host-side: one per engine.
class FusionBuffer {
 public:
  uint8_t* get(size_t nbytes) {
    if (buf_.size() < nbytes) buf_.resize(nbytes);
    return buf_.data();
  }
  size_t capacity() const { return buf_.size(); }

 private:
  std::vector<uint8_t> buf_;
};

}  // namespace hvd

#endif  // HVD_FUSION_H
