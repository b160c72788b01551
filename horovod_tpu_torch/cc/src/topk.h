// Top-k sparse wire format for the native eager engine (the native plane
// ships sparse frames for topk, not dense ones).
//
// This is the C++ mirror of horovod_tpu/compression.py's numpy-first topk
// helpers, BITWISE: selection is deterministic (magnitude descending, ties
// to the lower index, exact zeros never selected), values travel as exact
// float32 whichever frame kind carries them, and the index merge performs
// the same incoming-first f32 adds as the dense fold — which is what pins
// the native sparse ring to the Python `_ring_order_reduce(wire="topk")`
// oracle. Frame layout (little-endian, self-describing):
//
//   kind 0 (sparse): u8 0 | u32 k | i32 idx[k] (ascending) | f32 val[k]
//   kind 1 (dense):  u8 1 | f32 val[n]
//
// A state is either sparse (ascending unique indices + values) or dense;
// densify-on-overflow past n/2 entries keeps a hop's frame no bigger than
// the dense chunk it replaces.
#ifndef HVD_TOPK_H
#define HVD_TOPK_H

#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <stdexcept>
#include <string>
#include <vector>

namespace hvd {

struct TopkState {
  bool dense = false;
  std::vector<int32_t> idx;  // sparse: ascending, unique
  std::vector<float> val;    // sparse values
  std::vector<float> dvals;  // dense values (dense == true)

  size_t nnz_or_n() const { return dense ? dvals.size() : idx.size(); }
};

// Entries to keep for an n-element tensor (compression.py topk_k):
// round-half-to-even like Python's round(), floor 1, cap n.
inline size_t topk_k(size_t n, double ratio) {
  double r = std::nearbyint((double)n * ratio);  // FE_TONEAREST = half-even
  long long k = (long long)r;
  if (k < 1) k = 1;
  if (k > (long long)n) k = (long long)n;
  return (size_t)k;
}

// compression.py topk_eligible: float32 only (checked by the caller via
// DataType), at least min_bytes dense bytes, and a k small enough that
// the sparse frame beats the dense one.
inline bool topk_eligible(size_t nbytes, double ratio, int64_t min_bytes) {
  if ((int64_t)nbytes < (min_bytes > 1 ? min_bytes : 1)) return false;
  size_t n = nbytes / 4;
  return topk_k(n, ratio) * 8 + 8 < n * 4;
}

// Deterministic top-k selection (compression.py topk_select): nonzero
// entries only, magnitude descending, ties to the lower index (numpy's
// lexsort((idx, -|v|)); NaN magnitudes order last, like numpy's ascending
// sort of NaN keys), indices returned ascending.
inline void topk_select(const float* flat, size_t n, size_t k,
                        std::vector<int32_t>& idx, std::vector<float>& val) {
  idx.clear();
  val.clear();
  std::vector<int32_t> nz;
  nz.reserve(std::min(n, k * 4));
  for (size_t i = 0; i < n; i++) {
    if (flat[i] != 0.0f) nz.push_back((int32_t)i);  // NaN != 0: included
  }
  if (nz.size() > k) {
    auto key = [&](int32_t i) {
      float a = -std::fabs(flat[(size_t)i]);
      return std::isnan(a) ? std::numeric_limits<float>::infinity() : a;
    };
    std::sort(nz.begin(), nz.end(), [&](int32_t a, int32_t b) {
      float ka = key(a), kb = key(b);
      if (ka != kb) return ka < kb;
      return a < b;
    });
    nz.resize(k);
    std::sort(nz.begin(), nz.end());
  }
  idx = std::move(nz);
  val.reserve(idx.size());
  for (int32_t i : idx) val.push_back(flat[(size_t)i]);
}

// Dense f32 vector of a sparse pair (zeros elsewhere).
inline void topk_densify(const std::vector<int32_t>& idx,
                         const std::vector<float>& val, size_t n,
                         std::vector<float>& out) {
  out.assign(n, 0.0f);
  for (size_t j = 0; j < idx.size(); j++) out[(size_t)idx[j]] = val[j];
}

// (idx, val) of a dense chunk's nonzero entries, ascending.
inline TopkState topk_sparsify(const float* dense, size_t n) {
  TopkState st;
  for (size_t i = 0; i < n; i++) {
    if (dense[i] != 0.0f) {
      st.idx.push_back((int32_t)i);
      st.val.push_back(dense[i]);
    }
  }
  return st;
}

inline void topk_to_dense(TopkState& st, size_t n) {
  if (st.dense) return;
  std::vector<float> d;
  topk_densify(st.idx, st.val, n, d);
  st.dense = true;
  st.dvals = std::move(d);
  st.idx.clear();
  st.val.clear();
}

// Fold one more sparse contribution into an accumulator state — the
// incoming-first add order of compression.py topk_state_add/topk_merge,
// with densify-on-overflow past max(n/2, 1) union entries.
inline void topk_state_add(TopkState& acc, const std::vector<int32_t>& idx,
                           const std::vector<float>& val, size_t n) {
  if (acc.dense) {
    for (size_t j = 0; j < idx.size(); j++)
      acc.dvals[(size_t)idx[j]] += val[j];
    return;
  }
  size_t max_nnz = n / 2 > 1 ? n / 2 : 1;
  std::vector<int32_t> mi;
  std::vector<float> mv;
  mi.reserve(acc.idx.size() + idx.size());
  mv.reserve(acc.idx.size() + idx.size());
  size_t a = 0, b = 0;
  while (a < acc.idx.size() || b < idx.size()) {
    if (b >= idx.size()
        || (a < acc.idx.size() && acc.idx[a] < idx[b])) {
      mi.push_back(acc.idx[a]);
      mv.push_back(acc.val[a]);
      a++;
    } else if (a >= acc.idx.size() || idx[b] < acc.idx[a]) {
      mi.push_back(idx[b]);
      mv.push_back(val[b]);
      b++;
    } else {  // overlap: incoming state (acc) adds first
      mi.push_back(acc.idx[a]);
      mv.push_back(acc.val[a] + val[b]);
      a++;
      b++;
    }
  }
  acc.idx = std::move(mi);
  acc.val = std::move(mv);
  if (acc.idx.size() > max_nnz) topk_to_dense(acc, n);
}

// Sub-chunk [lo, hi) of a state, indices re-based (topk_state_slice).
inline TopkState topk_state_slice(const TopkState& st, size_t lo, size_t hi) {
  TopkState out;
  if (st.dense) {
    out.dense = true;
    out.dvals.assign(st.dvals.begin() + (ptrdiff_t)lo,
                     st.dvals.begin() + (ptrdiff_t)hi);
    return out;
  }
  auto first = std::lower_bound(st.idx.begin(), st.idx.end(), (int32_t)lo);
  auto last = std::lower_bound(st.idx.begin(), st.idx.end(), (int32_t)hi);
  for (auto it = first; it != last; ++it) {
    out.idx.push_back(*it - (int32_t)lo);
    out.val.push_back(st.val[(size_t)(it - st.idx.begin())]);
  }
  return out;
}

// Divide every carried value by world (the AVERAGE finish), f32 like the
// dense oracle — zeros stay +0.0 implicitly.
inline void topk_state_scale(TopkState& st, int world) {
  if (st.dense) {
    for (float& v : st.dvals) v = v / (float)world;
  } else {
    for (float& v : st.val) v = v / (float)world;
  }
}

// Dense f32 view of a state into out[0..n).
inline void topk_state_dense(const TopkState& st, size_t n, float* out) {
  if (st.dense) {
    std::memcpy(out, st.dvals.data(), n * 4);
  } else {
    std::memset(out, 0, n * 4);
    for (size_t j = 0; j < st.idx.size(); j++)
      out[(size_t)st.idx[j]] = st.val[j];
  }
}

// Wire frame of a state (compression.py topk_encode): sparse when the
// caller prefers it AND it is smaller than dense, else dense. A dense
// state re-sparsifies when the tier prefers sparse (value-neutral).
inline std::vector<uint8_t> topk_encode(const TopkState& st, size_t n,
                                        bool prefer_sparse) {
  if (prefer_sparse) {
    const TopkState* sp = &st;
    TopkState tmp;
    if (st.dense) {
      tmp = topk_sparsify(st.dvals.data(), n);
      sp = &tmp;
    }
    if (sp->idx.size() * 8 + 5 < n * 4 + 1) {
      std::vector<uint8_t> f(5 + 8 * sp->idx.size());
      f[0] = 0;
      uint32_t k = (uint32_t)sp->idx.size();
      std::memcpy(f.data() + 1, &k, 4);
      std::memcpy(f.data() + 5, sp->idx.data(), 4 * k);
      std::memcpy(f.data() + 5 + 4 * (size_t)k, sp->val.data(), 4 * k);
      return f;
    }
  }
  std::vector<uint8_t> f(1 + 4 * n);
  f[0] = 1;
  if (st.dense) {
    std::memcpy(f.data() + 1, st.dvals.data(), 4 * n);
  } else {
    std::vector<float> d;
    topk_densify(st.idx, st.val, n, d);
    std::memcpy(f.data() + 1, d.data(), 4 * n);
  }
  return f;
}

// Upper bound of any legal frame for an n-element chunk (allocation cap
// for the length-prefixed hop exchange).
inline size_t topk_frame_cap(size_t n) { return 5 + 8 * n; }

// Parse + validate a frame (compression.py topk_unpack): every length is
// checked before any scatter trusts it; indices must be ascending, unique
// and in range. A violation here is a protocol bug — throw, the engine
// latches the data plane error.
inline TopkState topk_unpack(const uint8_t* buf, size_t len, size_t n) {
  if (len < 1) throw std::runtime_error("empty topk frame");
  TopkState st;
  if (buf[0] == 1) {
    if (len != 1 + 4 * n)
      throw std::runtime_error("dense topk frame carries " +
                               std::to_string(len - 1) + " bytes, expected " +
                               std::to_string(4 * n));
    st.dense = true;
    st.dvals.resize(n);
    std::memcpy(st.dvals.data(), buf + 1, 4 * n);
    return st;
  }
  if (buf[0] != 0)
    throw std::runtime_error("unknown topk frame kind " +
                             std::to_string((int)buf[0]));
  if (len < 5) throw std::runtime_error("truncated topk frame header");
  uint32_t k;
  std::memcpy(&k, buf + 1, 4);
  if ((size_t)k > n || len != 5 + 8 * (size_t)k)
    throw std::runtime_error("sparse topk frame k=" + std::to_string(k) +
                             " size=" + std::to_string(len) +
                             " inconsistent with n=" + std::to_string(n));
  st.idx.resize(k);
  st.val.resize(k);
  std::memcpy(st.idx.data(), buf + 5, 4 * (size_t)k);
  std::memcpy(st.val.data(), buf + 5 + 4 * (size_t)k, 4 * (size_t)k);
  int32_t prev = -1;
  for (int32_t i : st.idx) {
    if (i <= prev || i < 0 || (size_t)i >= n)
      throw std::runtime_error("sparse topk frame indices invalid");
    prev = i;
  }
  return st;
}

}  // namespace hvd

#endif  // HVD_TOPK_H
