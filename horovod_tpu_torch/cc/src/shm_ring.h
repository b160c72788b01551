// Shared-memory data plane for same-host ring links.
//
// The reference moves intra-host traffic through shared memory wherever it
// can: NCCL's shm transport under the GPU ring, and an explicit MPI
// shared-memory window for hierarchical allgather
// (operations.cc:929-1034 MPI_Win_allocate_shared). The eager engine's
// same-host neighbours previously talked loopback TCP, which pays the whole
// kernel network stack (skb copies + TCP processing + a syscall per socket
// buffer) for bytes that never leave DRAM. This header replaces those links
// with a single-producer/single-consumer ring buffer in a POSIX shm
// segment: one memcpy in, one memcpy out, futex parking instead of poll().
//
// Design notes, tuned for the worst case (many ranks time-sharing one core):
// - NO spinning. A blocked side parks on a futex in the segment; the
//   producer publishes up to a whole buffer's worth of data per wake, so
//   the natural rhythm on a shared core is "fill 16 MiB, yield to peer" —
//   ~6 context switches per 100 MiB instead of one per socket buffer.
// - Wakes are skipped when nobody waits (waiter counters), so the hot path
//   of a large transfer is pure memcpy + two atomic stores.
// - Same-machine-ness is PROVEN, not assumed from topology metadata: the
//   acceptor must open the freshly created segment and find the 16-byte
//   nonce the connector sent over the authenticated TCP link. Two machines
//   that merely claim the same host fall back to TCP (each would see its
//   own /dev/shm). Tests that simulate multi-host on one box keep their TCP
//   "cross-host" links because the engine only proposes shm when the
//   coordinator-reported cross_rank matches.
// - The segment is unlinked as soon as both sides have mapped it, so a
//   crashed job leaks nothing in /dev/shm.

#ifndef HVD_SHM_RING_H
#define HVD_SHM_RING_H

#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>

namespace hvd {

inline long futex_call(std::atomic<uint32_t>* addr, int op, uint32_t val,
                       const timespec* timeout) {
  // Shared (non-PRIVATE) futex: the word lives in a MAP_SHARED segment.
  return ::syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), op, val,
                   timeout, nullptr, 0);
}

struct ShmRingHdr {
  uint8_t nonce[16];            // proof the TCP peer mapped THIS segment
  uint32_t capacity;            // data bytes (power of two)
  std::atomic<uint64_t> head;   // produced bytes (monotonic)
  std::atomic<uint64_t> tail;   // consumed bytes (monotonic)
  std::atomic<uint32_t> head_seq;       // futex word: bumped per publish
  std::atomic<uint32_t> tail_seq;       // futex word: bumped per consume
  std::atomic<uint32_t> cons_waiters;   // consumers parked on head_seq
  std::atomic<uint32_t> prod_waiters;   // producers parked on tail_seq
  std::atomic<uint32_t> peer_gone;      // either side sets on close
};

inline size_t shm_ring_bytes(uint32_t capacity) {
  return sizeof(ShmRingHdr) + capacity;
}

// Uncached (called once per link at establish time): the Python binding
// exports Config.shm_bytes into the env right before init, including on
// re-init, so a static cache would pin the first process-lifetime value.
inline uint32_t shm_ring_capacity() {
  const char* env = std::getenv("HOROVOD_SHM_BYTES");
  uint64_t v = env ? std::strtoull(env, nullptr, 10) : (16u << 20);
  if (v < (1u << 16)) v = 1u << 16;
  if (v > (1u << 30)) v = 1u << 30;
  uint32_t p = 1;  // round down to a power of two (mask arithmetic)
  while ((uint64_t)p * 2 <= v) p *= 2;
  return p;
}

inline bool shm_enabled() {
  // On unless explicitly disabled; same semantics as the Python boolean
  // knobs (common/config.py _env_bool): unset/empty = default (on), and
  // "0"/"false"/"no" in any case disable.
  const char* env = std::getenv("HOROVOD_SHM");
  if (!env || !*env) return true;
  std::string v(env);
  // unsigned char cast: std::tolower on a negative char (non-ASCII byte in
  // the env var) is UB.
  for (auto& c : v) c = (char)std::tolower((unsigned char)c);
  return !(v == "0" || v == "false" || v == "no");
}

// One direction of payload between two same-host ranks. The connector of
// the TCP link creates and produces; the acceptor opens and consumes.
class ShmLink {
 public:
  ShmLink() = default;
  ~ShmLink() { close(); }
  ShmLink(const ShmLink&) = delete;
  ShmLink& operator=(const ShmLink&) = delete;

  bool active() const { return hdr_ != nullptr; }

  // Producer side: create + map + unlink-after-peer-ack is handled by the
  // caller (needs the TCP channel); this maps a fresh segment.
  void create(const std::string& name, const uint8_t nonce[16]) {
    uint32_t cap = shm_ring_capacity();
    int fd = ::shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) throw std::runtime_error("shm_open(create) failed");
    if (::ftruncate(fd, (off_t)shm_ring_bytes(cap)) != 0) {
      ::close(fd);
      ::shm_unlink(name.c_str());
      throw std::runtime_error("ftruncate(shm) failed");
    }
    try {
      map_(fd, cap);
    } catch (...) {
      // No half-created segment may outlive this call: the caller only
      // unlinks names it successfully created (the 'leaks nothing' rule).
      ::close(fd);
      ::shm_unlink(name.c_str());
      throw;
    }
    ::close(fd);
    new (hdr_) ShmRingHdr();
    std::memcpy(hdr_->nonce, nonce, 16);
    hdr_->capacity = cap;
    name_ = name;
  }

  // Consumer side: open the named segment and verify the nonce matches what
  // arrived over the authenticated TCP link. Returns false (and stays
  // inactive) when the segment is unreachable or wrong — the TCP fallback.
  bool open(const std::string& name, const uint8_t nonce[16]) {
    int fd = ::shm_open(name.c_str(), O_RDWR, 0600);
    if (fd < 0) return false;
    struct stat st {};
    if (::fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(ShmRingHdr)) {
      ::close(fd);
      return false;
    }
    ShmRingHdr* probe = (ShmRingHdr*)::mmap(nullptr, sizeof(ShmRingHdr),
                                            PROT_READ, MAP_SHARED, fd, 0);
    if (probe == MAP_FAILED) {
      ::close(fd);
      return false;
    }
    uint32_t cap = probe->capacity;
    bool ok = std::memcmp(probe->nonce, nonce, 16) == 0 &&
              (size_t)st.st_size >= shm_ring_bytes(cap);
    ::munmap(probe, sizeof(ShmRingHdr));
    if (!ok) {
      ::close(fd);
      return false;
    }
    try {
      map_(fd, cap);
    } catch (...) {
      // Contract: any failure here means "stay on TCP", never an exception
      // (a throw would abort ring establishment instead of falling back).
      ::close(fd);
      return false;
    }
    ::close(fd);
    return true;
  }

  // Move up to `n` bytes into the ring; returns bytes written (0 = full).
  size_t try_produce(const uint8_t* p, size_t n) {
    uint64_t head = hdr_->head.load(std::memory_order_relaxed);
    uint64_t tail = hdr_->tail.load(std::memory_order_acquire);
    size_t free = cap_ - (size_t)(head - tail);
    size_t take = n < free ? n : free;
    if (take == 0) return 0;
    size_t at = (size_t)(head & (cap_ - 1));
    size_t first = std::min(take, cap_ - at);
    std::memcpy(data_ + at, p, first);
    if (take > first) std::memcpy(data_, p + first, take - first);
    hdr_->head.store(head + take, std::memory_order_release);
    // seq_cst on the seq bump and the waiters load: with weaker orders the
    // waiters load could be hoisted above the seq store's visibility and a
    // consumer that just registered would miss its wake (100 ms stall per
    // occurrence on weakly-ordered CPUs; x86's LOCK prefix masks it).
    hdr_->head_seq.fetch_add(1, std::memory_order_seq_cst);
    if (hdr_->cons_waiters.load(std::memory_order_seq_cst) > 0)
      futex_call(&hdr_->head_seq, FUTEX_WAKE, 1, nullptr);
    return take;
  }

  // Like try_consume, but hands the ring memory to `fn(src, len)` instead
  // of memcpy-ing it out — the zero-copy reduce path applies
  // the add DIRECTLY from the shared segment into the accumulator chunk,
  // skipping the scratch bounce entirely (one full read+write of the
  // payload per ring pass). `fn` may be called twice (wrap point) and
  // must consume every byte it is given.
  template <typename Fn>
  size_t try_consume_apply(size_t n, Fn&& fn) {
    uint64_t tail = hdr_->tail.load(std::memory_order_relaxed);
    uint64_t head = hdr_->head.load(std::memory_order_acquire);
    size_t avail = (size_t)(head - tail);
    size_t take = n < avail ? n : avail;
    if (take == 0) return 0;
    size_t at = (size_t)(tail & (cap_ - 1));
    size_t first = std::min(take, cap_ - at);
    fn(data_ + at, first);
    if (take > first) fn(data_, take - first);
    hdr_->tail.store(tail + take, std::memory_order_release);
    hdr_->tail_seq.fetch_add(1, std::memory_order_seq_cst);  // see try_produce
    if (hdr_->prod_waiters.load(std::memory_order_seq_cst) > 0)
      futex_call(&hdr_->tail_seq, FUTEX_WAKE, 1, nullptr);
    return take;
  }

  // Move up to `n` bytes out of the ring; returns bytes read (0 = empty).
  size_t try_consume(uint8_t* p, size_t n) {
    uint64_t tail = hdr_->tail.load(std::memory_order_relaxed);
    uint64_t head = hdr_->head.load(std::memory_order_acquire);
    size_t avail = (size_t)(head - tail);
    size_t take = n < avail ? n : avail;
    if (take == 0) return 0;
    size_t at = (size_t)(tail & (cap_ - 1));
    size_t first = std::min(take, cap_ - at);
    std::memcpy(p, data_ + at, first);
    if (take > first) std::memcpy(p + first, data_, take - first);
    hdr_->tail.store(tail + take, std::memory_order_release);
    hdr_->tail_seq.fetch_add(1, std::memory_order_seq_cst);  // see try_produce
    if (hdr_->prod_waiters.load(std::memory_order_seq_cst) > 0)
      futex_call(&hdr_->tail_seq, FUTEX_WAKE, 1, nullptr);
    return take;
  }

  // Park until the peer makes progress on `seq` (which the caller sampled
  // BEFORE its last failed try_*), or ~100 ms passes. The re-check between
  // waiter registration and the futex syscall closes the lost-wake race.
  enum class Side { producer, consumer };
  void wait(Side side, uint32_t observed_seq) {
    std::atomic<uint32_t>& seq =
        side == Side::producer ? hdr_->tail_seq : hdr_->head_seq;
    std::atomic<uint32_t>& waiters =
        side == Side::producer ? hdr_->prod_waiters : hdr_->cons_waiters;
    waiters.fetch_add(1, std::memory_order_seq_cst);
    if (seq.load(std::memory_order_seq_cst) == observed_seq &&
        !hdr_->peer_gone.load(std::memory_order_acquire)) {
      timespec ts{0, 100 * 1000 * 1000};
      futex_call(&seq, FUTEX_WAIT, observed_seq, &ts);
    }
    waiters.fetch_sub(1, std::memory_order_acq_rel);
  }

  uint32_t seq(Side side) const {
    return (side == Side::producer ? hdr_->tail_seq : hdr_->head_seq)
        .load(std::memory_order_acquire);
  }

  // Park when BOTH directions of a mixed transfer are blocked at once (out
  // ring full AND in ring empty — distinct segments, so two futex words).
  // Registers as a waiter on both words: each peer then issues its wake, and
  // the pre-sleep re-check of BOTH seqs catches any progress made between
  // the failed try_* and the park. FUTEX_WAIT is single-address, so the
  // sleep itself parks on the consumer word with a 5 ms cap (matching the
  // mixed shm+TCP poll cap in ring.h) — a producer-side wake that lands
  // while parked costs at most the cap, not the 100 ms single-side timeout.
  static void wait_both(ShmLink& cons, uint32_t cons_seq,
                        ShmLink& prod, uint32_t prod_seq) {
    cons.hdr_->cons_waiters.fetch_add(1, std::memory_order_seq_cst);
    prod.hdr_->prod_waiters.fetch_add(1, std::memory_order_seq_cst);
    if (cons.hdr_->head_seq.load(std::memory_order_seq_cst) == cons_seq &&
        prod.hdr_->tail_seq.load(std::memory_order_seq_cst) == prod_seq &&
        !cons.hdr_->peer_gone.load(std::memory_order_acquire) &&
        !prod.hdr_->peer_gone.load(std::memory_order_acquire)) {
      timespec ts{0, 5 * 1000 * 1000};
      futex_call(&cons.hdr_->head_seq, FUTEX_WAIT, cons_seq, &ts);
    }
    prod.hdr_->prod_waiters.fetch_sub(1, std::memory_order_acq_rel);
    cons.hdr_->cons_waiters.fetch_sub(1, std::memory_order_acq_rel);
  }

  bool peer_gone() const {
    return hdr_ && hdr_->peer_gone.load(std::memory_order_acquire) != 0;
  }

  void unlink() {
    if (!name_.empty()) {
      ::shm_unlink(name_.c_str());
      name_.clear();
    }
  }

  void close() {
    if (hdr_) {
      hdr_->peer_gone.store(1, std::memory_order_release);
      // Wake both directions so a parked peer sees peer_gone promptly.
      futex_call(&hdr_->head_seq, FUTEX_WAKE, INT32_MAX, nullptr);
      futex_call(&hdr_->tail_seq, FUTEX_WAKE, INT32_MAX, nullptr);
      ::munmap(hdr_, shm_ring_bytes(cap_));
      hdr_ = nullptr;
    }
    unlink();
  }

 private:
  void map_(int fd, uint32_t cap) {
    void* m = ::mmap(nullptr, shm_ring_bytes(cap), PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    if (m == MAP_FAILED) throw std::runtime_error("mmap(shm ring) failed");
    hdr_ = (ShmRingHdr*)m;
    data_ = (uint8_t*)m + sizeof(ShmRingHdr);
    cap_ = cap;
  }

  ShmRingHdr* hdr_ = nullptr;
  uint8_t* data_ = nullptr;
  size_t cap_ = 0;
  std::string name_;  // non-empty only on the creator until unlink
};

}  // namespace hvd

#endif  // HVD_SHM_RING_H
