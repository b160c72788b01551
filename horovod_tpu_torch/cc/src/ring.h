// Peer-to-peer ring data plane for the eager engine.
//
// The bandwidth-optimal topology the reference uses, not a rank-0 star
// relay: every rank talks only to its ring
// neighbours, so per-rank traffic for an allreduce is O(2·bytes·(N-1)/N)
// regardless of world size — the same property as the NCCL ring allreduce
// the reference runs on GPUs (operations.cc:1221-1446) and the
// MPI_Allreduce it runs on CPUs (operations.cc:1491-1586).
//
// Topology: rank r owns two TCP links — it connects to rank (r+1)%N
// ("next") and accepts one authenticated connection from rank (r-1+N)%N
// ("prev"). All collectives are sequences of (send-to-next ‖
// recv-from-prev) steps executed in the coordinator-broadcast order, which
// is identical on every rank, so no message tags are needed and chunk sizes
// are deterministic on both sides of every transfer (hence no per-chunk
// framing: a desync is a build/protocol bug, not a runtime condition).
//
// Algorithms:
//   allreduce      = ring reduce-scatter + ring allgather (2(N-1) steps)
//   reducescatter  = ring reduce-scatter over row-aligned chunks
//   allgather      = ring allgather over per-rank slots (N-1 steps)
//   broadcast      = chunked store-and-forward pipeline from the root
//   alltoall       = shrinking-parcel rotation (chunk for the receiver is
//                    peeled off the front, the remainder is forwarded)
#ifndef HVD_RING_H
#define HVD_RING_H

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include "hvd_common.h"
#include "net.h"
#include "shm_ring.h"
#include "topk.h"

namespace hvd {

struct RingStats {
  std::atomic<uint64_t> passes{0};      // ring collectives executed
  std::atomic<uint64_t> bytes_sent{0};  // bytes pushed to the next neighbour
};

// Separate accounting of bytes whose next-hop crosses a host boundary.
// The hierarchical-collective tests (and the scaling harness) need to prove
// the two-level ring actually shrinks inter-host traffic, so every link
// knows at establish time whether its outgoing neighbour lives on another
// host and bills sends to this secondary counter too (reference analog: the
// NCCL-intra/MPI-inter split of hierarchical allreduce makes the same
// distinction structurally, operations.cc:1284-1446).

// numpy array_split semantics: the first n % parts chunks get one extra.
inline std::vector<size_t> split_counts(size_t n, int parts) {
  std::vector<size_t> out((size_t)parts, n / (size_t)parts);
  for (size_t i = 0; i < n % (size_t)parts; i++) out[i]++;
  return out;
}

inline std::vector<size_t> offsets_of(const std::vector<size_t>& counts) {
  std::vector<size_t> off(counts.size() + 1, 0);
  for (size_t i = 0; i < counts.size(); i++) off[i + 1] = off[i] + counts[i];
  return off;
}

// The two neighbour links. Establishment is bootstrap-ordered by the
// coordinator: every rank learns the full (host, port) map in its hello
// response, then connects to next while accepting from prev.
class RingLinks {
 public:
  RingLinks() = default;
  ~RingLinks() { close(); }

  // Open the listener before registering with the coordinator, so the
  // advertised port is live by the time any peer sees it.
  void open_listener() {
    listen_fd_ = listen_on("", 0, 4);
    port_ = bound_port(listen_fd_);
  }
  int port() const { return port_; }

  // Connect to next and accept prev (world > 1). Peer addresses come from
  // the coordinator's hello response. Throws on timeout or auth failure.
  // `purpose` namespaces the HMAC handshake per ring (flat/local/cross), so
  // a connection that reaches the wrong ring's listener fails auth instead
  // of wiring in a neighbour with mismatched transfer sizes.
  //
  // `try_shm_next` / `try_shm_prev`: offer to upgrade that link to the
  // shared-memory data plane (shm_ring.h). The engine sets these only when
  // the coordinator-reported topology says the neighbour shares this host;
  // the nonce handshake inside the negotiation then PROVES it (two machines
  // with cosplaying cross_ranks fall back to TCP), and HOROVOD_SHM=0
  // disables the whole path.
  void establish(int rank, int world,
                 const std::vector<std::pair<std::string, int>>& peers,
                 const std::string& secret, double timeout_s = 60.0,
                 const std::string& purpose = "hvd-ring",
                 bool try_shm_next = false, bool try_shm_prev = false) {
    if (world <= 1) return;
    int next = (rank + 1) % world;
    int prev = (rank - 1 + world) % world;
    std::string conn_error;
    std::thread connector([&] {
      int fd = -1;
      try {
        fd = connect_to(peers[(size_t)next].first, peers[(size_t)next].second,
                        timeout_s);
        auth_connect(fd, secret, purpose);
        int32_t my_rank = rank;
        send_all(fd, &my_rank, 4);
        // --- shm upgrade negotiation (this side produces) ---
        uint8_t propose = (try_shm_next && shm_enabled()) ? 1 : 0;
        send_all(fd, &propose, 1);
        if (propose) {
          auto nonce = fresh_nonce();
          std::string name = "/hvd-" + std::to_string(::getpid());
          for (uint8_t b : fresh_nonce()) {
            char hex[3];
            std::snprintf(hex, sizeof(hex), "%02x", b);
            name += hex;
          }
          name = name.substr(0, 32);
          bool created = false;
          try {
            shm_next_.create(name, nonce.data());
            created = true;
          } catch (const std::exception&) {
            // /dev/shm unavailable: withdraw the offer with an empty name.
            name.clear();
          }
          uint8_t len = (uint8_t)name.size();
          send_all(fd, &len, 1);
          if (len) send_all(fd, name.data(), len);
          send_all(fd, nonce.data(), 16);
          uint8_t ack = 0;
          recv_all(fd, &ack, 1);
          if (created) shm_next_.unlink();  // mapped by both (or dead): no leak
          if (!(created && ack == 1)) shm_next_.close();
        }
        next_fd_ = fd;
      } catch (const std::exception& ex) {
        conn_error = ex.what();
        // The failure path may leave the socket open and a half-negotiated
        // shm segment mapped AND still linked in /dev/shm (create succeeded,
        // then send/recv of name/nonce/ack threw before the unlink). Tear
        // both down here — close() unmaps and unlinks, and is a no-op on an
        // inactive link — so nothing outlives the error.
        if (fd >= 0) ::close(fd);
        shm_next_.close();
      }
    });
    try {
      // Accept until the authenticated prev neighbour shows up; reject
      // strangers (wrong MAC or wrong claimed rank).
      auto deadline = std::chrono::steady_clock::now() +
                      std::chrono::duration<double>(timeout_s);
      while (prev_fd_ < 0) {
        if (std::chrono::steady_clock::now() > deadline)
          throw std::runtime_error("timed out waiting for ring neighbour " +
                                   std::to_string(prev));
        pollfd p{listen_fd_, POLLIN, 0};
        int rc = ::poll(&p, 1, 200);
        if (rc <= 0) continue;
        int fd = ::accept(listen_fd_, nullptr, nullptr);
        if (fd < 0) continue;
        // Bound the handshake: a connection that sends nothing (scanner,
        // probe, hostile peer) must not wedge init past the deadline.
        timeval tv{10, 0};
        ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
        if (!auth_accept(fd, secret, purpose)) {
          ::close(fd);
          continue;
        }
        int32_t claimed = -1;
        try {
          recv_all(fd, &claimed, 4);
        } catch (const std::exception&) {
          ::close(fd);
          continue;
        }
        if (claimed != prev) {
          ::close(fd);
          continue;
        }
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        // --- shm upgrade negotiation (this side consumes) ---
        try {
          uint8_t propose = 0;
          recv_all(fd, &propose, 1);
          if (propose) {
            uint8_t len = 0;
            recv_all(fd, &len, 1);
            std::string name((size_t)len, '\0');
            if (len) recv_all(fd, &name[0], len);
            uint8_t nonce[16];
            recv_all(fd, nonce, 16);
            uint8_t ack = 0;
            if (len && try_shm_prev && shm_enabled() &&
                shm_prev_.open(name, nonce))
              ack = 1;
            send_all(fd, &ack, 1);
          }
        } catch (const std::exception&) {
          shm_prev_.close();
          ::close(fd);
          continue;
        }
        // Handshake done: drop the short deadline; ring transfers use
        // poll-based timeouts of their own (duplex).
        timeval none{0, 0};
        ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &none, sizeof(none));
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &none, sizeof(none));
        prev_fd_ = fd;
      }
    } catch (...) {
      connector.join();
      throw;
    }
    connector.join();
    if (next_fd_ < 0)
      throw std::runtime_error("ring connect to rank " + std::to_string(next) +
                               " failed: " + conn_error);
  }

  void close() {
    shm_next_.close();
    shm_prev_.close();
    for (int* fd : {&prev_fd_, &next_fd_, &listen_fd_}) {
      if (*fd >= 0) {
        ::close(*fd);
        *fd = -1;
      }
    }
  }

  bool active() const { return next_fd_ >= 0 && prev_fd_ >= 0; }
  bool shm_next_active() const { return shm_next_.active(); }
  bool shm_prev_active() const { return shm_prev_.active(); }

  // Bill sends on this link to `s` as inter-host traffic (set when the
  // outgoing neighbour has a different cross_rank, or for every link of the
  // cross-host ring).
  void set_cross_stats(RingStats* s) { cross_stats_ = s; }

  void transfer(const uint8_t* out, size_t n, uint8_t* in, size_t m,
                RingStats* stats) {
    if (!shm_next_.active() && !shm_prev_.active()) {
      duplex(next_fd_, out, n, prev_fd_, in, m);
    } else {
      mixed_duplex(out, n, in, m);
    }
    if (stats) stats->bytes_sent += n;
    if (cross_stats_) cross_stats_->bytes_sent += n;
  }
  void send(const uint8_t* p, size_t n, RingStats* stats) {
    if (shm_next_.active()) {
      mixed_duplex(p, n, nullptr, 0);
    } else {
      send_all(next_fd_, p, n);
    }
    if (stats) stats->bytes_sent += n;
    if (cross_stats_) cross_stats_->bytes_sent += n;
  }
  void recv(uint8_t* p, size_t n) {
    if (shm_prev_.active()) {
      mixed_duplex(nullptr, 0, p, n);
    } else {
      recv_all(prev_fd_, p, n);
    }
  }

  // Duplex step whose RECEIVE side streams through a sink instead of a
  // buffer (zero-copy reduce): `feed(src, len)` is called with
  // in-order byte runs totalling exactly `m`. Over an shm-upgraded link
  // the runs point INTO the shared segment — the reduce-scatter's add
  // runs straight from ring memory to the accumulator chunk, skipping
  // the scratch bounce (a full read+write of the payload per pass); over
  // TCP the runs come from a small cache-hot staging block, which also
  // beats the old chunk-sized scratch on locality.
  template <typename Feed>
  void transfer_apply(const uint8_t* out, size_t n, size_t m, Feed&& feed,
                      RingStats* stats) {
    size_t sent = 0, got = 0;
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::seconds(300);
    uint8_t staging[64 << 10];  // TCP receive runs (L1/L2-resident)
    while (sent < n || got < m) {
      bool prog = false;
      uint32_t prod_seq = 0, cons_seq = 0;
      if (sent < n) {
        if (shm_next_.active()) {
          prod_seq = shm_next_.seq(ShmLink::Side::producer);
          size_t w = shm_next_.try_produce(out + sent, n - sent);
          if (w) { sent += w; prog = true; }
          if (shm_next_.peer_gone())
            throw std::runtime_error("shm ring peer closed");
        } else {
          ssize_t w = ::send(next_fd_, out + sent, n - sent,
                             MSG_NOSIGNAL | MSG_DONTWAIT);
          if (w > 0) { sent += (size_t)w; prog = true; }
          else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                   errno != EINTR)
            throw std::runtime_error("ring send failed");
        }
      }
      if (got < m) {
        if (shm_prev_.active()) {
          cons_seq = shm_prev_.seq(ShmLink::Side::consumer);
          size_t r = shm_prev_.try_consume_apply(m - got, feed);
          if (r) { got += r; prog = true; }
          if (!r && shm_prev_.peer_gone())
            throw std::runtime_error("shm ring peer closed");
        } else {
          size_t want = std::min(m - got, sizeof(staging));
          ssize_t r = ::recv(prev_fd_, staging, want, MSG_DONTWAIT);
          if (r == 0) throw std::runtime_error("ring peer closed");
          if (r > 0) { feed(staging, (size_t)r); got += (size_t)r; prog = true; }
          else if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
            throw std::runtime_error("ring recv failed");
        }
      }
      if (prog) {
        deadline = std::chrono::steady_clock::now() +
                   std::chrono::seconds(300);
        continue;
      }
      if (std::chrono::steady_clock::now() > deadline)
        throw std::runtime_error("ring transfer timed out (300s idle)");
      // Parking: identical structure to mixed_duplex (see there for the
      // rationale of every branch).
      bool tcp_send = sent < n && !shm_next_.active();
      bool tcp_recv = got < m && !shm_prev_.active();
      if (tcp_send || tcp_recv) {
        pollfd fds[2];
        int nfds = 0;
        if (tcp_send) fds[nfds++] = {next_fd_, POLLOUT, 0};
        if (tcp_recv) fds[nfds++] = {prev_fd_, POLLIN, 0};
        bool shm_pending = (sent < n && shm_next_.active()) ||
                           (got < m && shm_prev_.active());
        if (::poll(fds, (nfds_t)nfds, shm_pending ? 5 : 300) < 0 &&
            errno != EINTR)
          throw std::runtime_error("poll failed in ring transfer");
      } else if (got < m && shm_prev_.active() &&
                 sent < n && shm_next_.active()) {
        ShmLink::wait_both(shm_prev_, cons_seq, shm_next_, prod_seq);
      } else if (got < m && shm_prev_.active()) {
        shm_prev_.wait(ShmLink::Side::consumer, cons_seq);
      } else if (sent < n && shm_next_.active()) {
        shm_next_.wait(ShmLink::Side::producer, prod_seq);
      }
      pollfd probe[2];
      int np = 0;
      if (shm_next_.active() && next_fd_ >= 0)
        probe[np++] = {next_fd_, 0, 0};
      if (shm_prev_.active() && prev_fd_ >= 0)
        probe[np++] = {prev_fd_, POLLIN, 0};
      if (np > 0 && ::poll(probe, (nfds_t)np, 0) > 0) {
        for (int i = 0; i < np; i++) {
          if (probe[i].revents & (POLLHUP | POLLERR | POLLIN))
            throw std::runtime_error(
                "ring peer died (socket closed during shm transfer)");
        }
      }
    }
    if (stats) stats->bytes_sent += n;
    if (cross_stats_) cross_stats_->bytes_sent += n;
  }

 private:
  // Bidirectional progress loop over any mix of shm and TCP links. Matches
  // duplex()'s contract (both neighbours push and pull concurrently, so
  // serialized blocking would deadlock past the buffering capacity), with
  // futex parking on the shm side and poll() on the TCP side — no spinning
  // in either transport, which matters when every rank shares one core.
  void mixed_duplex(const uint8_t* out, size_t n, uint8_t* in, size_t m) {
    size_t sent = 0, got = 0;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::seconds(300);
    while (sent < n || got < m) {
      bool prog = false;
      uint32_t prod_seq = 0, cons_seq = 0;
      if (sent < n) {
        if (shm_next_.active()) {
          prod_seq = shm_next_.seq(ShmLink::Side::producer);
          size_t w = shm_next_.try_produce(out + sent, n - sent);
          if (w) { sent += w; prog = true; }
          if (shm_next_.peer_gone())
            throw std::runtime_error("shm ring peer closed");
        } else {
          ssize_t w = ::send(next_fd_, out + sent, n - sent,
                             MSG_NOSIGNAL | MSG_DONTWAIT);
          if (w > 0) { sent += (size_t)w; prog = true; }
          else if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                   errno != EINTR)
            throw std::runtime_error("ring send failed");
        }
      }
      if (got < m) {
        if (shm_prev_.active()) {
          cons_seq = shm_prev_.seq(ShmLink::Side::consumer);
          size_t r = shm_prev_.try_consume(in + got, m - got);
          if (r) { got += r; prog = true; }
          if (!r && shm_prev_.peer_gone())
            throw std::runtime_error("shm ring peer closed");
        } else {
          ssize_t r = ::recv(prev_fd_, in + got, m - got, MSG_DONTWAIT);
          if (r == 0) throw std::runtime_error("ring peer closed");
          if (r > 0) { got += (size_t)r; prog = true; }
          else if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
            throw std::runtime_error("ring recv failed");
        }
      }
      if (prog) {
        // Idle timer, not a transfer budget: duplex()'s poll timeout only
        // fires after 300 s with NO progress, and a slow-but-moving link
        // must behave the same here.
        deadline = std::chrono::steady_clock::now() +
                   std::chrono::seconds(300);
        continue;
      }
      if (std::chrono::steady_clock::now() > deadline)
        throw std::runtime_error("ring transfer timed out (300s idle)");
      // Both directions blocked: park on whichever transport is pending.
      // TCP pending -> poll (also covers the mixed case: 5 ms cap keeps the
      // shm direction responsive); pure shm -> futex with 100 ms timeout.
      bool tcp_send = sent < n && !shm_next_.active();
      bool tcp_recv = got < m && !shm_prev_.active();
      if (tcp_send || tcp_recv) {
        pollfd fds[2];
        int nfds = 0;
        if (tcp_send) fds[nfds++] = {next_fd_, POLLOUT, 0};
        if (tcp_recv) fds[nfds++] = {prev_fd_, POLLIN, 0};
        bool shm_pending = (sent < n && shm_next_.active()) ||
                           (got < m && shm_prev_.active());
        if (::poll(fds, (nfds_t)nfds, shm_pending ? 5 : 300) < 0 &&
            errno != EINTR)
          throw std::runtime_error("poll failed in ring transfer");
      } else if (got < m && shm_prev_.active() &&
                 sent < n && shm_next_.active()) {
        // Both shm directions blocked: register on both seq words so the
        // peer's consume of the full out ring also wakes us (
        // a single-side wait slept through that wake for up to 100 ms).
        ShmLink::wait_both(shm_prev_, cons_seq, shm_next_, prod_seq);
      } else if (got < m && shm_prev_.active()) {
        shm_prev_.wait(ShmLink::Side::consumer, cons_seq);
      } else if (sent < n && shm_next_.active()) {
        shm_next_.wait(ShmLink::Side::producer, prod_seq);
      }
      // Liveness probe of TCP sockets idling under shm-upgraded links: a
      // SIGKILLed peer never sets peer_gone, but the kernel closes its fds
      // — without this, death mid-transfer surfaces only at the 300 s idle
      // deadline (plain-TCP links get ECONNRESET for free). The sockets
      // carry no payload after the upgrade, so POLLIN here is EOF or a
      // protocol violation; either way the peer is unusable.
      pollfd probe[2];
      int np = 0;
      if (shm_next_.active() && next_fd_ >= 0)
        probe[np++] = {next_fd_, 0, 0};  // events=0: HUP/ERR still reported
      if (shm_prev_.active() && prev_fd_ >= 0)
        probe[np++] = {prev_fd_, POLLIN, 0};
      if (np > 0 && ::poll(probe, (nfds_t)np, 0) > 0) {
        for (int i = 0; i < np; i++) {
          if (probe[i].revents & (POLLHUP | POLLERR | POLLIN))
            throw std::runtime_error(
                "ring peer died (socket closed during shm transfer)");
        }
      }
    }
  }

  int listen_fd_ = -1;
  int prev_fd_ = -1;
  int next_fd_ = -1;
  int port_ = 0;
  RingStats* cross_stats_ = nullptr;
  ShmLink shm_next_;
  ShmLink shm_prev_;
};

// ------------------------------------------------------------ typed arithmetic
// Ring reduction runs at the tensor's NATIVE width: f16/bf16 move 2 bytes
// per element on the wire and in DRAM, with each per-element add performed
// in f32 (the reference's custom MPI fp16 op does exactly this, half.h:135
// float16_sum: load halves -> float add -> store half). The accumulator is
// re-rounded to 16 bits each ring step, the same semantics as an MPI
// reduction tree at native width; the win is half the wire bytes on the
// host-DRAM-bound eager path.

template <typename T>
static void add_chunk_t(uint8_t* dst, const uint8_t* src, size_t count) {
  T* d = (T*)dst;
  const T* s = (const T*)src;
  for (size_t i = 0; i < count; i++) d[i] += s[i];
}

inline void add_chunk_f16(uint8_t* dst, const uint8_t* src, size_t count) {
  uint16_t* d = (uint16_t*)dst;
  const uint16_t* s = (const uint16_t*)src;
  for (size_t i = 0; i < count; i++)
    d[i] = float_to_half(half_to_float(d[i]) + half_to_float(s[i]));
}

inline void add_chunk_bf16(uint8_t* dst, const uint8_t* src, size_t count) {
  uint16_t* d = (uint16_t*)dst;
  const uint16_t* s = (const uint16_t*)src;
  for (size_t i = 0; i < count; i++)
    d[i] = float_to_bf16(bf16_to_float(d[i]) + bf16_to_float(s[i]));
}

// Three-operand fold: dst[i] = a[i] + s[i] — the out-of-place twin of
// add_chunk, used by the borrowed-input reduce-scatter (the
// caller's buffer is read-only; the fold writes the fresh output buffer).
// Identical operand order and per-element arithmetic as add_chunk, so the
// results are bitwise the same.
template <typename T>
static void add_into_t(uint8_t* dst, const uint8_t* a, const uint8_t* s,
                       size_t count) {
  T* d = (T*)dst;
  const T* x = (const T*)a;
  const T* y = (const T*)s;
  for (size_t i = 0; i < count; i++) d[i] = x[i] + y[i];
}

inline void add_chunk_into(DataType t, uint8_t* dst, const uint8_t* a,
                           const uint8_t* s, size_t count) {
  const uint16_t* xa = (const uint16_t*)a;
  const uint16_t* xs = (const uint16_t*)s;
  uint16_t* xd = (uint16_t*)dst;
  switch (t) {
    case DataType::F32: add_into_t<float>(dst, a, s, count); return;
    case DataType::F64: add_into_t<double>(dst, a, s, count); return;
    case DataType::F16:
      for (size_t i = 0; i < count; i++)
        xd[i] = float_to_half(half_to_float(xa[i]) + half_to_float(xs[i]));
      return;
    case DataType::BF16:
      for (size_t i = 0; i < count; i++)
        xd[i] = float_to_bf16(bf16_to_float(xa[i]) + bf16_to_float(xs[i]));
      return;
    case DataType::I32: add_into_t<int32_t>(dst, a, s, count); return;
    case DataType::I64: add_into_t<int64_t>(dst, a, s, count); return;
    case DataType::U8:
    case DataType::BOOL: add_into_t<uint8_t>(dst, a, s, count); return;
    case DataType::I8: add_into_t<int8_t>(dst, a, s, count); return;
    default:
      throw std::runtime_error("ring reduction on unsupported dtype");
  }
}

inline void add_chunk(DataType t, uint8_t* dst, const uint8_t* src,
                      size_t count) {
  switch (t) {
    case DataType::F32: add_chunk_t<float>(dst, src, count); return;
    case DataType::F64: add_chunk_t<double>(dst, src, count); return;
    case DataType::F16: add_chunk_f16(dst, src, count); return;
    case DataType::BF16: add_chunk_bf16(dst, src, count); return;
    case DataType::I32: add_chunk_t<int32_t>(dst, src, count); return;
    case DataType::I64: add_chunk_t<int64_t>(dst, src, count); return;
    case DataType::U8:
    case DataType::BOOL: add_chunk_t<uint8_t>(dst, src, count); return;
    case DataType::I8: add_chunk_t<int8_t>(dst, src, count); return;
    default:
      throw std::runtime_error("ring reduction on unsupported dtype");
  }
}

template <typename T>
static void scale_chunk_t(uint8_t* p, size_t count, int world) {
  T* d = (T*)p;
  for (size_t i = 0; i < count; i++) d[i] = (T)(d[i] / (T)world);
}

inline void scale_chunk(DataType t, uint8_t* p, size_t count, int world) {
  uint16_t* u16 = (uint16_t*)p;
  switch (t) {
    case DataType::F32: scale_chunk_t<float>(p, count, world); return;
    case DataType::F64: scale_chunk_t<double>(p, count, world); return;
    case DataType::F16:
      for (size_t i = 0; i < count; i++)
        u16[i] = float_to_half(half_to_float(u16[i]) / (float)world);
      return;
    case DataType::BF16:
      for (size_t i = 0; i < count; i++)
        u16[i] = float_to_bf16(bf16_to_float(u16[i]) / (float)world);
      return;
    case DataType::I32: scale_chunk_t<int32_t>(p, count, world); return;
    case DataType::I64: scale_chunk_t<int64_t>(p, count, world); return;
    case DataType::U8:
    case DataType::BOOL: scale_chunk_t<uint8_t>(p, count, world); return;
    case DataType::I8: scale_chunk_t<int8_t>(p, count, world); return;
    default:
      throw std::runtime_error("ring scaling on unsupported dtype");
  }
}

// ----------------------------------------------------------------- collectives

// Streaming reduce sink for transfer_apply: applies in-order byte runs of
// an incoming chunk onto the accumulator with add_chunk, handling runs
// that split mid-element (the shm ring wraps at arbitrary byte offsets)
// through a tiny carry buffer. Element-for-element this performs the
// exact same add sequence (ascending index, one add per element) the old
// consume-to-scratch-then-add path did — bitwise identical results, one
// full payload read+write less per ring pass.
struct ReduceCursor {
  uint8_t* dst;
  DataType work;
  size_t esize;
  size_t done = 0;          // bytes fully folded into dst
  uint8_t carry[16] = {0};  // partial element spanning two runs
  size_t carry_n = 0;

  void operator()(const uint8_t* src, size_t len) {
    if (carry_n) {
      size_t need = esize - carry_n;
      size_t take = len < need ? len : need;
      std::memcpy(carry + carry_n, src, take);
      carry_n += take;
      src += take;
      len -= take;
      if (carry_n == esize) {
        add_chunk(work, dst + done, carry, 1);
        done += esize;
        carry_n = 0;
      }
    }
    size_t whole = (len / esize) * esize;
    if (whole) {
      if (((uintptr_t)src % esize) == 0) {
        add_chunk(work, dst + done, src, whole / esize);
        done += whole;
      } else {
        // Element-misaligned run (a carry fill or an shm wrap landed
        // mid-element): typed loads on it are UB, so bounce through a
        // small aligned block. Rare — at most once per carry event.
        alignas(8) uint8_t block[4096];
        size_t off = 0;
        while (off < whole) {
          size_t take = whole - off < sizeof(block) ? whole - off
                                                    : sizeof(block);
          std::memcpy(block, src + off, take);
          add_chunk(work, dst + done, block, take / esize);
          done += take;
          off += take;
        }
      }
      src += whole;
      len -= whole;
    }
    if (len) {
      std::memcpy(carry, src, len);
      carry_n = len;
    }
  }
};

// Ring reduce-scatter over explicit element chunks (counts/offs in elements).
// After N-1 steps rank r holds the fully reduced chunk r. Flat equal-ish
// chunks give allreduce; row-aligned chunks give reducescatter semantics.
// The receive side folds incoming bytes straight into the accumulator
// chunk (transfer_apply + ReduceCursor): zero-copy from the shm segment
// on same-host links, a 64 KiB cache-hot staging block on TCP — the old
// chunk-sized scratch bounce (an extra full read+write of the payload per
// pass) is gone.
inline void ring_reduce_scatter(RingLinks& links, int rank, int world,
                                uint8_t* buf, const std::vector<size_t>& counts,
                                const std::vector<size_t>& offs, size_t esize,
                                DataType work, RingStats* stats) {
  auto mod = [&](int v) { return ((v % world) + world) % world; };
  for (int s = 0; s < world - 1; s++) {
    int send_idx = mod(rank - 1 - s);
    int recv_idx = mod(rank - 2 - s);
    ReduceCursor fold{buf + offs[(size_t)recv_idx] * esize, work, esize};
    links.transfer_apply(buf + offs[(size_t)send_idx] * esize,
                         counts[(size_t)send_idx] * esize,
                         counts[(size_t)recv_idx] * esize, fold, stats);
  }
}

// Three-operand streaming fold (the borrowed-input path): out chunk =
// own (read-only input) chunk + incoming bytes. Same add order as
// ReduceCursor, bitwise identical; `own` tracks `done` so runs may split
// anywhere.
struct FoldCursor {
  uint8_t* dst;
  const uint8_t* own;
  DataType work;
  size_t esize;
  size_t done = 0;
  uint8_t carry[16] = {0};
  size_t carry_n = 0;

  void operator()(const uint8_t* src, size_t len) {
    if (carry_n) {
      size_t need = esize - carry_n;
      size_t take = len < need ? len : need;
      std::memcpy(carry + carry_n, src, take);
      carry_n += take;
      src += take;
      len -= take;
      if (carry_n == esize) {
        add_chunk_into(work, dst + done, own + done, carry, 1);
        done += esize;
        carry_n = 0;
      }
    }
    size_t whole = (len / esize) * esize;
    if (whole) {
      if (((uintptr_t)src % esize) == 0) {
        add_chunk_into(work, dst + done, own + done, src, whole / esize);
        done += whole;
      } else {
        alignas(8) uint8_t block[4096];
        size_t off = 0;
        while (off < whole) {
          size_t take = whole - off < sizeof(block) ? whole - off
                                                    : sizeof(block);
          std::memcpy(block, src + off, take);
          add_chunk_into(work, dst + done, own + done, block, take / esize);
          done += take;
          off += take;
        }
      }
      src += whole;
      len -= whole;
    }
    if (len) {
      std::memcpy(carry, src, len);
      carry_n = len;
    }
  }
};

// Reduce-scatter with a READ-ONLY input buffer and a separate output
// (zero-copy enqueue: the engine borrows the caller's tensor
// instead of copying it into the table). Step 0 sends the caller's own
// chunk; every later step sends the chunk folded the step before (which
// lives in `out`); folds write out chunk = in chunk + incoming. After
// world-1 steps `out` holds the same bytes the in-place variant leaves in
// `buf` for chunks it folded; chunk (rank-1+world)%world of `out` stays
// untouched (the allgather fills it).
inline void ring_reduce_scatter_into(RingLinks& links, int rank, int world,
                                     const uint8_t* in, uint8_t* out,
                                     const std::vector<size_t>& counts,
                                     const std::vector<size_t>& offs,
                                     size_t esize, DataType work,
                                     RingStats* stats) {
  auto mod = [&](int v) { return ((v % world) + world) % world; };
  for (int s = 0; s < world - 1; s++) {
    int send_idx = mod(rank - 1 - s);
    int recv_idx = mod(rank - 2 - s);
    const uint8_t* src = (s == 0 ? in : out) + offs[(size_t)send_idx] * esize;
    FoldCursor fold{out + offs[(size_t)recv_idx] * esize,
                    in + offs[(size_t)recv_idx] * esize, work, esize};
    links.transfer_apply(src, counts[(size_t)send_idx] * esize,
                         counts[(size_t)recv_idx] * esize, fold, stats);
  }
}

// Ring allgather over chunks: rank r starts owning chunk r (complete) and
// after N-1 steps every rank holds every chunk. Receives land directly in
// the destination buffer — no scratch copy.
inline void ring_allgather(RingLinks& links, int rank, int world, uint8_t* buf,
                           const std::vector<size_t>& counts,
                           const std::vector<size_t>& offs, size_t esize,
                           RingStats* stats) {
  auto mod = [&](int v) { return ((v % world) + world) % world; };
  for (int s = 0; s < world - 1; s++) {
    int send_idx = mod(rank - s);
    int recv_idx = mod(rank - s - 1);
    links.transfer(buf + offs[(size_t)send_idx] * esize,
                   counts[(size_t)send_idx] * esize,
                   buf + offs[(size_t)recv_idx] * esize,
                   counts[(size_t)recv_idx] * esize, stats);
  }
}

// Full ring allreduce: reduce-scatter, scale own chunk (average), allgather.
inline void ring_allreduce(RingLinks& links, int rank, int world, uint8_t* buf,
                           size_t count, size_t esize, DataType work,
                           bool average, RingStats* stats) {
  if (stats) stats->passes++;
  auto counts = split_counts(count, world);
  auto offs = offsets_of(counts);
  ring_reduce_scatter(links, rank, world, buf, counts, offs, esize, work,
                      stats);
  if (average) {
    scale_chunk(work, buf + offs[(size_t)rank] * esize, counts[(size_t)rank],
                world);
  }
  ring_allgather(links, rank, world, buf, counts, offs, esize, stats);
}

// Chunked store-and-forward pipeline broadcast. The root pushes ~1 MiB
// chunks to next; intermediate ranks forward chunk c-1 while receiving
// chunk c (duplex), so all N-1 hops stream concurrently.
inline void ring_broadcast(RingLinks& links, int rank, int world, int root,
                           uint8_t* buf, size_t nbytes, RingStats* stats) {
  if (world <= 1 || nbytes == 0) return;  // empty tensor: nothing on the wire
  if (stats) stats->passes++;
  constexpr size_t kChunk = 1 << 20;
  int dist = ((rank - root) % world + world) % world;
  size_t nchunks = (nbytes + kChunk - 1) / kChunk;
  auto chunk_at = [&](size_t c) {
    size_t off = c * kChunk;
    return std::make_pair(buf + off, std::min(kChunk, nbytes - off));
  };
  if (dist == 0) {
    for (size_t c = 0; c < nchunks; c++) {
      auto [p, n] = chunk_at(c);
      links.send(p, n, stats);
    }
  } else if (dist == world - 1) {
    for (size_t c = 0; c < nchunks; c++) {
      auto [p, n] = chunk_at(c);
      links.recv(p, n);
    }
  } else {
    for (size_t c = 0; c < nchunks; c++) {
      auto [p, n] = chunk_at(c);
      if (c == 0) {
        links.recv(p, n);
      } else {
        auto [pp, pn] = chunk_at(c - 1);
        links.transfer(pp, pn, p, n, stats);
      }
    }
    auto [lp, ln] = chunk_at(nchunks - 1);
    links.send(lp, ln, stats);
  }
}

// Shrinking-parcel ring alltoall. `in` holds this rank's input split into
// world destination chunks (row-aligned, sizes in dest_bytes); `out` must
// have world origin slots of dest_bytes[rank] each (out[o] = origin o's
// chunk addressed to this rank). Per-link traffic is sum_{s=1}^{N-1}
// (parcel_s) ≈ N/2 · input bytes — acceptable for the eager/host path; the
// compiled path uses XLA's all_to_all over ICI instead.
inline void ring_alltoall(RingLinks& links, int rank, int world,
                          const uint8_t* in,
                          const std::vector<size_t>& dest_bytes,
                          const std::vector<size_t>& dest_offs, uint8_t* out,
                          RingStats* stats) {
  if (stats) stats->passes++;
  auto mod = [&](int v) { return ((v % world) + world) % world; };
  size_t my_bytes = dest_bytes[(size_t)rank];
  // own chunk: straight copy into slot `rank`
  std::memcpy(out + (size_t)rank * my_bytes, in + dest_offs[(size_t)rank],
              my_bytes);
  // first parcel: my chunks for destinations at distance 1..N-1, in
  // increasing distance order
  std::vector<uint8_t> parcel;
  for (int d = 1; d < world; d++) {
    int dest = mod(rank + d);
    parcel.insert(parcel.end(), in + dest_offs[(size_t)dest],
                  in + dest_offs[(size_t)dest] + dest_bytes[(size_t)dest]);
  }
  std::vector<uint8_t> incoming;
  for (int s = 1; s < world; s++) {
    int origin = mod(rank - s);
    // incoming parcel = origin's chunks for distances s..N-1, i.e. for
    // destinations rank, rank+1, ..., in that order
    size_t in_size = 0;
    for (int t = s; t < world; t++) in_size += dest_bytes[(size_t)mod(origin + t)];
    incoming.resize(in_size);
    links.transfer(parcel.data(), parcel.size(), incoming.data(), in_size,
                   stats);
    // peel off the front chunk (addressed to me, from `origin`)
    std::memcpy(out + (size_t)origin * my_bytes, incoming.data(), my_bytes);
    // forward the remainder next step
    parcel.assign(incoming.begin() + (ptrdiff_t)my_bytes, incoming.end());
  }
}

// ------------------------------------------------------ sparse (topk) wire
// The native half of the zero-copy hot path for HOROVOD_COMPRESSION
// =topk: ring hops carry self-describing indices+values frames (topk.h)
// instead of dense chunks, reduced by index merge in the SAME fold order
// as the dense path — bitwise identical to the Python engine's
// _sparse_allreduce and the _ring_order_reduce(wire="topk") oracle.
// Sparse frames are variable-size (k grows with every merge), so each hop
// prefixes a 4-byte length — the only framed transfer on the ring; the
// dense path's sizes stay protocol-derived.

// Per-collective wire accounting for the sparse hops (single executor
// thread; the engine folds these into its atomic EngineMetrics after the
// pass). `saved` counts against the dense f32 hop the uncompressed plane
// would ship (native width — the Python engine uses the same basis).
struct SparseWire {
  uint64_t wire = 0;
  uint64_t saved = 0;

  void hop(size_t frame_bytes, size_t chunk_elems) {
    wire += frame_bytes;
    size_t dense = chunk_elems * 4;
    saved += dense > frame_bytes ? dense - frame_bytes : 0;
  }
};

// One framed hop: exchange 4-byte lengths, then the payloads. `cap` bounds
// the incoming allocation (topk_frame_cap of the expected chunk).
inline std::vector<uint8_t> sparse_hop(RingLinks& links,
                                       const std::vector<uint8_t>& out_frame,
                                       size_t cap, RingStats* stats) {
  uint32_t out_len = (uint32_t)out_frame.size();
  uint32_t in_len = 0;
  links.transfer((const uint8_t*)&out_len, 4, (uint8_t*)&in_len, 4, stats);
  if ((size_t)in_len > cap)
    throw std::runtime_error("sparse frame length " + std::to_string(in_len) +
                             " exceeds cap " + std::to_string(cap));
  std::vector<uint8_t> in_frame((size_t)in_len);
  links.transfer(out_frame.data(), out_frame.size(), in_frame.data(),
                 in_frame.size(), stats);
  return in_frame;
}

// Flat-ring sparse allreduce over a dense float32 buffer (in place),
// mirroring engine.py _PeerRing._sparse_allreduce hop for hop.
// `prefer_sparse` is the value-neutral per-link framing choice (the
// adaptive policy ships sparse on cross-host links, dense on loopback).
inline void ring_sparse_allreduce(RingLinks& links, int rank, int world,
                                  float* buf, size_t count, bool average,
                                  bool prefer_sparse, RingStats* stats,
                                  SparseWire* wire) {
  if (stats) stats->passes++;
  auto bounds = offsets_of(split_counts(count, world));
  auto mod = [&](int v) { return ((v % world) + world) % world; };
  auto csize = [&](int c) {
    return bounds[(size_t)c + 1] - bounds[(size_t)c];
  };
  auto chunk = [&](int c) { return buf + bounds[(size_t)c]; };
  int c = mod(rank - 1);
  TopkState state = topk_sparsify(chunk(c), csize(c));
  for (int s = 1; s < world; s++) {
    auto frame = topk_encode(state, csize(c), prefer_sparse);
    if (wire) wire->hop(frame.size(), csize(c));
    c = mod(rank - s - 1);
    auto in = sparse_hop(links, frame, topk_frame_cap(csize(c)), stats);
    TopkState st_in = topk_unpack(in.data(), in.size(), csize(c));
    TopkState mine = topk_sparsify(chunk(c), csize(c));
    topk_state_add(st_in, mine.idx, mine.val, csize(c));
    state = std::move(st_in);
  }
  if (average) topk_state_scale(state, world);
  topk_state_dense(state, csize(rank), chunk(rank));
  auto cur = topk_encode(state, csize(rank), prefer_sparse);
  c = rank;
  for (int s = 1; s < world; s++) {
    if (wire) wire->hop(cur.size(), csize(c));
    c = mod(rank - s);
    // Forward the frame verbatim next hop: every rank stores the identical
    // f32 values whichever encoding carried them.
    cur = sparse_hop(links, cur, topk_frame_cap(csize(c)), stats);
    TopkState st = topk_unpack(cur.data(), cur.size(), csize(c));
    topk_state_dense(st, csize(c), chunk(c));
  }
}

// Two-level (hierarchical) sparse allreduce, mirroring engine.py
// _HierPlane._sparse_allreduce: intra-host sparse reduce-scatter, L
// parallel cross-host leaders rings on the local chunk, intra-host
// allgather of the finished chunks. `sp_local`/`sp_cross` are the
// per-fabric framing preferences (value-neutral).
inline void grid_sparse_allreduce(RingLinks& local, RingLinks& cross,
                                  int local_rank, int L, int cross_rank,
                                  int C, float* buf, size_t count,
                                  bool average, bool sp_local, bool sp_cross,
                                  RingStats* stats, SparseWire* wire) {
  if (stats) stats->passes++;
  int world = L * C;
  auto lb = offsets_of(split_counts(count, L));
  auto lmod = [&](int v) { return ((v % L) + L) % L; };
  auto cmod = [&](int v) { return ((v % C) + C) % C; };
  auto lsize = [&](int i) { return lb[(size_t)i + 1] - lb[(size_t)i]; };
  auto lchunk = [&](int i) { return buf + lb[(size_t)i]; };
  int l = local_rank, c = cross_rank;

  // -- stage 1: intra-host sparse reduce-scatter (fold start (i+1) % L) --
  int i = lmod(l - 1);
  TopkState state = topk_sparsify(lchunk(i), lsize(i));
  for (int s = 1; s < L; s++) {
    auto frame = topk_encode(state, lsize(i), sp_local);
    if (wire) wire->hop(frame.size(), lsize(i));
    i = lmod(l - s - 1);
    auto in = sparse_hop(local, frame, topk_frame_cap(lsize(i)), stats);
    TopkState st_in = topk_unpack(in.data(), in.size(), lsize(i));
    TopkState mine = topk_sparsify(lchunk(i), lsize(i));
    topk_state_add(st_in, mine.idx, mine.val, lsize(i));
    state = std::move(st_in);
  }
  // `state` = this host's subtotal of local chunk l.

  // -- stage 2: leaders ring allreduce of chunk l across hosts -----------
  size_t nl = lsize(l);
  auto cb = offsets_of(split_counts(nl, C));
  auto csz = [&](int k) { return cb[(size_t)k + 1] - cb[(size_t)k]; };
  int k = cmod(c - 1);
  TopkState cstate = topk_state_slice(state, cb[(size_t)k],
                                      cb[(size_t)k + 1]);
  for (int s = 1; s < C; s++) {
    auto frame = topk_encode(cstate, csz(k), sp_cross);
    if (wire) wire->hop(frame.size(), csz(k));
    k = cmod(c - s - 1);
    auto in = sparse_hop(cross, frame, topk_frame_cap(csz(k)), stats);
    TopkState st_in = topk_unpack(in.data(), in.size(), csz(k));
    TopkState mine = topk_state_slice(state, cb[(size_t)k],
                                      cb[(size_t)k + 1]);
    if (mine.dense) mine = topk_sparsify(mine.dvals.data(), csz(k));
    topk_state_add(st_in, mine.idx, mine.val, csz(k));
    cstate = std::move(st_in);
  }
  if (average) topk_state_scale(cstate, world);
  std::vector<float> fin_l(nl);
  topk_state_dense(cstate, csz(c), fin_l.data() + cb[(size_t)c]);
  auto cur = topk_encode(cstate, csz(c), sp_cross);
  k = c;
  for (int s = 1; s < C; s++) {
    if (wire) wire->hop(cur.size(), csz(k));
    k = cmod(c - s);
    cur = sparse_hop(cross, cur, topk_frame_cap(csz(k)), stats);
    TopkState st = topk_unpack(cur.data(), cur.size(), csz(k));
    topk_state_dense(st, csz(k), fin_l.data() + cb[(size_t)k]);
  }

  // -- stage 3: intra-host allgather of finished local chunks ------------
  std::memcpy(lchunk(l), fin_l.data(), nl * 4);
  TopkState fin_sp = topk_sparsify(fin_l.data(), nl);
  cur = topk_encode(fin_sp, nl, sp_local);
  i = l;
  for (int s = 1; s < L; s++) {
    if (wire) wire->hop(cur.size(), lsize(i));
    i = lmod(l - s);
    cur = sparse_hop(local, cur, topk_frame_cap(lsize(i)), stats);
    TopkState st = topk_unpack(cur.data(), cur.size(), lsize(i));
    topk_state_dense(st, lsize(i), lchunk(i));
  }
}

}  // namespace hvd

#endif  // HVD_RING_H
