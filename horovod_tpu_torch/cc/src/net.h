// TCP plumbing for the control plane and the ring data plane.
//
// Replaces the reference's MPI control-plane collectives
// (operations.cc:2088-2109, 2282-2287) and the NCCL ring data plane
// (operations.cc:1221-1446) transport with sockets. Framing follows the
// in-repo blueprint of the Spark network layer (reference
// horovod/spark/util/network.py:44-76: authenticated digest + length +
// body): every connection is authenticated with an HMAC-SHA256
// challenge-response keyed by the launcher-distributed HOROVOD_SECRET
// before any payload is exchanged, and frame lengths are capped so a
// malicious peer cannot drive unbounded allocations.
#ifndef HVD_NET_H
#define HVD_NET_H

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace hvd {

// ------------------------------------------------------------------ SHA-256
// Self-contained FIPS 180-4 SHA-256 (no OpenSSL in the image). Used only for
// connection authentication; tensor payloads are never hashed.

struct Sha256 {
  uint32_t h[8];
  uint8_t block[64];
  uint64_t len = 0;
  size_t fill = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    std::memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  void compress(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++) {
      w[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
             (uint32_t)p[4 * i + 2] << 8 | (uint32_t)p[4 * i + 3];
    }
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const void* data, size_t n) {
    const uint8_t* p = (const uint8_t*)data;
    len += n;
    while (n > 0) {
      size_t take = std::min(n, (size_t)64 - fill);
      std::memcpy(block + fill, p, take);
      fill += take;
      p += take;
      n -= take;
      if (fill == 64) {
        compress(block);
        fill = 0;
      }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bitlen = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t lenbuf[8];
    for (int i = 0; i < 8; i++) lenbuf[i] = (uint8_t)(bitlen >> (56 - 8 * i));
    update(lenbuf, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = (uint8_t)(h[i] >> 24);
      out[4 * i + 1] = (uint8_t)(h[i] >> 16);
      out[4 * i + 2] = (uint8_t)(h[i] >> 8);
      out[4 * i + 3] = (uint8_t)h[i];
    }
  }
};

inline void hmac_sha256(const std::string& key, const void* msg, size_t n,
                        uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (key.size() > 64) {
    Sha256 s;
    s.update(key.data(), key.size());
    s.final(k);
  } else {
    std::memcpy(k, key.data(), key.size());
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 si;
  si.update(ipad, 64);
  si.update(msg, n);
  si.final(inner);
  Sha256 so;
  so.update(opad, 64);
  so.update(inner, 32);
  so.final(out);
}

inline bool const_time_eq(const uint8_t* a, const uint8_t* b, size_t n) {
  uint8_t diff = 0;
  for (size_t i = 0; i < n; i++) diff |= a[i] ^ b[i];
  return diff == 0;
}

// The shared job secret (hex, distributed by the launcher; reference
// spark/util/secret.py). Empty string disables authentication — only for
// worlds launched without the horovod_tpu launcher on a trusted loopback.
inline std::string job_secret() {
  const char* env = std::getenv("HOROVOD_SECRET");
  return env ? std::string(env) : std::string();
}

// Cap on any single frame (HOROVOD_MAX_FRAME_BYTES). A peer-provided length
// above this aborts the connection instead of allocating (no unbounded
// allocation from an attacker-controlled 64-bit length).
inline uint64_t max_frame_bytes() {
  static uint64_t cap = [] {
    const char* env = std::getenv("HOROVOD_MAX_FRAME_BYTES");
    return env ? (uint64_t)std::strtoull(env, nullptr, 10)
               : (uint64_t)8 << 30;  // 8 GiB
  }();
  return cap;
}

// --------------------------------------------------------------- raw socket IO

inline void send_all(int fd, const void* p, size_t n) {
  const uint8_t* c = (const uint8_t*)p;
  while (n > 0) {
    ssize_t w = ::send(fd, c, n, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && (errno == EINTR)) continue;
      throw std::runtime_error("send failed");
    }
    c += w;
    n -= (size_t)w;
  }
}

inline void recv_all(int fd, void* p, size_t n) {
  uint8_t* c = (uint8_t*)p;
  while (n > 0) {
    ssize_t r = ::recv(fd, c, n, 0);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      throw std::runtime_error("recv failed / peer closed");
    }
    c += r;
    n -= (size_t)r;
  }
}

inline void send_frame(int fd, const std::vector<uint8_t>& payload) {
  uint64_t len = payload.size();
  send_all(fd, &len, 8);
  if (len) send_all(fd, payload.data(), payload.size());
}

inline std::vector<uint8_t> recv_frame(int fd) {
  uint64_t len = 0;
  recv_all(fd, &len, 8);
  if (len > max_frame_bytes()) {
    throw std::runtime_error("frame length " + std::to_string(len) +
                             " exceeds HOROVOD_MAX_FRAME_BYTES cap");
  }
  std::vector<uint8_t> out(len);
  if (len) recv_all(fd, out.data(), len);
  return out;
}

// Send `n` bytes to `out_fd` while receiving `m` bytes from `in_fd`, making
// progress on whichever direction is ready. This is the primitive the ring
// collectives run on: both neighbours send and receive simultaneously, so
// blocking send+recv in sequence would deadlock once chunks exceed the
// socket buffers (the role NCCL's async streams play in the reference's
// ring, operations.cc:1221-1446).
inline void duplex(int out_fd, const uint8_t* out, size_t n, int in_fd,
                   uint8_t* in, size_t m) {
  size_t sent = 0, got = 0;
  while (sent < n || got < m) {
    pollfd fds[2];
    int nfds = 0;
    int wi = -1, ri = -1;
    if (sent < n) {
      fds[nfds] = {out_fd, POLLOUT, 0};
      wi = nfds++;
    }
    if (got < m) {
      fds[nfds] = {in_fd, POLLIN, 0};
      ri = nfds++;
    }
    int rc = ::poll(fds, (nfds_t)nfds, 300 * 1000);
    if (rc < 0) {
      if (errno == EINTR) continue;
      throw std::runtime_error("poll failed in ring transfer");
    }
    if (rc == 0) throw std::runtime_error("ring transfer timed out (300s)");
    if (wi >= 0 && (fds[wi].revents & (POLLOUT | POLLERR | POLLHUP))) {
      ssize_t w = ::send(out_fd, out + sent, n - sent,
                         MSG_NOSIGNAL | MSG_DONTWAIT);
      if (w < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
        throw std::runtime_error("ring send failed");
      if (w > 0) sent += (size_t)w;
    }
    if (ri >= 0 && (fds[ri].revents & (POLLIN | POLLERR | POLLHUP))) {
      ssize_t r = ::recv(in_fd, in + got, m - got, MSG_DONTWAIT);
      if (r == 0) throw std::runtime_error("ring peer closed");
      if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
        throw std::runtime_error("ring recv failed");
      if (r > 0) got += (size_t)r;
    }
  }
}

// ----------------------------------------------------------- listen / connect

inline sockaddr_in resolve(const std::string& host, int port) {
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (host.empty() || host == "0.0.0.0") {
    addr.sin_addr.s_addr = INADDR_ANY;
    return addr;
  }
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
    throw std::runtime_error("cannot resolve host " + host);
  addr.sin_addr = ((sockaddr_in*)res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return addr;
}

// Binds to `host` when given (the coordinator should not
// listen on INADDR_ANY when the launcher told it where it lives); empty host
// binds all interfaces (the ring data listeners, whose reachable interface
// per peer is unknown — the auth handshake gates those). If `host` is the
// clients' view of this machine but not a local interface (NAT/VIP
// forwarding), the specific bind fails and we fall back to all interfaces
// with a warning — the HMAC handshake still gates every connection.
inline int listen_on(const std::string& host, int port, int backlog) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) throw std::runtime_error("socket failed");
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr = resolve(host, port);
  if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0) {
    if (!host.empty() && host != "0.0.0.0") {
      std::fprintf(stderr,
                   "[horovod_tpu/warning] cannot bind %s:%d (not a local "
                   "interface?); listening on all interfaces instead\n",
                   host.c_str(), port);
      addr.sin_addr.s_addr = INADDR_ANY;
      if (::bind(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
        if (::listen(fd, backlog) != 0) {
          ::close(fd);
          throw std::runtime_error("listen failed");
        }
        return fd;
      }
    }
    ::close(fd);
    throw std::runtime_error("bind failed on " + host + ":" + std::to_string(port));
  }
  if (::listen(fd, backlog) != 0) {
    ::close(fd);
    throw std::runtime_error("listen failed");
  }
  return fd;
}

inline int bound_port(int fd) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (::getsockname(fd, (sockaddr*)&addr, &len) != 0)
    throw std::runtime_error("getsockname failed");
  return (int)ntohs(addr.sin_port);
}

// Local IP used to reach the peer on `fd` — the address this rank should
// advertise for its own listeners (multi-host: the interface that routes to
// the coordinator routes between workers too; reference uses the Spark
// ring-ping NIC discovery for the same decision, spark/__init__.py:135-140).
inline std::string local_addr(int fd) {
  sockaddr_in addr{};
  socklen_t len = sizeof(addr);
  if (::getsockname(fd, (sockaddr*)&addr, &len) != 0) return "127.0.0.1";
  char buf[INET_ADDRSTRLEN] = {0};
  inet_ntop(AF_INET, &addr.sin_addr, buf, sizeof(buf));
  return buf;
}

inline int connect_to(const std::string& host, int port, double timeout_s) {
  sockaddr_in addr = resolve(host, port);
  double waited = 0.0;
  while (true) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd >= 0 && ::connect(fd, (sockaddr*)&addr, sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    if (fd >= 0) ::close(fd);
    if (waited >= timeout_s) {
      throw std::runtime_error("cannot reach " + host + ":" +
                               std::to_string(port));
    }
    ::usleep(100 * 1000);
    waited += 0.1;
  }
}

// ------------------------------------------------------------- authentication
// Mutual HMAC-SHA256 challenge-response, keyed by HOROVOD_SECRET and bound
// to a channel purpose string so a ring credential cannot be replayed
// against the coordinator. Runs before any payload byte is accepted
// (the repo rule set by runner/network.py: authenticate, then parse).

inline std::vector<uint8_t> fresh_nonce() {
  std::vector<uint8_t> nonce(16);
  std::FILE* f = std::fopen("/dev/urandom", "rb");
  if (!f || std::fread(nonce.data(), 1, nonce.size(), f) != nonce.size()) {
    throw std::runtime_error("cannot read /dev/urandom for auth nonce");
  }
  std::fclose(f);
  return nonce;
}

inline void auth_mac(const std::string& secret, const std::string& purpose,
                     const std::vector<uint8_t>& nonce, uint8_t out[32]) {
  std::vector<uint8_t> msg(purpose.begin(), purpose.end());
  msg.insert(msg.end(), nonce.begin(), nonce.end());
  hmac_sha256(secret, msg.data(), msg.size(), out);
}

// Server side. Returns false (and closes nothing) on auth failure.
inline bool auth_accept(int fd, const std::string& secret,
                        const std::string& purpose) {
  if (secret.empty()) return true;  // auth disabled: no secret distributed
  try {
    auto nonce = fresh_nonce();
    send_all(fd, nonce.data(), nonce.size());
    uint8_t theirs[32], expect[32];
    recv_all(fd, theirs, 32);
    auth_mac(secret, purpose + ".client", nonce, expect);
    if (!const_time_eq(theirs, expect, 32)) return false;
    uint8_t client_nonce[16];
    recv_all(fd, client_nonce, 16);
    uint8_t mine[32];
    auth_mac(secret, purpose + ".server",
             std::vector<uint8_t>(client_nonce, client_nonce + 16), mine);
    send_all(fd, mine, 32);
    return true;
  } catch (const std::exception&) {
    return false;
  }
}

// Client side. Throws on failure (the caller owns the fd).
inline void auth_connect(int fd, const std::string& secret,
                         const std::string& purpose) {
  if (secret.empty()) return;
  std::vector<uint8_t> nonce(16);
  recv_all(fd, nonce.data(), nonce.size());
  uint8_t mine[32];
  auth_mac(secret, purpose + ".client", nonce, mine);
  send_all(fd, mine, 32);
  auto my_nonce = fresh_nonce();
  send_all(fd, my_nonce.data(), my_nonce.size());
  uint8_t theirs[32], expect[32];
  recv_all(fd, theirs, 32);
  auth_mac(secret, purpose + ".server", my_nonce, expect);
  if (!const_time_eq(theirs, expect, 32))
    throw std::runtime_error("server failed HOROVOD_SECRET authentication");
}

}  // namespace hvd

#endif  // HVD_NET_H
