// Multi-threaded ring-reduce stress for the sanitizer CI leg.
//
// CPython under libtsan preload drowns in allocator noise, so the
// ASan+TSan sweep of the NEW native byte path (sparse topk framing,
// 16-bit per-hop rounding, mixed shm/TCP duplex) runs as this standalone
// binary instead: four "ranks" as threads of one process, each owning a
// RingLinks pair over localhost (shm upgrade negotiated like production),
// hammering dense f32 / native bf16 / sparse topk ring allreduces
// concurrently, then a chaos iteration — one rank slams its links shut
// mid-collective (connection reset) and every survivor must surface a
// clean std::runtime_error, no deadlock, no race, no leak.
//
// Built by `make asan_stress` / `make tsan_stress` (Makefile), driven by
// tools/sanitize_smoke.py. Exit 0 = clean; any sanitizer report aborts.

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "ring.h"
#include "topk.h"

using namespace hvd;

static constexpr int kWorld = 4;
static constexpr size_t kElems = 40013;  // odd: uneven ring chunks

int main() {
  // HOROVOD_SHM stays at its default (on): same-process "ranks" are
  // same-host by construction, so half the links upgrade to the shm plane
  // and the mixed_duplex path runs under the sanitizer too.
  std::string secret = "stress-secret";
  std::vector<RingLinks> links(kWorld);
  std::vector<std::pair<std::string, int>> peers(kWorld);
  for (int r = 0; r < kWorld; r++) {
    links[r].open_listener();
    peers[r] = {"127.0.0.1", links[r].port()};
  }
  std::atomic<int> establish_fail{0};
  {
    std::vector<std::thread> ts;
    for (int r = 0; r < kWorld; r++) {
      ts.emplace_back([&, r] {
        try {
          links[r].establish(r, kWorld, peers, secret, 30.0, "hvd-ring",
                             r % 2 == 0, r % 2 == 1);
        } catch (const std::exception& ex) {
          std::fprintf(stderr, "establish(%d) failed: %s\n", r, ex.what());
          establish_fail++;
        }
      });
    }
    for (auto& t : ts) t.join();
  }
  if (establish_fail.load()) return 1;

  std::atomic<int> errors{0};
  std::atomic<int> chaos_errors{0};
  // Phase barrier: the chaos close must not race the tail of the clean
  // pass (a rank's final transfer completes before its neighbour DRAINS
  // the bytes — closing links in that window fails the clean pass).
  std::mutex bmu;
  std::condition_variable bcv;
  int arrived = 0;
  auto barrier = [&] {
    std::unique_lock<std::mutex> lk(bmu);
    if (++arrived >= kWorld) {
      bcv.notify_all();
    } else {
      bcv.wait(lk, [&] { return arrived >= kWorld; });
    }
  };
  {
    std::vector<std::thread> ts;
    for (int r = 0; r < kWorld; r++) {
      ts.emplace_back([&, r] {
        RingStats stats;
        std::vector<float> f32(kElems);
        std::vector<uint16_t> b16(kElems);
        std::vector<float> sparse(kElems, 0.0f);
        try {
          for (int it = 0; it < 6; it++) {
            for (size_t i = 0; i < kElems; i++) {
              f32[i] = (float)((i * 7 + (size_t)r * 13 + (size_t)it) % 97)
                       - 48.0f;
              b16[i] = float_to_bf16(f32[i]);
              sparse[i] = (i % 53 == 0) ? f32[i] : 0.0f;
            }
            ring_allreduce(links[r], r, kWorld, (uint8_t*)f32.data(),
                           kElems, 4, DataType::F32, it % 2 == 0, &stats);
            ring_allreduce(links[r], r, kWorld, (uint8_t*)b16.data(),
                           kElems, 2, DataType::BF16, false, &stats);
            SparseWire sw;
            ring_sparse_allreduce(links[r], r, kWorld, sparse.data(),
                                  kElems, it % 2 == 1, it % 3 != 0, &stats,
                                  &sw);
          }
        } catch (const std::exception& ex) {
          std::fprintf(stderr, "rank %d clean pass failed: %s\n", r,
                       ex.what());
          errors++;
          links[r].close();  // unblock neighbours, then leave
          barrier();
          return;
        }
        barrier();
        // Chaos: rank 2 resets its links mid-collective; every other rank
        // must surface a clean error (broken pipe / peer closed / frame
        // cap), never hang or corrupt.
        try {
          if (r == 2) {
            links[r].close();
          } else {
            SparseWire sw;
            ring_sparse_allreduce(links[r], r, kWorld, sparse.data(),
                                  kElems, false, true, &stats, &sw);
            ring_allreduce(links[r], r, kWorld, (uint8_t*)f32.data(),
                           kElems, 4, DataType::F32, false, &stats);
          }
        } catch (const std::exception&) {
          chaos_errors++;
        }
        links[r].close();  // cascade: unblocks neighbours still in duplex
      });
    }
    for (auto& t : ts) t.join();
  }
  if (errors.load()) return 1;
  if (chaos_errors.load() < 1) {
    std::fprintf(stderr,
                 "chaos reset surfaced no errors (expected >= 1 rank to "
                 "fail cleanly)\n");
    return 1;
  }
  std::printf("ring stress OK: dense f32 + bf16 + sparse topk passes, "
              "chaos reset surfaced %d clean errors\n",
              chaos_errors.load());
  return 0;
}
