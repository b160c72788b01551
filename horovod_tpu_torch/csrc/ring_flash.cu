// Ring flash attention for Hopper (sm_90a): one ring step's forward, dQ
// and dK/dV kernels.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/ring_flash.py:
//   hvd_ring_flash_fwd <- _rf_fwd_kernel (online-softmax update of the
//                         carried, unnormalized (acc, m, l) by one K/V block)
//   hvd_ring_flash_dq  <- _rf_dq_kernel  (dQ carry += this block's dQ)
//   hvd_ring_flash_dkv <- _rf_dkv_kernel (dK, dV carries += this block's
//                         share, over every q tile of the GQA group)
//
// The kernels are the kRing variant of the flash kernels: float32 carries
// read and written back in place (one block per carry tile, no atomics),
// and causal masking by the global positions qpos[i] >= kpos[j], so one
// kernel serves the contiguous and the zigzag layouts. Every tile pair is
// visited and a pair with max(qpos) < min(kpos) is skipped; a ring step
// with every pair masked is skipped by the caller before any launch. The
// headers describe the layout, the arithmetic and what bounds them.
//
// In bfloat16 all three run the kRing variants of flash_tc.cuh's
// tensor-core kernels (TMA, wgmma); in float32 they run flash_kernels.cuh's
// float32 FMA kernels. Neither falls back to the other.
//
// Positions are one int32 vector (t,) each for q and k; m and l are
// (B*H, t) float32 (the TPU's (B*H, 8, t), (8, t) and (t, 128) replicated
// layouts are not kept).

#include "flash_kernels.cuh"
#include "flash_tc.cuh"

namespace {

template <int D>
int ring_fwd(const void* q, const void* k, const void* v, void* acc, void* m,
             void* l, const void* qpos, const void* kpos, int rows, int h,
             int hkv, int t, cudaStream_t st) {
  Args a = make_args<D>(h, hkv, t, 1);
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.acc = (float*)acc;
  a.m = (float*)m;
  a.l = (float*)l;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  return launch(fwd_kernel<D, kRing>, a, rows, fwd_smem<D>(), st);
}

template <int D>
int ring_dq(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* qpos,
            const void* kpos, void* dq, int rows, int h, int hkv, int t,
            cudaStream_t st) {
  Args a = make_args<D>(h, hkv, t, 1);
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  a.dq_c = (float*)dq;
  return launch(dq_kernel<D, kRing>, a, rows, bwd_smem<D>(), st);
}

template <int D>
int ring_dkv(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* qpos,
             const void* kpos, void* dk, void* dv, int rows_kv, int h, int hkv,
             int t, cudaStream_t st) {
  Args a = make_args<D>(h, hkv, t, 1);
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  a.dk_c = (float*)dk;
  a.dv_c = (float*)dv;
  return launch(dkv_kernel<D, kRing>, a, rows_kv, bwd_smem<D>(), st);
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` (of the calling thread's
// current device) and returns cudaGetLastError() (0 on success), 1000 for
// arguments no kernel takes, a tile pair (bq, bk) not built among them,
// or 1001 when a tensor map of a bf16 kernel does not encode. Carries
// (acc, m, l, dq, dk, dv) are float32 and updated in place; qpos and kpos
// are int32 (t,). (bq, bk) are the kernel's q and k extents, as in
// flash_attention.cu: the float32 kernels take (kTile, kTile) alone. The
// bf16 kernels load their tiles and the positions of the tile in the ring
// by TMA: they need 16-byte aligned q, k, v and dout, kpos (forward, dQ),
// and lse, delta and qpos (dK/dV, which reads lse and delta with rows t
// rounded up to 4 apart; the wrapper pads them).
int hvd_ring_flash_fwd(const void* q, const void* k, const void* v, void* acc,
                       void* m, void* l, const void* qpos, const void* kpos,
                       int rows, int h, int hkv, int t, int d, int dtype,
                       int bq, int bk, void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  if (dtype == 0 && (bq != kTile || bk != kTile)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 1000 + d) {
    case 32: return ring_fwd<32>(q, k, v, acc, m, l, qpos, kpos, rows, h, hkv, t, st);
    case 64: return ring_fwd<64>(q, k, v, acc, m, l, qpos, kpos, rows, h, hkv, t, st);
    case 128: return ring_fwd<128>(q, k, v, acc, m, l, qpos, kpos, rows, h, hkv, t, st);
    case 1032: return fwd_tc<32, kRing>(bq, bk, q, k, v, nullptr, nullptr, acc, m, l, qpos,
                                        kpos, rows, h, hkv, t, 1, st);
    case 1064: return fwd_tc<64, kRing>(bq, bk, q, k, v, nullptr, nullptr, acc, m, l, qpos,
                                        kpos, rows, h, hkv, t, 1, st);
    case 1128: return fwd_tc<128, kRing>(bq, bk, q, k, v, nullptr, nullptr, acc, m, l, qpos,
                                         kpos, rows, h, hkv, t, 1, st);
    default: return kBadArgs;
  }
}

int hvd_ring_flash_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* qpos, const void* kpos, void* dq, int rows,
                      int h, int hkv, int t, int d, int dtype, int bq, int bk,
                      void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  if (dtype == 0 && (bq != kTile || bk != kTile)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 1000 + d) {
    case 32: return ring_dq<32>(q, k, v, dout, lse, delta, qpos, kpos, dq, rows, h, hkv,
                                       t, st);
    case 64: return ring_dq<64>(q, k, v, dout, lse, delta, qpos, kpos, dq, rows, h, hkv,
                                       t, st);
    case 128: return ring_dq<128>(q, k, v, dout, lse, delta, qpos, kpos, dq, rows, h, hkv,
                                         t, st);
    case 1032: return dq_tc<32, kRing>(bq, bk, q, k, v, dout, lse, delta, qpos, kpos, dq, rows,
                                       h, hkv, t, 1, st);
    case 1064: return dq_tc<64, kRing>(bq, bk, q, k, v, dout, lse, delta, qpos, kpos, dq, rows,
                                       h, hkv, t, 1, st);
    case 1128: return dq_tc<128, kRing>(bq, bk, q, k, v, dout, lse, delta, qpos, kpos, dq, rows,
                                        h, hkv, t, 1, st);
    default: return kBadArgs;
  }
}

int hvd_ring_flash_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* qpos, const void* kpos, void* dk, void* dv,
                       int rows_kv, int h, int hkv, int t, int d, int dtype,
                       int bq, int bk, void* stream) {
  if (bad_kv_shape(rows_kv, h, hkv, t)) return kBadArgs;
  if (dtype == 0 && (bq != kTile || bk != kTile)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 1000 + d) {
    case 32: return ring_dkv<32>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, rows_kv,
                                        h, hkv, t, st);
    case 64: return ring_dkv<64>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, rows_kv,
                                        h, hkv, t, st);
    case 128: return ring_dkv<128>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv, rows_kv,
                                          h, hkv, t, st);
    case 1032: return dkv_tc<32, kRing>(bq, bk, q, k, v, dout, lse, delta, qpos, kpos, dk, dv,
                                        rows_kv, h, hkv, t, 1, st);
    case 1064: return dkv_tc<64, kRing>(bq, bk, q, k, v, dout, lse, delta, qpos, kpos, dk, dv,
                                        rows_kv, h, hkv, t, 1, st);
    case 1128: return dkv_tc<128, kRing>(bq, bk, q, k, v, dout, lse, delta, qpos, kpos, dk, dv,
                                         rows_kv, h, hkv, t, 1, st);
    default: return kBadArgs;
  }
}

}  // extern "C"
