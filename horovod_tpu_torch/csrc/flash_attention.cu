// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/flash_attention.py:
//   hvd_flash_fwd     <- _fwd_kernel  (online-softmax forward, O and L)
//   hvd_flash_bwd_dq  <- _dq_kernel   (dQ, recomputing p = exp(s - L))
//   hvd_flash_bwd_dkv <- _dkv_kernel  (dK and dV over every q tile of the
//                                      GQA group; no atomics)
//
// Each entry dispatches on the dtype. bfloat16 runs the tensor-core kernels
// of flash_tc.cuh (TMA, wgmma); float32 runs the kFlash variant of
// flash_kernels.cuh (float32 FMA).
// Both families keep one contract: no carries, causal masking by index, k
// tiles past the diagonal never visited; the headers describe the layout,
// the arithmetic and what bounds each.

#include "flash_kernels.cuh"
#include "flash_tc.cuh"

namespace {

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int rows, int h, int hkv, int t, int causal, cudaStream_t st) {
  Args a = make_args<D>(h, hkv, t, causal);
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.o = (float*)o;
  a.lse_out = (float*)lse;
  return launch(fwd_kernel<D, kFlash>, a, rows, fwd_smem<D>(), st);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int rows, int h,
              int hkv, int t, int causal, cudaStream_t st) {
  Args a = make_args<D>(h, hkv, t, causal);
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dq = (float*)dq;
  return launch(dq_kernel<D, kFlash>, a, rows, bwd_smem<D>(), st);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int rows_kv, int h, int hkv, int t, int causal, cudaStream_t st) {
  Args a = make_args<D>(h, hkv, t, causal);
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.dout = (const float*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  return launch(dkv_kernel<D, kFlash>, a, rows_kv, bwd_smem<D>(), st);
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream`, which belongs to the
// calling thread's current device (the wrappers make the inputs' device
// current around the call), and returns cudaGetLastError() (0 on
// success), 1000 for arguments no kernel takes, a tile pair (bq, bk) not
// built among them, or 1001 when a tensor map of the bf16 kernels does not
// encode. None of these falls back to another kernel. (bq, bk) are the
// kernel's q and k extents: for dK/dV, q rows per tile and k rows per
// block. The float32 kernels take (kTile, kTile) alone; the bf16 ones the
// pairs of flash_tc.cuh's fwd_tc, dq_tc and dkv_tc.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int rows, int h, int hkv, int t, int d,
                  int causal, int dtype, int bq, int bk, void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  if (dtype == 0 && (bq != kTile || bk != kTile)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 1000 + d) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, rows, h, hkv, t, causal, st);
    case 64: return launch_fwd<64>(q, k, v, o, lse, rows, h, hkv, t, causal, st);
    case 128: return launch_fwd<128>(q, k, v, o, lse, rows, h, hkv, t, causal, st);
    case 1032: return fwd_tc<32, kFlash>(bq, bk, q, k, v, o, lse, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, rows, h, hkv, t, causal, st);
    case 1064: return fwd_tc<64, kFlash>(bq, bk, q, k, v, o, lse, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, rows, h, hkv, t, causal, st);
    case 1128: return fwd_tc<128, kFlash>(bq, bk, q, k, v, o, lse, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, rows, h, hkv, t, causal, st);
    default: return kBadArgs;
  }
}

int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int rows, int h, int hkv, int t, int d,
                     int causal, int dtype, int bq, int bk, void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  if (dtype == 0 && (bq != kTile || bk != kTile)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 1000 + d) {
    case 32: return launch_dq<32>(q, k, v, dout, lse, delta, dq, rows, h, hkv, t, causal, st);
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, rows, h, hkv, t, causal, st);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, rows, h, hkv, t, causal, st);
    case 1032: return dq_tc<32, kFlash>(bq, bk, q, k, v, dout, lse, delta, nullptr, nullptr, dq,
                                        rows, h, hkv, t, causal, st);
    case 1064: return dq_tc<64, kFlash>(bq, bk, q, k, v, dout, lse, delta, nullptr, nullptr, dq,
                                        rows, h, hkv, t, causal, st);
    case 1128: return dq_tc<128, kFlash>(bq, bk, q, k, v, dout, lse, delta, nullptr, nullptr, dq,
                                         rows, h, hkv, t, causal, st);
    default: return kBadArgs;
  }
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int rows_kv, int h, int hkv, int t,
                      int d, int causal, int dtype, int bq, int bk, void* stream) {
  if (bad_kv_shape(rows_kv, h, hkv, t)) return kBadArgs;
  if (dtype == 0 && (bq != kTile || bk != kTile)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype * 1000 + d) {
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, rows_kv, h, hkv, t,
                          causal, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, rows_kv, h, hkv, t,
                          causal, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, rows_kv, h, hkv, t,
                          causal, st);
    case 1032: return dkv_tc<32, kFlash>(bq, bk, q, k, v, dout, lse, delta, nullptr, nullptr,
                                         dk, dv, rows_kv, h, hkv, t, causal, st);
    case 1064: return dkv_tc<64, kFlash>(bq, bk, q, k, v, dout, lse, delta, nullptr, nullptr,
                                         dk, dv, rows_kv, h, hkv, t, causal, st);
    case 1128: return dkv_tc<128, kFlash>(bq, bk, q, k, v, dout, lse, delta, nullptr, nullptr,
                                          dk, dv, rows_kv, h, hkv, t, causal, st);
    default: return kBadArgs;
  }
}

}  // extern "C"
