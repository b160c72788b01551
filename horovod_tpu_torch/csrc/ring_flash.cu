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
// The kernels are the kRing variant of flash_kernels.cuh: float32 carries
// read and written back in place (one block per carry tile, no atomics),
// and causal masking by the global positions qpos[i] >= kpos[j], so one
// kernel serves the contiguous and the zigzag layouts. Every tile pair is
// visited and a pair with max(qpos) < min(kpos) is skipped; a ring step
// with every pair masked is skipped by the caller before any launch. The
// header describes the layout, the arithmetic and what bounds them.
//
// Positions are one int32 vector (t,) each for q and k; m and l are
// (B*H, t) float32 (the TPU's (B*H, 8, t), (8, t) and (t, 128) replicated
// layouts are not kept).

#include "flash_kernels.cuh"

namespace {

template <typename T, int D>
int ring_fwd(const void* q, const void* k, const void* v, void* acc, void* m,
             void* l, const void* qpos, const void* kpos, int rows, int h,
             int hkv, int t, cudaStream_t st) {
  Args<T> a = make_args<T, D>(h, hkv, t, 1);
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.acc = (float*)acc;
  a.m = (float*)m;
  a.l = (float*)l;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  return launch<T>(fwd_kernel<T, D, kRing>, a, rows, fwd_smem<D>(), st);
}

template <typename T, int D>
int ring_dq(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, const void* qpos,
            const void* kpos, void* dq, int rows, int h, int hkv, int t,
            cudaStream_t st) {
  Args<T> a = make_args<T, D>(h, hkv, t, 1);
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.dout = (const T*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  a.dq_c = (float*)dq;
  return launch<T>(dq_kernel<T, D, kRing>, a, rows, bwd_smem<D>(), st);
}

template <typename T, int D>
int ring_dkv(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* qpos,
             const void* kpos, void* dk, void* dv, int rows_kv, int h, int hkv,
             int t, cudaStream_t st) {
  Args<T> a = make_args<T, D>(h, hkv, t, 1);
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.dout = (const T*)dout;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  a.dk_c = (float*)dk;
  a.dv_c = (float*)dv;
  return launch<T>(dkv_kernel<T, D, kRing>, a, rows_kv, bwd_smem<D>(), st);
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` (of the calling thread's
// current device) and returns cudaGetLastError() (0 on success), or 1000
// for arguments no kernel takes. Carries (acc, m, l, dq, dk, dv) are
// float32 and updated in place; qpos and kpos are int32 (t,).
int hvd_ring_flash_fwd(const void* q, const void* k, const void* v, void* acc,
                       void* m, void* l, const void* qpos, const void* kpos,
                       int rows, int h, int hkv, int t, int d, int dtype,
                       void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(ring_fwd, q, k, v, acc, m, l, qpos, kpos, rows, h, hkv, t, st)
}

int hvd_ring_flash_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* qpos, const void* kpos, void* dq, int rows,
                      int h, int hkv, int t, int d, int dtype, void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(ring_dq, q, k, v, dout, lse, delta, qpos, kpos, dq, rows, h,
               hkv, t, st)
}

int hvd_ring_flash_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* qpos, const void* kpos, void* dk, void* dv,
                       int rows_kv, int h, int hkv, int t, int d, int dtype,
                       void* stream) {
  if (bad_kv_shape(rows_kv, h, hkv, t)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(ring_dkv, q, k, v, dout, lse, delta, qpos, kpos, dk, dv,
               rows_kv, h, hkv, t, st)
}

}  // extern "C"
