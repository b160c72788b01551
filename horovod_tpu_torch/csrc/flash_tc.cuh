// Flash attention on Hopper's tensor cores: the bf16 forward (B1) and
// dK/dV (B3) of the kFlash variant, built from hopper.cuh.
//
// Replace, for bf16 inputs, the FMA kernels of flash_kernels.cuh:
//   fwd_tc_kernel <- horovod_tpu/ops/flash_attention.py _fwd_kernel
//   dkv_tc_kernel <- horovod_tpu/ops/flash_attention.py _dkv_kernel
// with the same contract: the rows layout (B*H, T, D), GQA through the kv
// row (r / H) * Hkv + (r % H) / group and its inverse, scale D^-0.5,
// masked logits -1e30 with probabilities exactly 0, L = m + ln l in
// natural-log units (B2, B5 and B6 read it), one block per output tile and
// no atomics, so results repeat run to run.
//
// What bounds them: at the training shape (T = 4096, D = 128) attention is
// compute-bound, and the bound is the tensor cores' 989 bf16 TFLOP/s. So
// every product is a wgmma with float32 accumulators:
//   forward  S = Q.K^T (SS), O += P.V (RS, V MN-major);
//   dK/dV    S^T = K.Q^T and dP^T = V.dO^T (SS), dV += P^T.dO and
//            dK += dS^T.Q (RS, dO and Q MN-major).
// The RS products take P, P^T and dS^T straight from the accumulator
// registers of the product before: the float32 accumulator fragment of
// m64nNk16, packed to bf16x2, is the A fragment of the next wgmma, so no
// probability goes through shared memory. Each of the three is split into
// a bf16 hi and a bf16 lo fragment (hopper::split_bf16), two RS wgmmas into
// one accumulator: rounding them to bf16 alone errs by up to 2^-8 of each
// term, which in a row of dK where a few large terms cancel breaks the
// element-wise bf16 rule against the float32 contract; the split errs by
// 2^-16. It costs the forward 3 products instead of 2 and dK/dV 6 instead
// of 4. Everything else (the online softmax, l from the float32 P, L,
// delta, the accumulators) stays float32.
//
// Each block runs a producer warpgroup and two consumer warpgroups of 64
// rows each. One producer warp keeps TMA loads of the next tiles in flight
// through a two-stage ring of bf16 tiles with the 128-byte swizzle
// (64-byte at D = 32) while the consumers compute; setmaxnreg moves
// registers from the producer to them. In the forward the two consumer
// warpgroups take turns on the tensor cores, so one's softmax runs under
// the other's products. A 3-D tensor map over (rows, T, D) zero-fills past T, so a
// ragged tile never reads the next row; masks apply only on diagonal and
// ragged tiles. Shared memory at D = 128: forward Q 32 KB + 2 x (K 32 KB +
// V 32 KB), dK/dV K and V 64 KB + 2 x (Q 16 KB + dO 16 KB + L and delta),
// one block per SM each.
//
// Float32 inputs keep the FMA kernels: Hopper's tensor cores have no
// float32 product, and TF32 (10 mantissa bits) would break the 1e-4
// float32 checks that the JAX kernels' float32 arithmetic sets.

#pragma once

#include <cuda_bf16.h>

#include "flash_kernels.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Warps 0-7: two consumer warpgroups; warps 8-11: the producer warpgroup,
// of which warp 8 issues every load. setmaxnreg works per warpgroup, so
// the producer is a whole one: 128 x 24 + 256 x 240 registers are the
// 3 x 128 x 168 that the block starts with.
constexpr int kTcThreads = 384;
constexpr int kProducerWarp = 8;
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;
constexpr int kFwdQ = 128;         // forward: q rows per block (64 per warpgroup)
constexpr int kFwdK = 128;         // forward: k rows per tile
constexpr int kDkvK = 128;         // dK/dV: k rows per block (64 per warpgroup)
constexpr int kDkvQ = 64;          // dK/dV: q rows per tile
constexpr int kMapFailed = 1001;   // returned when a tensor map does not encode
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  alignas(1024) bf16 q[kFwdQ * D];
  alignas(1024) bf16 k[kStages][kFwdK * D];
  alignas(1024) bf16 v[kStages][kFwdK * D];
  hopper::Ring<kStages> ring;      // full: K arrived; empty: K and V free
  uint64_t v_full[kStages];
  uint64_t q_full;
};

template <int D>
struct DkvSmem {
  alignas(1024) bf16 k[kDkvK * D];
  alignas(1024) bf16 v[kDkvK * D];
  alignas(1024) bf16 q[kStages][kDkvQ * D];
  alignas(1024) bf16 dout[kStages][kDkvQ * D];
  alignas(128) float lse[kStages][kDkvQ];    // 0 past t
  alignas(128) float delta[kStages][kDkvQ];
  hopper::Ring<kStages> ring;      // full: Q, dO, L, delta arrived
  uint64_t kv_full;
};

template <typename S>
__device__ __forceinline__ S& smem_as(uint8_t* raw) {
  const uintptr_t p = ((uintptr_t)raw + 1023) & ~(uintptr_t)1023;
  return *reinterpret_cast<S*>(p);
}

template <typename S> constexpr size_t smem_bytes() { return sizeof(S) + 1024; }

__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
}

// Max over the four threads that share a row of an accumulator.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ forward
// Grid (B*H, q tiles): block (r, y) owns q rows [q0, q0 + 128) of row r,
// the heaviest causal tiles first; warpgroup w owns rows q0 + 64w + [0, 64).
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, bf16* o, float* lse,
              int h, int hkv, int t, int causal, float scale_log2) {
  extern __shared__ uint8_t tc_smem[];
  FwdSmem<D>& sm = smem_as<FwdSmem<D>>(tc_smem);
  const int nt = (t + kFwdQ - 1) / kFwdQ;
  const int q0 = (nt - 1 - (int)blockIdx.y) * kFwdQ;
  const int r = blockIdx.x;
  const int rkv = (r / h) * hkv + (r % h) / (h / hkv);
  // Causal by index: the last live key of this tile is min(q0 + 128, t) - 1.
  const int kend = causal ? (min(q0 + kFwdQ, t) - 1) / kFwdK + 1 : (t + kFwdK - 1) / kFwdK;
  const int warp = warp_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm.ring.init(1, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) hopper::bar_init(&sm.v_full[s], 1);
    hopper::bar_init(&sm.q_full, 1);
    hopper::fence_bar_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    hopper::regs_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      hopper::arrive_expect(&sm.q_full, hopper::tile_bytes<kFwdQ, D>());
      hopper::load_tile<kFwdQ, D>(sm.q, &qmap, &sm.q_full, q0, r);
      hopper::Cursor c;
      bool ok = true;
      for (int ki = 0; ki < kend; ++ki) {
        const int s = c.stage;
        ok &= hopper::wait(&sm.ring.empty[s], c.phase ^ 1);
        hopper::arrive_expect(&sm.ring.full[s], hopper::tile_bytes<kFwdK, D>());
        hopper::load_tile<kFwdK, D>(sm.k[s], &kmap, &sm.ring.full[s], ki * kFwdK, rkv);
        hopper::arrive_expect(&sm.v_full[s], hopper::tile_bytes<kFwdK, D>());
        hopper::load_tile<kFwdK, D>(sm.v[s], &vmap, &sm.v_full[s], ki * kFwdK, rkv);
        c.next<kStages>();
      }
      hopper::trap_unless(ok);
    }
  } else {
    hopper::regs_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;                       // first row of the warpgroup
    const int row = wq0 + 16 * (warp % 4) + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);
    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units

    const uint64_t qd = hopper::desc_k<kFwdQ, D>(sm.q, 64 * wg);
    float sacc[kFwdK / 2];                              // S of the next tile
    uint32_t phi[kFwdK / 16][4], plo[kFwdK / 16][4];    // its P, split
    float alpha[2];
    // S = Q.K^T of the tile in stage s, into sacc.
    auto issue_s = [&](int s) {
      const uint64_t kd = hopper::desc_k<kFwdK, D>(sm.k[s], 0);
      hopper::static_for<0, D / 16>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        hopper::Wgmma<kFwdK>::ss<0, hopper::k_step<kFwdQ, D>(K), hopper::k_step<kFwdK, D>(K)>(
            sacc, qd, kd, K > 0);
      });
    };
    // The online softmax of the tile at k0 from sacc: alpha, the new m and
    // l, and P in float32 for l, then split into bf16 hi and lo A fragments
    // of P.V (columns [16kk, 16kk + 16) are n-blocks 2kk and 2kk + 1).
    auto softmax = [&](int k0) {
      if ((causal && k0 + kFwdK - 1 > wq0) || k0 + kFwdK > t) {
#pragma unroll
        for (int j = 0; j < kFwdK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = k0 + 8 * j + col + (e & 1), qr = row + 8 * (e >> 1);
            if (!(kc < t && (!causal || qr >= kc))) sacc[4 * j + e] = kNegInf;
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kFwdK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < kFwdK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = exp2f(fmaf(sacc[4 * j + e], scale_log2, -m[e >> 1]));
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        hopper::split_bf16(p[0], p[1], phi[j / 2][(j % 2) * 2], plo[j / 2][(j % 2) * 2]);
        hopper::split_bf16(p[2], p[3], phi[j / 2][(j % 2) * 2 + 1], plo[j / 2][(j % 2) * 2 + 1]);
      }
    };

    // The two warpgroups take turns on the tensor cores (named barriers
    // 1 + wg): a turn issues P.V of tile ki and S of tile ki + 1 back to
    // back, then hands over, and the softmax of tile ki + 1 runs while the
    // other warpgroup's products do. Warpgroup 0 goes first; each barrier
    // sees one arrival per sync, so warpgroup 1 skips its last hand-over.
    if (wg == 1) hopper::turn_pass(1);
    hopper::Cursor c;
    bool ok = hopper::wait(&sm.q_full, 0);
    hopper::turn_take(1 + wg);
    ok &= hopper::wait(&sm.ring.full[c.stage], c.phase);
    hopper::wgmma_fence();
    issue_s(c.stage);
    hopper::wgmma_commit();
    hopper::turn_pass(2 - wg);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    softmax(0);
    for (int ki = 0; ki < kend; ++ki) {
      const int s = c.stage;
      const bool more = ki + 1 < kend;
      hopper::Cursor n = c;
      n.next<kStages>();
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= alpha[0];
        oacc[4 * j + 1] *= alpha[0];
        oacc[4 * j + 2] *= alpha[1];
        oacc[4 * j + 3] *= alpha[1];
      }
      const uint64_t vd = hopper::desc_mn<kFwdK, D>(sm.v[s]);
      hopper::turn_take(1 + wg);
      ok &= hopper::wait(&sm.v_full[s], c.phase);
      hopper::wgmma_fence();
      hopper::static_for<0, kFwdK / 16>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(oacc, phi[K], vd, 1);
        hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(oacc, plo[K], vd, 1);
      });
      if (more) {
        ok &= hopper::wait(&sm.ring.full[n.stage], n.phase);
        issue_s(n.stage);
      }
      hopper::wgmma_commit();
      if (more || wg == 0) hopper::turn_pass(2 - wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      hopper::fence_regs(sacc);
      hopper::fence_regs(phi);
      hopper::fence_regs(plo);
      if (lane == 0) hopper::arrive(&sm.ring.empty[s]);
      c = n;
      if (more) softmax((ki + 1) * kFwdK);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = row + 8 * i;
      const float lsum = quad_sum(l[i]);
      if (qr < t) {
        const float inv = 1.f / lsum;
        bf16* orow = o + ((size_t)r * t + qr) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
              hopper::pack_bf16(oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
        if (lane % 4 == 0) lse[(size_t)r * t + qr] = m[i] * kLn2 + logf(lsum);
      }
    }
    hopper::trap_unless(ok);
  }
}

// ------------------------------------------------------------ backward dK/dV
// Grid (B*Hkv, k tiles): block (rk, ki) owns k rows [k0, k0 + 128) of kv
// row rk, warpgroup w rows k0 + 64w + [0, 64), and walks (g, q tile of 64)
// over the GQA group from the diagonal on, as _dkv_kernel's innermost grid
// dimension does; k tile 0 sees every q tile, so it goes first. A
// warpgroup whose rows see none of a q tile skips its products.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap lmap,
              const __grid_constant__ CUtensorMap emap, bf16* dk, bf16* dv,
              int h, int hkv, int t, int causal, float scale, float scale_log2) {
  extern __shared__ uint8_t tc_smem[];
  DkvSmem<D>& sm = smem_as<DkvSmem<D>>(tc_smem);
  const int nq = (t + kDkvQ - 1) / kDkvQ;
  const int k0 = blockIdx.y * kDkvK;
  const int rk = blockIdx.x;
  const int group = h / hkv;
  // Causal by index: the first q tile whose rows can see this k tile.
  const int qstart = causal ? k0 / kDkvQ : 0;
  const int warp = warp_index(), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm.ring.init(1, kConsumerWarps);
    hopper::bar_init(&sm.kv_full, 1);
    hopper::fence_bar_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    hopper::regs_dec<kProducerRegs>();
    if (warp == kProducerWarp && lane == 0) {
      hopper::arrive_expect(&sm.kv_full, 2 * hopper::tile_bytes<kDkvK, D>());
      hopper::load_tile<kDkvK, D>(sm.k, &kmap, &sm.kv_full, k0, rk);
      hopper::load_tile<kDkvK, D>(sm.v, &vmap, &sm.kv_full, k0, rk);
      hopper::Cursor c;
      bool ok = true;
      for (int g = 0; g < group; ++g) {
        const int rq = (rk / hkv) * h + (rk % hkv) * group + g;
        for (int qi = qstart; qi < nq; ++qi) {
          const int s = c.stage, q0 = qi * kDkvQ;
          ok &= hopper::wait(&sm.ring.empty[s], c.phase ^ 1);
          hopper::arrive_expect(&sm.ring.full[s],
                                2 * hopper::tile_bytes<kDkvQ, D>() + 2 * kDkvQ * 4);
          hopper::load_tile<kDkvQ, D>(sm.q[s], &qmap, &sm.ring.full[s], q0, rq);
          hopper::load_tile<kDkvQ, D>(sm.dout[s], &dmap, &sm.ring.full[s], q0, rq);
          hopper::tma_load_2d(sm.lse[s], &lmap, &sm.ring.full[s], q0, rq);
          hopper::tma_load_2d(sm.delta[s], &emap, &sm.ring.full[s], q0, rq);
          c.next<kStages>();
        }
      }
      hopper::trap_unless(ok);
    }
  } else {
    hopper::regs_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int wk0 = k0 + 64 * wg;                        // first k row of the warpgroup
    const int krow = wk0 + 16 * (warp % 4) + lane / 4;   // and krow + 8
    const int col = 2 * (lane % 4);
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    const uint64_t kd = hopper::desc_k<kDkvK, D>(sm.k, 64 * wg);
    const uint64_t vd = hopper::desc_k<kDkvK, D>(sm.v, 64 * wg);
    bool ok = hopper::wait(&sm.kv_full, 0);
    hopper::Cursor c;
    for (int g = 0; g < group; ++g) {
      for (int qi = qstart; qi < nq; ++qi) {
        const int s = c.stage, q0 = qi * kDkvQ;
        ok &= hopper::wait(&sm.ring.full[s], c.phase);
        if (!((causal && q0 + kDkvQ - 1 < wk0) || wk0 >= t)) {
          float st[kDkvQ / 2], dpt[kDkvQ / 2];   // S^T and dP^T: 64 k rows x kDkvQ q columns
          const uint64_t qd = hopper::desc_k<kDkvQ, D>(sm.q[s], 0);
          const uint64_t dd = hopper::desc_k<kDkvQ, D>(sm.dout[s], 0);
          hopper::wgmma_fence();
          hopper::static_for<0, D / 16>([&](auto kk) {
            constexpr int K = decltype(kk)::value;
            constexpr int A = hopper::k_step<kDkvK, D>(K), B = hopper::k_step<kDkvQ, D>(K);
            hopper::Wgmma<kDkvQ>::ss<0, A, B>(st, kd, qd, K > 0);
            hopper::Wgmma<kDkvQ>::ss<0, A, B>(dpt, vd, dd, K > 0);
          });
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);

          const bool mask = (causal && q0 < wk0 + 63) || q0 + kDkvQ > t || wk0 + 64 > t;
          // P^T and dS^T, each split into bf16 hi and lo A fragments.
          uint32_t phi[kDkvQ / 16][4], plo[kDkvQ / 16][4], dhi[kDkvQ / 16][4], dlo[kDkvQ / 16][4];
#pragma unroll
          for (int j = 0; j < kDkvQ / 8; ++j) {
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + col + (e & 1), kr = krow + 8 * (e >> 1);
              float pe = exp2f(fmaf(st[4 * j + e], scale_log2, -sm.lse[s][qc] * kLog2e));
              if (mask && !(q0 + qc < t && kr < t && (!causal || q0 + qc >= kr))) pe = 0.f;
              p[e] = pe;
              ds[e] = pe * (dpt[4 * j + e] - sm.delta[s][qc]);
            }
            const int f = j / 2, x = (j % 2) * 2;
            hopper::split_bf16(p[0], p[1], phi[f][x], plo[f][x]);
            hopper::split_bf16(p[2], p[3], phi[f][x + 1], plo[f][x + 1]);
            hopper::split_bf16(ds[0], ds[1], dhi[f][x], dlo[f][x]);
            hopper::split_bf16(ds[2], ds[3], dhi[f][x + 1], dlo[f][x + 1]);
          }
          const uint64_t qm = hopper::desc_mn<kDkvQ, D>(sm.q[s]);
          const uint64_t dm = hopper::desc_mn<kDkvQ, D>(sm.dout[s]);
          hopper::wgmma_fence();
          hopper::static_for<0, kDkvQ / 16>([&](auto kk) {
            constexpr int K = decltype(kk)::value;
            hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(dva, phi[K], dm, 1);
            hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(dka, dhi[K], qm, 1);
            hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(dva, plo[K], dm, 1);
            hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(dka, dlo[K], qm, 1);
          });
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(dva);
          hopper::fence_regs(dka);
          hopper::fence_regs(phi);
          hopper::fence_regs(plo);
          hopper::fence_regs(dhi);
          hopper::fence_regs(dlo);
        }
        if (lane == 0) hopper::arrive(&sm.ring.empty[s]);
        c.next<kStages>();
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = krow + 8 * i;
      if (kr < t) {
        const size_t at = ((size_t)rk * t + kr) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int e = 4 * j + 2 * i;
          *reinterpret_cast<uint32_t*>(dk + at + 8 * j + col) =
              hopper::pack_bf16(dka[e] * scale, dka[e + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at + 8 * j + col) =
              hopper::pack_bf16(dva[e], dva[e + 1]);
        }
      }
    }
    hopper::trap_unless(ok);
  }
}

// --------------------------------------------------------------- launches

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  void* lse, int rows, int h, int hkv, int t, int causal,
                  cudaStream_t st) {
  const int rows_kv = rows / h * hkv;
  CUtensorMap qm, km, vm;
  if (hopper::make_map(&qm, q, rows, t, D, kFwdQ) ||
      hopper::make_map(&km, k, rows_kv, t, D, kFwdK) ||
      hopper::make_map(&vm, v, rows_kv, t, D, kFwdK))
    return kMapFailed;
  constexpr size_t smem = smem_bytes<FwdSmem<D>>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, (t + kFwdQ - 1) / kFwdQ);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  fwd_tc_kernel<D><<<grid, kTcThreads, smem, st>>>(
      qm, km, vm, (bf16*)o, (float*)lse, h, hkv, t, causal, scale_log2);
  return cudaGetLastError();
}

// lse and delta: (rows, t) float32 with rows ld = t rounded up to 4 apart,
// which TMA needs (the wrapper pads them when t % 4).
template <int D>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int rows_kv, int h, int hkv, int t,
                  int causal, cudaStream_t st) {
  const int rows = rows_kv / hkv * h, ld = (t + 3) / 4 * 4;
  CUtensorMap qm, km, vm, dm, lm, em;
  if (hopper::make_map(&qm, q, rows, t, D, kDkvQ) ||
      hopper::make_map(&dm, dout, rows, t, D, kDkvQ) ||
      hopper::make_map(&km, k, rows_kv, t, D, kDkvK) ||
      hopper::make_map(&vm, v, rows_kv, t, D, kDkvK) ||
      hopper::make_vec_map(&lm, lse, rows, t, ld, kDkvQ) ||
      hopper::make_vec_map(&em, delta, rows, t, ld, kDkvQ))
    return kMapFailed;
  constexpr size_t smem = smem_bytes<DkvSmem<D>>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows_kv, (t + kDkvK - 1) / kDkvK);
  dkv_tc_kernel<D><<<grid, kTcThreads, smem, st>>>(
      qm, km, vm, dm, lm, em, (bf16*)dk, (bf16*)dv, h, hkv, t, causal, 1.0f / sqrtf((float)D),
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace
