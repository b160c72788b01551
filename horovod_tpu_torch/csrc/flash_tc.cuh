// Flash attention on Hopper's tensor cores: the bf16 forward (B1), dQ (B2)
// and dK/dV (B3) of the kFlash variant, and one ring step's forward (B4),
// dQ (B5) and dK/dV (B6), the kRing variants of the same three kernels,
// built from hopper.cuh.
//
// Replace, for bf16 inputs, the FMA kernels of flash_kernels.cuh:
//   fwd_tc_kernel<D, kFlash> <- horovod_tpu/ops/flash_attention.py _fwd_kernel
//   dq_tc_kernel<D, kFlash>  <- horovod_tpu/ops/flash_attention.py _dq_kernel
//   dkv_tc_kernel<D, kFlash> <- horovod_tpu/ops/flash_attention.py _dkv_kernel
//   fwd_tc_kernel<D, kRing>  <- horovod_tpu/ops/ring_flash.py _rf_fwd_kernel
//   dq_tc_kernel<D, kRing>   <- horovod_tpu/ops/ring_flash.py _rf_dq_kernel
//   dkv_tc_kernel<D, kRing>  <- horovod_tpu/ops/ring_flash.py _rf_dkv_kernel
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
//   dQ       S = Q.K^T and dP = dO.V^T (SS), dQ += dS.K (RS, K MN-major);
//   dK/dV    S^T = K.Q^T and dP^T = V.dO^T (SS), dV += P^T.dO and
//            dK += dS^T.Q (RS, dO and Q MN-major).
// The RS products take P, dS, P^T and dS^T straight from the accumulator
// registers of the product before: the float32 accumulator fragment of
// m64nNk16, packed to bf16x2, is the A fragment of the next wgmma, so no
// probability goes through shared memory. Each is split into a bf16 hi
// and a bf16 lo fragment (hopper::split_bf16), two RS wgmmas into one
// accumulator: rounding them to bf16 alone errs by up to 2^-8 of each
// term, which in a row of dK where a few large terms cancel breaks the
// element-wise bf16 rule against the float32 contract; the split errs by
// 2^-16. It costs the forward 3 products instead of 2, dQ 4 instead of 3
// and dK/dV 6 instead of 4. Everything else (the online softmax, l from
// the float32 P, L, delta, the accumulators) stays float32.
//
// Each block runs a producer warpgroup and one or two consumer warpgroups
// of 64 rows each: its tiles (q extent, k extent) are template arguments,
// 64 or 128 rows a side (HVD_*_PAIRS below list the pairs built). One
// producer warp keeps TMA loads of the next tiles in flight through a
// two-stage ring of bf16 tiles with the 128-byte swizzle (64-byte at
// D = 32) while the consumers compute; with two consumer warpgroups
// setmaxnreg moves registers from the producer to them. In the forward two
// consumer warpgroups take turns on the tensor cores, so one's softmax
// runs under the other's products. A 3-D tensor map over (rows, T, D)
// zero-fills past T, so a ragged tile never reads the next row; masks
// apply only on diagonal and ragged tiles, wherever the q and k extents
// put them. Shared memory at D = 128 and the default tiles: forward Q
// 32 KB + 2 x (K 32 KB + V 32 KB), dQ Q and dO 64 KB + 2 x (K 16 KB + V
// 16 KB), dK/dV K and V 64 KB + 2 x (Q 16 KB + dO 16 KB + L and delta),
// one block per SM each; the largest pair, dQ 64/128, takes 32 KB + 2 x
// 64 KB.
//
// The kRing variants take the two options of flash_kernels.cuh: their
// epilogues add into float32 carries instead of writing bf16 (kCarry: the
// forward reads the unnormalized (acc, m, l) in its prologue and writes
// them back; dQ adds dQ * scale, dK/dV dK * scale and dV), and their
// causal mask is qpos[q] >= kpos[k] (kPositions). The positions of the
// tile that passes through the ring come with it, by TMA (k positions in
// the forward and dQ, q positions in dK/dV; zero past t, so the masks
// also test the index against t); those of the rows a block keeps stay in
// each consumer thread's registers. A tile whose positions put it wholly
// after (dK/dV: before) the block's is skipped by the producer (no load)
// and by the consumers (no wait) alike: both decide from the same
// positions in device memory with the same warp reductions, so the ring's
// phases stay in step, and in the forward both warpgroups take the same
// number of turns. A warpgroup whose 64 rows see none of a live tile
// issues no product (it still waits, takes its turn and frees the stage),
// and masks apply only where the warpgroup's positions and the tile's
// overlap or a tile is ragged. A zigzag shard is not contiguous in
// position, so none of this reads an index as a position. A block with no
// live tile loads nothing and leaves its carries bit-identical.
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

// A block whose outer extent (q rows for the forward and dQ, k rows for
// dK/dV) is R rows runs R / 64 consumer warpgroups, 64 rows each (a wgmma's
// M), and one producer warpgroup after them, of which its first warp
// issues every load. At R = 128 setmaxnreg moves registers from the
// producer to the consumers: 128 x 24 + 256 x 240 registers are the
// 3 x 128 x 168 that the block starts with. At R = 64 the block has 256
// threads and each may keep 255 registers from the start, so no
// warpgroup changes its budget.
template <int R> __host__ __device__ constexpr int consumer_groups() { return R / 64; }
template <int R> __host__ __device__ constexpr int tc_threads() {
  return 128 * (consumer_groups<R>() + 1);
}
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;
// Each kernel's tiles are template arguments (q extent, k extent): the
// outer extent is a block's rows, the inner one the rows of a tile that
// passes through the ring per stage. The defaults below are the pairs that
// every head dim is built for; flash_attention.cu and ring_flash.cu build
// the others of kTilePairs at kTileD alone.
constexpr int kFwdQ = 128;         // forward: q rows per block
constexpr int kFwdK = 128;         // forward: k rows per tile
constexpr int kDqQ = 128;          // dQ: q rows per block
constexpr int kDqK = 64;           // dQ: k rows per tile
constexpr int kDkvQ = 64;          // dK/dV: q rows per tile
constexpr int kDkvK = 128;         // dK/dV: k rows per block
constexpr int kTileD = 128;        // the head dim the other pairs are built for
constexpr int kMapFailed = 1001;   // returned when a tensor map does not encode
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D, int BQ, int BK>
struct FwdSmem {
  alignas(1024) bf16 q[BQ * D];
  alignas(1024) bf16 k[kStages][BK * D];
  alignas(1024) bf16 v[kStages][BK * D];
  hopper::Ring<kStages> ring;      // full: K (and kpos) arrived; empty: K and V free
  uint64_t v_full[kStages];
  uint64_t q_full;
};

template <int D, int BQ, int BK>
struct DqSmem {
  alignas(1024) bf16 q[BQ * D];
  alignas(1024) bf16 dout[BQ * D];
  alignas(1024) bf16 k[kStages][BK * D];
  alignas(1024) bf16 v[kStages][BK * D];
  hopper::Ring<kStages> ring;      // full: K and V (and kpos) arrived; empty: free
  uint64_t qd_full;
};

template <int D, int BQ, int BK>
struct DkvSmem {
  alignas(1024) bf16 k[BK * D];
  alignas(1024) bf16 v[BK * D];
  alignas(1024) bf16 q[kStages][BQ * D];
  alignas(1024) bf16 dout[kStages][BQ * D];
  alignas(128) float lse[kStages][BQ];    // 0 past t
  alignas(128) float delta[kStages][BQ];
  hopper::Ring<kStages> ring;      // full: Q, dO, L, delta (and qpos) arrived
  uint64_t kv_full;
};

// kPositions: the positions of the tile that passes through the ring
// arrive with it (0 past t). The kFlash layouts stay the bases' own.
template <int D, int BQ, int BK>
struct RingFwdSmem : FwdSmem<D, BQ, BK> {
  alignas(128) int kpos[kStages][BK];
};
template <int D, int BQ, int BK>
struct RingDqSmem : DqSmem<D, BQ, BK> {
  alignas(128) int kpos[kStages][BK];
};
template <int D, int BQ, int BK>
struct RingDkvSmem : DkvSmem<D, BQ, BK> {
  alignas(128) int qpos[kStages][BQ];
};

template <int D, int V, int BQ, int BK>
using FwdSmemOf = std::conditional_t<(V & kPositions) != 0, RingFwdSmem<D, BQ, BK>,
                                     FwdSmem<D, BQ, BK>>;
template <int D, int V, int BQ, int BK>
using DqSmemOf = std::conditional_t<(V & kPositions) != 0, RingDqSmem<D, BQ, BK>,
                                    DqSmem<D, BQ, BK>>;
template <int D, int V, int BQ, int BK>
using DkvSmemOf = std::conditional_t<(V & kPositions) != 0, RingDkvSmem<D, BQ, BK>,
                                     DkvSmem<D, BQ, BK>>;

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

// Max (MAX) or min of positions [row0, row0 + R), R a multiple of 64, by
// every warp with shuffles (position()'s sentinels past t).
template <bool MAX, int R>
__device__ __forceinline__ int span_extreme(const int* pos, int row0, int t) {
  int x = tile_extreme<MAX>(pos, row0, t);
#pragma unroll
  for (int i = 64; i < R; i += 64) {
    const int y = tile_extreme<MAX>(pos, row0 + i, t);
    x = MAX ? max(x, y) : min(x, y);
  }
  return x;
}

// setmaxnreg, in blocks of two consumer warpgroups (see consumer_groups).
template <int NWG> __device__ __forceinline__ void producer_regs() {
  if constexpr (NWG > 1) hopper::regs_dec<kProducerRegs>();
}
template <int NWG> __device__ __forceinline__ void consumer_regs() {
  if constexpr (NWG > 1) hopper::regs_inc<kConsumerRegs>();
}

// ------------------------------------------------------------------ forward
// Grid (B*H, q tiles): block (r, y) owns q rows [q0, q0 + BQ) of row r,
// the heaviest causal tiles first; warpgroup w owns rows q0 + 64w + [0, 64).
// It walks k tiles of BK rows: kFlash up to the diagonal, writing O (bf16)
// and L; kRing every k tile whose min(kpos) reaches the block's max(qpos),
// on the carried (acc, m, l), writing them back unnormalized. With one
// consumer warpgroup (BQ = 64) there is no partner to take turns with.
template <int D, int V, int BQ, int BK>
__global__ void __launch_bounds__(tc_threads<BQ>(), 1)
fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap pmap,   // kPositions: kpos
              const int* qpos, const int* kpos, bf16* o, float* lse,
              float* acc, float* mc, float* lc,          // kCarry: (acc, m, l)
              int h, int hkv, int t, int causal, float scale_log2) {
  constexpr bool CARRY = V & kCarry, POSITIONS = V & kPositions;
  constexpr int NWG = consumer_groups<BQ>(), kProducerWarp = 4 * NWG;
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK == 64 || BK == 128, "a k tile is one wgmma's N");
  extern __shared__ uint8_t tc_smem[];
  FwdSmemOf<D, V, BQ, BK>& sm = smem_as<FwdSmemOf<D, V, BQ, BK>>(tc_smem);
  const int nt = (t + BQ - 1) / BQ;
  const int q0 = (nt - 1 - (int)blockIdx.y) * BQ;
  const int r = blockIdx.x;
  const int rkv = (r / h) * hkv + (r % h) / (h / hkv);
  // Causal by index: the last live key of this tile is min(q0 + BQ, t) - 1.
  const int kend = causal && !POSITIONS ? (min(q0 + BQ, t) - 1) / BK + 1
                                        : (t + BK - 1) / BK;
  const int warp = warp_index(), lane = threadIdx.x % 32;
  // kPositions: the greatest position of the block's BQ q rows, which
  // every warp reduces itself; a k tile whose least position is past it is
  // skipped. next_live(ki): the first tile from ki on that is not (kend if
  // none), the same for the producer and both warpgroups.
  int qmax = 0;
  if constexpr (POSITIONS) qmax = span_extreme<true, BQ>(qpos, q0, t);
  auto next_live = [&](int ki) {
    if constexpr (POSITIONS)
      while (ki < kend && span_extreme<false, BK>(kpos, ki * BK, t) > qmax) ++ki;
    return ki;
  };

  if (threadIdx.x == 0) {
    sm.ring.init(1, 4 * NWG);
    for (int s = 0; s < kStages; ++s) hopper::bar_init(&sm.v_full[s], 1);
    hopper::bar_init(&sm.q_full, 1);
    hopper::fence_bar_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    producer_regs<NWG>();
    // kPositions: the whole warp reduces each tile's positions; lane 0
    // issues the loads.
    if (warp == kProducerWarp && (POSITIONS || lane == 0)) {
      const bool issuer = lane == 0;
      int ki = next_live(0);
      if (issuer && ki < kend) {
        hopper::arrive_expect(&sm.q_full, hopper::tile_bytes<BQ, D>());
        hopper::load_tile<BQ, D>(sm.q, &qmap, &sm.q_full, q0, r);
      }
      hopper::Cursor c;
      bool ok = true;
      for (; ki < kend; ki = next_live(ki + 1)) {
        const int s = c.stage;
        if (issuer) {
          constexpr uint32_t pos_bytes = POSITIONS ? BK * 4 : 0;
          ok &= hopper::wait(&sm.ring.empty[s], c.phase ^ 1);
          hopper::arrive_expect(&sm.ring.full[s], hopper::tile_bytes<BK, D>() + pos_bytes);
          hopper::load_tile<BK, D>(sm.k[s], &kmap, &sm.ring.full[s], ki * BK, rkv);
          if constexpr (POSITIONS)
            hopper::tma_load_2d(sm.kpos[s], &pmap, &sm.ring.full[s], ki * BK, 0);
          hopper::arrive_expect(&sm.v_full[s], hopper::tile_bytes<BK, D>());
          hopper::load_tile<BK, D>(sm.v[s], &vmap, &sm.v_full[s], ki * BK, rkv);
        }
        c.next<kStages>();
      }
      hopper::trap_unless(ok);
    }
  } else {
    consumer_regs<NWG>();
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;                       // first row of the warpgroup
    const int row = wq0 + 16 * (warp % 4) + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);
    int ki = next_live(0);
    if (ki >= kend) return;   // kPositions: nothing live, the carries stay as they are
    // kPositions: the positions of the thread's two rows (INT_MIN past t),
    // and the least and greatest of the warpgroup's 64.
    int qp[2] = {}, wqmin = 0, wqmax = 0;
    if constexpr (POSITIONS) {
      qp[0] = position<true>(qpos, row, t);
      qp[1] = position<true>(qpos, row + 8, t);
      wqmin = tile_extreme<false>(qpos, wq0, t);
      wqmax = tile_extreme<true>(qpos, wq0, t);
    }
    // Whether the warpgroup's rows see any key of live tile ki.
    auto sees = [&](int ki) {
      if constexpr (POSITIONS) return wqmax >= span_extreme<false, BK>(kpos, ki * BK, t);
      return true;
    };
    // The running (acc, m, l) at the thread's fragment positions, m in
    // log2 units of the scaled logits. kCarry reads them from the carries
    // (natural units): l is a per-thread partial sum that the epilogue
    // reduces across the quad, so the carried l enters it once, in the
    // quad's first thread. Rows past t start at (0, -1e30, 0).
    float oacc[D / 2];
    float m[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = row + 8 * i;
      const size_t at = (size_t)r * t + qr;
      const bool in = CARRY && qr < t;
      m[i] = (in ? mc[at] : kNegInf) * (CARRY ? kLog2e : 1.f);
      l[i] = in && lane % 4 == 0 ? lc[at] : 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 a = in ? *reinterpret_cast<const float2*>(acc + at * D + 8 * j + col)
                            : make_float2(0.f, 0.f);
        oacc[4 * j + 2 * i] = a.x;
        oacc[4 * j + 2 * i + 1] = a.y;
      }
    }

    const uint64_t qd = hopper::desc_k<BQ, D>(sm.q, 64 * wg);
    float sacc[BK / 2];                              // S of the next tile
    uint32_t phi[BK / 16][4], plo[BK / 16][4];    // its P, split
    float alpha[2];
    // S = Q.K^T of the tile in stage s, into sacc.
    auto issue_s = [&](int s) {
      const uint64_t kd = hopper::desc_k<BK, D>(sm.k[s], 0);
      hopper::static_for<0, D / 16>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        hopper::Wgmma<BK>::template ss<0, hopper::k_step<BQ, D>(K), hopper::k_step<BK, D>(K)>(
            sacc, qd, kd, K > 0);
      });
    };
    // The online softmax of tile ki (in stage s) from sacc: alpha, the new
    // m and l, and P in float32 for l, then split into bf16 hi and lo A
    // fragments of P.V (columns [16kk, 16kk + 16) are n-blocks 2kk and
    // 2kk + 1). kPositions masks to -inf, so a row with no live key keeps
    // its m bit for bit, and pivots on 0 while its m is still the
    // sentinel (ring_flash.py's m_safe): alpha and its p underflow to 0.
    auto softmax = [&](int ki, int s) {
      const float kMasked = POSITIONS ? -INFINITY : kNegInf;
      const int k0 = ki * BK;
      bool mask;
      if constexpr (POSITIONS)
        mask = wqmin < span_extreme<true, BK>(kpos, k0, t) || k0 + BK > t;
      else
        mask = (causal && k0 + BK - 1 > wq0) || k0 + BK > t;
      if (mask) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = 8 * j + col + (e & 1), qr = row + 8 * (e >> 1);
            bool live;
            if constexpr (POSITIONS) live = k0 + kc < t && qp[e >> 1] >= sm.kpos[s][kc];
            else live = k0 + kc < t && (!causal || qr >= k0 + kc);
            if (!live) sacc[4 * j + e] = kMasked;
          }
      }
      float mx[2] = {kMasked, kMasked}, piv[2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
        piv[i] = POSITIONS && m_new <= kNegInf * 0.5f ? 0.f : m_new;
        alpha[i] = exp2f(m[i] - piv[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = exp2f(fmaf(sacc[4 * j + e], scale_log2, -piv[e >> 1]));
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
        hopper::split_bf16(p[0], p[1], phi[j / 2][(j % 2) * 2], plo[j / 2][(j % 2) * 2]);
        hopper::split_bf16(p[2], p[3], phi[j / 2][(j % 2) * 2 + 1], plo[j / 2][(j % 2) * 2 + 1]);
      }
    };

    // The two warpgroups take turns on the tensor cores (named barriers
    // 1 + wg): a turn issues P.V of tile ki and S of the next live tile
    // back to back, then hands over, and the softmax of that tile runs
    // while the other warpgroup's products do. Warpgroup 0 goes first;
    // each barrier sees one arrival per sync, so warpgroup 1 skips its last
    // hand-over. Both walk the same live tiles, so the turns pair up; a
    // warpgroup that sees none of a tile takes its turn and issues nothing.
    bool busy = sees(ki);
    if (NWG == 2 && wg == 1) hopper::turn_pass(1);
    hopper::Cursor c;
    bool ok = hopper::wait(&sm.q_full, 0);
    if constexpr (NWG == 2) hopper::turn_take(1 + wg);
    ok &= hopper::wait(&sm.ring.full[c.stage], c.phase);
    hopper::wgmma_fence();
    if (busy) issue_s(c.stage);
    hopper::wgmma_commit();
    if constexpr (NWG == 2) hopper::turn_pass(2 - wg);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    if (busy) softmax(ki, c.stage);
    while (ki < kend) {
      const int s = c.stage;
      const int next = next_live(ki + 1);
      const bool more = next < kend;
      const bool busy_next = more && sees(next);
      hopper::Cursor n = c;
      n.next<kStages>();
      if (busy) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          oacc[4 * j] *= alpha[0];
          oacc[4 * j + 1] *= alpha[0];
          oacc[4 * j + 2] *= alpha[1];
          oacc[4 * j + 3] *= alpha[1];
        }
      }
      const uint64_t vd = hopper::desc_mn<BK, D>(sm.v[s]);
      if constexpr (NWG == 2) hopper::turn_take(1 + wg);
      ok &= hopper::wait(&sm.v_full[s], c.phase);
      hopper::wgmma_fence();
      if (busy) {
        hopper::static_for<0, BK / 16>([&](auto kk) {
          constexpr int K = decltype(kk)::value;
          hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(oacc, phi[K], vd, 1);
          hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(oacc, plo[K], vd, 1);
        });
      }
      if (more) {
        ok &= hopper::wait(&sm.ring.full[n.stage], n.phase);
        if (busy_next) issue_s(n.stage);
      }
      hopper::wgmma_commit();
      if (NWG == 2 && (more || wg == 0)) hopper::turn_pass(2 - wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      hopper::fence_regs(sacc);
      hopper::fence_regs(phi);
      hopper::fence_regs(plo);
      if (lane == 0) hopper::arrive(&sm.ring.empty[s]);
      c = n;
      if (busy_next) softmax(next, n.stage);
      busy = busy_next;
      ki = next;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = row + 8 * i;
      const float lsum = quad_sum(l[i]);
      if (qr < t) {
        const size_t at = (size_t)r * t + qr;
        if constexpr (CARRY) {   // one block owns each carry tile: no atomics
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(acc + at * D + 8 * j + col) =
                make_float2(oacc[4 * j + 2 * i], oacc[4 * j + 2 * i + 1]);
          if (lane % 4 == 0) {
            // m back in natural units; a row whose max did not move keeps
            // its carry's bits (-1e30 exactly while it has no live key).
            const float m0 = mc[at];
            if (m[i] != m0 * kLog2e) mc[at] = m[i] * kLn2;
            lc[at] = lsum;
          }
        } else {
          const float inv = 1.f / lsum;
          bf16* orow = o + at * D;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<uint32_t*>(orow + 8 * j + col) =
                hopper::pack_bf16(oacc[4 * j + 2 * i] * inv, oacc[4 * j + 2 * i + 1] * inv);
          if (lane % 4 == 0) lse[at] = m[i] * kLn2 + logf(lsum);
        }
      }
    }
    hopper::trap_unless(ok);
  }
}

// ------------------------------------------------------------- backward dQ
// Grid (B*H, q tiles): block (r, y) owns q rows [q0, q0 + BQ) of row r,
// the heaviest causal tiles first, warpgroup w rows q0 + 64w + [0, 64), and
// walks the k tiles of BK rows of its kv row, as _dq_kernel's innermost
// grid dimension does: kFlash up to the diagonal, kRing every tile whose
// min(kpos) reaches the block's max(qpos). Q and dO are loaded once; K and
// V (and kRing's k positions) pass through the ring. Per k tile: S = Q.K^T
// and dP = dO.V^T, P = exp2(S * scale_log2 - L * log2e) (set to 0 where
// masked), dS = P * (dP - delta), dQ += dS.K. A warpgroup whose rows see
// none of a k tile skips its products. kFlash writes dQ in bf16; kRing
// adds it into the float32 carry. Live registers per consumer thread at
// D = 128 and BK = 64: the dQ accumulator 64, S 32, dP 32, dS's hi and lo
// fragments 32 (BK = 128 doubles all but the accumulator). Unlike the forward's, dQ's warpgroups do not take turns on the
// tensor cores: a trial with turns gave bit-identical outputs and no gain
// at the causal training shape, where dS is a small share of each tile's
// work.
template <int D, int V, int BQ, int BK>
__global__ void __launch_bounds__(tc_threads<BQ>(), 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap dmap,
             const __grid_constant__ CUtensorMap pmap,    // kPositions: kpos
             const int* qpos, const int* kpos, const float* lse,
             const float* delta, void* dq, int h, int hkv, int t, int causal,
             float scale, float scale_log2) {
  constexpr bool CARRY = V & kCarry, POSITIONS = V & kPositions;
  constexpr int NWG = consumer_groups<BQ>(), kProducerWarp = 4 * NWG;
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static_assert(BK == 64 || BK == 128, "a k tile is one wgmma's N");
  extern __shared__ uint8_t tc_smem[];
  DqSmemOf<D, V, BQ, BK>& sm = smem_as<DqSmemOf<D, V, BQ, BK>>(tc_smem);
  const int nt = (t + BQ - 1) / BQ;
  const int q0 = (nt - 1 - (int)blockIdx.y) * BQ;
  const int r = blockIdx.x;
  const int rkv = (r / h) * hkv + (r % h) / (h / hkv);
  // Causal by index: the last live key of this tile is min(q0 + BQ, t) - 1.
  const int kend = causal && !POSITIONS ? (min(q0 + BQ, t) - 1) / BK + 1
                                        : (t + BK - 1) / BK;
  const int warp = warp_index(), lane = threadIdx.x % 32;
  // kPositions: as the forward's, the block's greatest q position and the
  // first k tile from ki on whose least position does not pass it.
  int qmax = 0;
  if constexpr (POSITIONS) qmax = span_extreme<true, BQ>(qpos, q0, t);
  auto next_live = [&](int ki) {
    if constexpr (POSITIONS)
      while (ki < kend && span_extreme<false, BK>(kpos, ki * BK, t) > qmax) ++ki;
    return ki;
  };

  if (threadIdx.x == 0) {
    sm.ring.init(1, 4 * NWG);
    hopper::bar_init(&sm.qd_full, 1);
    hopper::fence_bar_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    producer_regs<NWG>();
    // kPositions: the whole warp reduces each tile's positions; lane 0
    // issues the loads.
    if (warp == kProducerWarp && (POSITIONS || lane == 0)) {
      const bool issuer = lane == 0;
      int ki = next_live(0);
      if (issuer && ki < kend) {
        hopper::arrive_expect(&sm.qd_full, 2 * hopper::tile_bytes<BQ, D>());
        hopper::load_tile<BQ, D>(sm.q, &qmap, &sm.qd_full, q0, r);
        hopper::load_tile<BQ, D>(sm.dout, &dmap, &sm.qd_full, q0, r);
      }
      hopper::Cursor c;
      bool ok = true;
      for (; ki < kend; ki = next_live(ki + 1)) {
        const int s = c.stage;
        if (issuer) {
          constexpr uint32_t pos_bytes = POSITIONS ? BK * 4 : 0;
          ok &= hopper::wait(&sm.ring.empty[s], c.phase ^ 1);
          hopper::arrive_expect(&sm.ring.full[s], 2 * hopper::tile_bytes<BK, D>() + pos_bytes);
          hopper::load_tile<BK, D>(sm.k[s], &kmap, &sm.ring.full[s], ki * BK, rkv);
          hopper::load_tile<BK, D>(sm.v[s], &vmap, &sm.ring.full[s], ki * BK, rkv);
          if constexpr (POSITIONS)
            hopper::tma_load_2d(sm.kpos[s], &pmap, &sm.ring.full[s], ki * BK, 0);
        }
        c.next<kStages>();
      }
      hopper::trap_unless(ok);
    }
  } else {
    consumer_regs<NWG>();
    const int wg = warp / 4;
    const int wq0 = q0 + 64 * wg;                       // first row of the warpgroup
    const int row = wq0 + 16 * (warp % 4) + lane / 4;   // and row + 8
    const int col = 2 * (lane % 4);
    int ki = next_live(0);
    if (ki >= kend) return;   // kPositions: nothing live, the carry stays as it is
    // kPositions: the positions of the thread's two rows (INT_MIN past t),
    // and the least and greatest of the warpgroup's 64.
    int qp[2] = {}, wqmin = 0, wqmax = 0;
    if constexpr (POSITIONS) {
      qp[0] = position<true>(qpos, row, t);
      qp[1] = position<true>(qpos, row + 8, t);
      wqmin = tile_extreme<false>(qpos, wq0, t);
      wqmax = tile_extreme<true>(qpos, wq0, t);
    }
    // L in log2 units and delta of the thread's two rows, read once (rows
    // past t read 0 and are never written).
    float lse2[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = row + 8 * i;
      lse2[i] = qr < t ? lse[(size_t)r * t + qr] * kLog2e : 0.f;
      dlt[i] = qr < t ? delta[(size_t)r * t + qr] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;

    const uint64_t qd = hopper::desc_k<BQ, D>(sm.q, 64 * wg);
    const uint64_t dd = hopper::desc_k<BQ, D>(sm.dout, 64 * wg);
    bool ok = hopper::wait(&sm.qd_full, 0);
    hopper::Cursor c;
    for (; ki < kend; ki = next_live(ki + 1)) {
      const int s = c.stage, k0 = ki * BK;
      ok &= hopper::wait(&sm.ring.full[s], c.phase);
      bool idle, mask;
      if constexpr (POSITIONS) {
        idle = wqmax < span_extreme<false, BK>(kpos, k0, t);
        mask = wqmin < span_extreme<true, BK>(kpos, k0, t) || k0 + BK > t;
      } else {
        idle = (causal && k0 > wq0 + 63) || wq0 >= t;
        mask = (causal && k0 + BK - 1 > wq0) || k0 + BK > t;
      }
      if (!idle) {
        float sacc[BK / 2], dpa[BK / 2];   // S and dP: 64 q rows x BK k columns
        const uint64_t kd = hopper::desc_k<BK, D>(sm.k[s], 0);
        const uint64_t vd = hopper::desc_k<BK, D>(sm.v[s], 0);
        hopper::wgmma_fence();
        hopper::static_for<0, D / 16>([&](auto kk) {
          constexpr int K = decltype(kk)::value;
          constexpr int A = hopper::k_step<BQ, D>(K), B = hopper::k_step<BK, D>(K);
          hopper::Wgmma<BK>::template ss<0, A, B>(sacc, qd, kd, K > 0);
          hopper::Wgmma<BK>::template ss<0, A, B>(dpa, dd, vd, K > 0);
        });
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);
        hopper::fence_regs(dpa);

        // dS, split into bf16 hi and lo A fragments (columns [16kk, 16kk +
        // 16) are n-blocks 2kk and 2kk + 1). A masked probability is set
        // to 0, never multiplied by a mask: a row with no live key carries
        // L = -1e30, and exp2 of its logits is inf.
        uint32_t dhi[BK / 16][4], dlo[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kc = 8 * j + col + (e & 1), qr = row + 8 * (e >> 1);
            float p = exp2f(fmaf(sacc[4 * j + e], scale_log2, -lse2[e >> 1]));
            bool live;
            if constexpr (POSITIONS) live = k0 + kc < t && qp[e >> 1] >= sm.kpos[s][kc];
            else live = k0 + kc < t && (!causal || qr >= k0 + kc);
            if (mask && !live) p = 0.f;
            ds[e] = p * (dpa[4 * j + e] - dlt[e >> 1]);
          }
          const int f = j / 2, x = (j % 2) * 2;
          hopper::split_bf16(ds[0], ds[1], dhi[f][x], dlo[f][x]);
          hopper::split_bf16(ds[2], ds[3], dhi[f][x + 1], dlo[f][x + 1]);
        }
        // dQ += dS.K, the K tile as the MN-major B operand.
        const uint64_t km = hopper::desc_mn<BK, D>(sm.k[s]);
        hopper::wgmma_fence();
        hopper::static_for<0, BK / 16>([&](auto kk) {
          constexpr int K = decltype(kk)::value;
          hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(dqa, dhi[K], km, 1);
          hopper::Wgmma<D>::template rs<1, hopper::mn_step<D>(K)>(dqa, dlo[K], km, 1);
        });
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dqa);
        hopper::fence_regs(dhi);
        hopper::fence_regs(dlo);
      }
      if (lane == 0) hopper::arrive(&sm.ring.empty[s]);
      c.next<kStages>();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = row + 8 * i;
      if (qr < t) {
        const size_t at = ((size_t)r * t + qr) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int e = 4 * j + 2 * i;
          if constexpr (CARRY) {   // one block owns each carry tile: no atomics
            float2* qc = reinterpret_cast<float2*>((float*)dq + at + 8 * j + col);
            float2 x = *qc;
            x.x += dqa[e] * scale;
            x.y += dqa[e + 1] * scale;
            *qc = x;
          } else {
            *reinterpret_cast<uint32_t*>((bf16*)dq + at + 8 * j + col) =
                hopper::pack_bf16(dqa[e] * scale, dqa[e + 1] * scale);
          }
        }
      }
    }
    hopper::trap_unless(ok);
  }
}

// ------------------------------------------------------------ backward dK/dV
// Grid (B*Hkv, k tiles): block (rk, ki) owns k rows [k0, k0 + BK) of kv
// row rk, warpgroup w rows k0 + 64w + [0, 64), and walks (g, q tile of BQ)
// over the GQA group, as _dkv_kernel's innermost grid dimension does:
// kFlash from the diagonal on (k tile 0 sees every q tile, so it goes
// first), kRing every tile whose max(qpos) reaches the block's min(kpos).
// A warpgroup whose rows see none of a q tile skips its products. V is
// kFlash (dK, dV written in bf16) or kRing (added into float32 carries).
template <int D, int V, int BQ, int BK>
__global__ void __launch_bounds__(tc_threads<BK>(), 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              const __grid_constant__ CUtensorMap dmap,
              const __grid_constant__ CUtensorMap lmap,
              const __grid_constant__ CUtensorMap emap,
              const __grid_constant__ CUtensorMap pmap,   // kPositions: qpos
              const int* qpos, const int* kpos, void* dk, void* dv,
              int h, int hkv, int t, int causal, float scale, float scale_log2) {
  constexpr bool CARRY = V & kCarry, POSITIONS = V & kPositions;
  constexpr int NWG = consumer_groups<BK>(), kProducerWarp = 4 * NWG;
  static_assert(BK == 64 || BK == 128, "one or two consumer warpgroups");
  static_assert(BQ == 64 || BQ == 128, "a q tile is one wgmma's N");
  extern __shared__ uint8_t tc_smem[];
  DkvSmemOf<D, V, BQ, BK>& sm = smem_as<DkvSmemOf<D, V, BQ, BK>>(tc_smem);
  const int nq = (t + BQ - 1) / BQ;
  const int k0 = blockIdx.y * BK;
  const int rk = blockIdx.x;
  const int group = h / hkv;
  // Causal by index: the first q tile whose rows can see this k tile.
  const int qstart = causal && !POSITIONS ? k0 / BQ : 0;
  const int warp = warp_index(), lane = threadIdx.x % 32;
  // kPositions: the least position of the block's BK k rows, which every
  // warp reduces itself; a q tile whose max(qpos) is below it is skipped.
  int kmin = 0;
  if constexpr (POSITIONS)
    kmin = span_extreme<false, BK>(kpos, k0, t);

  if (threadIdx.x == 0) {
    sm.ring.init(1, 4 * NWG);
    hopper::bar_init(&sm.kv_full, 1);
    hopper::fence_bar_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    producer_regs<NWG>();
    // kPositions: the whole warp reduces each tile's positions; lane 0
    // issues the loads.
    if (warp == kProducerWarp && (POSITIONS || lane == 0)) {
      const bool issuer = !POSITIONS || lane == 0;
      if (issuer) {
        hopper::arrive_expect(&sm.kv_full, 2 * hopper::tile_bytes<BK, D>());
        hopper::load_tile<BK, D>(sm.k, &kmap, &sm.kv_full, k0, rk);
        hopper::load_tile<BK, D>(sm.v, &vmap, &sm.kv_full, k0, rk);
      }
      hopper::Cursor c;
      bool ok = true;
      for (int g = 0; g < group; ++g) {
        const int rq = (rk / hkv) * h + (rk % hkv) * group + g;
        for (int qi = qstart; qi < nq; ++qi) {
          const int s = c.stage, q0 = qi * BQ;
          if constexpr (POSITIONS) {
            if (span_extreme<true, BQ>(qpos, q0, t) < kmin) continue;   // all masked
          }
          if (issuer) {
            constexpr uint32_t pos_bytes = POSITIONS ? BQ * 4 : 0;
            ok &= hopper::wait(&sm.ring.empty[s], c.phase ^ 1);
            hopper::arrive_expect(&sm.ring.full[s],
                                  2 * hopper::tile_bytes<BQ, D>() + 2 * BQ * 4 + pos_bytes);
            hopper::load_tile<BQ, D>(sm.q[s], &qmap, &sm.ring.full[s], q0, rq);
            hopper::load_tile<BQ, D>(sm.dout[s], &dmap, &sm.ring.full[s], q0, rq);
            hopper::tma_load_2d(sm.lse[s], &lmap, &sm.ring.full[s], q0, rq);
            hopper::tma_load_2d(sm.delta[s], &emap, &sm.ring.full[s], q0, rq);
            if constexpr (POSITIONS)
              hopper::tma_load_2d(sm.qpos[s], &pmap, &sm.ring.full[s], q0, 0);
          }
          c.next<kStages>();
        }
      }
      hopper::trap_unless(ok);
    }
  } else {
    consumer_regs<NWG>();
    const int wg = warp / 4;
    const int wk0 = k0 + 64 * wg;                        // first k row of the warpgroup
    const int krow = wk0 + 16 * (warp % 4) + lane / 4;   // and krow + 8
    const int col = 2 * (lane % 4);
    // kPositions: the positions of the thread's two k rows, and the least
    // and greatest of the warpgroup's 64 (past t: INT_MAX, INT_MIN).
    int kp[2] = {}, wkmin = 0, wkmax = 0;
    if constexpr (POSITIONS) {
      kp[0] = position<false>(kpos, krow, t);
      kp[1] = position<false>(kpos, krow + 8, t);
      wkmin = tile_extreme<false>(kpos, wk0, t);
      wkmax = tile_extreme<true>(kpos, wk0, t);
    }
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    const uint64_t kd = hopper::desc_k<BK, D>(sm.k, 64 * wg);
    const uint64_t vd = hopper::desc_k<BK, D>(sm.v, 64 * wg);
    bool ok = hopper::wait(&sm.kv_full, 0);
    hopper::Cursor c;
    for (int g = 0; g < group; ++g) {
      for (int qi = qstart; qi < nq; ++qi) {
        const int s = c.stage, q0 = qi * BQ;
        int qmax = 0, qmin = 0;
        if constexpr (POSITIONS) {
          qmax = span_extreme<true, BQ>(qpos, q0, t);
          if (qmax < kmin) continue;   // all masked: the producer skipped it too
          qmin = span_extreme<false, BQ>(qpos, q0, t);
        }
        ok &= hopper::wait(&sm.ring.full[s], c.phase);
        const bool idle = POSITIONS ? qmax < wkmin || wk0 >= t
                                    : (causal && q0 + BQ - 1 < wk0) || wk0 >= t;
        if (!idle) {
          float st[BQ / 2], dpt[BQ / 2];   // S^T and dP^T: 64 k rows x BQ q columns
          const uint64_t qd = hopper::desc_k<BQ, D>(sm.q[s], 0);
          const uint64_t dd = hopper::desc_k<BQ, D>(sm.dout[s], 0);
          hopper::wgmma_fence();
          hopper::static_for<0, D / 16>([&](auto kk) {
            constexpr int K = decltype(kk)::value;
            constexpr int A = hopper::k_step<BK, D>(K), B = hopper::k_step<BQ, D>(K);
            hopper::Wgmma<BQ>::template ss<0, A, B>(st, kd, qd, K > 0);
            hopper::Wgmma<BQ>::template ss<0, A, B>(dpt, vd, dd, K > 0);
          });
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);

          const bool ragged = q0 + BQ > t || wk0 + 64 > t;
          const bool mask = POSITIONS ? qmin < wkmax || ragged
                                      : (causal && q0 < wk0 + 63) || ragged;
          // P^T and dS^T, each split into bf16 hi and lo A fragments. A
          // masked probability is set to 0, never multiplied by a mask: a
          // row with no live key carries L = -1e30, and exp2 of it is inf.
          uint32_t phi[BQ / 16][4], plo[BQ / 16][4], dhi[BQ / 16][4], dlo[BQ / 16][4];
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = 8 * j + col + (e & 1), kr = krow + 8 * (e >> 1);
              float pe = exp2f(fmaf(st[4 * j + e], scale_log2, -sm.lse[s][qc] * kLog2e));
              bool live;
              if constexpr (POSITIONS) live = q0 + qc < t && kr < t && sm.qpos[s][qc] >= kp[e >> 1];
              else live = q0 + qc < t && kr < t && (!causal || q0 + qc >= kr);
              if (mask && !live) pe = 0.f;
              p[e] = pe;
              ds[e] = pe * (dpt[4 * j + e] - sm.delta[s][qc]);
            }
            const int f = j / 2, x = (j % 2) * 2;
            hopper::split_bf16(p[0], p[1], phi[f][x], plo[f][x]);
            hopper::split_bf16(p[2], p[3], phi[f][x + 1], plo[f][x + 1]);
            hopper::split_bf16(ds[0], ds[1], dhi[f][x], dlo[f][x]);
            hopper::split_bf16(ds[2], ds[3], dhi[f][x + 1], dlo[f][x + 1]);
          }
          const uint64_t qm = hopper::desc_mn<BQ, D>(sm.q[s]);
          const uint64_t dm = hopper::desc_mn<BQ, D>(sm.dout[s]);
          hopper::wgmma_fence();
          hopper::static_for<0, BQ / 16>([&](auto kk) {
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
          if constexpr (CARRY) {   // one block owns each carry tile: no atomics
            float2* kc = reinterpret_cast<float2*>((float*)dk + at + 8 * j + col);
            float2* vc = reinterpret_cast<float2*>((float*)dv + at + 8 * j + col);
            float2 x = *kc, y = *vc;
            x.x += dka[e] * scale;
            x.y += dka[e + 1] * scale;
            y.x += dva[e];
            y.y += dva[e + 1];
            *kc = x;
            *vc = y;
          } else {
            *reinterpret_cast<uint32_t*>((bf16*)dk + at + 8 * j + col) =
                hopper::pack_bf16(dka[e] * scale, dka[e + 1] * scale);
            *reinterpret_cast<uint32_t*>((bf16*)dv + at + 8 * j + col) =
                hopper::pack_bf16(dva[e], dva[e + 1]);
          }
        }
      }
    }
    hopper::trap_unless(ok);
  }
}

// --------------------------------------------------------------- launches

// kFlash writes O (bf16) and L, masks causally by index and takes no
// carries or positions (null); kRing updates the float32 carries acc
// (rows, t, D), m and l (rows, t) in place, masks by qpos and kpos (int32
// (t,), kpos 16-byte aligned for TMA) and ignores `causal`.
template <int D, int V, int BQ, int BK>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                  void* acc, void* m, void* l, const void* qpos, const void* kpos,
                  int rows, int h, int hkv, int t, int causal, cudaStream_t st) {
  const int rows_kv = rows / h * hkv, ld = (t + 3) / 4 * 4;
  CUtensorMap qm, km, vm, pm{};
  if (hopper::make_map(&qm, q, rows, t, D, BQ) ||
      hopper::make_map(&km, k, rows_kv, t, D, BK) ||
      hopper::make_map(&vm, v, rows_kv, t, D, BK) ||
      ((V & kPositions) &&
       hopper::make_vec_map(&pm, kpos, 1, t, ld, BK, CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return kMapFailed;
  constexpr size_t smem = smem_bytes<FwdSmemOf<D, V, BQ, BK>>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_tc_kernel<D, V, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, (t + BQ - 1) / BQ);
  const float scale_log2 = kLog2e / sqrtf((float)D);
  fwd_tc_kernel<D, V, BQ, BK><<<grid, tc_threads<BQ>(), smem, st>>>(
      qm, km, vm, pm, (const int*)qpos, (const int*)kpos, (bf16*)o, (float*)lse,
      (float*)acc, (float*)m, (float*)l, h, hkv, t, causal, scale_log2);
  return cudaGetLastError();
}

// lse and delta: (rows, t) float32, read by plain loads (no padding).
// kFlash writes dq in bf16 and takes no positions (null); kRing adds into
// the float32 carry dq, masks by qpos and kpos (int32 (t,), kpos 16-byte
// aligned for TMA) and ignores `causal`.
template <int D, int V, int BQ, int BK>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* qpos,
                 const void* kpos, void* dq, int rows, int h, int hkv, int t,
                 int causal, cudaStream_t st) {
  const int rows_kv = rows / h * hkv, ld = (t + 3) / 4 * 4;
  CUtensorMap qm, km, vm, dm, pm{};
  if (hopper::make_map(&qm, q, rows, t, D, BQ) ||
      hopper::make_map(&dm, dout, rows, t, D, BQ) ||
      hopper::make_map(&km, k, rows_kv, t, D, BK) ||
      hopper::make_map(&vm, v, rows_kv, t, D, BK) ||
      ((V & kPositions) &&
       hopper::make_vec_map(&pm, kpos, 1, t, ld, BK, CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return kMapFailed;
  constexpr size_t smem = smem_bytes<DqSmemOf<D, V, BQ, BK>>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_tc_kernel<D, V, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, (t + BQ - 1) / BQ);
  dq_tc_kernel<D, V, BQ, BK><<<grid, tc_threads<BQ>(), smem, st>>>(
      qm, km, vm, dm, pm, (const int*)qpos, (const int*)kpos, (const float*)lse,
      (const float*)delta, dq, h, hkv, t, causal, 1.0f / sqrtf((float)D),
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

// lse and delta: (rows, t) float32 with rows ld = t rounded up to 4 apart,
// which TMA needs (the wrapper pads them when t % 4). kFlash writes dK and
// dV in bf16 and takes no positions (null); kRing adds into float32
// carries dk and dv, masks by qpos and kpos (int32 (t,), qpos 16-byte
// aligned for TMA) and ignores `causal`.
template <int D, int V, int BQ, int BK>
int launch_dkv_tc(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* qpos, const void* kpos, void* dk, void* dv,
                  int rows_kv, int h, int hkv, int t, int causal, cudaStream_t st) {
  const int rows = rows_kv / hkv * h, ld = (t + 3) / 4 * 4;
  CUtensorMap qm, km, vm, dm, lm, em, pm{};
  if (hopper::make_map(&qm, q, rows, t, D, BQ) ||
      hopper::make_map(&dm, dout, rows, t, D, BQ) ||
      hopper::make_map(&km, k, rows_kv, t, D, BK) ||
      hopper::make_map(&vm, v, rows_kv, t, D, BK) ||
      hopper::make_vec_map(&lm, lse, rows, t, ld, BQ) ||
      hopper::make_vec_map(&em, delta, rows, t, ld, BQ) ||
      ((V & kPositions) &&
       hopper::make_vec_map(&pm, qpos, 1, t, ld, BQ, CU_TENSOR_MAP_DATA_TYPE_INT32)))
    return kMapFailed;
  constexpr size_t smem = smem_bytes<DkvSmemOf<D, V, BQ, BK>>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_tc_kernel<D, V, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows_kv, (t + BK - 1) / BK);
  dkv_tc_kernel<D, V, BQ, BK><<<grid, tc_threads<BK>(), smem, st>>>(
      qm, km, vm, dm, lm, em, pm, (const int*)qpos, (const int*)kpos, dk, dv, h, hkv, t,
      causal, 1.0f / sqrtf((float)D), kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

// The tile pairs (q extent, k extent) built per kernel: at kTileD every
// pair below, at the other head dims the default (kFwdQ/kFwdK,
// kDqQ/kDqK, kDkvQ/kDkvK) alone. ops/flash_attention.py's TILE_PAIRS lists
// the same pairs; any other pair returns kBadArgs. A pair is in the set
// only if both variants of it fit shared memory with kStages stages and
// ptxas reports no spill (chip_smoke.py's phase 2 reads the report). Out
// at D = 128: dQ 128/128 (kRing spills 28 bytes: S, dP and dS's fragments
// of a 128-column tile beside the 64 accumulators), and dK/dV with q tiles
// of 128 (7.6-10.9 KB of spills in both variants: P^T, dS^T and their hi
// and lo fragments beside 128 accumulators), whose launches ran 2.7-8 x
// the default's. Blocks of 192 rows (three consumer warpgroups) were not
// tried: 512 threads leave 160 registers a consumer thread, fewer than
// the forward's accumulator, S and P fragments at a 128-row k tile.
#define HVD_FWD_PAIRS(X) X(128, 128) X(128, 64) X(64, 128) X(64, 64)
#define HVD_DQ_PAIRS(X) X(128, 64) X(64, 64) X(64, 128)
#define HVD_DKV_PAIRS(X) X(64, 128) X(64, 64)

template <int D, int V>
int fwd_tc(int bq, int bk, const void* q, const void* k, const void* v, void* o,
           void* lse, void* acc, void* m, void* l, const void* qpos,
           const void* kpos, int rows, int h, int hkv, int t, int causal,
           cudaStream_t st) {
#define HVD_CASE(Q, K)                                                                   \
  if (bq == Q && bk == K)                                                                 \
    return launch_fwd_tc<D, V, Q, K>(q, k, v, o, lse, acc, m, l, qpos, kpos, rows, h,  \
                                     hkv, t, causal, st);
  if constexpr (D == kTileD) {
    HVD_FWD_PAIRS(HVD_CASE)
  } else {
    HVD_CASE(kFwdQ, kFwdK)
  }
#undef HVD_CASE
  return kBadArgs;
}

template <int D, int V>
int dq_tc(int bq, int bk, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, const void* qpos,
          const void* kpos, void* dq, int rows, int h, int hkv, int t, int causal,
          cudaStream_t st) {
#define HVD_CASE(Q, K)                                                                   \
  if (bq == Q && bk == K)                                                                \
    return launch_dq_tc<D, V, Q, K>(q, k, v, dout, lse, delta, qpos, kpos, dq, rows, h,  \
                                    hkv, t, causal, st);
  if constexpr (D == kTileD) {
    HVD_DQ_PAIRS(HVD_CASE)
  } else {
    HVD_CASE(kDqQ, kDqK)
  }
#undef HVD_CASE
  return kBadArgs;
}

template <int D, int V>
int dkv_tc(int bq, int bk, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta, const void* qpos,
           const void* kpos, void* dk, void* dv, int rows_kv, int h, int hkv, int t,
           int causal, cudaStream_t st) {
#define HVD_CASE(Q, K)                                                                   \
  if (bq == Q && bk == K)                                                                \
    return launch_dkv_tc<D, V, Q, K>(q, k, v, dout, lse, delta, qpos, kpos, dk, dv,      \
                                     rows_kv, h, hkv, t, causal, st);
  if constexpr (D == kTileD) {
    HVD_DKV_PAIRS(HVD_CASE)
  } else {
    HVD_CASE(kDkvQ, kDkvK)
  }
#undef HVD_CASE
  return kBadArgs;
}

}  // namespace
