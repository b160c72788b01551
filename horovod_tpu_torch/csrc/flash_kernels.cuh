// Flash attention kernels for Hopper (sm_90a), shared by flash_attention.cu
// (B1-B3) and ring_flash.cu (B4-B6).
//
// Three kernels, each a template over the input type T, the head dim D and
// a variant V made of two compile-time options:
//
//   kCarry     - the online-softmax state (acc, m, l) or the gradient
//                (dQ, or dK and dV) is a float32 carry that the kernel reads
//                at its start and writes back in place at its end, instead
//                of starting from zero and writing a finished output. One
//                block owns each carry tile (fwd/dQ: one (row, q tile);
//                dK/dV: one (kv row, k tile)), so no atomics are needed and
//                results repeat run to run.
//   kPositions - causal masking by explicit global positions, live =
//                qpos[i] >= kpos[j] from two int32 vectors (t,), instead of
//                the index test live(). Every tile pair is visited; a pair
//                where max(qpos of the q tile) < min(kpos of the k tile) is
//                skipped whole, before any barrier (the pl.when of
//                ring_flash.py). Every warp reduces the min and max itself
//                with shuffles, so the block agrees without shared memory;
//                positions need not be sorted (the zigzag layout is not).
//                Each thread keeps the positions of its own rows and
//                columns in registers. Shared memory stays that of kFlash:
//                at D = 128 the forward's 115,712 bytes let exactly two
//                blocks share an SM's 228 KB, and one more byte would
//                halve that. A row that has no live key yet carries
//                m = -1e30; its pivot is 0 (m_safe), so exp(m_prev - m_safe)
//                underflows to 0 instead of rescaling by exp(0) = 1.
//
// kFlash (neither option) is the slice-1 flash attention of
// horovod_tpu/ops/flash_attention.py (_fwd_kernel, _dq_kernel,
// _dkv_kernel); kRing (both) is one ring step of
// horovod_tpu/ops/ring_flash.py (_rf_fwd_kernel, _rf_dq_kernel,
// _rf_dkv_kernel). `if constexpr` keeps each option out of the code of the
// variants that lack it.
//
// Layout: the "rows" layout of the JAX package. q, o, dO, dq are
// (B*H, T, D); k, v, dk, dv are (B*Hkv, T, D); L (logsumexp), delta
// (rowsum(dO * O)), m and l are (B*H, T) float32, one value per row (the
// TPU's sublane-replicated (B*H, 8, T) copy is not kept). All tensors are
// contiguous. The q row r reads kv row (r / H) * Hkv + (r % H) / group and
// the kv row rk collects q rows (rk / Hkv) * H + (rk % Hkv) * group + g
// (_kv_row and _q_row of the JAX package).
//
// Arithmetic: float32 throughout, whatever the input type (float32 or
// bfloat16); masked logits are -1e30 and their probabilities exactly 0;
// scale D^-0.5. Finished outputs are written in the input type, carries in
// float32.
//
// Which inputs come here: every float32 launch, dQ (B2) in both types, and
// the ring kernels (B4-B6) in both types. The bf16 forward (B1) and dK/dV
// (B3) of kFlash run on the tensor cores instead (flash_tc.cuh: TMA tiles,
// wgmma; flash_attention.cu dispatches on the dtype). Float32 stays here:
// Hopper's tensor cores have no float32 product, and TF32 keeps 10
// mantissa bits, which would break the 1e-4 float32 checks that the JAX
// kernels' float32 arithmetic sets.
//
// What bounds these kernels: at the training shape (T = 4096, D = 128)
// attention does ~T/2 multiply-adds per byte it must move, far above the
// card's ~295 bf16 operations per byte, so the work is compute-bound and
// the bound is the tensor cores' 989 TFLOP/s. These kernels compute on the
// float32 CUDA cores with FMA from shared-memory tiles (register tiles of
// 4 x 4 logits and 4 x D/16 outputs per thread, bf16 widened to float32
// with a row stride of D + 1), so they reach 1.5-2.5% of that bound; B2
// and the ring kernels move onto wgmma next, on hopper.cuh's building
// blocks. What the design does keep from the TPU kernels is what matters
// for memory: the (T, T) logits never reach device memory, each block
// streams K/V (or Q/dO) tiles through shared memory, and masked tiles are
// skipped, with the heaviest causal tiles scheduled first.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;       // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int kBadArgs = 1000;  // returned for shapes no kernel takes

// Variants (template argument V).
constexpr int kCarry = 1;
constexpr int kPositions = 2;
constexpr int kFlash = 0;
constexpr int kRing = kCarry | kPositions;

static_assert(kTile == 64, "tile_extreme covers a tile with two rows per lane");

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Copy rows [row0, row0 + kTile) of a (t, D) matrix into shared memory as
// float32 with row stride D + 1 (no bank conflicts on column walks),
// multiplied by `mul`; rows past t read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int t, float mul) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D, gr = row0 + r;
    dst[r * (D + 1) + c] = gr < t ? to_f32(src[(size_t)gr * D + c]) * mul : 0.f;
  }
}

// Rows [row0, row0 + kTile) of a (t,) float32 vector; rows past t read 0.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int t) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    dst[i] = row0 + i < t ? src[row0 + i] : 0.f;
  }
}

// Position of row `row` of a (t,) int32 vector; past t, INT_MIN for a q row
// (MAX) and INT_MAX for a k row, so qpos >= kpos is false there and the
// row moves no max or min.
template <bool MAX>
__device__ __forceinline__ int position(const int* pos, int row, int t) {
  return row < t ? pos[row] : (MAX ? INT_MIN : INT_MAX);
}

// Max (MAX, a q tile) or min (a k tile) of positions [row0, row0 + kTile),
// computed by every warp with shuffles, so each thread holds it.
template <bool MAX>
__device__ __forceinline__ int tile_extreme(const int* pos, int row0, int t) {
  const int lane = threadIdx.x % 32;
  const int a = position<MAX>(pos, row0 + lane, t);
  const int b = position<MAX>(pos, row0 + lane + 32, t);
  int x = MAX ? max(a, b) : min(a, b);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? max(x, y) : min(x, y);
  }
  return x;
}

__device__ __forceinline__ bool live(int qp, int kp, int t, int causal) {
  return qp < t && kp < t && (!causal || qp >= kp);
}

// Max and sum over the 16 threads of a half-warp that share a row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Everything a kernel may read or write; each variant uses its own subset.
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;
  const float* delta;
  T* o;              // kFlash outputs, in the input type
  float* lse_out;
  T* dq;
  T* dk;
  T* dv;
  float* acc;        // kCarry: forward (acc, m, l), updated in place
  float* m;
  float* l;
  float* dq_c;       // kCarry: gradient carries, updated in place
  float* dk_c;
  float* dv_c;
  const int* qpos;   // kPositions: (t,) global positions of q and k rows
  const int* kpos;
  int h, hkv, t, causal;
  float scale;
};

// ------------------------------------------------------------------ forward
// Grid (q tiles, B*H). Thread (ty, tx) owns q rows ty*4 + i of the tile, the
// logits at k columns tx + 16*j, and the outputs at d columns tx + 16*c.
template <typename T, int D, int V>
__global__ void __launch_bounds__(kThreads) fwd_kernel(Args<T> a) {
  constexpr bool CARRY = V & kCarry, POSITIONS = V & kPositions;
  constexpr int S = D + 1, P = kTile + 1, CJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;

  const int t = a.t;
  const int nt = (t + kTile - 1) / kTile;
  const int qi = nt - 1 - blockIdx.x;        // heaviest causal tiles first
  const int r = blockIdx.y;
  const int rkv = (r / a.h) * a.hkv + (r % a.h) / (a.h / a.hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kTile;
  const T* kr = a.k + (size_t)rkv * t * D;
  const T* vr = a.v + (size_t)rkv * t * D;

  load_tile<T, D>(qs, a.q + (size_t)r * t * D, q0, t, a.scale);  // q * scale, as _fwd_kernel
  int qmax = 0, qpos[4] = {}, kpos[4] = {};  // kPositions only
  if constexpr (POSITIONS) {
    qmax = tile_extreme<true>(a.qpos, q0, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) qpos[i] = position<true>(a.qpos, q0 + ty * 4 + i, t);
  }
  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if constexpr (CARRY) {
      const bool in = qp < t;
      const size_t row = (size_t)r * t + qp;
      m[i] = in ? a.m[row] : kNegInf;
      l[i] = in ? a.l[row] : 0.f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] = in ? a.acc[row * D + tx + 16 * c] : 0.f;
    } else {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
    }
  }
  // Causal by index: the last live key of this tile is min(q0 + kTile, t) - 1.
  const int kend = a.causal && !POSITIONS ? (min(q0 + kTile, t) - 1) / kTile + 1 : nt;
  for (int ki = 0; ki < kend; ++ki) {
    const int k0 = ki * kTile;
    if constexpr (POSITIONS) {
      if (qmax < tile_extreme<false>(a.kpos, k0, t)) continue;  // all masked
#pragma unroll
      for (int j = 0; j < 4; ++j) kpos[j] = position<false>(a.kpos, k0 + tx + 16 * j, t);
    }
    __syncthreads();
    load_tile<T, D>(ks, kr, k0, t, 1.f);
    load_tile<T, D>(vs, vr, k0, t, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = qs[(ty * 4 + i) * S + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = ks[(tx + 16 * j) * S + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i, qp = q0 + row;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if constexpr (POSITIONS) ok[j] = qpos[i] >= kpos[j];
        else ok[j] = live(qp, k0 + col, t, a.causal);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      // A row with no live key yet pivots on 0 (ring_flash.py's m_safe).
      const float m_safe = POSITIONS && m_new <= kNegInf * 0.5f ? 0.f : m_new;
      const float alpha = expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        ps[row * P + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * P + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) vv[c] = vs[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp < t) {
      const size_t row = (size_t)r * t + qp;
      if constexpr (CARRY) {
#pragma unroll
        for (int c = 0; c < CJ; ++c) a.acc[row * D + tx + 16 * c] = acc[i][c];
        if (tx == 0) {
          a.m[row] = m[i];
          a.l[row] = l[i];
        }
      } else {
#pragma unroll
        for (int c = 0; c < CJ; ++c) a.o[row * D + tx + 16 * c] = from_f32<T>(acc[i][c] / l[i]);
        if (tx == 0) a.lse_out[row] = m[i] + logf(l[i]);
      }
    }
  }
}

// -------------------------------------------------------------- backward dQ
// Grid (q tiles, B*H), the thread map of the forward. Per k tile:
// p = exp(s - L), ds = p * (dO.V^T - delta), dQ += ds.K; dQ *= scale at the
// end (and, with kCarry, is added to the carry).
template <typename T, int D, int V>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args<T> a) {
  constexpr bool CARRY = V & kCarry, POSITIONS = V & kPositions;
  constexpr int S = D + 1, P = kTile + 1, CJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;
  float* ls = dss + kTile * P;
  float* dl = ls + kTile;

  const int t = a.t;
  const float scale = a.scale;
  const int nt = (t + kTile - 1) / kTile;
  const int qi = nt - 1 - blockIdx.x;
  const int r = blockIdx.y;
  const int rkv = (r / a.h) * a.hkv + (r % a.h) / (a.h / a.hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kTile;
  const T* kr = a.k + (size_t)rkv * t * D;
  const T* vr = a.v + (size_t)rkv * t * D;

  load_tile<T, D>(qs, a.q + (size_t)r * t * D, q0, t, 1.f);
  load_tile<T, D>(dos, a.dout + (size_t)r * t * D, q0, t, 1.f);
  load_vec(ls, a.lse + (size_t)r * t, q0, t);
  load_vec(dl, a.delta + (size_t)r * t, q0, t);
  int qmax = 0, qpos[4] = {}, kpos[4] = {};  // kPositions only
  if constexpr (POSITIONS) {
    qmax = tile_extreme<true>(a.qpos, q0, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) qpos[i] = position<true>(a.qpos, q0 + ty * 4 + i, t);
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  const int kend = a.causal && !POSITIONS ? (min(q0 + kTile, t) - 1) / kTile + 1 : nt;
  for (int ki = 0; ki < kend; ++ki) {
    const int k0 = ki * kTile;
    if constexpr (POSITIONS) {
      if (qmax < tile_extreme<false>(a.kpos, k0, t)) continue;  // all masked
#pragma unroll
      for (int j = 0; j < 4; ++j) kpos[j] = position<false>(a.kpos, k0 + tx + 16 * j, t);
    }
    __syncthreads();
    load_tile<T, D>(ks, kr, k0, t, 1.f);
    load_tile<T, D>(vs, vr, k0, t, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float x[4], g[4], y[4], c4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = qs[(ty * 4 + i) * S + d];
        g[i] = dos[(ty * 4 + i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        y[j] = ks[(tx + 16 * j) * S + d];
        c4[j] = vs[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(x[i], y[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i, qp = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        bool ok;
        if constexpr (POSITIONS) ok = qpos[i] >= kpos[j];
        else ok = live(qp, k0 + col, t, a.causal);
        const float p = ok ? expf(s[i][j] * scale - ls[row]) : 0.f;
        dss[row * P + col] = p * (dp[i][j] - dl[row]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dv4[4], kv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv4[i] = dss[(ty * 4 + i) * P + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) kv[c] = ks[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CJ; ++c) acc[i][c] = fmaf(dv4[i], kv[c], acc[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp < t) {
      const size_t row = ((size_t)r * t + qp) * D;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        if constexpr (CARRY) a.dq_c[row + tx + 16 * c] += acc[i][c] * scale;
        else a.dq[row + tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
      }
    }
  }
}

// ------------------------------------------------------------ backward dK/dV
// Grid (k tiles, B*Hkv). The block keeps its K/V tile and walks (g, q tile)
// over the GQA group, as _dkv_kernel's innermost grid dimension does.
// Thread (ty, tx) owns k rows ty*4 + i and, in the transposed logits tile,
// q columns tx + 16*j: pT = exp(s^T * scale - L), dsT = pT * (V.dO^T - delta);
// dV += pT.dO, dK += dsT.Q; dK *= scale at the end (and, with kCarry, both
// are added to their carries).
template <typename T, int D, int V>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args<T> a) {
  constexpr bool CARRY = V & kCarry, POSITIONS = V & kPositions;
  constexpr int S = D + 1, P = kTile + 1, CJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* dos = qs + kTile * S;
  float* pt = dos + kTile * S;
  float* ls = pt + kTile * P;
  float* dl = ls + kTile;

  const int t = a.t, h = a.h, hkv = a.hkv;
  const float scale = a.scale;
  const int nt = (t + kTile - 1) / kTile;
  const int ki = blockIdx.x;                 // k tile 0 sees every q tile: first
  const int rk = blockIdx.y;
  const int group = h / hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = ki * kTile;

  load_tile<T, D>(ks, a.k + (size_t)rk * t * D, k0, t, 1.f);
  load_tile<T, D>(vs, a.v + (size_t)rk * t * D, k0, t, 1.f);
  int kmin = 0, kpos[4] = {}, qpos[4] = {};  // kPositions only
  if constexpr (POSITIONS) {
    kmin = tile_extreme<false>(a.kpos, k0, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) kpos[i] = position<false>(a.kpos, k0 + ty * 4 + i, t);
  }
  float dka[4][CJ], dva[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dka[i][c] = dva[i][c] = 0.f;
  // Causal by index: the first q tile whose rows can see this k tile.
  const int qstart = a.causal && !POSITIONS ? k0 / kTile : 0;
  for (int g = 0; g < group; ++g) {
    const int rq = (rk / hkv) * h + (rk % hkv) * group + g;
    const T* qr = a.q + (size_t)rq * t * D;
    const T* dr = a.dout + (size_t)rq * t * D;
    for (int qi = qstart; qi < nt; ++qi) {
      const int q0 = qi * kTile;
      if constexpr (POSITIONS) {
        if (tile_extreme<true>(a.qpos, q0, t) < kmin) continue;  // all masked
#pragma unroll
        for (int j = 0; j < 4; ++j) qpos[j] = position<true>(a.qpos, q0 + tx + 16 * j, t);
      }
      __syncthreads();
      load_tile<T, D>(qs, qr, q0, t, 1.f);
      load_tile<T, D>(dos, dr, q0, t, 1.f);
      load_vec(ls, a.lse + (size_t)rq * t, q0, t);
      load_vec(dl, a.delta + (size_t)rq * t, q0, t);
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float x[4], c4[4], y[4], g4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = ks[(ty * 4 + i) * S + d];
          c4[i] = vs[(ty * 4 + i) * S + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[j] = qs[(tx + 16 * j) * S + d];
          g4[j] = dos[(tx + 16 * j) * S + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(x[i], y[j], s[i][j]);
            dp[i][j] = fmaf(c4[i], g4[j], dp[i][j]);
          }
      }
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int krow = ty * 4 + i, kp = k0 + krow;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          bool ok;
          if constexpr (POSITIONS) ok = qpos[j] >= kpos[i];
          else ok = live(q0 + col, kp, t, a.causal);
          const float p = ok ? expf(s[i][j] * scale - ls[col]) : 0.f;
          pt[krow * P + col] = p;
          ds[i][j] = p * (dp[i][j] - dl[col]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], gv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = pt[(ty * 4 + i) * P + qq];
#pragma unroll
        for (int c = 0; c < CJ; ++c) gv[c] = dos[qq * S + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) dva[i][c] = fmaf(pv[i], gv[c], dva[i][c]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pt[(ty * 4 + i) * P + tx + 16 * j] = ds[i][j];
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kTile; ++qq) {
        float dv4[4], qv[CJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv4[i] = pt[(ty * 4 + i) * P + qq];
#pragma unroll
        for (int c = 0; c < CJ; ++c) qv[c] = qs[qq * S + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CJ; ++c) dka[i][c] = fmaf(dv4[i], qv[c], dka[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp < t) {
      const size_t row = ((size_t)rk * t + kp) * D;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const size_t at = row + tx + 16 * c;
        if constexpr (CARRY) {
          a.dk_c[at] += dka[i][c] * scale;
          a.dv_c[at] += dva[i][c];
        } else {
          a.dk[at] = from_f32<T>(dka[i][c] * scale);
          a.dv[at] = from_f32<T>(dva[i][c]);
        }
      }
    }
  }
}

// Dynamic shared memory of each kernel, in bytes (every variant the same).
template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}
template <int D> constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile);
}

inline bool bad_shape(int rows, int h, int hkv, int t) {
  return rows <= 0 || h <= 0 || hkv <= 0 || h % hkv || rows % h || t <= 0;
}
inline bool bad_kv_shape(int rows_kv, int h, int hkv, int t) {
  return rows_kv <= 0 || h <= 0 || hkv <= 0 || h % hkv || rows_kv % hkv || t <= 0;
}

template <typename T, int D>
Args<T> make_args(int h, int hkv, int t, int causal) {
  Args<T> a = {};
  a.h = h;
  a.hkv = hkv;
  a.t = t;
  a.causal = causal;
  a.scale = 1.0f / sqrtf((float)D);
  return a;
}

// Launch `kernel` on a grid of (tiles of t, rows) with `smem` bytes.
template <typename T>
int launch(void (*kernel)(Args<T>), const Args<T>& a, int rows, size_t smem,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.t + kTile - 1) / kTile, rows);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dispatch on (dtype, head dim): dtype 0 is float32, 1 is bfloat16. FN is a
// function template <typename T, int D>.
#define HVD_DISPATCH(FN, ...)                                              \
  switch (dtype * 1000 + d) {                                             \
    case 32: return FN<float, 32>(__VA_ARGS__);                           \
    case 64: return FN<float, 64>(__VA_ARGS__);                           \
    case 128: return FN<float, 128>(__VA_ARGS__);                         \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                 \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                 \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                \
    default: return kBadArgs;                                             \
  }
