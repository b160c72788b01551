// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas kernels of horovod_tpu/ops/flash_attention.py:
//   hvd_flash_fwd     <- _fwd_kernel  (online-softmax forward, O and L)
//   hvd_flash_bwd_dq  <- _dq_kernel   (dQ, recomputing p = exp(s - L))
//   hvd_flash_bwd_dkv <- _dkv_kernel  (dK and dV over every q tile of the
//                                      GQA group; no atomics)
//
// Layout: the "rows" layout of the JAX package. q, o, dO, dq are
// (B*H, T, D); k, v, dk, dv are (B*Hkv, T, D); L (logsumexp) and delta
// (rowsum(dO * O)) are (B*H, T) float32, one value per row (the TPU's
// sublane-replicated (B*H, 8, T) copy is not kept). All tensors are
// contiguous. The q row r reads kv row (r / H) * Hkv + (r % H) / group and
// the kv row rk collects q rows (rk / Hkv) * H + (rk % Hkv) * group + g
// (_kv_row and _q_row of the JAX package).
//
// Arithmetic: float32 throughout, whatever the input type (float32 or
// bfloat16); masked logits are -1e30 and their probabilities exactly 0;
// scale D^-0.5. Outputs are written in the input type.
//
// What bounds these kernels: at the training shape (T = 4096, D = 128)
// attention does ~T/2 multiply-adds per byte it must move, far above the
// card's ~295 bf16 operations per byte, so the work is compute-bound and
// the bound is the tensor cores' 989 TFLOP/s. This first version computes
// on the float32 CUDA cores with FMA from shared-memory tiles (register
// tiles of 4 x 4 logits and 4 x D/16 outputs per thread), so it reaches a
// fraction of that bound; moving the three products onto wgmma is the
// next step. What the design does keep from the TPU kernels is what
// matters for memory: the (T, T) logits never reach device memory, each
// block streams K/V (or Q/dO) tiles through shared memory, and causal
// programs skip the tiles above the diagonal, with the heaviest tiles
// scheduled first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;       // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16: thread (ty, tx)
constexpr int kBadArgs = 1000;  // returned for shapes no kernel takes

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

// ------------------------------------------------------------------ forward
// Grid (q tiles, B*H). Thread (ty, tx) owns q rows ty*4 + i of the tile, the
// logits at k columns tx + 16*j, and the outputs at d columns tx + 16*c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
           int h, int hkv, int t, int causal, float scale) {
  constexpr int S = D + 1, P = kTile + 1, CJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * S;
  float* vs = ks + kTile * S;
  float* ps = vs + kTile * S;

  const int nt = (t + kTile - 1) / kTile;
  const int qi = nt - 1 - blockIdx.x;        // heaviest causal tiles first
  const int r = blockIdx.y;
  const int rkv = (r / h) * hkv + (r % h) / (h / hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kTile;
  const T* kr = k + (size_t)rkv * t * D;
  const T* vr = v + (size_t)rkv * t * D;

  load_tile<T, D>(qs, q + (size_t)r * t * D, q0, t, scale);  // q * scale, as _fwd_kernel
  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }
  // Causal: the last live key of this tile is min(q0 + kTile, t) - 1.
  const int kend = causal ? (min(q0 + kTile, t) - 1) / kTile + 1 : nt;
  for (int ki = 0; ki < kend; ++ki) {
    const int k0 = ki * kTile;
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
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * S + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * S + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live(qp, k0 + tx + 16 * j, t, causal)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(qp, k0 + tx + 16 * j, t, causal) ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * P + tx + 16 * j] = p;
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
      T* orow = o + ((size_t)r * t + qp) * D;
#pragma unroll
      for (int c = 0; c < CJ; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] / l[i]);
      if (tx == 0) lse[(size_t)r * t + qp] = m[i] + logf(l[i]);
    }
  }
}

// -------------------------------------------------------------- backward dQ
// Grid (q tiles, B*H), the thread map of the forward. Per k tile:
// p = exp(s - L), ds = p * (dO.V^T - delta), dQ += ds.K; dQ *= scale at the end.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int h, int hkv, int t, int causal, float scale) {
  constexpr int S = D + 1, P = kTile + 1, CJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * S;
  float* ks = dos + kTile * S;
  float* vs = ks + kTile * S;
  float* dss = vs + kTile * S;
  float* ls = dss + kTile * P;
  float* dl = ls + kTile;

  const int nt = (t + kTile - 1) / kTile;
  const int qi = nt - 1 - blockIdx.x;
  const int r = blockIdx.y;
  const int rkv = (r / h) * hkv + (r % h) / (h / hkv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qi * kTile;
  const T* kr = k + (size_t)rkv * t * D;
  const T* vr = v + (size_t)rkv * t * D;

  load_tile<T, D>(qs, q + (size_t)r * t * D, q0, t, 1.f);
  load_tile<T, D>(dos, dout + (size_t)r * t * D, q0, t, 1.f);
  load_vec(ls, lse + (size_t)r * t, q0, t);
  load_vec(dl, delta + (size_t)r * t, q0, t);
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  const int kend = causal ? (min(q0 + kTile, t) - 1) / kTile + 1 : nt;
  for (int ki = 0; ki < kend; ++ki) {
    const int k0 = ki * kTile;
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
      float a[4], g[4], b[4], c4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * S + d];
        g[i] = dos[(ty * 4 + i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(tx + 16 * j) * S + d];
        c4[j] = vs[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c4[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i, qp = q0 + row;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(qp, k0 + tx + 16 * j, t, causal)
                            ? expf(s[i][j] * scale - ls[row]) : 0.f;
        dss[row * P + tx + 16 * j] = p * (dp[i][j] - dl[row]);
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
      T* row = dq + ((size_t)r * t + qp) * D;
#pragma unroll
      for (int c = 0; c < CJ; ++c) row[tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

// ------------------------------------------------------------ backward dK/dV
// Grid (k tiles, B*Hkv). The block keeps its K/V tile and walks (g, q tile)
// over the GQA group, as _dkv_kernel's innermost grid dimension does.
// Thread (ty, tx) owns k rows ty*4 + i and, in the transposed logits tile,
// q columns tx + 16*j: pT = exp(s^T * scale - L), dsT = pT * (V.dO^T - delta);
// dV += pT.dO, dK += dsT.Q; dK *= scale at the end.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, int h, int hkv, int t,
           int causal, float scale) {
  constexpr int S = D + 1, P = kTile + 1, CJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * S;
  float* qs = vs + kTile * S;
  float* dos = qs + kTile * S;
  float* pt = dos + kTile * S;
  float* ls = pt + kTile * P;
  float* dl = ls + kTile;

  const int nt = (t + kTile - 1) / kTile;
  const int ki = blockIdx.x;                 // k tile 0 sees every q tile: first
  const int rk = blockIdx.y;
  const int group = h / hkv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = ki * kTile;

  load_tile<T, D>(ks, k + (size_t)rk * t * D, k0, t, 1.f);
  load_tile<T, D>(vs, v + (size_t)rk * t * D, k0, t, 1.f);
  float dka[4][CJ], dva[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) dka[i][c] = dva[i][c] = 0.f;
  // Causal: the first q tile whose rows can see this k tile.
  const int qstart = causal ? k0 / kTile : 0;
  for (int g = 0; g < group; ++g) {
    const int rq = (rk / hkv) * h + (rk % hkv) * group + g;
    const T* qr = q + (size_t)rq * t * D;
    const T* dr = dout + (size_t)rq * t * D;
    for (int qi = qstart; qi < nt; ++qi) {
      const int q0 = qi * kTile;
      __syncthreads();
      load_tile<T, D>(qs, qr, q0, t, 1.f);
      load_tile<T, D>(dos, dr, q0, t, 1.f);
      load_vec(ls, lse + (size_t)rq * t, q0, t);
      load_vec(dl, delta + (size_t)rq * t, q0, t);
      __syncthreads();
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], c4[4], b[4], g4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = ks[(ty * 4 + i) * S + d];
          c4[i] = vs[(ty * 4 + i) * S + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = qs[(tx + 16 * j) * S + d];
          g4[j] = dos[(tx + 16 * j) * S + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], b[j], s[i][j]);
            dp[i][j] = fmaf(c4[i], g4[j], dp[i][j]);
          }
      }
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          const float p = live(q0 + col, kp, t, causal)
                              ? expf(s[i][j] * scale - ls[col]) : 0.f;
          pt[(ty * 4 + i) * P + col] = p;
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
      T* dkrow = dk + ((size_t)rk * t + kp) * D;
      T* dvrow = dv + ((size_t)rk * t + kp) * D;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        dkrow[tx + 16 * c] = from_f32<T>(dka[i][c] * scale);
        dvrow[tx + 16 * c] = from_f32<T>(dva[i][c]);
      }
    }
  }
}

// Dynamic shared memory of each kernel, in bytes.
template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}
template <int D> constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 1) + 2 * kTile);
}

bool bad_shape(int rows, int h, int hkv, int t) {
  return rows <= 0 || h <= 0 || hkv <= 0 || h % hkv || rows % h || t <= 0;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int rows, int h, int hkv, int t, int causal, cudaStream_t st) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, rows);
  fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, h, hkv, t,
      causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int rows, int h,
              int hkv, int t, int causal, cudaStream_t st) {
  const size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, rows);
  dq_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, h, hkv, t, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int rows_kv, int h, int hkv, int t, int causal, cudaStream_t st) {
  const size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + kTile - 1) / kTile, rows_kv);
  dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, h, hkv, t,
      causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// Dispatch on (dtype, head dim): dtype 0 is float32, 1 is bfloat16.
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

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream`, which belongs to the
// calling thread's current device (the wrappers make the inputs' device
// current around the call), and returns cudaGetLastError() (0 on
// success), or 1000 for arguments no kernel takes.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int rows, int h, int hkv, int t, int d,
                  int causal, int dtype, void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(launch_fwd, q, k, v, o, lse, rows, h, hkv, t, causal, st)
}

int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int rows, int h, int hkv, int t, int d,
                     int causal, int dtype, void* stream) {
  if (bad_shape(rows, h, hkv, t)) return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, rows, h, hkv, t,
               causal, st)
}

int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int rows_kv, int h, int hkv, int t,
                      int d, int causal, int dtype, void* stream) {
  if (rows_kv <= 0 || h <= 0 || hkv <= 0 || h % hkv || rows_kv % hkv || t <= 0)
    return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  HVD_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, rows_kv, h,
               hkv, t, causal, st)
}

}  // extern "C"
