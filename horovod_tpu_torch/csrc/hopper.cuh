// Hopper (sm_90a) building blocks for the tensor-core kernels of
// flash_tc.cuh: tensor maps and TMA tile loads, mbarriers and the
// full/empty ring, shared-memory matrix descriptors, and warpgroup matrix
// multiply (wgmma) wrappers.
//
// Tiles live in shared memory as bf16 in the layout TMA writes with a
// swizzle: a tile of R rows by D columns is cut into D / AC "atoms" of AC
// columns (AC = 64 at D >= 64 with the 128-byte swizzle, AC = 32 at D = 32
// with the 64-byte swizzle), each atom R rows of SW = 2 * AC bytes, 8-row
// groups of 8 * SW bytes, atoms placed one after the other. Every atom
// starts on a 1024-byte boundary, which the swizzle patterns need.
//
// A wgmma operand reads such a tile in one of two ways:
// - K-major (the product's K dimension runs along the tile's columns, as
//   for Q and K in S = Q.K^T): SBO is one 8-row group, LBO is unused, and
//   the 16-column step k advances the start address by 32 bytes inside an
//   atom, then jumps to the next atom;
// - MN-major (K runs along the rows, as for V in O = P.V, with the
//   transpose-B flag): SBO is one 8-row group along K, LBO one atom along
//   N, and the 16-row step k advances the start by 16 * SW bytes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

// ------------------------------------------------------------ tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library links against the runtime alone; null if the driver lacks it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p : (EncodeTiled) nullptr;
  }();
  return fn;
}

// Swizzle width in bytes of a bf16 tile with d columns: the row, up to 128.
__host__ __device__ constexpr int swizzle_bytes(int d) { return d * 2 < 128 ? d * 2 : 128; }

// A 3-D map over a contiguous bf16 tensor (rows, t, d), boxes of
// (1, box_rows, swizzle_bytes(d) / 2): one box is one atom of a tile.
// Reads past t fill with zeros and never reach the next row. Returns 0 or
// the driver's error (and 1 if the driver has no encoder).
inline int make_map(CUtensorMap* map, const void* base, int rows, int t, int d,
                    int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 1;
  const int sw = swizzle_bytes(d);
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)rows};
  cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  cuuint32_t box[3] = {(cuuint32_t)sw / 2, (cuuint32_t)box_rows, 1};
  cuuint32_t unit[3] = {1, 1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                     const_cast<void*>(base), dims, strides, box, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A 2-D map over a float32 matrix (rows, t) whose rows lie ld >= t apart
// (ld a multiple of 4, so rows start on 16 bytes), boxes of (1, box):
// one box is `box` values of one row; reads past t fill with zeros.
inline int make_vec_map(CUtensorMap* map, const void* base, int rows, int t,
                        int ld, int box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return 1;
  cuuint64_t dims[2] = {(cuuint64_t)t, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  cuuint32_t boxes[2] = {(cuuint32_t)box, 1};
  cuuint32_t unit[2] = {1, 1};
  return (int)encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                     const_cast<void*>(base), dims, strides, boxes, unit,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_NONE,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// --------------------------------------------------------------- mbarriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA);
// follow it with __syncthreads() before any thread uses them.
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Arrive, and expect `bytes` more of TMA traffic in this phase.
__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed; false if it gave
// up after 2^26 polls (each up to the hardware's own time-out: seconds in
// all, far beyond any tile's work). The kernels fold every wait into one
// flag and end with trap_unless(flag), so a broken pipeline fails the
// launch, and the next CUDA call on the stream raises, instead of hanging
// the card or writing stale tiles. The trap sits after the epilogue, not
// in the wait loop: one inside the loop made ptxas spill the dK/dV
// accumulators.
__device__ __forceinline__ bool wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0; polls < (1u << 26); ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return true;
  }
  return false;
}

__device__ __forceinline__ void trap_unless(bool ok) {
  if (!ok) __trap();
}

// A ring of S stages, each with a "full" barrier (the producer's arrivals
// and its TMA bytes) and an "empty" one (one arrival per consumer warp).
// Each side walks the stages in order with its own (stage, phase); the
// producer's first wait on an empty barrier passes at once.
template <int S>
struct Ring {
  uint64_t full[S];
  uint64_t empty[S];
  __device__ void init(int producers, int consumers) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], producers);
      bar_init(&empty[s], consumers);
    }
  }
};

struct Cursor {
  int stage = 0;
  uint32_t phase = 0;
  template <int S> __device__ __forceinline__ void next() {
    if (++stage == S) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// TMA: copy one box at (c0, c1, c2) = (column, row in t, row of the
// tensor) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// TMA: copy one box at (c0, c1) = (column, row) of a 2-D map.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"((uint64_t)map), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// Bytes of a bf16 tile of R rows and D columns.
template <int R, int D> __host__ __device__ constexpr uint32_t tile_bytes() { return R * D * 2; }

// Load rows [row0, row0 + R) of tensor row `r` as a whole swizzled tile:
// D / AC atoms of R rows, tile_bytes<R, D>() in all.
template <int R, int D>
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int r) {
  constexpr int AC = swizzle_bytes(D) / 2;
#pragma unroll
  for (int a = 0; a < D / AC; ++a)
    tma_load((char*)dst + a * R * AC * 2, map, bar, a * AC, row0, r);
}

// ------------------------------------------------------ matrix descriptors

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int sw) {
  const uint64_t layout = sw == 128 ? 1 : 2;  // 128- or 64-byte swizzle
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: rows [row0, row0 + 64 or N) of a swizzled tile of R
// rows and D columns. Its 16-column step k is the descriptor plus
// k_step<R, D>(k), which the wgmma wrappers add as an immediate.
template <int R, int D>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int row0) {
  constexpr int SW = swizzle_bytes(D);
  return desc(smem_addr(tile) + row0 * SW, 16, 8 * SW, SW);
}
template <int R, int D>
__host__ __device__ constexpr int k_step(int k) {
  return ((k * 16 / (swizzle_bytes(D) / 2)) * R * swizzle_bytes(D) +
          (k * 16 % (swizzle_bytes(D) / 2)) * 2) >> 4;
}

// MN-major operand (used with the transpose-B flag): a swizzled tile of R
// rows and D columns, all D columns as N. Its step k, rows
// [16k, 16k + 16), is the descriptor plus mn_step<D>(k).
template <int R, int D>
__device__ __forceinline__ uint64_t desc_mn(const void* tile) {
  constexpr int SW = swizzle_bytes(D);
  return desc(smem_addr(tile), R * SW, 8 * SW, SW);
}
template <int D>
__host__ __device__ constexpr int mn_step(int k) {
  return (k * 16 * swizzle_bytes(D)) >> 4;
}

// f(std::integral_constant<int, I>) for I in [B, E): the step of a product
// as a compile-time constant, so each wgmma gets its descriptor offset as
// an immediate and no descriptor stays live in a register.
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma that is still in flight, or from reusing the registers of
// its A fragments before it completes: call after wgmma_wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// Turns between two warpgroups of 128 threads on named barrier `id`
// (1-15; 0 is __syncthreads): turn_take waits until the other warpgroup
// has passed the turn with turn_pass(id). Every take needs exactly one pass.
__device__ __forceinline__ void turn_take(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// Register budget per warpgroup (setmaxnreg): the producer gives back what
// the consumers take.
template <int R> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// Two floats as one bf16x2 register, lo in the low half (round to nearest
// even, as torch's cast).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Two floats as two bf16x2 registers whose sum keeps 16 of their 24 bits:
// hi holds them rounded to bf16, lo the remainders (exact in float32)
// rounded to bf16. A product fed hi and then lo as two wgmmas into one
// accumulator errs by at most 2^-16 of each term, where hi alone errs by
// up to 2^-8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// wgmma m64nNk16, bf16 inputs, float32 accumulators d[N / 2] in the
// warpgroup's accumulator layout: warp w, lane l holds rows 16w + l/4 and
// 16w + l/4 + 8 at columns 8j + 2(l%4) + {0, 1}, as d[4j + {0, 1}] and
// d[4j + {2, 3}]. ss: A and B from shared-memory descriptors (A K-major);
// rs: A from registers, four bf16x2 per thread in the same layout over
// 16 columns, which is the layout of an accumulator's columns
// [16k, 16k + 16), packed. TRANS_B = 1 reads B as MN-major. OFF_A and
// OFF_B (16-byte units) are added to the descriptors right before the
// instruction: the step offsets k_step and mn_step. scale_d = 0 overwrites
// d, 1 adds to it.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  template <int TRANS_B, int OFF_A, int OFF_B>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %18, 0;\n"
        "add.s64 da, %16, %20;\nadd.s64 db, %17, %21;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, da, db, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(OFF_A), "n"(OFF_B));
  }
  template <int TRANS_B, int OFF_B>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %21, 0;\n"
        "add.s64 db, %20, %23;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, db, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B),
          "n"(OFF_B));
  }
};

template <> struct Wgmma<64> {
  template <int TRANS_B, int OFF_A, int OFF_B>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %34, 0;\n"
        "add.s64 da, %32, %36;\nadd.s64 db, %33, %37;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, da, db, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(OFF_A), "n"(OFF_B));
  }
  template <int TRANS_B, int OFF_B>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %37, 0;\n"
        "add.s64 db, %36, %39;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, db, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B),
          "n"(OFF_B));
  }
};

template <> struct Wgmma<128> {
  template <int TRANS_B, int OFF_A, int OFF_B>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"
        "add.s64 da, %64, %68;\nadd.s64 db, %65, %69;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, da, db, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B), "n"(OFF_A), "n"(OFF_B));
  }
  template <int TRANS_B, int OFF_B>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %69, 0;\n"
        "add.s64 db, %68, %71;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, db, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TRANS_B),
          "n"(OFF_B));
  }
};

}  // namespace hopper
