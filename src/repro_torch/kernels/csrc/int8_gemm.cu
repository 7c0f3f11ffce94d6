// W8A16 GEMM for Hopper (sm_90a): y = (x @ w_q) * scale[None, :], summed in
// f32 and written as f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/int8_gemm.py: both of its
// dataflows, `_kernel_os` (output-stationary, the one every CiM-gated
// projection runs) and `_kernel_ws` (weight-stationary, psums accumulated
// across K in the output), and both weight types it is fed: int8, and the
// float8 e4m3 weights of `quant/lowbit.py:planned_linear_fp8`, which the
// TPU kernel upcasts to f32 in-register.  x is (M, K) bf16 or f32 with row
// stride ldx, w_q is (K, N) int8 or e4m3 in the JAX layout (K rows, row
// stride ldw), scale is (N,) f32, y is (M, N) contiguous.
//
// Weight format.  Every design is a template on WF (W_INT8, W_E4M3) that
// changes only how a weight byte is decoded; tiles, rings and masks are
// the same, since both formats are one byte and both decode exactly to
// bf16 (int8: the f32 magic-number trick below; e4m3: cvt.rn.f16x2.e4m3x2,
// exact because every e4m3 value is a normal f16, then f16 -> f32 -> bf16,
// exact because e4m3's 3 mantissa bits and its range 2^-9 .. 448 fit
// bf16).  TMA and cp.async move bytes, so the weight's tensor map stays a
// 1-byte type, and a zero-filled tail byte is +0.0 in e4m3 as in int8.
// e4m3fn's 0x7F / 0xFF (NaN) decode to NaN; the quantizer never writes
// them.
//
// What bounds it on an H100 SXM: the call moves K*N weight bytes for
// 2*M*K*N operations.  At decode (M = 8) that is 16 operations per byte,
// far below the ~295 where the bf16 tensor cores (989 TFLOP/s) rather than
// HBM (3.35 TB/s) are the limit: the weight bytes bound it.  At the
// prefill (M = 2048) it is ~4000 per byte: the tensor cores bound it.  So
// there are two designs; `kernels/int8_gemm.py:plan_gemm` picks one.
//
// Design A -- M > 32, bf16 x, `os`, TMA-aligned operands (the prefill, and
// decode batches above 32, where it beats design B: PERF.md).
//   A warp-specialised tiled GEMM: 2 consumer warpgroups and a producer
//   warp per block.  One producer thread keeps TMA loads of x tiles
//   (128 x 64 bf16, K-major, 128-byte swizzle) and int8 weight tiles
//   (64 x BN) in flight in a 4-stage ring, each stage with a `full` and
//   an `empty` mbarrier.  The consumers together convert each int8
//   weight tile once to bf16 (prmt into an f32 magic number, a subtract and
//   cvt.rn.bf16x2.f32, 8 weights per thread step; int8 -> bf16 is exact;
//   an e4m3 tile goes through cvt.rn.f16x2.e4m3x2 instead)
//   into a shared tile in the 128-byte-swizzled MN-major layout that
//   `wgmma` reads as a transposed B operand (3 such tiles, so converting
//   tile k+1 overlaps the wgmmas of tile k), fence it into the async
//   proxy, and each issues wgmma.mma_async m64n64k16 for its 64 rows with
//   f32 accumulators in registers.  The scale is applied after the K loop,
//   as `_kernel_os` does on its last K step; TMA zero-fills ragged M, N, K
//   and the epilogue masks its stores.  Tile: 128 x 64, which fits two
//   blocks on an SM (104 KB of shared memory each), so one block's int8
//   conversion overlaps the other's wgmmas; 128- and 256-column tiles,
//   one block per SM, ran the prefill's GEMMs slower.  It also gives
//   qwen2-7b's Wk/Wv at M = 2048 (N = 512) 128 tiles; no split of K and no
//   persistent loop.
//
// Design B -- every other bf16 shape, and the `ws` dataflow at every M.
//   Weight-stationary split-K, the TPU's "CiM array" with `_kernel_ws`'s
//   grid (n, k, m): block (n, s) holds the int8 tile of K-slice s and a
//   128-column slab in shared memory (16-byte cp.async copies, a 5-stage
//   ring of 64-row pieces; a slice of at most 320 rows stays resident)
//   and streams every row of x past it in chunks of at most 64 rows, each
//   64-column piece of x staged beside its weight piece (cp.async, then
//   ldmatrix into mma fragments: x fragments loaded from global memory
//   made the M = 8 lm_head call 1.5x slower).  With 128 columns each
//   weight row a block reads is a whole 128-byte line.  The number of
//   slices is chosen so that the qwen2-7b shapes put several blocks on
//   each SM (too few weight bytes are in flight otherwise), with slices
//   of at least 64 rows, and
//   bounded so the f32 partials (splits x M x N) fit a workspace cap.
//   bf16 x runs mma.sync m16n8k16 (M padded to 16: M = 8 needs no more,
//   the tensor cores are idle either way); each warp owns 32 columns over
//   the whole slice.  One 32-bit shared load of 4 columns gives one weight
//   of 4 mma column tiles, so a warp's columns are visited in a permuted
//   order that the epilogue undoes.
//   Partials go to device memory, as `_kernel_ws` accumulates them in its
//   output window, and a second small kernel sums them in a fixed split
//   order and applies the scale once: no float atomics, so two calls give
//   the same bits.  One split writes y directly.  Any shape, alignment and
//   row stride is taken (unaligned tails are copied byte by byte).
//
// f32 x takes a plain FMA kernel on either dataflow (bf16 tensor cores
// would round x); it is off the serving path, which computes in bf16.
//
// bf16 outputs are rounded once, from the f32 value the f32 output would
// hold (__float2bfloat16_rn), so they equal that output cast to bf16.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------- common --

// int8 byte j of `u` (already xor 0x80: offset binary) as an exact float:
// the byte goes into the mantissa of 2^23 (0x4B000000), and 2^23 + 128 is
// subtracted.
__device__ __forceinline__ float i8_to_f32(uint32_t u, int j) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j))
         - 8388736.0f;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // cvt.rn.bf16x2.f32
  return *reinterpret_cast<uint32_t*>(&v);
}

// The weight formats: one byte each.
constexpr int W_INT8 = 0;
constexpr int W_E4M3 = 1;

// Two e4m3 bytes (the low 16 bits of `pair`, the lower byte first) ->
// bf16x2 bits, the lower byte in the low half: exact (see the header).
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return bf16x2_bits(f.x, f.y);
}

// Bytes j of weight words lo and hi -> bf16x2 bits, lo's byte in the low
// half.
template <int WF>
__device__ __forceinline__ uint32_t w_pair_to_bf16x2(uint32_t lo, uint32_t hi,
                                                     int j) {
  if constexpr (WF == W_INT8)
    return bf16x2_bits(i8_to_f32(lo ^ 0x80808080u, j),
                       i8_to_f32(hi ^ 0x80808080u, j));
  else
    return e4m3x2_to_bf16x2(__byte_perm(lo, hi, j | ((j + 4) << 4)));
}

// 8 weights (two words, lowest address first) -> 8 bf16 as 16 bytes.
template <int WF>
__device__ __forceinline__ uint4 w8x8_to_bf16x8(uint2 v) {
  uint4 o;
  if constexpr (WF == W_INT8) {
    const uint32_t a = v.x ^ 0x80808080u, b = v.y ^ 0x80808080u;
    o.x = bf16x2_bits(i8_to_f32(a, 0), i8_to_f32(a, 1));
    o.y = bf16x2_bits(i8_to_f32(a, 2), i8_to_f32(a, 3));
    o.z = bf16x2_bits(i8_to_f32(b, 0), i8_to_f32(b, 1));
    o.w = bf16x2_bits(i8_to_f32(b, 2), i8_to_f32(b, 3));
  } else {
    o.x = e4m3x2_to_bf16x2(v.x);
    o.y = e4m3x2_to_bf16x2(v.x >> 16);
    o.z = e4m3x2_to_bf16x2(v.y);
    o.w = e4m3x2_to_bf16x2(v.y >> 16);
  }
  return o;
}

// One weight byte -> its exact f32 value.
template <int WF>
__device__ __forceinline__ float w8_to_f32(uint8_t b) {
  if constexpr (WF == W_INT8)
    return (float)(int8_t)b;
  else
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

__device__ __forceinline__ void store_out(void* y, long long i, float v,
                                          bool out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(y)[i] = v;
}

// ------------------------------------------------------------- design A --

namespace ga {

constexpr int BM = 128;            // rows per block: 2 consumer warpgroups
constexpr int BN = 64;             // columns per block (one MN chunk)
constexpr int BK = 64;             // K rows per stage (128 bytes of bf16 x)
constexpr int STAGES = 4;          // TMA ring depth
constexpr int BSTAGES = 3;         // converted bf16 weight tiles
constexpr int THREADS = 288;       // 2 consumer warpgroups + a producer warp
constexpr int X_STAGE = BM * BK * 2;           // 16 KB
constexpr int CHUNK_BYTES = BK * 128;          // one 64-column MN chunk

struct Layout {
  static constexpr int W_STAGE = BK * BN;                  // int8
  static constexpr int B_STAGE = BK * BN * 2;              // bf16
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + STAGES * X_STAGE;
  static constexpr int W_OFF = B_OFF + BSTAGES * B_STAGE;
  static constexpr int BAR_OFF = W_OFF + STAGES * W_STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;               // for alignment
};

struct Wgmma {
  // D (64 x 64, f32) += A (64 x 16, K-major) * B (16 x 64, MN-major)
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Grid (m tiles, n tiles): consecutive blocks share one weight slab, so it
// is read from HBM about once and from L2 by the other row tiles.
template <int WF>
__global__ void __launch_bounds__(THREADS)
int8_gemm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ scale, void* __restrict__ y,
                     int M, int N, int K, int out_bf16) {
  using L = Layout;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;          // swizzle atoms
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t full0 = base + L::BAR_OFF, empty0 = full0 + STAGES * 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);          // one arrive per consumer WG
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer warp: one thread keeps the ring full
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty0 + 8 * s, ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, X_STAGE + L::W_STAGE);
        tma_load_2d(base + L::X_OFF + s * X_STAGE, &xmap, full0 + 8 * s,
                    kt * BK, m0);
        tma_load_2d(base + L::W_OFF + s * L::W_STAGE, &wmap, full0 + 8 * s,
                    n0, kt * BK);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64*cw .. +63 of the tile
  const int cw = threadIdx.x / 128;
  const int ct = threadIdx.x;                // 0..255 across both WGs
  const int t = threadIdx.x % 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    const int bs = kt % BSTAGES;
    mbar_wait(full0 + 8 * s, (kt / STAGES) & 1);
    // weight bytes (BK x BN, row-major) -> bf16 MN-major, 128-byte swizzle
    const uint8_t* wsrc = sbase + L::W_OFF + s * L::W_STAGE;
    uint8_t* bdst = sbase + L::B_OFF + bs * L::B_STAGE;
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / 256; ++i) {
      const int c = ct + i * 256;
      const int k = c / (BN / 8), n = (c % (BN / 8)) * 8;
      const uint2 v = *reinterpret_cast<const uint2*>(wsrc + k * BN + n);
      const uint32_t off = (n / 64) * CHUNK_BYTES + (k / 8) * 1024
                           + (k % 8) * 128 + (n % 64) * 2;
      const uint32_t sw = off ^ (((off >> 7) & 7u) << 4);
      *reinterpret_cast<uint4*>(bdst + sw) = w8x8_to_bf16x8<WF>(v);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");

    const uint32_t xa = base + L::X_OFF + s * X_STAGE + cw * 64 * 128;
    const uint32_t ba = base + L::B_OFF + bs * L::B_STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Wgmma::mma(acc, gmma_desc(xa + kk * 32, 16, 1024),
                     gmma_desc(ba + kk * 2048, CHUNK_BYTES, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // the wgmmas of step kt-1 are done: release their stage
    if (kt > 0 && t == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // epilogue: accumulator fragment (row, col) of m64nBN, scale, store
  const int warp = t / 32, lane = t % 32;
  const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if (r >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e < N)
          store_out(y, (long long)r * N + c + e,
                    acc[j * 4 + h * 2 + e] * scale[c + e], out_bf16);
      }
    }
  }
}

}  // namespace ga

// ------------------------------------------------------------- design B --

namespace gb {

constexpr int BN = 128;            // columns per block: one warp per 32
constexpr int KP = 64;             // K rows per piece of the weight tile
constexpr int STAGES = 5;          // pieces in flight; <= 320 rows resident
constexpr int THREADS = 128;
constexpr int PIECE = KP * BN;     // 8 KB of int8: 128-byte weight rows

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [k0, k0 + KP) of the weight, columns [n0, n0 + BN), into one piece;
// zero at or past the slice's end ke and past N.  Aligned 16-byte runs go
// by cp.async, the rest byte by byte.
__device__ __forceinline__ void load_piece(int8_t* dst,
                                           const int8_t* __restrict__ w,
                                           int k0, int ke, int n0, int N,
                                           long long ldw, bool wvec) {
  for (int i = threadIdx.x; i < KP * (BN / 16); i += THREADS) {
    const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
    const int k = k0 + r, n = n0 + c;
    int8_t* d = dst + r * BN + c;
    if (wvec && k < ke && n + 16 <= N) {
      cp_async16(d, w + (long long)k * ldw + n);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (k < ke) {
        const int8_t* p = w + (long long)k * ldw + n;
        for (int j = 0; j < 16 && n + j < N; ++j)
          v[j / 4] |= (uint32_t)(uint8_t)p[j] << (8 * (j % 4));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

constexpr int XROW = KP + 8;       // bf16 per staged x row (+16 B: no
                                   // ldmatrix bank conflicts)

// Rows [m0, m0 + rows) of x, columns [k0, k0 + KP), bf16, into one staged
// piece; zero at or past M and the slice's end ke.  16-byte runs go by
// cp.async when x allows it (xvec16), the rest element by element.
__device__ __forceinline__ void load_x_piece(__nv_bfloat16* dst,
                                             const __nv_bfloat16* __restrict__ x,
                                             int m0, int rows, int k0, int ke,
                                             int M, long long ldx,
                                             bool xvec16) {
  for (int i = threadIdx.x; i < rows * (KP / 8); i += THREADS) {
    const int r = i / (KP / 8), c = (i % (KP / 8)) * 8;
    const int m = m0 + r, k = k0 + c;
    __nv_bfloat16* d = dst + r * XROW + c;
    if (xvec16 && m < M && k + 8 <= ke) {
      cp_async16(d, x + (long long)m * ldx + k);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (m < M) {
        const __nv_bfloat16* p = x + (long long)m * ldx + k;
        for (int j = 0; j < 8 && k + j < ke; ++j)
          v[j / 2] |= (uint32_t)__bfloat16_as_ushort(p[j]) << (16 * (j % 2));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The A fragment of mma m16n8k16 (16 rows x 16 k) from a staged x piece.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Grid (column slabs, K slices).  MT = 16-row tiles per chunk of x (1, 2
// or 4: at most 64 rows).  With one slice the block writes y (scaled);
// with more it writes its f32 partial to part[slice] and ws_reduce adds.
template <int MT, int WF>
__global__ void __launch_bounds__(THREADS)
int8_gemm_ws_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ y,
                    float* __restrict__ part, int M, int N, int K,
                    long long ldx, long long ldw, int kslice, int out_bf16,
                    int xvec16, int wvec) {
  constexpr int MC = 16 * MT;
  extern __shared__ __align__(16) uint8_t smem_b[];
  int8_t (*wt)[PIECE] = reinterpret_cast<int8_t (*)[PIECE]>(smem_b);
  __nv_bfloat16* const xs =               // x: STAGES pieces of MC rows
      reinterpret_cast<__nv_bfloat16*>(smem_b + STAGES * PIECE);
  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const bool direct = gridDim.y == 1;
  const int kb = split * kslice, ke = min(K, kb + kslice);
  const int nk = (ke - kb + KP - 1) / KP;
  const int nchunks = (M + MC - 1) / MC;
  const bool stationary = nk <= STAGES;      // the slice stays resident
  const int total = nchunks * nk;            // (chunk, piece) steps
  // step q loads x piece q and, unless the slice is resident and already
  // loaded, weight piece q % nk
  auto load_step = [&](int q) {
    const int kp = q % nk;
    load_x_piece(xs + (q % STAGES) * MC * XROW, x, (q / nk) * MC, MC,
                 kb + kp * KP, ke, M, ldx, xvec16);
    if (!stationary)
      load_piece(wt[q % STAGES], w, kb + kp * KP, ke, n0, N, ldw, wvec);
    else if (q < nk)
      load_piece(wt[q], w, kb + kp * KP, ke, n0, N, ldw, wvec);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, kq = lane % 4;    // warp: columns 32*warp..+31

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < total) load_step(p);
    cp_async_commit();
  }

  for (int c = 0; c < nchunks; ++c) {
    const int m0 = c * MC;
    float acc[MT * 4][4];                    // [mma tile (mt, t)][fragment]
#pragma unroll
    for (int i = 0; i < MT * 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

    for (int kp = 0; kp < nk; ++kp) {
      const int p = c * nk + kp;
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int8_t* tile = wt[stationary ? kp : p % STAGES];
      const int kbase = kb + kp * KP;
      // mma.sync m16n8k16.  Lane (g, kq) reads 4 columns
      // 32*warp + 4g .. +3 of rows 2kq, 2kq+1, 2kq+8, 2kq+9: column
      // 4g + t is column g of the t-th mma tile.
#pragma unroll
      for (int ks = 0; ks < KP / 16; ++ks) {
        const int k0 = kbase + ks * 16;
        if (k0 >= ke) break;
        const int8_t* wr = tile + (ks * 16 + 2 * kq) * BN + warp * 32 + 4 * g;
        const uint32_t u0 = *reinterpret_cast<const uint32_t*>(wr);
        const uint32_t u1 = *reinterpret_cast<const uint32_t*>(wr + BN);
        const uint32_t u2 = *reinterpret_cast<const uint32_t*>(wr + 8 * BN);
        const uint32_t u3 = *reinterpret_cast<const uint32_t*>(wr + 9 * BN);
        uint32_t b[4][2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          b[t][0] = w_pair_to_bf16x2<WF>(u0, u1, t);
          b[t][1] = w_pair_to_bf16x2<WF>(u2, u3, t);
        }
        const __nv_bfloat16* xp = xs + (p % STAGES) * MC * XROW
                                  + (lane % 16) * XROW + ks * 16
                                  + (lane / 16) * 8;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, xp + mt * 16 * XROW);
#pragma unroll
          for (int t = 0; t < 4; ++t)
            mma_bf16(acc[mt * 4 + t], a[0], a[1], a[2], a[3], b[t][0],
                     b[t][1]);
        }
      }
      const int q = p + STAGES - 1;
      if (q < total) load_step(q);
      cp_async_commit();
    }

    // epilogue of the chunk
    auto emit = [&](int r, int n, float v) {
      if (r >= M || n >= N) return;
      if (direct)
        store_out(y, (long long)r * N + n, v * scale[n], out_bf16);
      else
        part[((long long)split * M + r) * N + n] = v;
    };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          emit(m0 + mt * 16 + g + 8 * (e / 2),
               n0 + warp * 32 + 4 * (2 * kq + e % 2) + t,
               acc[mt * 4 + t][e]);
  }
}

// y = (part[0] + part[1] + ... + part[S-1]) * scale, in that order.
__global__ void int8_gemm_ws_reduce(const float* __restrict__ part,
                                    const float* __restrict__ scale,
                                    void* __restrict__ y, int M, int N,
                                    int splits, int out_bf16) {
  const long long total = (long long)M * N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[s * total + i];
    store_out(y, i, v * scale[i % N], out_bf16);
  }
}

template <int MT, int WF>
int launch_ws(const void* x, const void* w, const void* scale, void* y,
              float* part, int M, int N, int K, long long ldx,
              long long ldw, int kslice, int splits, int out_bf16,
              cudaStream_t s) {
  constexpr int smem = STAGES * PIECE + STAGES * 16 * MT * XROW * 2;
  static unsigned long long attr_set = 0;
  const int e = allow_smem((const void*)int8_gemm_ws_kernel<MT, WF>, smem,
                           &attr_set);
  if (e != 0) return e;
  const int xvec16 = (uintptr_t)x % 16 == 0 && ldx % 8 == 0;
  const int wvec = (uintptr_t)w % 16 == 0 && ldw % 16 == 0;
  const dim3 grid((N + BN - 1) / BN, splits);
  int8_gemm_ws_kernel<MT, WF><<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), y, part, M, N, K, ldx, ldw, kslice,
      out_bf16, xvec16, wvec);
  return (int)cudaGetLastError();
}

}  // namespace gb

// --------------------------------------------------------- f32 x, `os` --

constexpr int F_BN = 128;   // columns per block, one per thread
constexpr int F_BM = 8;     // rows of x per block
constexpr int F_BK = 32;    // K rows of x staged per step

// f32 x: FMA in f32, one column per thread over an 8-row slab of x.
template <int WF>
__global__ void __launch_bounds__(F_BN)
int8_gemm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, void* __restrict__ y,
                     int M, int N, int K, long long ldx, long long ldw,
                     int out_bf16) {
  __shared__ float xs[F_BM][F_BK];
  const int n = blockIdx.x * F_BN + threadIdx.x;
  const int m0 = blockIdx.y * F_BM;
  float acc[F_BM];
#pragma unroll
  for (int rr = 0; rr < F_BM; ++rr) acc[rr] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = threadIdx.x; i < F_BM * F_BK; i += F_BN) {
      const int rr = i / F_BK, kk = i % F_BK;
      const int m = m0 + rr, k = k0 + kk;
      xs[rr][kk] = (m < M && k < K) ? x[(long long)m * ldx + k] : 0.0f;
    }
    __syncthreads();
    if (n < N) {
      const int kend = min(F_BK, K - k0);
      for (int kk = 0; kk < kend; ++kk) {
        const float wv = w8_to_f32<WF>(
            (uint8_t)w[(long long)(k0 + kk) * ldw + n]);
#pragma unroll
        for (int rr = 0; rr < F_BM; ++rr) acc[rr] = fmaf(xs[rr][kk], wv, acc[rr]);
      }
    }
    __syncthreads();
  }
  if (n < N) {
#pragma unroll
    for (int rr = 0; rr < F_BM; ++rr)
      if (m0 + rr < M)
        store_out(y, (long long)(m0 + rr) * N + n, acc[rr] * scale[n],
                  out_bf16);
  }
}

template <int WF>
int launch_tma(const void* x, const void* w, const void* scale, void* y,
               int M, int N, int K, long long ldx, long long ldw,
               int out_bf16, cudaStream_t s) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  CUresult r = encode_2d(&xmap, fn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M,
                         K, ldx * 2, ga::BM, ga::BK,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = encode_2d(&wmap, fn, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, ldw,
                  ga::BK, ga::BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  constexpr int smem = ga::Layout::ALLOC;
  static unsigned long long attr_set = 0;
  const int e = allow_smem((const void*)ga::int8_gemm_tma_kernel<WF>, smem,
                           &attr_set);
  if (e != 0) return e;
  const dim3 grid((M + ga::BM - 1) / ga::BM, (N + ga::BN - 1) / ga::BN);
  ga::int8_gemm_tma_kernel<WF><<<grid, ga::THREADS, smem, s>>>(
      xmap, wmap, static_cast<const float*>(scale), y, M, N, K, out_bf16);
  return (int)cudaGetLastError();
}

template <int WF>
int launch_fma(const void* x, const void* w, const void* scale, void* y,
               int M, int N, int K, long long ldx, long long ldw,
               int out_bf16, cudaStream_t s) {
  const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
  int8_gemm_f32_kernel<WF><<<grid, F_BN, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), y, M, N, K, ldx, ldw, out_bf16);
  return (int)cudaGetLastError();
}

template <int WF>
int launch_ws_rows(const void* x, const void* w, const void* scale, void* y,
                   float* part, int M, int N, int K, long long ldx,
                   long long ldw, int kslice, int splits, int out_bf16,
                   cudaStream_t s) {
  const int rows = M < 64 ? M : 64;
  if (rows <= 16)
    return gb::launch_ws<1, WF>(x, w, scale, y, part, M, N, K, ldx, ldw,
                                kslice, splits, out_bf16, s);
  if (rows <= 32)
    return gb::launch_ws<2, WF>(x, w, scale, y, part, M, N, K, ldx, ldw,
                                kslice, splits, out_bf16, s);
  return gb::launch_ws<4, WF>(x, w, scale, y, part, M, N, K, ldx, ldw,
                              kslice, splits, out_bf16, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() (0 on success); int8_gemm_tma_launch returns
// 10000 + the CUresult when a TMA descriptor cannot be encoded.  x: (M, K)
// with row stride ldx; w_q: (K, N) weight bytes with row stride ldw, int8
// when w_fp8 is 0, float8 e4m3 when it is 1; scale: (N,) f32; y: (M, N)
// contiguous, bf16 when out_bf16 else f32.

// f32 x, either dataflow: the FMA kernel.
extern "C" int int8_gemm_fma_launch(const void* x, const void* w_q,
                                    const void* scale, void* y, int M, int N,
                                    int K, long long ldx, long long ldw,
                                    int out_bf16, int w_fp8, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (w_fp8 & ~1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_fp8 ? launch_fma<W_E4M3>(x, w_q, scale, y, M, N, K, ldx, ldw,
                                    out_bf16, s)
               : launch_fma<W_INT8>(x, w_q, scale, y, M, N, K, ldx, ldw,
                                    out_bf16, s);
}

// Design A (bf16 x): x and w_q 16-byte aligned, ldx % 8 == 0,
// ldw % 16 == 0.
extern "C" int int8_gemm_tma_launch(const void* x, const void* w_q,
                                    const void* scale, void* y, int M, int N,
                                    int K, long long ldx, long long ldw,
                                    int out_bf16, int w_fp8, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (w_fp8 & ~1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w_fp8 ? launch_tma<W_E4M3>(x, w_q, scale, y, M, N, K, ldx, ldw,
                                    out_bf16, s)
               : launch_tma<W_INT8>(x, w_q, scale, y, M, N, K, ldx, ldw,
                                    out_bf16, s);
}

// Design B (bf16 x): `splits` K-slices of `kslice` rows (a multiple of
// 16); with splits > 1, `part` is an (splits, M, N) f32 workspace and a
// second kernel reduces it into y.
extern "C" int int8_gemm_ws_launch(const void* x,
                                   const void* w_q, const void* scale,
                                   void* y, void* part, int M, int N, int K,
                                   long long ldx, long long ldw, int kslice,
                                   int splits, int out_bf16, int w_fp8,
                                   void* stream) {
  if (M < 1 || N < 1 || K < 1 || kslice < 16 || kslice % 16 != 0 ||
      splits < 1 || (long long)(splits - 1) * kslice >= K ||
      (splits > 1 && part == nullptr) || (w_fp8 & ~1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  const int rc =
      w_fp8 ? launch_ws_rows<W_E4M3>(x, w_q, scale, y, pf, M, N, K, ldx, ldw,
                                     kslice, splits, out_bf16, s)
            : launch_ws_rows<W_INT8>(x, w_q, scale, y, pf, M, N, K, ldx, ldw,
                                     kslice, splits, out_bf16, s);
  const cudaError_t e = (cudaError_t)rc;
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long total = (long long)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                       : 4096);
  gb::int8_gemm_ws_reduce<<<blocks, 256, 0, s>>>(
      pf, static_cast<const float*>(scale), y, M, N, splits, out_bf16);
  return (int)cudaGetLastError();
}
