// W8A16 GEMM for Hopper (sm_90a): y = (x @ w_q) * scale[None, :] in f32.
//
// Replaces the TPU kernel src/repro/kernels/int8_gemm.py:_kernel_os (the
// output-stationary Pallas dataflow that routes every CiM-gated projection
// of the serving path).  x is (M, K) bf16 or f32, w_q is (K, N) int8 in the
// JAX layout (row-major, K rows), scale is (N,) f32, y is (M, N) f32.
//
// Bound on an H100 SXM: at decode M is the batch (8 on the serving path),
// so the call moves K*N weight bytes for 2*M*K*N operations -- 16 ops per
// byte at M = 8 and 256 at M = 128, both below the ~295 ops per byte where
// the bf16 tensor cores (989 TFLOP/s), not HBM at 3.35 TB/s, would be the
// limit.
// The kernel is bound by the weight bytes, so the design is about reading
// each weight byte once and keeping enough of them in flight:
//
//  * one block owns a BN = 32 column slab and ALL rows of x (M <= 128;
//    larger M adds a grid row per 128 rows), so every weight byte is read
//    from HBM once per call;
//  * the block's 8 warps are 2 column warps (16 columns each) x 4 K warps:
//    each K warp streams every 4th group of 128 K rows independently (no
//    block barrier in the main loop).  It prefetches its next group's
//    weights into registers while it multiplies the current one, and
//    loads the current group's x (M <= 32) in one batch, so no load
//    latency is paid per 16-row step.  The 4 partial sums are added in a
//    fixed order in shared memory at the end (the result does not depend
//    on scheduling);
//  * int8 -> bf16 is exact, so the products run on the bf16 tensor cores
//    (WMMA 16x16x16, f32 accumulation); M = 8 pads to one 16-row tile;
//  * the per-channel scale is applied once, after the K reduction, as the
//    TPU kernel does on its last K step;
//  * ragged M, N and K are masked (zero-filled in shared memory), so no
//    shape has to divide a block (qwen2-7b's mlp-down has K = 37 * 512).
//
// f32 x takes a plain FMA kernel (bf16 tensor cores would round x); it is
// off the serving path, which computes in bf16.  wgmma, TMA and a split-K
// grid for the few-column shapes are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int WARP = 32;
constexpr int TILE = 16;                          // WMMA m = n = k
constexpr int COL_WARPS = 2;                      // 16-column slabs per block
constexpr int K_WARPS = 4;                        // warps splitting K
constexpr int N_WARPS = COL_WARPS * K_WARPS;
constexpr int THREADS = WARP * N_WARPS;           // 256
constexpr int BN = TILE * COL_WARPS;              // 32 columns per block
constexpr int STEPS = 8;                          // 16-row k steps per group
constexpr int KG = TILE * STEPS;                  // 128 K rows per group
constexpr int MAX_ROWS = 128;                     // rows of x per block
constexpr int X_GROUP_MT = 2;                     // up to 32 rows: x of a
                                                  // group in registers

// 8 consecutive int8 weights of row k starting at column n, zero outside
// the (K, N) matrix.
__device__ __forceinline__ uint2 load_w8(const int8_t* __restrict__ w, int k,
                                         int n, int K, int N, long long ldw,
                                         bool vec) {
  uint2 out = make_uint2(0u, 0u);
  if (k >= K) return out;
  const int8_t* p = w + (long long)k * ldw + n;
  if (vec && n + 8 <= N) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (n + j < N) {
      const uint32_t b = (uint32_t)(uint8_t)p[j];
      if (j < 4) lo |= b << (8 * j);
      else hi |= b << (8 * (j - 4));
    }
  }
  out.x = lo;
  out.y = hi;
  return out;
}

__device__ __forceinline__ __nv_bfloat16 byte_to_bf16(uint32_t word, int j) {
  // arithmetic shift sign-extends byte j; every int8 is exact in bf16
  return __float2bfloat16((float)((int)(word << (24 - 8 * j)) >> 24));
}

// Convert 8 int8 weights to bf16 and store them as 16 bytes.
__device__ __forceinline__ void stage_w8(__nv_bfloat16* dst, uint2 v) {
  __align__(16) __nv_bfloat16 t[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = byte_to_bf16(v.x, j);
    t[4 + j] = byte_to_bf16(v.y, j);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(t);
}

// x[m, k:k+8] (bf16) as 16 bytes, zero outside the (M, K) matrix.
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* __restrict__ x,
                                         int m, int k, int M, int K,
                                         long long ldx, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (m < M && k < K) {
    const __nv_bfloat16* p = x + (long long)m * ldx + k;
    if (vec && k + 8 <= K) {
      v = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      __align__(16) __nv_bfloat16 t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        t[j] = (k + j < K) ? p[j] : __float2bfloat16(0.0f);
      v = *reinterpret_cast<const uint4*>(t);
    }
  }
  return v;
}

// MT = 16-row tiles of x per block (1, 2, 4 or 8: M up to 16 ... 128).
template <int MT>
__global__ void __launch_bounds__(THREADS)
int8_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ scale, float* __restrict__ y,
                      int M, int N, int K, long long ldx, long long ldw,
                      bool xvec, bool wvec) {
  __shared__ __align__(32) __nv_bfloat16 xs[N_WARPS][MT * TILE * TILE];
  __shared__ __align__(32) __nv_bfloat16 ws[N_WARPS][TILE * TILE];
  __shared__ __align__(32) float red[K_WARPS][TILE * BN];

  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int cw = warp % COL_WARPS, kw = warp / COL_WARPS;
  const int n0 = blockIdx.x * BN + cw * TILE;    // this warp's 16 columns
  const int m0 = blockIdx.y * MAX_ROWS;
  const int r = lane >> 1, c = (lane & 1) * 8;   // lane's row, 8 columns

  wmma::fragment<wmma::accumulator, TILE, TILE, TILE, float> acc[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) wmma::fill_fragment(acc[mt], 0.0f);

  constexpr int XREGS = MT <= X_GROUP_MT ? STEPS * MT : 1;
  const int n_groups = (K + KG - 1) / KG;
  uint2 next[STEPS];
  if (kw < n_groups) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s)
      next[s] = load_w8(w, kw * KG + s * TILE + r, n0 + c, K, N, ldw, wvec);
  }
  for (int g = kw; g < n_groups; g += K_WARPS) {
    // x of the whole group is loaded up front (M <= 32), so its L2 latency
    // is paid once per group, not once per 16-row step
    uint4 xr[XREGS];
    if constexpr (MT <= X_GROUP_MT) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          xr[s * MT + mt] = load_x8(x, m0 + mt * TILE + r,
                                    g * KG + s * TILE + c, M, K, ldx, xvec);
    }
    uint2 cur[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) cur[s] = next[s];
    const int gn = g + K_WARPS;
    if (gn < n_groups) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s)
        next[s] = load_w8(w, gn * KG + s * TILE + r, n0 + c, K, N, ldw, wvec);
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int k0 = g * KG + s * TILE;
      if (k0 >= K) break;                        // uniform across the warp
      stage_w8(&ws[warp][r * TILE + c], cur[s]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint4 xv;
        if constexpr (MT <= X_GROUP_MT) xv = xr[s * MT + mt];
        else xv = load_x8(x, m0 + mt * TILE + r, k0 + c, M, K, ldx, xvec);
        *reinterpret_cast<uint4*>(&xs[warp][(mt * TILE + r) * TILE + c]) = xv;
      }
      __syncwarp();
      wmma::fragment<wmma::matrix_b, TILE, TILE, TILE, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(bf, ws[warp], TILE);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wmma::fragment<wmma::matrix_a, TILE, TILE, TILE, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, xs[warp] + mt * TILE * TILE, TILE);
        wmma::mma_sync(acc[mt], af, bf, acc[mt]);
      }
      __syncwarp();
    }
  }

  // Add the K warps' partial sums in a fixed order, one 16-row tile at a
  // time, then apply the per-channel scale and write the masked tile.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    wmma::store_matrix_sync(&red[kw][cw * TILE], acc[mt], BN,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * BN; i += THREADS) {
      const int rr = i / BN, cc = i % BN;
      const int m = m0 + mt * TILE + rr, n = blockIdx.x * BN + cc;
      if (m < M && n < N) {
        float sum = red[0][i];
#pragma unroll
        for (int q = 1; q < K_WARPS; ++q) sum += red[q][i];
        y[(long long)m * N + n] = sum * scale[n];
      }
    }
    __syncthreads();
  }
}

constexpr int F_BN = 128;   // columns per block, one per thread
constexpr int F_BM = 8;     // rows of x per block
constexpr int F_BK = 32;    // K rows of x staged per step

// f32 x: FMA in f32, one column per thread over an 8-row slab of x.
__global__ void __launch_bounds__(F_BN)
int8_gemm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, float* __restrict__ y,
                     int M, int N, int K, long long ldx, long long ldw) {
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
        const float wv = (float)w[(long long)(k0 + kk) * ldw + n];
#pragma unroll
        for (int rr = 0; rr < F_BM; ++rr) acc[rr] = fmaf(xs[rr][kk], wv, acc[rr]);
      }
    }
    __syncthreads();
  }
  if (n < N) {
#pragma unroll
    for (int rr = 0; rr < F_BM; ++rr)
      if (m0 + rr < M) y[(long long)(m0 + rr) * N + n] = acc[rr] * scale[n];
  }
}

template <int MT>
void launch_bf16(const void* x, const void* w, const void* scale, void* y,
                 int M, int N, int K, long long ldx, long long ldw,
                 cudaStream_t stream) {
  const bool xvec = ((uintptr_t)x % 16 == 0) && (ldx % 8 == 0);
  const bool wvec = ((uintptr_t)w % 8 == 0) && (ldw % 8 == 0);
  const dim3 grid((N + BN - 1) / BN, (M + MAX_ROWS - 1) / MAX_ROWS);
  int8_gemm_bf16_kernel<MT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), M, N, K, ldx,
      ldw, xvec, wvec);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  x: (M, K) with row stride ldx,
// bf16 when x_is_bf16 else f32; w_q: (K, N) int8 with row stride ldw;
// scale: (N,) f32; y: (M, N) f32, contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int int8_gemm_launch(const void* x, int x_is_bf16, const void* w_q,
                                const void* scale, void* y, int M, int N,
                                int K, long long ldx, long long ldw,
                                void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    const int rows = M < MAX_ROWS ? M : MAX_ROWS;
    if (rows <= 16) launch_bf16<1>(x, w_q, scale, y, M, N, K, ldx, ldw, s);
    else if (rows <= 32) launch_bf16<2>(x, w_q, scale, y, M, N, K, ldx, ldw, s);
    else if (rows <= 64) launch_bf16<4>(x, w_q, scale, y, M, N, K, ldx, ldw, s);
    else launch_bf16<8>(x, w_q, scale, y, M, N, K, ldx, ldw, s);
  } else {
    const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM);
    int8_gemm_f32_kernel<<<grid, F_BN, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w_q),
        static_cast<const float*>(scale), static_cast<float*>(y), M, N, K, ldx,
        ldw);
  }
  return (int)cudaGetLastError();
}
