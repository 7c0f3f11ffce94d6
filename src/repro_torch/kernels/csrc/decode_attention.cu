// Flash-decoding for Hopper (sm_90a): one query token per head against a KV
// cache whose first `length` positions are valid.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_kernel.  It
// keeps that kernel's folded contract -- q (bh, 1, d), caches (bh_kv, S, d)
// with bh = rep * bh_kv, query row i reading cache row i / rep -- and its
// arithmetic: scores scaled by 1/sqrt(d), positions >= length masked with
// NEG = -1e30 (never -inf: with length = 0 every score is NEG and the result
// is the mean of v over all S positions, as the JAX package's reference
// gives), online softmax with f32 sums, output in q's dtype.  `length` is
// read from device memory, so a launch never waits on the host.
//
// Bound on an H100 SXM: at qwen2-7b's decode_32k shape (batch 8, S = 32768,
// 28 query and 4 kv heads, d = 128, bf16) the caches are 537 MB and the
// work is 4 * d operations per (head, position): ~0.02 operations per
// byte, so HBM at 3.35 TB/s bounds it at ~160 us -- if every cache byte is
// read once.  The design is about that:
//  * one block serves the `hb` query heads that share one kv head (all 7
//    at qwen2-7b), so each cache byte is read once, not once per query
//    head as the TPU kernel's repeated cache is;
//  * S is split across blocks (the wrapper sizes the split so that about
//    four blocks per SM are in flight: one block per kv head would leave
//    most of the 132 SMs idle at 32 kv heads), and a second small kernel
//    combines the splits' (m, l, acc) partials;
//  * a split stops at `length` when length >= 1: the positions after it
//    contribute exp(-1e30 - m) = 0 exactly, so skipping them is the same
//    function.  With length <= 0 every position is visited;
//  * in a 64-position tile each thread scores one position for half the
//    block's heads, reading its K row straight from global memory (each K
//    byte is used by every head in registers); V is staged in shared memory
//    as f32, and each thread accumulates one output column for its heads.
// The kernel computes in f32 (FMA) for bf16 and f32 inputs alike.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int DT = 128;       // threads per block
constexpr int TK = 64;        // cache positions per tile
constexpr int HB_MAX = 16;    // query heads per block
constexpr int SH = DT / TK;   // threads per position in the score phase

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}

// 16 bytes of T at p (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = to_f(e[i]);
}

// Grid (n_splits, bh / hb).  Writes, for each of its hb heads, the
// partial (acc[0..D), m, l) of positions [split * split_len, ...) to
// part[(blockIdx.y * n_splits + split) * hb + head].
template <typename T, int D>
__global__ void __launch_bounds__(DT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ length,
                    float* __restrict__ part, int S, int hb, int rep,
                    int split_len, float scale) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int RSTEP = DT / D;          // threads per output column
  constexpr int NACC = HB_MAX / RSTEP;
  constexpr int NS = HB_MAX / SH;
  __shared__ __align__(16) float qs[HB_MAX * D];
  __shared__ __align__(16) float Vs[TK * D];
  __shared__ __align__(16) float Ps[HB_MAX * TK];
  __shared__ float ms[HB_MAX], ls[HB_MAX], cs[HB_MAX];

  const int split = blockIdx.x, blk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = *length;
  const int valid = len > 0 ? min(len, S) : S;
  const int k_lo = split * split_len;
  const int k_hi = min(valid, k_lo + split_len);
  const long long kv_row = (long long)blk * hb / rep;
  const T* qb = q + (long long)blk * hb * D;
  const T* kb = kc + kv_row * S * D;
  const T* vb = vc + kv_row * S * D;
  for (int i = tid; i < hb * D; i += DT) qs[i] = to_f(qb[i]);
  if (tid < HB_MAX) {
    ms[tid] = NEG;
    ls[tid] = 0.0f;
  }
  const int c = tid % D, rb = tid / D;   // PV phase: column, first head
  const int kj = tid % TK, kh = tid / TK;  // score phase: position, head
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int t0 = k_lo; t0 < k_hi; t0 += TK) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < TK * D / VEC; i += DT) {
      const int row = i / (D / VEC), c0 = (i % (D / VEC)) * VEC;
      float f[VEC];
      if (t0 + row < k_hi) {
        load16(vb + (long long)(t0 + row) * D + c0, f);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vs[row * D + c0 + e] = f[e];
    }
    const int key = t0 + kj;
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.0f;
    if (key < k_hi) {
      const T* kr = kb + (long long)key * D;
      for (int e0 = 0; e0 < D; e0 += VEC) {
        float kf[VEC];
        load16(kr + e0, kf);
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int r = kh + SH * i;
          if (r < hb) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s[i] = fmaf(qs[r * D + e0 + e], kf[e], s[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = kh + SH * i;
      if (r < hb) {
        float x = s[i] * scale;
        if (key >= k_hi) x = -INFINITY;  // outside this split: no weight
        else if (key >= len) x = NEG;    // masked (only when length <= 0)
        Ps[r * TK + kj] = x;
      }
    }
    __syncthreads();
    for (int r = warp; r < hb; r += DT / 32) {  // one warp per head
      const float x0 = Ps[r * TK + lane], x1 = Ps[r * TK + lane + 32];
      float mx = fmaxf(ms[r], fmaxf(x0, x1));
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float p0 = expf(x0 - mx), p1 = expf(x1 - mx);
      float ps = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, w);
      const float corr = expf(ms[r] - mx);
      Ps[r * TK + lane] = p0;
      Ps[r * TK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        ls[r] = ls[r] * corr + ps;
        cs[r] = corr;
        ms[r] = mx;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int r = rb + RSTEP * i;
      if (r < hb) {
        float a = acc[i] * cs[r];
        for (int jj = 0; jj < TK; jj += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(&Ps[r * TK + jj]);
          a = fmaf(p4.x, Vs[jj * D + c], a);
          a = fmaf(p4.y, Vs[(jj + 1) * D + c], a);
          a = fmaf(p4.z, Vs[(jj + 2) * D + c], a);
          a = fmaf(p4.w, Vs[(jj + 3) * D + c], a);
        }
        acc[i] = a;
      }
    }
  }
  float* pb = part + ((long long)blk * gridDim.x + split) * hb * (D + 2);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int r = rb + RSTEP * i;
    if (r < hb) pb[r * (D + 2) + c] = acc[i];
  }
  if (tid < hb) {                        // this thread set them, or the
    pb[tid * (D + 2) + D] = ms[tid];     // last tile's barrier ordered them
    pb[tid * (D + 2) + D + 1] = ls[tid];
  }
}

// Grid (bh / hb), D threads: merges the n_splits partials of each head.
template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      int hb, int n_splits) {
  const int blk = blockIdx.x, c = threadIdx.x;
  const float* pb = part + (long long)blk * n_splits * hb * (D + 2);
  for (int r = 0; r < hb; ++r) {
    float M = NEG;
    for (int i = 0; i < n_splits; ++i)
      M = fmaxf(M, pb[(i * hb + r) * (D + 2) + D]);
    float L = 0.0f, A = 0.0f;
    for (int i = 0; i < n_splits; ++i) {
      const float* e = pb + (i * hb + r) * (D + 2);
      const float w = expf(e[D] - M);
      L += e[D + 1] * w;
      A += e[c] * w;
    }
    from_f(A / fmaxf(L, 1e-30f), out + ((long long)blk * hb + r) * D + c);
  }
}

template <typename T, int D>
void launch(const void* q, const void* kc, const void* vc, const void* length,
            void* part, void* out, int bh, int S, int hb, int rep,
            int n_splits, int split_len, float scale, cudaStream_t s) {
  const dim3 grid(n_splits, bh / hb);
  decode_split_kernel<T, D><<<grid, DT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(length),
      static_cast<float*>(part), S, hb, rep, split_len, scale);
  decode_combine_kernel<T, D><<<bh / hb, D, 0, s>>>(
      static_cast<const float*>(part), static_cast<T*>(out), hb, n_splits);
}

template <typename T>
int launch_d(const void* q, const void* kc, const void* vc,
             const void* length, void* part, void* out, int bh, int S, int d,
             int hb, int rep, int n_splits, int split_len, float scale,
             cudaStream_t s) {
  switch (d) {
    case 16: launch<T, 16>(q, kc, vc, length, part, out, bh, S, hb, rep,
                           n_splits, split_len, scale, s); return 0;
    case 32: launch<T, 32>(q, kc, vc, length, part, out, bh, S, hb, rep,
                           n_splits, split_len, scale, s); return 0;
    case 64: launch<T, 64>(q, kc, vc, length, part, out, bh, S, hb, rep,
                           n_splits, split_len, scale, s); return 0;
    case 128: launch<T, 128>(q, kc, vc, length, part, out, bh, S, hb, rep,
                             n_splits, split_len, scale, s); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q, out: (bh, 1, d) contiguous;
// caches: (bh / rep, S, d) contiguous; all bf16 when is_bf16 else f32;
// d in {16, 32, 64, 128}; length: one int32 in device memory; part: f32
// workspace of (bh / hb) * n_splits * hb * (d + 2) floats.  Each block
// serves hb query heads (hb divides rep, hb <= 16) over split_len
// positions.  Launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* length,
                                       void* part, void* out, int is_bf16,
                                       int bh, int S, int d, int hb, int rep,
                                       int n_splits, int split_len,
                                       float scale, void* stream) {
  if (bh < 1 || S < 1 || rep < 1 || hb < 1 || hb > HB_MAX || rep % hb ||
      bh % rep || bh / hb > 65535 || n_splits < 1 || split_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = is_bf16
      ? launch_d<__nv_bfloat16>(q, kc, vc, length, part, out, bh, S, d, hb,
                                rep, n_splits, split_len, scale, s)
      : launch_d<float>(q, kc, vc, length, part, out, bh, S, d, hb, rep,
                        n_splits, split_len, scale, s);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
