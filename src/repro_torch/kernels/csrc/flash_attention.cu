// Blocked online-softmax attention for Hopper (sm_90a), causal with
// seq_offset = sk - sq and an optional sliding window.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_kernel (the
// Pallas kernel behind `attend(impl="pallas")` in the prefill forward).  It
// keeps that kernel's folded contract: q is (bh, sq, d), k and v are
// (bh_kv, sk, d) with bh = rep * bh_kv, and query row i reads kv row
// i / rep -- the GQA heads of one kv head are consecutive rows, so the
// wrapper never materialises the repeat.  Scores are scaled by 1/sqrt(d),
// masked with NEG = -1e30 (never -inf: a row whose first tiles are all
// masked gets p = exp(0) there, and the later correction exp(-1e30 - m)
// wipes it out), and accumulated in f32; the output has q's dtype.
//
// Bound on an H100 SXM: at qwen2-7b's prefill (1 x 2048 tokens, 28 query
// and 4 kv heads, d = 128, bf16) one call does ~30 GFLOP of causal work
// (QK^T and PV, 4 * d operations per unmasked (query, key) pair) on 34 MB of
// inputs and output: ~295x more operations per byte than the card's ridge,
// so the bf16 tensor cores (989 TFLOP/s) bound it at ~30 us.
//
// bf16 design (simple first; speed is later work):
//  * one block of 8 warps owns 128 query rows of one (batch, head); each
//    warp owns 16 rows and keeps its Q fragments, the (m, l) pair of each
//    of its rows and the f32 output accumulator in registers;
//  * the block loops over 64-key tiles of K and V staged in shared memory
//    (V transposed, so the PV operand is one 32-bit load), computes
//    S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in, f32 sums), and
//    runs the online softmax on the S fragments in registers;
//  * P is rounded to bf16 for the PV product (as the JAX package's
//    `flash_jnp` does); l sums the f32 p;
//  * tiles that lie wholly above the diagonal, or wholly before the window,
//    are skipped when every row of the block has a visible key: the TPU
//    kernel visits them, and there they contribute exactly 0;
//  * keys past sk (a ragged last tile) are -inf, so they count for nothing
//    even in a row that is masked everywhere; rows past sq are not stored;
//  * blocks are issued heaviest (last query tile) first.
// f32 inputs take a plain FMA kernel with the same recurrence (no TF32);
// it is off the prefill path, which computes in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int WARP = 32;

// --- bf16: mma.sync ----------------------------------------------------------

constexpr int BQ = 128;                  // query rows per block
constexpr int BKV = 64;                  // keys per tile
constexpr int WARPS = BQ / 16;           // 8: one 16-row MMA tile each
constexpr int THREADS = WARPS * WARP;    // 256

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The key tiles [j_lo, j_hi) a block of query rows [q0, q_end) must visit.
// Skipping is exact only when every row has a visible key (its own
// position, pos_q >= 0); otherwise the block visits every tile, as the TPU
// kernel does, so a row masked everywhere averages v over all sk keys.
__device__ __forceinline__ void tile_range(int q0, int q_end, int sq, int sk,
                                           int causal, int window, int bkv,
                                           int* j_lo, int* j_hi) {
  const int off = sk - sq;
  int lo = 0, hi = sk;
  if (q0 + off >= 0) {
    if (causal) hi = min(sk, q_end + off);     // past the last row's key
    if (window > 0) lo = max(0, q0 + off - window + 1);
  }
  *j_lo = lo / bkv;
  *j_hi = (hi + bkv - 1) / bkv;
}

// Score of (query position pq, key) after masking: -inf past sk, NEG where
// the causal or window mask hides the key, else the scaled dot product.
__device__ __forceinline__ float masked(float s, int pq, int key, int sk,
                                        int causal, int window) {
  if (key >= sk) return -INFINITY;
  if ((causal && pq < key) || (window > 0 && pq - key >= window)) return NEG;
  return s;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int sq, int sk, int rep,
                  int causal, int window, float scale) {
  constexpr int KS = D / 16;             // k-steps of QK^T
  constexpr int DN = D / 8;              // 8-column tiles of O
  constexpr int NT = BKV / 8;            // 8-key tiles of S
  constexpr int KP = D + 8;              // K row pitch (bf16): conflict-free
  constexpr int VP = BKV + 8;            // V^T row pitch (bf16)
  constexpr int CH = D / 8;              // 16-byte chunks per K/V row
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * KP];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VP];

  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;     // heaviest first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const __nv_bfloat16* qb = q + (long long)bh * sq * D;
  const __nv_bfloat16* kb = k + (long long)(bh / rep) * sk * D;
  const __nv_bfloat16* vb = v + (long long)(bh / rep) * sk * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;     // this thread's rows
  const int pq0 = r0 + off, pq1 = r1 + off;

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = r0 < sq ? ld32(qb + (long long)r0 * D + c) : 0u;
    qa[ks][1] = r1 < sq ? ld32(qb + (long long)r1 * D + c) : 0u;
    qa[ks][2] = r0 < sq ? ld32(qb + (long long)r0 * D + c + 8) : 0u;
    qa[ks][3] = r1 < sq ? ld32(qb + (long long)r1 * D + c + 8) : 0u;
  }
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;

  int j_lo, j_hi;
  tile_range(q0, min(q0 + BQ, sq), sq, sk, causal, window, BKV, &j_lo, &j_hi);
  for (int j = j_lo; j < j_hi; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();                      // the previous tile is consumed
    for (int i = threadIdx.x; i < BKV * CH; i += THREADS) {
      const int row = i / CH, c8 = (i % CH) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (kv0 + row < sk) {
        const long long at = (long long)(kv0 + row) * D + c8;
        kk = __ldg(reinterpret_cast<const uint4*>(kb + at));
        vv = __ldg(reinterpret_cast<const uint4*>(vb + at));
      }
      *reinterpret_cast<uint4*>(&Ks[row * KP + c8]) = kk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c8 + e) * VP + row] = ve[e];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kp = &Ks[(nt * 8 + g) * KP + ks * 16 + 2 * t];
        mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int key = kv0 + nt * 8 + 2 * t;
      s[nt][0] = masked(s[nt][0] * scale, pq0, key, sk, causal, window);
      s[nt][1] = masked(s[nt][1] * scale, pq0, key + 1, sk, causal, window);
      s[nt][2] = masked(s[nt][2] * scale, pq1, key, sk, causal, window);
      s[nt][3] = masked(s[nt][3] * scale, pq1, key + 1, sk, causal, window);
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four lanes of a quad hold one row's 64 scores between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= c0;
      acc[dn][1] *= c0;
      acc[dn][2] *= c1;
      acc[dn][3] *= c1;
    }
    // p as bf16 A fragments: the C layout of two 8-key tiles is the A
    // layout of one 16-key step
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = expf(s[nt][0] - m0), p1 = expf(s[nt][1] - m0);
      const float p2 = expf(s[nt][2] - m1), p3 = expf(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const __nv_bfloat16* vp = &Vt[(dn * 8 + g) * VP + kk * 16 + 2 * t];
        mma_bf16(acc[dn], pa[kk], ld32(vp), ld32(vp + 8));
      }
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (long long)bh * sq * D;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + c) =
          pack_bf16(acc[dn][0] / d0, acc[dn][1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + c) =
          pack_bf16(acc[dn][2] / d1, acc[dn][3] / d1);
  }
}

// --- f32: FMA ----------------------------------------------------------------

constexpr int F_BQ = 32;                 // query rows per block
constexpr int F_BKV = 16;                // keys per tile
constexpr int F_LANES = 8;               // threads per query row
constexpr int F_THREADS = F_BQ * F_LANES;  // 256

// Thread (r, x) owns query row r: it scores keys x and x + 8 of each tile,
// runs the row's softmax with the row's other 7 lanes (one aligned group of
// 8 in a warp), and accumulates output columns x, x + 8, ...
template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int sk, int rep, int causal, int window, float scale) {
  constexpr int DP = D + 1;              // conflict-free row pitch
  constexpr int PP = F_BKV + 1;
  __shared__ float Qs[F_BQ * DP];
  __shared__ float Ks[F_BKV * DP];
  __shared__ float Vs[F_BKV * D];
  __shared__ float Ps[F_BQ * PP];

  const int n_qt = (sq + F_BQ - 1) / F_BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * F_BQ;
  const int bh = blockIdx.y;
  const int r = threadIdx.x / F_LANES, x = threadIdx.x % F_LANES;
  const int pq = q0 + r + sk - sq;
  const float* qb = q + (long long)bh * sq * D;
  const float* kb = k + (long long)(bh / rep) * sk * D;
  const float* vb = v + (long long)(bh / rep) * sk * D;
  for (int i = threadIdx.x; i < F_BQ * D; i += F_THREADS) {
    const int row = i / D, c = i % D;
    Qs[row * DP + c] = q0 + row < sq ? qb[(long long)(q0 + row) * D + c] : 0.0f;
  }
  float acc[D / F_LANES];
#pragma unroll
  for (int jj = 0; jj < D / F_LANES; ++jj) acc[jj] = 0.0f;
  float m = NEG, l = 0.0f;

  int j_lo, j_hi;
  tile_range(q0, min(q0 + F_BQ, sq), sq, sk, causal, window, F_BKV, &j_lo,
             &j_hi);
  for (int j = j_lo; j < j_hi; ++j) {
    const int kv0 = j * F_BKV;
    __syncthreads();
    for (int i = threadIdx.x; i < F_BKV * D; i += F_THREADS) {
      const int row = i / D, c = i % D;
      const bool in = kv0 + row < sk;
      const long long at = (long long)(kv0 + row) * D + c;
      Ks[row * DP + c] = in ? kb[at] : 0.0f;
      Vs[row * D + c] = in ? vb[at] : 0.0f;
    }
    __syncthreads();
    float s[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kl = x + F_LANES * u;
      float dot = 0.0f;
#pragma unroll 8
      for (int e = 0; e < D; ++e)
        dot = fmaf(Qs[r * DP + e], Ks[kl * DP + e], dot);
      s[u] = masked(dot * scale, pq, kv0 + kl, sk, causal, window);
    }
    float mx = fmaxf(m, fmaxf(s[0], s[1]));
#pragma unroll
    for (int w = 1; w < F_LANES; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float corr = expf(m - mx);
    m = mx;
    const float p0 = expf(s[0] - m), p1 = expf(s[1] - m);
    float ps = p0 + p1;
#pragma unroll
    for (int w = 1; w < F_LANES; w <<= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, w);
    l = l * corr + ps;
    Ps[r * PP + x] = p0;
    Ps[r * PP + x + F_LANES] = p1;
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < D / F_LANES; ++jj) {
      const int c = x + F_LANES * jj;
      float a = acc[jj] * corr;
#pragma unroll
      for (int kk = 0; kk < F_BKV; ++kk)
        a = fmaf(Ps[r * PP + kk], Vs[kk * D + c], a);
      acc[jj] = a;
    }
  }
  if (q0 + r < sq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = o + (long long)bh * sq * D + (long long)(q0 + r) * D;
#pragma unroll
    for (int jj = 0; jj < D / F_LANES; ++jj)
      orow[x + F_LANES * jj] = acc[jj] / den;
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int is_bf16,
            int bh, int sq, int sk, int rep, int causal, int window,
            float scale, cudaStream_t s) {
  if (is_bf16) {
    const dim3 grid((sq + BQ - 1) / BQ, bh);
    flash_bf16_kernel<D><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        sq, sk, rep, causal, window, scale);
  } else {
    const dim3 grid((sq + F_BQ - 1) / F_BQ, bh);
    flash_f32_kernel<D><<<grid, F_THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), sq, sk, rep,
        causal, window, scale);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q, o: (bh, sq, d) contiguous;
// k, v: (bh / rep, sk, d) contiguous; all bf16 when is_bf16 else f32;
// d in {16, 32, 64, 128}.  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int is_bf16,
                                      int bh, int sq, int sk, int d, int rep,
                                      int causal, int window, float scale,
                                      void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || rep < 1 || bh % rep)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: launch<16>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal, window,
                        scale, s); break;
    case 32: launch<32>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal, window,
                        scale, s); break;
    case 64: launch<64>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal, window,
                        scale, s); break;
    case 128: launch<128>(q, k, v, o, is_bf16, bh, sq, sk, rep, causal,
                          window, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
