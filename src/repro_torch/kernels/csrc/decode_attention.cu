// Flash-decoding for Hopper (sm_90a): one query token per head against a KV
// cache whose first `length` positions are valid.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_kernel
// (:20).  It keeps that kernel's folded contract -- q (bh, 1, d), caches
// (bh_kv, S, d) with bh = rep * bh_kv, query row i reading cache row
// i / rep -- and its arithmetic: scores scaled by 1/sqrt(d), positions >=
// length masked with NEG = -1e30 (never -inf: with length = 0 every score
// is NEG and the result is the mean of v over all S positions, as the JAX
// package's reference gives), online softmax with f32 sums, output in q's
// dtype.  `length` is read from device memory, so a launch never waits on
// the host.
//
// Bound on an H100 SXM: at qwen2-7b's decode_32k shape (batch 8, S = 32768,
// 28 query and 4 kv heads, d = 128, bf16) the caches are 537 MB and the
// work is 4 * d operations per (head, position): ~0.02 operations per
// byte, so HBM at 3.35 TB/s bounds it at ~160 us -- if every cache byte is
// read once, and enough bytes are in flight to cover HBM's latency.  The
// bf16 design is about that:
//  * one block serves the `hb` query heads that share one kv head (all 7
//    at qwen2-7b; at most 16), so each cache byte is read once, not once
//    per query head as the TPU kernel's repeated cache is;
//  * S is split across blocks (the wrapper's `split_plan` sizes the split
//    so that one wave fills every SM with one block), and a second small
//    kernel, one block per head, combines the splits' (m, l, acc) partials
//    in split order: no atomics, so two calls give equal bits;
//  * a producer warp's one thread streams the split's 64-position tiles of
//    K and V through a 4-stage ring by TMA (3-D maps (d, S, heads),
//    64-column boxes, 128-byte swizzle: 32 KB a stage at d = 128, so up to
//    128 KB in flight on an SM; 2 or 3 stages at two blocks an SM measured
//    no faster).  Positions past S read as zeros, never another head's
//    rows;
//  * four consumer warps each take 16 positions of every tile.  Both
//    products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//    sums): the hb query heads are the 16 rows of the A operand (rows past
//    hb are zero); K fragments come from the swizzled tile by ldmatrix and
//    V fragments by ldmatrix.trans, conflict-free.  Each warp keeps its
//    rows' (m, l, acc) in registers, in log2 units (one multiply by
//    scale * log2(e), then the masks, then ex2);
//  * p enters the PV product as a hi/lo pair of bf16 values (two MMAs),
//    which keeps ~16 bits of it: the kernel holds p in f32 as far as the
//    check can see, and is bound by bytes, so the extra MMAs cost nothing;
//  * the warps' partials merge in shared memory at the end in warp order;
//  * a split stops at `length` when length >= 1: the positions after it
//    contribute exp(-1e30 - m) = 0 exactly, so skipping them is the same
//    function.  With length <= 0 every position is visited.
// f32 inputs keep the FMA kernel (computing in f32), off every path.
//
// The paged design (`paged_decode_attention_launch`) replaces no TPU
// kernel: it is the engine's decode attention, which the JAX package
// computes with XLA over the gathered strips (models/attention.py:
// decode_attend).  It reads the layer's block pool (n_blocks, bs, kv, d)
// in place through each slot's block table, at each slot's own length
// and window, read from device memory: no gathered strip, no GQA copy, no
// f32 copy of the cache, no host sync, so it captures into a CUDA graph.
// Bound: each valid K/V byte read once (at qwen2-7b's engine step, 32
// slots x 512 positions x 4 kv heads x 128 x 2 x 2 B = 33.6 MB a layer at
// most, ~10 us at 3.35 TB/s; less at shorter lengths).  It keeps the mma
// design's blocks, ring, products, p as hi/lo pair and merge
// (`consume`): a 64-position tile comes in as boxes of one pool block's
// rows, each from the physical block the slot's table names.  With one
// split per row (the plan whenever the blocks fill a wave) it writes the
// output itself and launches no combine kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// --- shared constants and the f32 FMA kernel ---------------------------------

constexpr float NEG = -1e30f;
constexpr int DT = 128;       // threads per block
constexpr int TK = 64;        // cache positions per tile
constexpr int HB_MAX = 16;    // query heads per block
constexpr int SH = DT / TK;   // threads per position in the score phase

__device__ __forceinline__ float to_f(float x) { return x; }
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

// --- bf16: TMA ring + mma.sync -----------------------------------------------

namespace dk {

constexpr int T = 64;                    // cache positions per tile
constexpr int STAGES = 4;                // tiles in flight per block
constexpr int WARPS = 4;                 // consumer warps, 16 positions each
constexpr int THREADS = (WARPS + 1) * 32;  // + a producer warp
constexpr int ROW = 128;                 // bytes of a 64-column chunk row

// Shared memory of a block for head widths padded to DP (64 or 128)
// columns: a stage is the K tile then the V tile, each DP / 64 chunks of
// T rows x 128 bytes.  After the loop the ring holds the warps' partials.
template <int DP>
struct Layout {
  static constexpr int NCH = DP / 64;
  static constexpr int TILE_BYTES = NCH * T * ROW;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;  // full, then empty
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;            // for alignment
};

// A block's ring: its shared memory aligned to 1024 bytes (the swizzle
// atoms) and the stages' barriers, full (the producer's arrive and the
// TMA bytes) and empty (one arrive per consumer warp), initialised and
// made visible to every thread before the constructor returns.
template <int DP>
struct Ring {
  uint32_t base, full0, empty0;
  uint8_t* sbase;
  __device__ __forceinline__ explicit Ring(uint8_t* smem_raw) {
    const uint32_t raw = smem_u32(smem_raw);
    base = (raw + 1023u) & ~1023u;
    sbase = smem_raw + (base - raw);
    full0 = base + Layout<DP>::BAR_OFF;
    empty0 = full0 + 8 * STAGES;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, WARPS);
      }
      fence_barrier_init();
    }
    __syncthreads();
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// (a, b) as a bf16 pair `hi` and the bf16 pair `lo` of what hi leaves
// over: hi + lo holds ~16 bits of each value.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Byte address of the 16-byte piece `piece` (8 columns) of row `row` in a
// tile of T rows: 64-column chunks of T x 128 bytes, 128-byte swizzle.
__device__ __forceinline__ uint32_t tile_at(uint32_t tile, int row,
                                            int piece) {
  return tile + (piece / 8) * T * ROW + row * ROW
         + (((piece % 8) ^ (row & 7)) << 4);
}

// The consumer warps of a bf16 block: warp w scores positions 16 w .. 16 w
// + 15 of each of the n_tiles tiles the ring delivers (the first at k_lo),
// then the warps' partials merge in warp order.  qb: the block's first
// query head, q_row elements between heads.  Scores of positions >= k_hi
// get no weight (-inf); positions >= mhi or < mlo are masked with NEG.
// The result goes to pb, the hb partials (acc[0..D), m, l) with m in log2
// units, or, when pb is null, normalised to ob (hb rows of D).
template <int D>
__device__ __forceinline__ void consume(
    uint32_t base, uint8_t* sbase, uint32_t full0, uint32_t empty0,
    const __nv_bfloat16* qb, long long q_row, int hb, int k_lo, int k_hi,
    int n_tiles, int mlo, int mhi, float scale, float* pb,
    __nv_bfloat16* ob) {
  constexpr int DP = D < 64 ? 64 : D;
  constexpr int KS = D / 16;             // k-steps of QK^T
  constexpr int NT = D / 8;              // 8-column tiles of the output
  using L = Layout<DP>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * tq;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(qb + g * q_row
                                                           + c);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(
        qb + (g + 8) * q_row + c);
    qa[ks][0] = g < hb ? r0[0] : 0u;
    qa[ks][1] = g + 8 < hb ? r1[0] : 0u;
    qa[ks][2] = g < hb ? r0[4] : 0u;
    qa[ks][3] = g + 8 < hb ? r1[4] : 0u;
  }
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = NEG, m1 = NEG, l0 = 0.0f, l1 = 0.0f;
  // ldmatrix rows: lane l addresses row l % 8 of matrix l / 8
  const int mi = lane / 8, mr = lane % 8;
  const int krow = warp * 16 + (mi / 2) * 8 + mr, kpiece = mi % 2;
  const int vrow = warp * 16 + (mi % 2) * 8 + mr, vpiece = mi / 2;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t kt = base + s * L::STAGE_BYTES;
    const uint32_t vt = kt + L::TILE_BYTES;
    const int p0 = k_lo + it * T + warp * 16;      // this warp's positions
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);

    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t b[4];
      ldsm_x4(tile_at(kt, krow, 2 * ks + kpiece), b);
      mma_bf16(sc[0], qa[ks], b[0], b[1]);
      mma_bf16(sc[1], qa[ks], b[2], b[3]);
    }
    // element (nt, 2 h + e): head row g + 8 h, position p0 + 8 nt + 2 tq + e
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = p0 + nt * 8 + 2 * tq + (i & 1);
        float x = sc[nt][i] * sl2;
        if (key >= k_hi) x = -INFINITY;  // outside this split: no weight
        else if (key >= mhi || key < mlo) x = NEG;   // masked
        sc[nt][i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // p as hi and lo A fragments (the C layout of the two 8-position
    // tiles is the A layout of one 16-position step)
    uint32_t ph[4], pl[4];
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float e0 = ex2(sc[nt][0] - m0), e1 = ex2(sc[nt][1] - m0);
      const float e2 = ex2(sc[nt][2] - m1), e3 = ex2(sc[nt][3] - m1);
      ps0 += e0 + e1;
      ps1 += e2 + e3;
      split_bf16(e0, e1, &ph[2 * nt], &pl[2 * nt]);
      split_bf16(e2, e3, &ph[2 * nt + 1], &pl[2 * nt + 1]);
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }
#pragma unroll
    for (int pi = 0; pi < NT / 2; ++pi) {
      uint32_t b[4];
      ldsm_x4_trans(tile_at(vt, vrow, 2 * pi + vpiece), b);
      mma_bf16(acc[2 * pi], ph, b[0], b[1]);
      mma_bf16(acc[2 * pi], pl, b[0], b[1]);
      mma_bf16(acc[2 * pi + 1], ph, b[2], b[3]);
      mma_bf16(acc[2 * pi + 1], pl, b[2], b[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // merge the warps' partials in warp order, in the (now idle) ring
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  float* ow = reinterpret_cast<float*>(sbase);     // [WARPS][16][D]
  float* mw = ow + WARPS * 16 * D;                   // [WARPS][16]
  float* lw = mw + WARPS * 16;                       // [WARPS][16]
  float* lsum = lw + WARPS * 16;                     // [16]
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
  if (tq == 0) {
    mw[warp * 16 + g] = m0;
    mw[warp * 16 + g + 8] = m1;
    lw[warp * 16 + g] = l0;
    lw[warp * 16 + g + 8] = l1;
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
  float M0 = NEG, M1 = NEG;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    M0 = fmaxf(M0, mw[w * 16 + g]);
    M1 = fmaxf(M1, mw[w * 16 + g + 8]);
  }
  const float w0 = ex2(m0 - M0), w1 = ex2(m1 - M1);
  float* mine = ow + warp * 16 * D;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int c = i * 8 + 2 * tq;
    mine[g * D + c] = acc[i][0] * w0;
    mine[g * D + c + 1] = acc[i][1] * w0;
    mine[(g + 8) * D + c] = acc[i][2] * w1;
    mine[(g + 8) * D + c + 1] = acc[i][3] * w1;
  }
  if ((int)threadIdx.x < hb) {
    const int r = threadIdx.x;
    float M = NEG, l = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mw[w * 16 + r]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      l += lw[w * 16 + r] * ex2(mw[w * 16 + r] - M);
    lsum[r] = l;
    if (pb != nullptr) {
      pb[r * (D + 2) + D] = M;
      pb[r * (D + 2) + D + 1] = l;
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(WARPS * 32) : "memory");
  for (int i = threadIdx.x; i < hb * D; i += WARPS * 32) {
    const int r = i / D, c = i % D;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += ow[(w * 16 + r) * D + c];
    if (pb != nullptr)
      pb[r * (D + 2) + c] = a;
    else      // what decode_combine_kernel gives for a single split
      ob[r * D + c] = __float2bfloat16(a / fmaxf(lsum[r], 1e-30f));
  }
}

// Grid (n_splits, bh / hb), THREADS threads.  Writes, for each of its hb
// heads, the partial (acc[0..D), m, l) of positions [split * split_len,
// ...) to part[(blockIdx.y * n_splits + split) * hb + head], m in log2
// units.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
decode_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q,
                  const int* __restrict__ length, float* __restrict__ part,
                  int S, int hb, int rep, int split_len, float scale) {
  constexpr int DP = D < 64 ? 64 : D;
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<DP> ring(smem_raw);
  const uint32_t base = ring.base, full0 = ring.full0, empty0 = ring.empty0;
  uint8_t* const sbase = ring.sbase;

  const int split = blockIdx.x, blk = blockIdx.y;
  const int len = *length;
  const int valid = len > 0 ? min(len, S) : S;
  const int k_lo = split * split_len;
  const int k_hi = min(valid, k_lo + split_len);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + T - 1) / T : 0;

  if (threadIdx.x >= WARPS * 32) {
    // producer warp: one thread keeps the ring full
    if (threadIdx.x == WARPS * 32) {
      const int kvh = blk * hb / rep;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t kt = base + s * L::STAGE_BYTES;
        const uint32_t vt = kt + L::TILE_BYTES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, L::STAGE_BYTES);
        for (int c = 0; c < L::NCH; ++c) {
          tma_load_3d(kt + c * T * ROW, &kmap, full0 + 8 * s, 64 * c,
                      k_lo + it * T, kvh);
          tma_load_3d(vt + c * T * ROW, &vmap, full0 + 8 * s, 64 * c,
                      k_lo + it * T, kvh);
        }
      }
    }
    return;
  }
  // masked past `length` (every position when length <= 0)
  consume<D>(base, sbase, full0, empty0, q + (long long)blk * hb * D, D, hb,
             k_lo, k_hi, n_tiles, 0, len, scale,
             part + ((long long)blk * gridDim.x + split) * hb * (D + 2),
             nullptr);
}

// The paged design.  Grid (n_splits, b * H / hb), THREADS threads: block
// y serves the folded query rows y hb .. y hb + hb - 1 (slot s = y hb / H,
// query heads from h0 = y hb % H, kv head h0 / rep) over the slot's
// logical positions [0, S), S = max_blocks * bs.  The slot's positions
// [lo, hi) are valid: hi = min(length, S), lo = max(0, length - window)
// with a window, else 0.  The block visits the tiles from the one holding
// lo up to hi, cut to this split's [split * split_len, ...) -- or, when no
// position is valid (length <= 0, or the window past S), all of [0, S),
// every position masked, which gives the mean of v as decode_attend does.
// Each 64-position tile arrives as 64 / box boxes of box rows (box =
// gcd(bs, 64) >= 8, so a box is 1024-byte aligned in the swizzled tile
// and never crosses a pool block), box j from the physical block the
// slot's table names for its positions; a box past S reads rows of the
// slot's last block (past the split's end no score gets weight).  The
// producer warp's lane j reads box j's table entry and starts its loads.
// With one split the block writes its rows of `out` itself; with more it
// writes partials to `part` as decode_mma_kernel does.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
paged_decode_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __nv_bfloat16* __restrict__ q, long long q_sb,
                    long long q_sh, const int* __restrict__ tables,
                    long long t_sb, const long long* __restrict__ lengths,
                    float* __restrict__ part, __nv_bfloat16* __restrict__ out,
                    int S, int bs, int box, int H, int hb, int rep,
                    int window, int split_len, float scale) {
  constexpr int DP = D < 64 ? 64 : D;
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<DP> ring(smem_raw);
  const uint32_t base = ring.base, full0 = ring.full0, empty0 = ring.empty0;
  uint8_t* const sbase = ring.sbase;

  const int split = blockIdx.x, blk = blockIdx.y;
  const int row0 = blk * hb, slot = row0 / H, h0 = row0 % H;
  const long long len = lengths[slot];
  const int hi = (int)max(0LL, min(len, (long long)S));
  const int lo = window > 0 ? (int)max(0LL, min(len - window, (long long)S))
                            : 0;
  const int v0 = hi > lo ? lo / T * T : 0, v1 = hi > lo ? hi : S;
  const int k_lo = max(v0, split * split_len);
  const int k_hi = min(v1, (split + 1) * split_len);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + T - 1) / T : 0;

  if (threadIdx.x >= WARPS * 32) {
    // producer warp: lane j < 64 / box loads box j of each tile
    const int lane = threadIdx.x % 32, kvh = h0 / rep, n_box = T / box;
    const int* tab = tables + (long long)slot * t_sb;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t kt = base + s * L::STAGE_BYTES;
      const uint32_t vt = kt + L::TILE_BYTES;
      int pblk = 0, off = 0;           // read before the wait, to hide it
      if (lane < n_box) {
        const int p = min(k_lo + it * T + lane * box, S - box);
        pblk = tab[p / bs];
        off = p % bs;
      }
      if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
      if (lane == 0) mbar_expect_tx(full0 + 8 * s, L::STAGE_BYTES);
      __syncwarp();
      if (lane < n_box) {
        for (int c = 0; c < L::NCH; ++c) {
          const uint32_t at = c * T * ROW + lane * box * ROW;
          tma_load_4d(kt + at, &kmap, full0 + 8 * s, 64 * c, kvh, off, pblk);
          tma_load_4d(vt + at, &vmap, full0 + 8 * s, 64 * c, kvh, off, pblk);
        }
      }
    }
    return;
  }
  consume<D>(base, sbase, full0, empty0, q + slot * q_sb + h0 * q_sh, q_sh,
             hb, k_lo, k_hi, n_tiles, lo, hi, scale,
             gridDim.x > 1
                 ? part + ((long long)blk * gridDim.x + split) * hb * (D + 2)
                 : nullptr,
             out + (long long)row0 * D);
}

}  // namespace dk

// Grid (bh / hb, hb), D threads: block (b, r) merges the n_splits partials
// of head r of query block b in split order; m is in log2 units when LOG2
// (the bf16 kernel's partials).
template <typename T, int D, bool LOG2>
__global__ void __launch_bounds__(D)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      int hb, int n_splits) {
  const int blk = blockIdx.x, r = blockIdx.y, c = threadIdx.x;
  const float* pb = part + (long long)blk * n_splits * hb * (D + 2);
  float M = NEG;
  for (int i = 0; i < n_splits; ++i)
    M = fmaxf(M, pb[(i * hb + r) * (D + 2) + D]);
  float L = 0.0f, A = 0.0f;
  for (int i = 0; i < n_splits; ++i) {
    const float* e = pb + (i * hb + r) * (D + 2);
    const float w = LOG2 ? exp2f(e[D] - M) : expf(e[D] - M);
    L += e[D + 1] * w;
    A += e[c] * w;
  }
  from_f(A / fmaxf(L, 1e-30f), out + ((long long)blk * hb + r) * D + c);
}

template <int D>
int launch_f32(const void* q, const void* kc, const void* vc,
               const void* length, void* part, void* out, int bh, int S,
               int hb, int rep, int n_splits, int split_len, float scale,
               cudaStream_t s) {
  const dim3 grid(n_splits, bh / hb);
  decode_split_kernel<float, D><<<grid, DT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const int*>(length),
      static_cast<float*>(part), S, hb, rep, split_len, scale);
  decode_combine_kernel<float, D, false><<<dim3(bh / hb, hb), D, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), hb,
      n_splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* kc, const void* vc,
                const void* length, void* part, void* out, int bh, int S,
                int hb, int rep, int n_splits, int split_len, float scale,
                cudaStream_t s) {
  constexpr int smem = dk::Layout<(D < 64 ? 64 : D)>::ALLOC;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap km, vm;
  CUresult r = encode_heads_bf16(&km, fn, kc, bh / rep, S, D, dk::T);
  if (r == CUDA_SUCCESS)
    r = encode_heads_bf16(&vm, fn, vc, bh / rep, S, D, dk::T);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  static unsigned long long attr_set = 0;
  const int e = allow_smem((const void*)dk::decode_mma_kernel<D>, smem,
                           &attr_set);
  if (e != 0) return e;
  const dim3 grid(n_splits, bh / hb);
  dk::decode_mma_kernel<D><<<grid, dk::THREADS, smem, s>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(length), static_cast<float*>(part), S, hb, rep,
      split_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<__nv_bfloat16, D, true>
      <<<dim3(bh / hb, hb), D, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), hb,
      n_splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* kc, const void* vc, const void* length,
           void* part, void* out, int is_bf16, int bh, int S, int hb, int rep,
           int n_splits, int split_len, float scale, cudaStream_t s) {
  return is_bf16 ? launch_bf16<D>(q, kc, vc, length, part, out, bh, S, hb,
                                  rep, n_splits, split_len, scale, s)
                 : launch_f32<D>(q, kc, vc, length, part, out, bh, S, hb,
                                 rep, n_splits, split_len, scale, s);
}

template <int D>
int launch_paged(const void* q, long long q_sb, long long q_sh,
                 const void* kp, const void* vp, int n_blocks, int bs, int kv,
                 long long p_blk, long long p_row, long long p_kv,
                 const void* tables, long long t_sb, int max_blocks,
                 const void* lengths, void* part, void* out, int b, int H,
                 int hb, int rep, int window, int n_splits, int split_len,
                 float scale, cudaStream_t s) {
  constexpr int smem = dk::Layout<(D < 64 ? 64 : D)>::ALLOC;
  const int box = (bs & -bs) < dk::T ? (bs & -bs) : dk::T;  // gcd(bs, 64)
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap km, vm;
  CUresult r = encode_pool_bf16(&km, fn, kp, n_blocks, bs, kv, D, 2 * p_blk,
                                2 * p_row, 2 * p_kv, box);
  if (r == CUDA_SUCCESS)
    r = encode_pool_bf16(&vm, fn, vp, n_blocks, bs, kv, D, 2 * p_blk,
                         2 * p_row, 2 * p_kv, box);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  static unsigned long long attr_set = 0;
  const int e = allow_smem((const void*)dk::paged_decode_kernel<D>, smem,
                           &attr_set);
  if (e != 0) return e;
  const dim3 grid(n_splits, b * H / hb);
  dk::paged_decode_kernel<D><<<grid, dk::THREADS, smem, s>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), q_sb, q_sh,
      static_cast<const int*>(tables), t_sb,
      static_cast<const long long*>(lengths), static_cast<float*>(part),
      static_cast<__nv_bfloat16*>(out), max_blocks * bs, bs, box, H, hb, rep,
      window, split_len, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  decode_combine_kernel<__nv_bfloat16, D, true>
      <<<dim3(b * H / hb, hb), D, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(out), hb,
      n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q, out: (bh, 1, d) contiguous;
// caches: (bh / rep, S, d) contiguous; all bf16 when is_bf16 else f32;
// d in {16, 32, 64, 128}; bf16 bases 16-byte aligned; length: one int32 in
// device memory; part: f32 workspace of (bh / hb) * n_splits * hb * (d + 2)
// floats.  Each block serves hb query heads (hb divides rep, hb <= 16) over
// split_len positions (a multiple of 64).  Launches both kernels on
// `stream` and returns cudaGetLastError() (0 on success), or 10000 + the
// CUresult when a TMA descriptor cannot be encoded.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* length,
                                       void* part, void* out, int is_bf16,
                                       int bh, int S, int d, int hb, int rep,
                                       int n_splits, int split_len,
                                       float scale, void* stream) {
  if (bh < 1 || S < 1 || rep < 1 || hb < 1 || hb > HB_MAX || rep % hb ||
      bh % rep || bh / hb > 65535 || n_splits < 1 || split_len < 1 ||
      split_len % TK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, kc, vc, length, part, out, is_bf16, bh, S,
                               hb, rep, n_splits, split_len, scale, s);
    case 32: return launch<32>(q, kc, vc, length, part, out, is_bf16, bh, S,
                               hb, rep, n_splits, split_len, scale, s);
    case 64: return launch<64>(q, kc, vc, length, part, out, is_bf16, bh, S,
                               hb, rep, n_splits, split_len, scale, s);
    case 128: return launch<128>(q, kc, vc, length, part, out, is_bf16, bh,
                                 S, hb, rep, n_splits, split_len, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry point of the paged design (loaded with ctypes).  q: (b, 1,
// H, d) bf16, element strides q_sb between slots and q_sh between heads
// (the last dim contiguous, rows 4-byte aligned); kp, vp: the layer's bf16
// K and V pools (n_blocks, bs, kv, d), element strides p_blk, p_row, p_kv
// (the last dim contiguous; bases 16-byte aligned, strides multiples of 8
// elements); tables: (b, max_blocks) int32, t_sb elements between slots;
// lengths: (b,) int64; out: (b, 1, H, d) bf16, contiguous; part: f32
// workspace of b * H * n_splits * (d + 2) floats (unused, may be null, at
// n_splits = 1).  H = rep * kv; hb divides rep (hb <= 16); bs a multiple
// of 8; window 0 (none) or the number of positions a query sees;
// split_len a multiple of 64.  Launches on `stream` (one kernel, or two
// with n_splits > 1) and returns cudaGetLastError() (0 on success), or
// 10000 + the CUresult when a TMA descriptor cannot be encoded.
extern "C" int paged_decode_attention_launch(
    const void* q, long long q_sb, long long q_sh, const void* kp,
    const void* vp, int n_blocks, int bs, int kv, long long p_blk,
    long long p_row, long long p_kv, const void* tables, long long t_sb,
    int max_blocks, const void* lengths, void* part, void* out, int b, int H,
    int d, int hb, int rep, int window, int n_splits, int split_len,
    float scale, void* stream) {
  if (b < 1 || H < 1 || kv < 1 || rep < 1 || H != rep * kv || hb < 1 ||
      hb > HB_MAX || rep % hb || (long long)b * H / hb > 65535 ||
      n_blocks < 1 || bs < 8 || bs % 8 || max_blocks < 1 || window < 0 ||
      n_splits < 1 || split_len < 1 || split_len % TK ||
      (n_splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_ARGS q, q_sb, q_sh, kp, vp, n_blocks, bs, kv, p_blk, p_row, \
    p_kv, tables, t_sb, max_blocks, lengths, part, out, b, H, hb, rep,     \
    window, n_splits, split_len, scale, s
  switch (d) {
    case 16: return launch_paged<16>(PAGED_ARGS);
    case 32: return launch_paged<32>(PAGED_ARGS);
    case 64: return launch_paged<64>(PAGED_ARGS);
    case 128: return launch_paged<128>(PAGED_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAGED_ARGS
}
